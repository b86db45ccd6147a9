"""Runnable examples of the port, one a use case; each takes ``--device``.

The counterparts of the JAX package's ``examples/`` scripts: the same
inputs, the same printed lines.  Run one as a module or as a file, e.g.
``python -m apda_fft_tpu_torch.examples.quickstart`` (on the card) or
``python apda_fft_tpu_torch/examples/quickstart.py --device cpu``.
"""

from __future__ import annotations

import argparse


def parse_device(doc: str | None, argv: list[str] | None = None) -> str | None:
    """The ``--device`` an example was given: None (the default) runs it on
    the card, as every entry point does; ``cpu`` runs it on the CPU."""
    parser = argparse.ArgumentParser(description=(doc or "").splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu or cuda:0 (default: the card)")
    return parser.parse_args(argv).device
