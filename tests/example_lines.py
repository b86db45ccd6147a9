"""Compare what two runs of an example script print, line by line.

JAX-free: ``tests/test_torch_examples.py`` holds the port's examples against
the JAX package's scripts with it, and ``chip_smoke.py`` (which loads this
file by path) holds a run on the card against a ``--device cpu`` run.

* Masked first: times and dates, the gateway's temp work directory and its
  per-epoch process metrics (``Process time: ... RAM: ...``), which differ
  from run to run.
* Then every line's text must be equal with its numbers taken out (runs of
  blanks and the blanks numpy pads array items with do not count).
* A number must equal its counterpart to within one step of its printed
  precision (float32 lands on either side of a rounding tie, and the JAX
  package may print a float32 one ulp off) plus 2e-5 relative.
* SSI's lines (after ``SSI-COV stabilized``) take ``tests/test_torch_ssi.py``'s
  looser rule, 1e-2 relative plus one printed step: its poles come from a
  float64 identification of float32 correlation blocks, whose last bits
  differ between devices and libraries.
"""

from __future__ import annotations

import re

_NUM = re.compile(r"[-+±]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
_MASKS = (
    (re.compile(r"Process time: .*?RAM: [-0-9.]+"), "METRICS"),
    (re.compile(r"Datetime: [-0-9]+ [0-9:]+"), "Datetime: TIME"),
    (re.compile(r"\d{1,4}[/_-]\d{1,2}[/_-]\d{1,4}(?:, |_| )\d{1,2}[:_]\d{2}[:_]\d{2}(?:\.\d+)?"),
     "TIME"),
    (re.compile(r"workdir=\S+"), "workdir=WORKDIR"),
)


def mask(text: str) -> list[str]:
    """The lines of ``text`` with run-to-run values masked and blanks normalised."""
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    lines = []
    for line in text.strip().splitlines():
        line = re.sub(r"\s+", " ", line.rstrip())
        lines.append(re.sub(r"\[ ", "[", re.sub(r" \]", "]", line)))
    return lines


def _number(token: str) -> float:
    return float(token.replace("±", ""))


def _close(x: str, y: str, rtol: float) -> bool:
    if x == y:
        return True
    mant = x.replace("±", "").lstrip("+-").partition("e")[0]
    exp = x.partition("e")[2]
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    step = 10.0 ** (int(exp or 0) - decimals)
    return abs(_number(x) - _number(y)) <= 1.01 * step + rtol * abs(_number(y))


def mismatches(got: str, want: str) -> list[str]:
    """Lines of ``got`` that do not match ``want`` under the module's rule
    (empty when the two runs printed the same)."""
    a, b = mask(got), mask(want)
    if len(a) != len(b):
        return [f"{len(a)} lines against {len(b)}"] + [x for x in a if x not in b]
    bad = []
    ssi = False
    for x, y in zip(a, b):
        ssi = ssi or x.startswith("SSI-COV stabilized")
        nx, ny = _NUM.findall(x), _NUM.findall(y)
        if _NUM.sub("#", x) != _NUM.sub("#", y) or len(nx) != len(ny) or not all(
            _close(p, q, 1e-2 if ssi else 2e-5) for p, q in zip(nx, ny)
        ):
            bad.append(f"{x!r} against {y!r}")
    return bad
