"""``precision="fast"`` in the port, on the CPU.

The analogue of ``tests/test_pipeline.py::test_fast_precision_knob``: the
same ``ValueError``s, and on the CPU (which has no TF32, as the JAX
package's CPU has no bf16 pass) decisions equal to ``"highest"``'s and to
the JAX package's fast run.  Then the override's thread rule: PyTorch keeps
the matmul precision process-wide, so ``ops.fft``'s override is shared, and
IEEE wins - while any ``"highest"`` call is inside, every knob reads
``"ieee"``, also when a fast call entered first; cuBLAS reads ``"tf32"``
only while fast calls alone are inside; the caller's settings come back
when the last call leaves.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from apda_fft_tpu.models.pipeline import analyze_epoch as janalyze
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.models import streaming as tstream
from apda_fft_tpu_torch.ops import fft as tfft
from tests.signals import two_mode_signal

KNOBS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul,
         torch.backends.cudnn.conv, torch.backends.mkldnn.conv)
CALLER = ("tf32", "bf16", "tf32", "tf32")


def _precisions():
    return tuple(k.fp32_precision for k in KNOBS)


@pytest.fixture
def caller_settings():
    """Non-IEEE settings a caller might hold, restored afterwards."""
    saved = _precisions()
    for k, v in zip(KNOBS, CALLER):
        k.fp32_precision = v
    yield
    for k, v in zip(KNOBS, saved):
        k.fp32_precision = v


def test_fast_precision_knob():
    x = two_mode_signal(1024, 500.0)[None, :].astype(np.float32)
    base = tpipe.analyze_epoch(x, 500.0, mode="flexible", device="cpu")
    fast = tpipe.analyze_epoch(x, 500.0, mode="flexible", precision="fast", device="cpu")
    want = janalyze(x, 500.0, mode="flexible", precision="fast")
    for name in ("count", "idx", "n_candidates", "n_required"):
        assert torch.equal(getattr(fast, name), getattr(base, name)), name
        np.testing.assert_array_equal(getattr(fast, name).numpy(), np.asarray(getattr(want, name)))

    with pytest.raises(ValueError, match="precision"):
        tpipe.analyze_epoch(x, 500.0, precision="turbo", device="cpu")
    with pytest.raises(ValueError, match="matmul backend only"):
        tpipe.analyze_epoch(x, 500.0, backend="xla", precision="fast", device="cpu")
    with pytest.raises(ValueError, match="matmul backend only"):
        tfft.halfspec_magnitudes(torch.zeros((1, 64)), backend="xla", precision="fast")
    with pytest.raises(ValueError, match="precision"):
        tfft.fft_matmul_real(torch.zeros((1, 64)), precision="turbo")


def test_fast_spectra_and_streams_equal_highest_on_the_cpu():
    """Every four-step entry point takes ``precision``; on the CPU the fast
    products are IEEE, so the results are bit-equal."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 2048)).astype(np.float32))
    for fn in (lambda p: tfft.halfspec_magnitudes(x, backend="matmul", precision=p),
               lambda p: tfft.fft_matmul_real(x, precision=p, half=True),
               lambda p: tfft.rfft_packed_matmul(x, precision=p)):
        fast, best = fn("fast"), fn("highest")
        for a, b in zip(fast if isinstance(fast, tuple) else (fast,),
                        best if isinstance(best, tuple) else (best,)):
            assert torch.equal(a, b)
    rec = x.reshape(-1)
    fast = tstream.analyze_welch(rec, 500.0, 1024, precision="fast", device="cpu")
    best = tstream.analyze_welch(rec, 500.0, 1024, device="cpu")
    assert torch.equal(fast.idx, best.idx) and torch.equal(fast.mag, best.mag)


def test_fast_override_sets_tf32_on_cublas_only(caller_settings):
    with tfft.fast_fp32_matmul():
        assert _precisions() == ("tf32", "ieee", "ieee", "ieee")
        with tfft.ieee_fp32_matmul():
            assert _precisions() == ("ieee",) * 4
        assert _precisions() == ("tf32", "ieee", "ieee", "ieee")
    assert _precisions() == CALLER
    with tfft.ieee_fp32_matmul():
        with tfft.fast_fp32_matmul():  # a fast call inside a highest one stays IEEE
            assert _precisions() == ("ieee",) * 4
        assert _precisions() == ("ieee",) * 4
    assert _precisions() == CALLER


def test_highest_call_never_sees_tf32_beside_a_fast_call(caller_settings):
    """While a fast call is inside on one thread, a highest call on another
    sees IEEE on every knob; the fast call gets TF32 back when the highest
    call leaves, and the caller's settings come back at the end."""
    fast_inside, highest_done, fast_may_leave = (threading.Event() for _ in range(3))
    seen = {}

    def fast_call():
        with tfft.fast_fp32_matmul():
            seen["fast alone"] = _precisions()
            fast_inside.set()
            highest_done.wait(timeout=30)
            seen["fast after"] = _precisions()
            fast_may_leave.wait(timeout=30)

    t = threading.Thread(target=fast_call)
    t.start()
    try:
        assert fast_inside.wait(timeout=30)
        with tfft.ieee_fp32_matmul():
            seen["highest"] = _precisions()
        highest_done.set()
    finally:
        highest_done.set()
        fast_may_leave.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"fast alone": ("tf32", "ieee", "ieee", "ieee"),
                    "highest": ("ieee",) * 4,
                    "fast after": ("tf32", "ieee", "ieee", "ieee")}
    assert _precisions() == CALLER


def test_precision_override_thread_stress(caller_settings):
    """More threads than cores enter fast and highest calls at random; every
    highest call reads IEEE on every knob, and the caller's settings come
    back once all are done."""
    bad, done = [], []
    interval = sys.getswitchinterval()

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            if rng.random() < 0.5:
                with tfft.ieee_fp32_matmul():
                    if _precisions() != ("ieee",) * 4:
                        bad.append(_precisions())
            else:
                with tfft.fast_fp32_matmul():
                    if _precisions()[1:] != ("ieee",) * 3:
                        bad.append(_precisions())
        done.append(seed)

    threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == 16
    assert bad == []
    assert _precisions() == CALLER
