"""The plan of the single-window kernels ``csrc/lowlat_window.cu``.

The kernels run only on the card; two parts of their plan are checked here:

* ``layout()``, mirrored from the source's constants: for every window
  length the route takes (one layout for both modes) the shared memory
  fits the 227 KB a block may use beside the static scratch, the
  magnitudes and a candidate list that holds every candidate (``H/4 + 2``
  keys, at most 4096) are always in it, and no global workspace is needed;
  up to N = 16384 one block holds the FFT buffers too, from N = 32768 a
  thread-block cluster of 8 CTAs (the cluster kernels) spreads them over
  its CTAs, point i of a buffer in CTA i % 8, and CTA 0 keeps the
  magnitudes, summaries and list over its own shares;
* the cluster kernels' distributed FFT, modelled CTA by CTA on those
  shares: every butterfly, pack point and split pair is taken once at 8 x
  1024 (and 8 x 512) threads, every pass reads only its CTA's share and
  writes outside it only where the kernel places a cluster barrier, and the
  magnitudes are the one-block plan's bits;
* the flexible kernel's finalize: its picks are scanned in rounds of 64,
  then thread 0 walks them in order and stops at the k-th acceptance.  A
  model of that walk, on picks from ``prominence_select`` and scans from
  ``_prominence_and_width``, gives ``prominence_finalize``'s count, idx and
  n_required on random and overflow-shaped rows, at budgets inside and
  past one round.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.ops import fft_cuda, latency_cuda
from apda_fft_tpu_torch.ops import peaks_prominence as tprom
from apda_fft_tpu_torch.utils import kernels
from tests import test_torch_fft_plan as plan

BLOCK_SMEM = 227 * 1024  # bytes of shared memory a block may use on Hopper


def _constant(source: str, name: str) -> int:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        text = f.read()
    expr = re.search(rf"constexpr \w+ {name} = ([0-9 *+\-]+);", text).group(1)
    return int(eval(expr))  # a constant expression of integers from the source


SMEM_CAP = _constant("lowlat_window.cu", "kSmemCap")
SLOTS = _constant("lowlat_window.cu", "kSlots")
MAX_LIST = _constant("walk_common.cuh", "kMaxList")
CLUSTER = _constant("cluster_common.cuh", "kClusterSize")


def padded(l: int) -> int:
    return l + (l >> 4)


def layout(n: int) -> dict:
    """``layout()`` of lowlat_window.cu, the same for both kernels: the
    dynamic shared memory of the block (or of each CTA), the list's room and
    whether the window runs on a cluster; with the parts of the shared memory
    in bytes."""
    h = n // 2
    full = min(h // 4 + 2, MAX_LIST) & ~1
    lists = 8 * ((h + 31) // 32) + 8 * full  # chunk summaries and candidate list
    fft = 16 * padded(h)  # both exchange buffers
    if 4 * h + lists + fft <= SMEM_CAP:
        return {"smem": 4 * h + lists + fft, "list_cap": full, "cluster": False,
                "mags": 4 * h, "lists": lists, "shares": fft}
    shares = 16 * padded(h // CLUSTER)  # this CTA's share of both buffers
    return {"smem": 4 * h + max(shares, lists), "list_cap": full, "cluster": True,
            "mags": 4 * h, "lists": lists, "shares": shares}


LENGTHS = [1 << p for p in range(6, latency_cuda.LOWLAT_MAX_N.bit_length())]
CLUSTER_LENGTHS = [n for n in LENGTHS if n >= latency_cuda.CLUSTER_MIN_N]


def test_lengths_cover_the_route():
    assert LENGTHS[0] == 64 and LENGTHS[-1] == latency_cuda.LOWLAT_MAX_N == 65536
    assert CLUSTER_LENGTHS == [32768, 65536]
    assert CLUSTER == latency_cuda.CLUSTER_SIZE == 8


def _static_scratch_bytes(kernel: str) -> int:
    """Bytes of the kernel's static shared arrays: the reduction scratch of
    32 warps (4 + 4 + 8 + 8 bytes a warp) and its ``__shared__`` arrays and
    scalars, read from the source."""
    with open(os.path.join(kernels.CSRC_DIR, "lowlat_window.cu")) as f:
        text = f.read()
    body = text[text.index(f"\n{kernel}("):]
    body = body[:body.index("const int tid")]
    sizes = {"kSlots": SLOTS, "kAccepted": _constant("lowlat_window.cu", "kAccepted")}
    total = 32 * (4 + 4 + 8 + 8)
    for decl in re.findall(r"__shared__ (?:int|float) ([^;]+);", body):
        for name in decl.split(","):
            m = re.search(r"\[(\w+)\]", name)
            total += 4 * (sizes[m.group(1)] if m else 1)
    return total


@pytest.mark.parametrize("rigid", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_shared_part_fits_and_holds_the_magnitudes(n, rigid):
    lay = layout(n)
    # The static scratch (reductions, pick slots) stays inside the 2 KB kept.
    assert SMEM_CAP == BLOCK_SMEM - 2048
    mode = "rigid" if rigid else "flexible"
    kernel = f"lowlat_{mode}{'_cluster' if lay['cluster'] else ''}_kernel"
    assert latency_cuda.kernel_name(mode, n) + "_kernel" == kernel
    assert _static_scratch_bytes(kernel) <= 2048
    assert lay["smem"] + 2048 <= BLOCK_SMEM
    h = n // 2
    assert lay["list_cap"] == min(h // 4 + 2, MAX_LIST) & ~1  # every candidate fits
    # One block holds the FFT buffers up to N = 16384; no length of the
    # route needs a global workspace: from 32768 the buffers are spread
    # over a cluster's CTAs.
    assert lay["cluster"] == (n >= latency_cuda.CLUSTER_MIN_N) == (n > 16384)
    assert lay["smem"] == lay["mags"] + (max(lay["shares"], lay["lists"]) if lay["cluster"]
                                         else lay["lists"] + lay["shares"])
    # The rigid kernel keeps its unwiped magnitudes in the free FFT buffer:
    # one block's, or the shares of CTAs 1-4 (h/4 floats each).
    if lay["cluster"]:
        assert lay["shares"] // 2 >= 4 * (h // 4) and 1 + (h - 1) // (h // 4) < CLUSTER
    else:
        assert 2 * (h + (h >> 4)) >= h


def test_one_kernel_per_route_and_no_workspace():
    """Each window length has one kernel per mode (the cluster kernels from
    CLUSTER_MIN_N), and the launch takes no workspace: the wrapper
    allocates only the outputs."""
    with open(os.path.join(kernels.CSRC_DIR, "lowlat_window.cu")) as f:
        text = f.read()
    for mode in ("flexible", "rigid"):
        assert f"lowlat_{mode}_kernel(" in text and f"lowlat_{mode}_cluster_kernel(" in text
    launch = text[text.index("int apda_lowlat_window("):]
    assert "ws" not in launch[:launch.index(")")] and "workspace_floats" not in text
    assert "ws_floats" not in inspect.getsource(latency_cuda)


@pytest.mark.parametrize("rigid", [False, True])
@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_layout(n, rigid):
    """Every CTA of a cluster within 227 KB with its static scratch; CTA 0
    holding the magnitudes, summaries, the whole list and its shares (the
    summaries and list over its shares once the split is done); the shares
    covering both padded buffers exactly once; the cluster a function of N."""
    lay = layout(n)
    h = n // 2
    mode = "rigid" if rigid else "flexible"
    assert lay["cluster"] and latency_cuda.kernel_name(mode, n) == f"lowlat_{mode}_cluster"
    assert lay["smem"] + _static_scratch_bytes(f"lowlat_{mode}_cluster_kernel") <= BLOCK_SMEM
    # CTA 0: magnitudes first, then its shares, later overlaid by the
    # summaries and the full list.
    assert lay["mags"] == 4 * h and lay["list_cap"] == MAX_LIST
    assert lay["mags"] + lay["shares"] <= lay["smem"] and lay["mags"] + lay["lists"] <= lay["smem"]
    # Point i of a buffer: CTA i % 8, slot pad(i // 8) of a share of
    # padded(h / 8) points; each buffer's h points land on distinct places.
    i = np.arange(h)
    places = (i % CLUSTER) * padded(h // CLUSTER) + (i // CLUSTER) + (i // CLUSTER >> 4)
    assert len(set(places.tolist())) == h
    assert ((i // CLUSTER) + (i // CLUSTER >> 4)).max() < padded(h // CLUSTER)
    assert lay["shares"] == 2 * 8 * padded(h // CLUSTER)  # both buffers, float2
    assert CLUSTER * lay["shares"] >= 2 * 8 * padded(h)


def _passes(l: int) -> list[tuple[int, int]]:
    """(radix, ns) of each Stockham pass of ``fft_passes`` over l points."""
    rem = (l.bit_length() - 1) % 3
    out, ns = ([(1 << rem, 1)], 1 << rem) if rem else ([], 1)
    while ns < l:
        out.append((8, ns))
        ns *= 8
    return out


def _loop(first: int, stride: int, end: int) -> list[int]:
    return list(range(first, end, stride)) if first < end else []


@pytest.mark.parametrize("threads", [1024, 512])
@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_work_is_taken_once(n, threads):
    """The cluster kernels' loops at 8 CTAs of ``threads``: CTA r, thread t
    takes butterflies r + 8t, + 8*threads, ...; pack points and split pairs
    from r*threads + t in strides of 8*threads; each once."""
    l = n // 2
    for radix, ns in _passes(l):
        nb = l // radix
        taken = [b for r in range(CLUSTER) for t in range(threads)
                 for b in _loop(r + CLUSTER * t, CLUSTER * threads, nb)]
        assert sorted(taken) == list(range(nb)), (radix, ns)
    stride = CLUSTER * threads
    firsts = [r * threads + t for r in range(CLUSTER) for t in range(threads)]
    # The pack: float4 q0, q0 + stride, ... four a round (two points each).
    packed = [q0 + u * stride for f in firsts for q0 in _loop(f, 4 * stride, l // 2)
              for u in range(4) if q0 + u * stride < l // 2]
    assert sorted(packed) == list(range(l // 2))
    split = [k for f in firsts for k in _loop(f, stride, l // 2 + 1)]
    assert sorted(split) == list(range(l // 2 + 1))


def _cluster_plan(x: np.ndarray, table: np.ndarray) -> tuple[np.ndarray, list[str]]:
    """The cluster kernels' FFT on one window, CTA by CTA on the shares of
    the two buffers (``[8, padded(l/8)]`` complex64 each): the pack through
    the spread map, each pass's butterflies of CTA r read from its own share
    (asserted) and written through the map, then the split.  Returns the
    magnitudes and the barrier each pass needs (``cluster`` where a pass's
    writes or the next pass's leave a CTA, or the split follows)."""
    n = x.shape[0]
    l = n // 2
    t = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
    share = padded(l // CLUSTER)

    def place(i):
        return i % CLUSTER, (i // CLUSTER) + ((i // CLUSTER) >> 4)

    mean = np.float32(np.float32(x.astype(np.float32).sum(dtype=np.float32)) / np.float32(n))
    xc = (x - mean).astype(np.float32)
    a = np.zeros((CLUSTER, share), np.complex64)
    c = np.zeros_like(a)
    i = np.arange(l)
    a[place(i)] = (xc[0::2] + 1j * xc[1::2]).astype(np.complex64)
    barriers, remote = [], []
    ns = 1
    for radix, ns in _passes(l):
        nb = l // radix
        step = 2 * l // (ns * radix)
        written = np.zeros((CLUSTER, share), int)
        out_of_cta = False
        for r in range(CLUSTER):
            b = np.arange(r, nb, CLUSTER)
            k = b & (ns - 1)
            idx = [b + q * nb for q in range(radix)]
            assert all((j % CLUSTER == r).all() for j in idx)  # reads: own share
            v = [a[r, place(j)[1]] for j in idx]
            if ns > 1:
                v = [v[0]] + [v[q] * plan._twiddle(t, q * k * step, l) for q in range(1, radix)]
            v = plan._dft([vi.astype(np.complex64) for vi in v])
            d = (b - k) * radix + k
            for q in range(radix):
                dst = place(d + q * ns)
                out_of_cta |= bool((dst[0] != r).any())
                c[dst] = v[q]
                np.add.at(written, dst, 1)
        assert written[place(i)].min() == 1 and written.sum() == l  # each point once
        remote.append(out_of_cta)
        assert out_of_cta == (ns < 8)  # the kernel's Own / Spread choice
        a, c = c, a
    for p, rem in enumerate(remote):
        barriers.append("cluster" if rem or p + 1 == len(remote) or
                        (p + 1 < len(remote) and remote[p + 1]) else "block")
    z = a[place(i)]
    k = np.arange(1, l // 2 + 1)
    za, zb = z[k], z[l - k]
    half = np.float32(0.5)
    er, ei = half * (za.real + zb.real), half * (za.imag - zb.imag)
    orr, oi = half * (za.real - zb.real), half * (za.imag + zb.imag)
    w = t[k]
    pr = w.real * orr - w.imag * oi
    pi = w.real * oi + w.imag * orr
    out = np.zeros(l, np.float32)
    out[l - k] = np.sqrt((er - pi) ** 2 + (ei + pr) ** 2)
    out[k] = np.sqrt((er + pi) ** 2 + (ei - pr) ** 2)
    return out, barriers


@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_fft_is_the_one_block_plan(n):
    """The distributed FFT gives the one-block plan's bits (the same
    butterflies, twiddles and operations, only their places differ), and
    its barriers are the kernel's: cluster-wide after the first pass or two
    and the last, block-wide between."""
    rng = np.random.default_rng(n)
    x = (np.sin(2 * np.pi * 12.5 * np.arange(n) / 500.0) + 0.3 * rng.standard_normal(n)
         + 2.0).astype(np.float32)
    table = fft_cuda._twiddle_table(n).numpy()
    got, barriers = _cluster_plan(x, table)
    mean = np.float32(np.float32(x.sum(dtype=np.float32)) / np.float32(n))
    want = plan.kernel_plan(x[None], table, mean=np.full((1, 1), mean, np.float32))[0]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    first_local = 1 if n // 2 == 32768 else 2  # radix-8 from ns = 1, or radix 4 then ns = 4
    assert barriers == ["cluster"] * first_local + ["block"] * (4 - first_local) + ["cluster"]


def kernel_finalize(cid, cmag, prom, bins, fs, n_fft, k, std, n_cand, m):
    """The flexible kernel's finalize for one window: rounds of SLOTS picks,
    walked in order by one thread, stopping at the k-th acceptance, in the
    kernel's float32 operations."""
    f32 = np.float32
    ds = f32(f32(fs) / f32(n_fft))
    half_sd = f32(f32(0.5) * f32(std))

    def round_dec(v, scale):
        return f32(f32(np.rint(f32(v * scale))) / scale)

    live = min(n_cand, m)
    count, consumed, idx, freqs = 0, 0, [], []
    for lo in range(0, live, SLOTS):
        for r in range(lo, min(live, lo + SLOTS)):
            if count >= k:
                break
            consumed += 1
            j, b = int(cid[r]), int(bins[r])
            width = f32(f32(b) * ds)
            fn = f32(f32(j) * ds)
            q = f32(fn / width)
            valid = prom[r] > half_sd and width > 0 and 500 * b >= j and 50 * b <= 7 * j
            freq_r = round_dec(fn, f32(1e4))
            mag_r = round_dec(cmag[r], f32(1e4))
            ratio = f32(prom[r] / mag_r) if mag_r > 0 else f32(0)
            near = any(f32(abs(f32(freq_r - f2)) / (f2 if f2 != 0 else f32(1))) < f32(0.05)
                       for f2 in freqs)
            if valid and not (near and ratio < f32(0.10)):
                idx.append(j)
                freqs.append(freq_r)
                count += 1
        if count >= k:
            break
    return count, idx, consumed if count >= k else n_cand


def _rows(kind: str, h: int, seed: int) -> np.ndarray:
    """Noise, modal (a few damped-mode bumps on low noise), or overflow-shaped
    rows: one-bin spikes above bin 1000, which all fail the damping floor, so
    the walk never completes."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "noise":
        x = rng.random((6, h)) * 5.0
    elif kind == "modal":
        x = 0.2 * rng.random((6, h))
        for row in x:
            for c in rng.uniform(20, h - 20, 6):
                row += rng.uniform(2, 30) * np.exp(-0.5 * ((bins - c) / rng.uniform(1, 8)) ** 2)
    else:
        x = 0.05 * rng.random((6, h))
        for row in x:
            spikes = np.arange(1001, 1001 + 3 * rng.integers(70, 100), 3)
            row[spikes] = rng.uniform(3.0, 5.0, spikes.size)
    x[:, 0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("m", [2, 8, 64, 128])
@pytest.mark.parametrize("kind", ["noise", "modal", "overflow"])
def test_ordered_finalize_equals_prominence_finalize(kind, m):
    h, n_fft, fs, k = 2048, 4096, 500.0, 4
    mags = torch.from_numpy(_rows(kind, h, seed=m + len(kind)))
    cid, is_cand, cmag, _, std, n_cand = tprom.prominence_select(mags, m)
    prom, bins = tprom._prominence_and_width(mags, cid, cmag)
    want = tprom.prominence_finalize(cid, is_cand, cmag, prom, bins, fs, n_fft, k, std, n_cand)
    for r in range(mags.shape[0]):
        count, idx, n_required = kernel_finalize(
            cid[r].numpy(), cmag[r].numpy(), prom[r].numpy(), bins[r].numpy(), fs, n_fft, k,
            std[r].numpy(), int(n_cand[r]), m)
        assert count == int(want.count[r]), (r, count)
        assert idx == want.idx[r, :count].tolist(), r
        assert n_required == int(want.n_required[r]), (r, n_required)
    if kind == "overflow":
        assert (want.count < k).all() and (want.n_required == n_cand).all()
        assert int(n_cand.min()) > 64  # past one round of picks
