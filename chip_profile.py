"""Where an epoch's time goes on one NVIDIA GPU, and two host-side probes.

    python3 chip_profile.py            # items 1-3 below, ~2 min on an H100
    python3 chip_profile.py --skip-cpu-probe
    python3 chip_profile.py --cpu-probe     # item 3 only, ~1 min
    python3 chip_profile.py --block-sizes   # item 4 only
    python3 chip_profile.py --sass OTHER_TREE   # item 5 only
    python3 chip_profile.py --paths         # item 6 only, ~1 min
    python3 chip_profile.py --fast-modes    # item 7 only, ~1 min
    python3 chip_profile.py --threshold-order   # item 8 only, ~30 s
    python3 chip_profile.py --lowlat-against OTHER_TREE   # item 9 only, ~1 min
    python3 chip_profile.py --span-cost     # item 10 only, ~10 s

1. profile: flexible ``analyze_epoch`` (refine, lowlat="never") on the
   B=2048 x N=4096 clean and noisy corpora of ``chip_smoke.py``, after two
   epochs that learn the budget: host wall per epoch (mean of 20
   unprofiled epochs, synchronized), then ``torch.profiler`` over 3
   epochs for the device's busy time, kernels per epoch, the idle share
   (1 - busy / wall) and the top kernels;
2. finalize forms: ``prominence_finalize`` in its unrolled and its
   slot-wise form (forced through ``_UNROLL_MAX``) on the select+scan
   kernel's outputs for the noisy spectra at M in {2, 4, 8, 12, 128}:
   both must give the same result; CUDA-event median of 20, A-B-B-A;
3. CPU probe: the port's CPU ``analyze_epoch`` on 256 clean windows, and
   its four-step without the one-thread guard of ``ops/fft.py``, each at
   the default intra-op thread count against one thread, repeated in this
   process and in fresh processes that first run an epoch on the card
   (the setting in which ``chip_smoke.py``'s CPU reference once went
   wrong); a last child runs the unguarded four-step with oneDNN's and MKL's
   verbose logs on and reports which GEMM paths it took;
4. block sizes: the profiler's device time of the single-window kernels
   at 256, 512 and 1024 threads a block or CTA (pinned in
   ``latency_cuda._THREADS``) on two-tone windows at N=1024 (cfg1's), 4096
   (cfg2's), 16384, and 32768 and 65536 (the cluster kernels),
   and of the flexible one also on the 71-candidate window at M=64; and of
   the scans kernel at 128 and 256
   threads (``detector_cuda._SCANS_THREADS``) on the noisy spectra at M in
   {12, 32, 128}; each order is mirrored (A-B-B-A) and every size gives the
   same decisions.
5. compiled code: every ``apda_fft_tpu_torch/csrc/*.cu`` of this tree and of
   another checkout (``--sass OTHER_TREE``, e.g. a ``git archive`` of the
   parent commit) built to SASS with the kernels' own nvcc flags; per
   kernel, its registers and spills (ptxas) and whether its SASS is the
   same, with addresses, encodings and namespace hashes left out.
6. gateway paths: item 1's profile of ``analyze_records`` (one gateway
   epoch of 1537 records, flexible, refine), ``analyze_records_welch``
   (1536 records, window 1024, both front ends) and ``analyze_stream``
   (BASELINE cfg4 at hop 4096, both front ends), at ``chip_smoke.py``
   phases 14-16's sizes, inputs from host memory.
7. fast front end: the two candidates for ``precision="fast"`` against
   ``"highest"`` on the clean and noisy B=2048 x N=4096 corpora (centred):
   the four-step's products in one TF32 pass (the knob
   ``fast_fp32_matmul`` sets) and in a three-pass split TF32 (each operand
   cut into a TF32 head and an IEEE tail, ``hi*hi + hi*lo + lo*hi``, the
   counterpart of the TPU's three bf16 passes); normwise error of the
   magnitudes against float64 ``numpy.fft`` and CUDA-event medians of 20,
   in the order highest, single, split, split, single, highest.
8. threshold order (``chip_smoke.py`` phase 26): the select+scan kernel
   against its plain twin on the clean and noisy corpora's magnitudes at
   both precisions, each scaled by 1, 1.001, ..., 1.004 times a factor
   drawn at run time (20 batches of 2048 rows, M=32): the rows whose std
   (which sets the noise threshold) differs in any bit, and the rows whose
   candidate count differs; the check fails unless both are 0.

9. single-window kernels against another checkout's (``--lowlat-against
   OTHER_TREE``, e.g. a ``git archive`` of the parent commit): every call of
   ``chip_smoke.py`` phase 7 (both modes, N 64..65536, its budgets and its
   overflow windows) and 16 windows drawn at run time (modal and noise,
   N=32768 and 65536) through this tree's ``analyze_window_lowlat`` and
   through the other tree's, built from its own sources in a child process;
   reports the outputs (call x field) that differ in any bit, per kernel,
   and fails unless there are none; then times both trees' kernels on
   two-tone windows at N in {4096, 32768, 65536} (profiler device time,
   CUDA-event call, routed ``analyze_epoch`` host wall), each tree in a
   fresh process, in the order other, this, this, other.
10. span cost: the host time of one ``utils.profiling.span`` entered and
   left with no profiler running, of one bare
   ``torch.profiler.record_function`` likewise, and of one span under a
   running ``torch.profiler`` (host and CUDA activity); best of three
   loops of 50,000 (5,000 under the profiler).

Every line carries the card's name and power limit.  Exit code 0 unless a
check fails; the probe's mismatches are reported, not raised.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke
from apda_fft_tpu_torch.models import batching, pipeline, streaming
from apda_fft_tpu_torch.ops import detector_cuda, latency_cuda, peaks_prominence
from apda_fft_tpu_torch.ops import fft as fft_ops
from apda_fft_tpu_torch.utils import kernels

FS, N_FFT, BATCH = chip_smoke.FS, chip_smoke.N_FFT, chip_smoke.BATCH
log = chip_smoke.log


def epoch(xs: torch.Tensor):
    return pipeline.analyze_epoch(
        xs, FS, n_fft=N_FFT, mode="flexible", refine=True, lowlat="never")


def profile_call(label: str, fn, card: str, walls: int = 20, runs: int = 3) -> None:
    """Host wall per call of ``fn`` (mean of ``walls`` unprofiled calls,
    synchronized, after two warm-up calls), then ``torch.profiler`` over
    ``runs`` calls: device busy time, kernels per call, idle share (1 -
    busy / wall) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(walls):
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / walls * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    per_kernel = collections.defaultdict(float)
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per_kernel[evt.name] += evt.device_time / 1e3 / runs
            n_kernels += 1
    busy_ms = sum(per_kernel.values())
    log(f"[profile] {label}: host wall {wall_ms:.4f} ms/call (mean of {walls}, unprofiled); "
        f"device busy {busy_ms:.4f} ms/call over {n_kernels // runs} kernels "
        f"(profiled) = idle share {1 - busy_ms / wall_ms:.3f}; {card}")
    for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:.4f} ms  {kname[:100]}")


def profile(corpora: dict[str, np.ndarray], card: str) -> None:
    pipeline.reset_dynamic_state()
    for name, x in corpora.items():
        xs = torch.from_numpy(x).cuda()
        profile_call(f"{name} epoch", lambda: epoch(xs), card)
        log(f"[profile] {name}: stats {pipeline.last_dynamic_stats()}")


def profile_paths(card: str) -> None:
    """The gateway paths of ``chip_smoke.py`` phases 14-16 at their sizes,
    inputs from host memory and results back to it, as a gateway calls
    them."""
    signals = chip_smoke._load_module("apda_signals", "signals.py")
    recs = chip_smoke.gateway_records(signals)
    welch = chip_smoke.gateway_welch_records()
    stream = chip_smoke.stream_records(signals)
    pipeline.reset_dynamic_state()
    pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(mode="flexible", refine=True))
    profile_call(f"analyze_records flexible refine, {len(recs)} records",
                 lambda: batching.analyze_records(recs, analyze=pipe), card, walls=5)
    for backend in ("matmul", "pallas"):
        wp = pipeline.SpectralPipeline(pipeline.PipelineConfig(refine=True, backend=backend))
        profile_call(f"analyze_records_welch {backend}, {len(welch)} records",
                     lambda: batching.analyze_records_welch(
                         welch, window=chip_smoke.WELCH_WINDOW, analyze=wp.welch), card, walls=5)
    for backend in ("matmul", "pallas"):
        profile_call(f"analyze_stream cfg4 hop 4096 {backend}, 1984 windows",
                     lambda: streaming.analyze_stream(
                         stream, FS, chip_smoke.STREAM_WINDOW, chip_smoke.STREAM_WINDOW // 2,
                         refine=True, backend=backend), card, walls=5)
    pipeline.reset_dynamic_state()


def finalize_forms(noisy: np.ndarray, card: str) -> None:
    mags = chip_smoke.centered_mags(torch.from_numpy(noisy).cuda()).contiguous()
    forms = {"unrolled": 10**9, "slot-wise": 0}
    for m in (2, 4, 8, 12, 128):
        args = detector_cuda.prominence_select_scan(mags, m)
        cid, is_cand, cmag, proms, bins, std, n_cand = args

        def run(form):
            peaks_prominence._UNROLL_MAX = forms[form]
            return peaks_prominence.prominence_finalize(
                cid, is_cand, cmag, proms, bins, FS, N_FFT, 4, std, n_cand)

        saved = peaks_prominence._UNROLL_MAX
        try:
            a, b = run("unrolled"), run("slot-wise")
            for fa, fb, fname in zip(a, b, a._fields):
                assert torch.equal(fa, fb), (m, fname)
            times = collections.defaultdict(list)
            for form in ("unrolled", "slot-wise", "slot-wise", "unrolled"):
                times[form].append(chip_smoke.event_ms(lambda: run(form)))
        finally:
            peaks_prominence._UNROLL_MAX = saved
        log(f"[finalize] B={BATCH} M={m} k=4: unrolled "
            f"{' / '.join(f'{t:.4f}' for t in times['unrolled'])} ms, slot-wise "
            f"{' / '.join(f'{t:.4f}' for t in times['slot-wise'])} ms (same result; "
            f"CUDA-event median of {chip_smoke.TIMING_RUNS}, A-B-B-A; {card})")


def rows_off(many: torch.Tensor, one: torch.Tensor) -> str:
    """The rows of ``many`` more than 1e-6 relative off ``one``'s."""
    rel = ((many - one).abs().amax(-1) / one.abs().amax(-1)).numpy()
    bad = np.flatnonzero(rel > 1e-6)
    if bad.size == 0:
        return "equal"
    return f"{bad.size} rows off (rows {bad.min()}..{bad.max()}, max rel {rel.max():.3g})"


def cpu_mismatch(x: np.ndarray) -> tuple[str, str]:
    """The port's CPU epoch (its transform on one thread,
    ``ops.fft._one_cpu_thread``) and the four-step without that guard, each
    at the default thread count against one thread: the rows off, each."""
    xc = torch.from_numpy(x)
    centred = xc - xc.mean(dim=-1, keepdim=True)

    def run():
        epoch_mag = pipeline.analyze_epoch(xc, FS, n_fft=N_FFT, mode="flexible",
                                           max_candidates=2).mag
        with fft_ops.ieee_fp32_matmul():
            raw = fft_ops._fourstep_magnitudes(centred, N_FFT // 2)
        return epoch_mag, raw

    many = run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run()
    finally:
        torch.set_num_threads(threads)
    return rows_off(many[0], one[0]), rows_off(many[1], one[1])


def cpu_probe(corpora: dict[str, np.ndarray], card: str) -> None:
    x = corpora["clean"][:256]
    log(f"[cpu probe] {host_identity()}")
    log(f"[cpu probe] {torch.get_num_threads()} threads, cpu capability "
        f"{torch.backends.cpu.get_cpu_capability()}, mkldnn matmul fp32_precision "
        f"{torch.backends.mkldnn.matmul.fp32_precision!r}, float32_matmul_precision "
        f"{torch.get_float32_matmul_precision()!r}")
    xs = torch.from_numpy(corpora["clean"]).cuda()
    found = []
    for _ in range(20):
        epoch(xs)
        torch.cuda.synchronize()
        found.append(cpu_mismatch(x))
    children = []
    for _ in range(6):
        out = subprocess.run([sys.executable, __file__, "--cpu-probe-child"],
                             capture_output=True, text=True, check=True, timeout=300)
        children.append(tuple(out.stdout.strip().splitlines()[-1].split(" | ")))
    for where, runs in (("in process, 20 runs after a card epoch each", found),
                        ("fresh processes, first CPU epoch after a card epoch", children)):
        for i, part in enumerate(("port's epoch", "unguarded four-step")):
            off = [r[i] for r in runs if r[i] != "equal"]
            log(f"[cpu probe] {where}: {part} {len(off)} of {len(runs)} off {off}")
    env = dict(os.environ, ONEDNN_VERBOSE="1", MKL_VERBOSE="1")
    out = subprocess.run([sys.executable, __file__, "--cpu-gemm-child"], env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    lines = out.stdout.splitlines()
    onednn = [ln for ln in lines if ln.startswith("onednn_verbose") and ",exec," in ln]
    mkl = [ln for ln in lines if ln.startswith("MKL_VERBOSE")]
    log(f"[cpu probe] unguarded four-step at {torch.get_num_threads()} threads: "
        f"{len(onednn)} oneDNN "
        f"primitives, {len(mkl)} MKL calls; {card}")
    for ln in (onednn[:3] + mkl[:3]):
        log(f"[cpu probe]   {ln[:200]}")


def host_identity() -> str:
    """The host's name, CPU model and microcode, and the card's UUID."""
    cpu = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            cpu.setdefault(key.strip(), value.strip())
    uuid = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    return (f"host {os.uname().nodename}, {cpu.get('model name')}, microcode "
            f"{cpu.get('microcode')}, card {uuid}")


def block_sizes(noisy: np.ndarray, card: str) -> None:
    fs = torch.tensor(FS, device="cuda")
    two_tone = chip_smoke.clean_batch
    windows = (("flexible", "two-tone N=1024 budget 2", two_tone(1, 1024)[0], 2),
               ("flexible", "cfg2 N=4096 budget 2", two_tone(1, 4096)[0], 2),
               ("flexible", "71-candidate window N=4096 M=64", chip_smoke.overflow_window(), 64),
               ("flexible", "two-tone N=16384 budget 2", two_tone(1, 16384)[0], 2),
               ("flexible", "two-tone N=32768 budget 2", two_tone(1, 32768)[0], 2),
               ("flexible", "two-tone N=65536 budget 2", two_tone(1, 65536)[0], 2),
               ("rigid", "cfg1 N=1024", two_tone(1, 1024)[0], 2),
               ("rigid", "two-tone N=4096", two_tone(1, 4096)[0], 2),
               ("rigid", "two-tone N=16384", two_tone(1, 16384)[0], 2),
               ("rigid", "two-tone N=32768", two_tone(1, 32768)[0], 2),
               ("rigid", "two-tone N=65536", two_tone(1, 65536)[0], 2))
    saved = dict(latency_cuda._THREADS)
    try:
        for mode, label, xn, m in windows:
            x = torch.from_numpy(xn).cuda()
            name = latency_cuda.kernel_name(mode, xn.shape[0])

            def run():
                return latency_cuda.analyze_window_lowlat(x, fs, mode=mode, max_candidates=m,
                                                          refine=True)

            times = collections.defaultdict(list)
            decisions = set()
            for threads in (1024, 512, 256, 256, 512, 1024):
                latency_cuda._THREADS[mode] = threads
                res = run()
                decisions.add(tuple(torch.cat([res.idx[0], res.count, res.n_candidates,
                                               res.n_required]).tolist()))
                times[threads].append(chip_smoke._kernel_device_ms(run, f"{name}_kernel"))
            assert len(decisions) == 1, (label, decisions)
            log(f"[block sizes] {name} {label}: device ms " + "; ".join(
                f"{t} threads {' / '.join(f'{v:.4f}' for v in times[t])}" for t in sorted(times))
                + f" (profiler, mean of 20; same decisions; {card})")
    finally:
        latency_cuda._THREADS.update(saved)
    mags = chip_smoke.centered_mags(torch.from_numpy(noisy).cuda()).contiguous()
    saved = detector_cuda._SCANS_THREADS
    try:
        for m in (12, 32, 128):
            cid, is_cand, cmag, _, _, _ = peaks_prominence.prominence_select(mags, m)
            n_valid = is_cand.sum(dim=-1).to(torch.int32)

            def run():
                return detector_cuda.prominence_scans(mags, cid, cmag, n_valid)

            times = collections.defaultdict(list)
            outs = []
            for threads in (128, 256, 256, 128):
                detector_cuda._SCANS_THREADS = threads
                outs.append(run())
                times[threads].append(chip_smoke._kernel_device_ms(
                    run, "preselected_scans_kernel"))
            assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0])), m
            log(f"[block sizes] prominence_scans B={BATCH} M={m}: device ms " + "; ".join(
                f"{t} threads {' / '.join(f'{v:.4f}' for v in times[t])}" for t in sorted(times))
                + f" (profiler, mean of 20; same bits; {card})")
    finally:
        detector_cuda._SCANS_THREADS = saved


def _sass(tree: str, name: str, out_dir: str) -> tuple[dict[str, list[str]], dict[str, str]]:
    """{kernel: normalized SASS lines} and {kernel: ptxas usage} of
    ``<tree>/apda_fft_tpu_torch/csrc/<name>.cu``."""
    csrc = os.path.join(tree, "apda_fft_tpu_torch", "csrc")
    cubin = os.path.join(out_dir, f"{abs(hash(tree))}_{name}.cubin")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([kernels.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-I", csrc,
                           "-o", cubin, os.path.join(csrc, name + ".cu")],
                          capture_output=True, text=True, check=True, timeout=600)
    usage, current = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            current = _anon(m.group(1))
        elif current and ("registers" in line or "spill" in line):
            usage[current] = (usage.get(current, "") + " " + line.split(":", 1)[-1].strip()).strip()
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = _anon(m.group(1))
            funcs[current] = []
            continue
        line = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
        line = " ".join(_anon(line).split())
        if current and line and not line.startswith("/* 0x"):
            funcs[current].append(line)
    return funcs, usage


def _anon(text: str) -> str:
    """Mangled names with the anonymous namespace's per-file hash left out."""
    return re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", text)


def sass_compare(other: str, card: str) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out_dir:
        for src in sorted(glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu"))):
            name = os.path.basename(src)[:-3]
            mine, mine_use = _sass(here, name, out_dir)
            theirs, their_use = ({}, {}) if not os.path.exists(
                os.path.join(other, "apda_fft_tpu_torch", "csrc", name + ".cu")) else _sass(
                    other, name, out_dir)
            for kernel in sorted(set(mine) | set(theirs)):
                if kernel not in theirs:
                    verdict = f"new ({len(mine[kernel])} SASS lines)"
                elif kernel not in mine:
                    verdict = "gone"
                elif mine[kernel] == theirs[kernel]:
                    verdict = f"same SASS ({len(mine[kernel])} lines)"
                else:
                    verdict = (f"SASS differs ({len(theirs[kernel])} -> {len(mine[kernel])} "
                               f"lines)")
                log(f"[sass] {name}.cu {kernel}: {verdict}; ptxas here: "
                    f"{mine_use.get(kernel, '-')}; there: {their_use.get(kernel, '-')}")
    log(f"[sass] this tree against {other}; {card}")


def _split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as a TF32-exact head (10 mantissa bits kept) and its tail."""
    hi = (t.view(torch.int32) & -8192).view(torch.float32)
    return hi, t - hi


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def _split_fourstep_magnitudes(x: torch.Tensor) -> torch.Tensor:
    """``fft_ops._fourstep_magnitudes`` with every product in three TF32 passes."""
    n = x.shape[-1]
    n_out = n // 2
    n1, n2 = fft_ops.split_lanes(n)
    k1_out = n_out // n2
    cs2, tc, ts, c1s1 = fft_ops._fourstep_tables(n, n_out, x.dtype, x.device)
    b = _split_matmul(cs2, x.reshape(*x.shape[:-1], n2, n1))
    br, bi = b[..., :n2, :], b[..., n2:, :]
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    p = _split_matmul(cr, c1s1)
    q = _split_matmul(ci, c1s1)
    dr, di = p[..., :k1_out] - q[..., k1_out:], p[..., k1_out:] + q[..., :k1_out]
    mags = torch.sqrt(dr**2 + di**2).transpose(-1, -2).reshape(*x.shape[:-1], n_out)
    mags[..., 0] = 0
    return mags


def fast_modes(corpora: dict[str, np.ndarray], card: str) -> None:
    for name, x in corpora.items():
        xc = x - x.mean(axis=-1, keepdims=True)
        ref = np.abs(np.fft.rfft(xc.astype(np.float64))[:, :N_FFT // 2])
        ref[:, 0] = 0
        xt = torch.from_numpy(xc).cuda()

        def single():
            return fft_ops.halfspec_magnitudes(xt, backend="matmul", precision="fast")

        def split():
            with fft_ops.fast_fp32_matmul():
                return _split_fourstep_magnitudes(xt)

        modes = {
            "highest": lambda: fft_ops.halfspec_magnitudes(xt, backend="matmul"),
            "tf32 single pass": single,
            "tf32 split, 3 passes": split,
        }
        times = collections.defaultdict(list)
        for mode in ("highest", "tf32 single pass", "tf32 split, 3 passes",
                     "tf32 split, 3 passes", "tf32 single pass", "highest"):
            times[mode].append(chip_smoke.event_ms(modes[mode]))
        for mode, fn in modes.items():
            got = fn().cpu().numpy().astype(np.float64)
            err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
            log(f"[fast] {name}: {mode}: normwise error {err:.3e} vs float64 numpy.fft; "
                f"{' / '.join(f'{t:.4f}' for t in times[mode])} ms (CUDA events, median "
                f"of 20); {card}")


def threshold_order(corpora: dict[str, np.ndarray], card: str) -> None:
    """Item 8: ``chip_smoke.py`` phase 26, which asserts 0 rows apart."""
    chip_smoke.phase_threshold_order(corpora, card)


#: Runs in the other tree (its package first on the path): the windows of
#: argv[1] through its ``analyze_window_lowlat`` on the card, outputs to argv[2].
_LOWLAT_CHILD = """
import json, sys
import numpy as np, torch
from apda_fft_tpu_torch.ops import latency_cuda
data = np.load(sys.argv[1])
calls = json.loads(str(data["calls"]))
out = {}
fs = torch.tensor(500.0, device="cuda")
for i, kw in enumerate(calls):
    res = latency_cuda.analyze_window_lowlat(torch.from_numpy(data[f"x{i}"]).cuda(), fs, **kw)
    for f in res._fields:
        out[f"{i}.{f}"] = getattr(res, f).cpu().numpy()
np.savez(sys.argv[2], **out)
"""


#: Runs in either tree: times its single-window kernels on two-tone windows
#: (its own ``chip_smoke`` helpers), one JSON line.
_LOWLAT_TIMES_CHILD = """
import json
import torch
import chip_smoke as c
from apda_fft_tpu_torch.models import pipeline
from apda_fft_tpu_torch.ops import latency_cuda
fs = torch.tensor(c.FS, device="cuda")
out = {}
for n in (4096, 32768, 65536):
    x = torch.from_numpy(c.clean_batch(1, n)[0]).cuda()
    for mode in ("flexible", "rigid"):
        def kernel():
            return latency_cuda.analyze_window_lowlat(x, fs, mode=mode, max_candidates=2,
                                                      refine=True)
        kernel()
        dev = c._kernel_device_ms(kernel, f"lowlat_{mode}")
        call = c.event_ms(kernel)
        pipeline.reset_dynamic_state()
        routed = c._wall_ms(lambda: pipeline.analyze_epoch(x[None], c.FS, mode=mode,
                                                           refine=True), runs=20)
        out[f"{mode} N={n}"] = [dev, call, routed]
print(json.dumps(out))
"""


def _tree_times(tree: str) -> dict[str, list[float]]:
    proc = subprocess.run([sys.executable, "-c", _LOWLAT_TIMES_CHILD], cwd=tree,
                          env={**os.environ, "PYTHONPATH": os.path.abspath(tree)},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def lowlat_calls() -> list[tuple[str, np.ndarray, dict]]:
    """Phase 7's calls of ``analyze_window_lowlat`` and 16 windows drawn at
    run time: (label, window, keyword arguments)."""
    calls = []
    for n in chip_smoke.LOWLAT_NS:
        for kind in ("modal", "noise", "impulse", "flat"):
            x = chip_smoke.lowlat_window(n, kind)
            calls.append((f"{kind} N={n} rigid", x, {"mode": "rigid", "refine": True}))
            for m in chip_smoke.LOWLAT_BUDGETS:
                calls.append((f"{kind} N={n} flexible M={m}", x,
                              {"mode": "flexible", "max_candidates": m, "refine": True}))
    for name, x, k in (("edge-set overflow", chip_smoke.rigid_edge_window(), 100),
                       ("edge-set overflow", chip_smoke.rigid_edge_window(65536), 100),
                       ("list overflow", chip_smoke.rigid_list_window(), 5)):
        calls.append((f"{name} N={x.shape[0]} rigid", x, {"mode": "rigid", "k": k,
                                                          "refine": True}))
    seed = int.from_bytes(os.urandom(4), "little")
    log(f"[lowlat against] fresh windows from seed {seed}")
    for n in (latency_cuda.CLUSTER_MIN_N, latency_cuda.LOWLAT_MAX_N):
        for kind in ("modal", "noise"):
            for s in range(2):
                x = chip_smoke.lowlat_window(n, kind, seed=seed + s)
                for mode in ("rigid", "flexible"):
                    calls.append((f"fresh {kind} N={n} {mode} seed {seed + s}", x,
                                  {"mode": mode, "max_candidates": 16, "refine": True}))
    return calls


def lowlat_against(other: str, card: str) -> None:
    """Item 9: this tree's single-window kernels against ``other``'s, bit for bit."""
    calls = lowlat_calls()
    fs = torch.tensor(FS, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "windows.npz"), os.path.join(tmp, "outputs.npz")
        np.savez(src, calls=json.dumps([kw for _, _, kw in calls]),
                 **{f"x{i}": x for i, (_, x, _) in enumerate(calls)})
        proc = subprocess.run([sys.executable, "-c", _LOWLAT_CHILD, src, dst],
                              cwd=other, env={**os.environ, "PYTHONPATH": os.path.abspath(other)},
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        theirs = dict(np.load(dst))
    differ = collections.Counter()
    per_kernel = collections.Counter()
    for i, (label, x, kw) in enumerate(calls):
        res = latency_cuda.analyze_window_lowlat(torch.from_numpy(x).cuda(), fs, **kw)
        kernel = latency_cuda.kernel_name(kw["mode"], x.shape[0])
        per_kernel[kernel] += 1
        for f in res._fields:
            mine, other_out = getattr(res, f).cpu().numpy(), theirs[f"{i}.{f}"]
            if mine.shape != other_out.shape or mine.view(np.uint32).tolist() != \
                    other_out.view(np.uint32).tolist():
                differ[kernel] += 1
                log(f"[lowlat against] {label}: {f} differs: {mine.tolist()} here, "
                    f"{other_out.tolist()} there")
    log(f"[lowlat against] {len(calls)} calls ({dict(per_kernel)}), 10 outputs each, against "
        f"{other}: {sum(differ.values())} outputs differ in any bit ({dict(differ)}); {card}")
    assert not differ, dict(differ)
    here = os.path.dirname(os.path.abspath(__file__))
    runs = [(tree, _tree_times(tree)) for tree in (other, here, here, other)]
    for case in runs[0][1]:
        log(f"[lowlat times] {case}, budget 2, two-tone window: device / call / routed wall ms "
            f"(profiler mean of 20, CUDA-event median of 20, host-wall median of 20): " + "; ".join(
                f"{'other' if tree == other else 'this'} " + " / ".join(
                    f"{v:.4f}" for v in times[case]) for tree, times in runs) + f"; {card}")


def span_cost(card: str) -> None:
    from apda_fft_tpu_torch.utils import profiling

    def per_span_us(make, n: int) -> float:
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(n):
                with make("apda.probe"):
                    pass
            best = min(best, (time.perf_counter() - t) / n * 1e6)
        return best

    off = per_span_us(profiling.span, 50_000)
    bare = per_span_us(torch.profiler.record_function, 50_000)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        on = per_span_us(profiling.span, 5_000)
    log(f"span cost, us a span: span() untraced {off:.3f}, record_function untraced "
        f"{bare:.3f}, span() under the profiler {on:.3f} | {card}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-cpu-probe", action="store_true")
    parser.add_argument("--cpu-probe", action="store_true", help="only run the CPU probe (item 3)")
    parser.add_argument("--block-sizes", action="store_true",
                        help="only time the kernels' block sizes (item 4)")
    parser.add_argument("--paths", action="store_true",
                        help="only profile the gateway's record, Welch and stream paths (item 6)")
    parser.add_argument("--fast-modes", action="store_true",
                        help="only measure the candidates for precision='fast' (item 7)")
    parser.add_argument("--threshold-order", action="store_true",
                        help="only compare B1's threshold with its plain twin's (item 8)")
    parser.add_argument("--lowlat-against", metavar="OTHER_TREE",
                        help="only hold the single-window kernels bit for bit against "
                             "another checkout's (item 9)")
    parser.add_argument("--sass", metavar="OTHER_TREE",
                        help="only compare the kernels' compiled code with another "
                             "checkout's (item 5)")
    parser.add_argument("--span-cost", action="store_true",
                        help="only time one span, off and under the profiler (item 10)")
    parser.add_argument("--cpu-probe-child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--cpu-gemm-child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.cpu_gemm_child:
        with fft_ops.ieee_fp32_matmul():
            fft_ops._fourstep_magnitudes(torch.from_numpy(chip_smoke.clean_batch(256)),
                                         N_FFT // 2)
        return 0
    if args.cpu_probe_child:
        epoch(torch.from_numpy(chip_smoke.clean_batch(BATCH)).cuda())
        torch.cuda.synchronize()
        print(" | ".join(cpu_mismatch(chip_smoke.clean_batch(256))))
        return 0
    card = chip_smoke.phase_device()
    if args.span_cost:
        span_cost(card)
        return 0
    if args.sass:
        sass_compare(args.sass, card)
        log(card)
        return 0
    if args.lowlat_against:
        lowlat_against(args.lowlat_against, card)
        log(card)
        return 0
    if args.paths:
        profile_paths(card)
        log(card)
        return 0
    corpora = {"clean": chip_smoke.clean_batch(BATCH), "noisy": chip_smoke.noisy_batch(BATCH)}
    if args.threshold_order:
        chip_smoke.phase_build()
        threshold_order(corpora, card)
        log(card)
        return 0
    if args.fast_modes:
        fast_modes(corpora, card)
        log(card)
        return 0
    if args.block_sizes:
        block_sizes(corpora["noisy"], card)
        log(card)
        return 0
    if args.cpu_probe:
        cpu_probe(corpora, card)
        log(card)
        return 0
    profile(corpora, card)
    finalize_forms(corpora["noisy"], card)
    if not args.skip_cpu_probe:
        cpu_probe(corpora, card)
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
