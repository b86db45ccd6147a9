"""Where an epoch's time goes on one NVIDIA GPU, and two host-side probes.

    python3 chip_profile.py            # items 1-3 below, ~2 min on an H100
    python3 chip_profile.py --skip-cpu-probe
    python3 chip_profile.py --block-sizes   # item 4 only
    python3 chip_profile.py --sass OTHER_TREE   # item 5 only
    python3 chip_profile.py --paths         # item 6 only, ~1 min

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
3. CPU probe: the port's CPU ``analyze_epoch`` on 256 clean windows at the
   default intra-op thread count against one thread, repeated in this
   process and in fresh processes that first run an epoch on the card
   (the setting in which ``chip_smoke.py``'s CPU reference once went
   wrong); a last child runs the CPU front end with oneDNN's and MKL's
   verbose logs on and reports which GEMM paths it took;
4. block sizes: the profiler's device time of the single-window kernels
   at 256, 512 and 1024 threads (pinned in ``latency_cuda._THREADS``) on
   two-tone windows at N=1024 (cfg1's), 4096 (cfg2's), 16384 and 65536,
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

Every line carries the card's name and power limit.  Exit code 0 unless a
check fails; the probe's mismatches are reported, not raised.
"""

from __future__ import annotations

import argparse
import collections
import glob
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
from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes
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


def cpu_mismatch(x: np.ndarray) -> str:
    """Run the CPU epoch at the default thread count, then at one thread;
    describe the rows whose magnitudes differ by more than 1e-6 relative."""
    xc = torch.from_numpy(x)
    many = pipeline.analyze_epoch(xc, FS, n_fft=N_FFT, mode="flexible", max_candidates=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = pipeline.analyze_epoch(xc, FS, n_fft=N_FFT, mode="flexible", max_candidates=2)
    finally:
        torch.set_num_threads(threads)
    rel = ((many.mag - one.mag).abs().amax(-1) / one.mag.abs().amax(-1)).numpy()
    bad = np.flatnonzero(rel > 1e-6)
    if bad.size == 0:
        return "equal"
    return f"{bad.size} rows off (rows {bad.min()}..{bad.max()}, max rel {rel.max():.3g})"


def cpu_probe(corpora: dict[str, np.ndarray], card: str) -> None:
    x = corpora["clean"][:256]
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
    log(f"[cpu probe] in process, 20 runs after a card epoch each: "
        f"{sum(f != 'equal' for f in found)} off {[f for f in found if f != 'equal']}")
    children = []
    for _ in range(6):
        out = subprocess.run([sys.executable, __file__, "--cpu-probe-child"],
                             capture_output=True, text=True, check=True, timeout=300)
        children.append(out.stdout.strip().splitlines()[-1])
    log(f"[cpu probe] fresh processes, first CPU epoch after a card epoch: "
        f"{sum(c != 'equal' for c in children)} of 6 off {children}")
    env = dict(os.environ, ONEDNN_VERBOSE="1", MKL_VERBOSE="1")
    out = subprocess.run([sys.executable, __file__, "--cpu-gemm-child"], env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    lines = out.stdout.splitlines()
    onednn = [ln for ln in lines if ln.startswith("onednn_verbose") and ",exec," in ln]
    mkl = [ln for ln in lines if ln.startswith("MKL_VERBOSE")]
    log(f"[cpu probe] front end at {torch.get_num_threads()} threads: {len(onednn)} oneDNN "
        f"primitives, {len(mkl)} MKL calls; {card}")
    for ln in (onednn[:3] + mkl[:3]):
        log(f"[cpu probe]   {ln[:200]}")


def block_sizes(noisy: np.ndarray, card: str) -> None:
    fs = torch.tensor(FS, device="cuda")
    two_tone = chip_smoke.clean_batch
    windows = (("flexible", "two-tone N=1024 budget 2", two_tone(1, 1024)[0], 2),
               ("flexible", "cfg2 N=4096 budget 2", two_tone(1, 4096)[0], 2),
               ("flexible", "71-candidate window N=4096 M=64", chip_smoke.overflow_window(), 64),
               ("flexible", "two-tone N=16384 budget 2", two_tone(1, 16384)[0], 2),
               ("flexible", "two-tone N=65536 budget 2", two_tone(1, 65536)[0], 2),
               ("rigid", "cfg1 N=1024", two_tone(1, 1024)[0], 2),
               ("rigid", "two-tone N=4096", two_tone(1, 4096)[0], 2),
               ("rigid", "two-tone N=16384", two_tone(1, 16384)[0], 2),
               ("rigid", "two-tone N=65536", two_tone(1, 65536)[0], 2))
    saved = dict(latency_cuda._THREADS)
    try:
        for mode, label, xn, m in windows:
            x = torch.from_numpy(xn).cuda()

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
                times[threads].append(chip_smoke._kernel_device_ms(run, f"lowlat_{mode}"))
            assert len(decisions) == 1, (label, decisions)
            log(f"[block sizes] lowlat_{mode} {label}: device ms " + "; ".join(
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-cpu-probe", action="store_true")
    parser.add_argument("--block-sizes", action="store_true",
                        help="only time the kernels' block sizes (item 4)")
    parser.add_argument("--paths", action="store_true",
                        help="only profile the gateway's record, Welch and stream paths (item 6)")
    parser.add_argument("--sass", metavar="OTHER_TREE",
                        help="only compare the kernels' compiled code with another "
                             "checkout's (item 5)")
    parser.add_argument("--cpu-probe-child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--cpu-gemm-child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.cpu_gemm_child:
        halfspec_magnitudes(torch.from_numpy(chip_smoke.clean_batch(256)))
        return 0
    if args.cpu_probe_child:
        epoch(torch.from_numpy(chip_smoke.clean_batch(BATCH)).cuda())
        torch.cuda.synchronize()
        print(cpu_mismatch(chip_smoke.clean_batch(256)))
        return 0
    card = chip_smoke.phase_device()
    if args.sass:
        sass_compare(args.sass, card)
        log(card)
        return 0
    if args.paths:
        profile_paths(card)
        log(card)
        return 0
    corpora = {"clean": chip_smoke.clean_batch(BATCH), "noisy": chip_smoke.noisy_batch(BATCH)}
    if args.block_sizes:
        block_sizes(corpora["noisy"], card)
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
