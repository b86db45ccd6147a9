"""Gateway CLI: run against real XBee hardware or a built-in simulation.

Usage:
    python -m apda_fft_tpu_torch.gateway --config gw_config.json           # hardware
    python -m apda_fft_tpu_torch.gateway --simulate [--sensors 4] [--workdir DIR] [--device cpu]

Simulation mode spins up N synthetic sensors streaming two-mode acquisitions
through the loopback transport, processes everything through the full state
machine + spectral pipeline on the card (``--device cpu`` runs it on the
CPU), and prints the history log - a smoke-drivable analog
of the reference's production-only deployment.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def _simulate(n_sensors: int, workdir: str | None, analysis: str = "epoch",
              device: str | None = None) -> None:
    from apda_fft_tpu_torch.gateway.config import GatewayConfig
    from apda_fft_tpu_torch.gateway.egress import FtpSink, HttpSink
    from apda_fft_tpu_torch.gateway.service import GatewayService
    from apda_fft_tpu_torch.gateway.transport import LoopbackTransport, SensorSimulator

    workdir = workdir or tempfile.mkdtemp(prefix="apda_gw_")
    data_dir = os.path.join(workdir, "SHM_Data") + os.sep
    os.makedirs(data_dir, exist_ok=True)
    cfg_path = os.path.join(workdir, "gw_config.json")
    with open(cfg_path, "w") as fh:
        json.dump(
            {
                "ftp": {"server": "", "user": "", "pwd": "", "path": ""},
                "fastapi": {"url": ""},
                "gateway": {
                    "logger_file": data_dir + "history.log",
                    "device_file": data_dir + "devices.txt",
                    "config_file": os.path.join(workdir, "config.txt"),
                    "data_dir": data_dir,
                    "is_flexibile_structure": True,
                    "analysis": analysis,
                    "welch_window": 1024,
                },
            },
            fh,
        )
    open(os.path.join(workdir, "config.txt"), "w").close()

    class NullFtp(FtpSink):
        def upload(self, addr, files, log):
            log(f"\t[FTP:sim] would upload {files}\n")
            return list(files)

    class NullHttp(HttpSink):
        def upload(self, addr, files, local_dir, fft_result, log):
            log(f"\t[FastAPI:sim] would post {files}\n")
            return list(files)

    config = GatewayConfig.load(cfg_path)
    transport = LoopbackTransport()
    svc = GatewayService(
        config,
        transport,
        flush_mode="on_sync",
        ftp_sink=NullFtp(config.ftp, data_dir),
        http_sink=NullHttp(""),
        device=device,
    )
    svc.start()

    rng = np.random.default_rng(0)
    t = np.arange(4096) / 500.0
    for i in range(n_sensors):
        mac = f"0013a20041e7f{i:03x}"
        sim = SensorSimulator(mac, fs=500.0, axis="XYZ"[i % 3], chunk=120, seed=i)
        f1, f2 = 8.0 + 3.1 * i, 40.0 + 2.7 * i
        x = (
            np.sin(2 * np.pi * f1 * t)
            + 0.6 * np.sin(2 * np.pi * f2 * t)
            + 0.05 * rng.standard_normal(4096)
        )
        sim.stream_acquisition(transport, x, baseline=0.1 * i)
        sim.heartbeat(transport, humidity=40.0 + i)
    n = svc.drain()
    svc.stop()

    print(f"processed {n} packets from {n_sensors} sensors; workdir={workdir}")
    print("--- history.log ---")
    print(open(config.logger_file).read())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apda_fft_tpu_torch.gateway")
    ap.add_argument("--config", default="/etc/config/scripts/gw_config.json")
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--sensors", type=int, default=4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--analysis", default="epoch", choices=["epoch", "welch"],
                    help="simulation acquisition analysis strategy")
    ap.add_argument("--device", default=None,
                    help="where the analysis runs (default: the CUDA card; 'cpu' "
                         "runs it on the CPU)")
    args = ap.parse_args(argv)

    if args.simulate:
        _simulate(args.sensors, args.workdir, args.analysis, args.device)
        return

    from apda_fft_tpu_torch.gateway.config import GatewayConfig
    from apda_fft_tpu_torch.gateway.service import GatewayService
    from apda_fft_tpu_torch.gateway.transport import XBeeTransport

    config = GatewayConfig.load(args.config)
    GatewayService(config, XBeeTransport(timeout=5), device=args.device).run_forever()


if __name__ == "__main__":
    main()
