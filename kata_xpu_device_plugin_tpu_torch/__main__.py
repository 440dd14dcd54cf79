"""CLI entry point of the host daemon for NVIDIA GPUs (counterpart of
``kata_xpu_device_plugin_tpu/__main__.py``, the reference's
``cmd/main.go:5-7``):

- ``run``     start the device-plugin daemon (every constant is a flag)
- ``status``  one-shot report: discovery, the worker identity, the CDI
  specs on disk and the pods holding the devices
- ``version``

    python -m kata_xpu_device_plugin_tpu_torch run|status|version [flags]

The daemon never touches CUDA: discovery reads sysfs, /dev and the
driver's procfs.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

__version__ = "0.1.0"

PROG = "kata-gpu-device-plugin"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="Kubernetes device plugin for NVIDIA GPUs in Kata Containers",
    )
    parser.add_argument("--version", action="version", version=f"{PROG} {__version__}")
    sub = parser.add_subparsers(dest="command")
    from .config import add_flags

    run_p = sub.add_parser("run", help="run the device-plugin daemon")
    add_flags(run_p)
    status_p = sub.add_parser("status", help="report discovery + CDI specs on disk")
    add_flags(status_p)
    status_p.add_argument("--json", action="store_true", dest="as_json")
    sub.add_parser("version", help="print version")

    args = parser.parse_args(argv)
    if args.command in (None, "version"):
        print(f"{PROG} {__version__}")
        return 0
    if args.command == "run":
        return _run(args)
    if args.command == "status":
        return _status(args)
    parser.error(f"unknown command {args.command!r}")
    return 2


def _run(args: argparse.Namespace) -> int:
    from .config import from_args
    from .plugin.manager import PluginManager
    from .utils import log, metrics

    cfg = from_args(args)
    logger = log.setup(cfg.log_level, cfg.log_format)
    metrics.serve(cfg.metrics_port)
    if cfg.obs_events_file:
        # The daemon's own JSONL event stream: the gRPC handlers' spans land
        # in the pipeline the guest writes to.
        from . import obs

        obs.set_default_sink(obs.EventSink(cfg.obs_events_file))
    if cfg.obs_profile_dir:
        os.environ.setdefault("KATATPU_OBS_PROFILE_DIR", cfg.obs_profile_dir)
    mgr = PluginManager(cfg)

    # Self-pipe shutdown: the handler runs ON the main thread, which may be
    # mid-start() holding a plugin-server lock, or mid-Event.wait() holding
    # that event's internal lock, so it touches no lock and no Event. It
    # only writes a byte (async-signal-safe); a watcher thread makes the
    # stop request from a thread where Event.set cannot self-deadlock.
    sig_r, sig_w = os.pipe()

    def _on_signal(signum, _frame):
        try:
            os.write(sig_w, bytes([signum & 0x7F]))
        except OSError:
            pass

    def _signal_watcher():
        while True:
            data = os.read(sig_r, 1)
            if data and data[0] == (signal.SIGUSR1 & 0x7F):
                # Dump live manager state as one structured log line and keep
                # running, on a separate short thread: debug_report takes
                # manager and handler locks, and a dump wedged on one must
                # not stop this watcher from reading the shutdown byte.
                def _dump():
                    try:
                        logger.info(
                            "debug state dump (SIGUSR1)",
                            extra=log.kv(state=json.dumps(mgr.debug_report())),
                        )
                    except Exception as e:
                        logger.error("debug dump failed", extra=log.kv(err=str(e)))

                threading.Thread(target=_dump, name="debug-dump", daemon=True).start()
                continue
            logger.info(
                "signal received, shutting down",
                extra=log.kv(signal=data[0] if data else "?"),
            )
            mgr.request_stop()
            return

    threading.Thread(target=_signal_watcher, name="signal-watcher", daemon=True).start()
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGUSR1, _on_signal)

    try:
        mgr.start()
        mgr.run_forever()  # ref: blocks on <-stop (device_plugin.go:114)
    finally:
        mgr.stop()
    return 0


def pod_assignments(cfg, timeout_s: float = 2.0) -> list[dict]:
    """Which pods hold which of this namespace's devices, from the kubelet's
    pod-resources socket (``cfg.pod_resources_socket``)."""
    from .utils.podresources import device_assignments, list_pod_resources

    resp = list_pod_resources(cfg.pod_resources_socket, timeout_s=timeout_s)
    return device_assignments(resp, cfg.resource_namespace)


def status_report(cfg) -> dict:
    """``status --json``'s report: discovery with the multi-host identity
    as the daemon's manager resolves it (read-only: the state dir is never
    written), the CDI specs on disk, and the pod assignments, or
    ``pod_assignments_error`` when the kubelet's socket does not answer."""
    from .plugin.manager import PluginManager

    gpu, vfio = PluginManager(cfg, state_readonly=True).scan()
    report: dict = {
        "gpu": {
            "resource": cfg.gpu_resource_name,
            "model": gpu.model_suffix,
            "gpus": [
                {
                    "index": c.index,
                    "dev_path": c.dev_path,
                    "pci_address": c.pci_address,
                    "pci_device": c.pci_device,
                    "numa_node": c.numa_node,
                    "present": os.path.exists(c.dev_path),
                }
                for c in gpu.chips
            ],
            "num_hosts": gpu.topology.num_hosts,
            "worker_id": gpu.topology.worker_id,
            "worker_hostnames": list(gpu.topology.worker_hostnames),
        },
        "cdi_specs": sorted(
            os.path.join(cfg.cdi_dir, f)
            for f in (os.listdir(cfg.cdi_dir) if os.path.isdir(cfg.cdi_dir) else [])
            if f.endswith((".yaml", ".json"))
        ),
    }
    if cfg.vfio_vendors:
        report["vfio"] = {
            f"{v}:{d}": groups for (v, d), groups in sorted(vfio.models.items())
        }
    try:
        report["pod_assignments"] = pod_assignments(cfg)
    except Exception as e:  # the report stands without the kubelet's answer
        report["pod_assignments_error"] = str(e) or type(e).__name__
    return report


def _status(args: argparse.Namespace) -> int:
    from .config import from_args

    report = status_report(from_args(args))
    if args.as_json:
        print(json.dumps(report, indent=2))
        return 0
    g = report["gpu"]
    print(f"resource: {g['resource']} ({g['model']}, worker {g['worker_id']} "
          f"of {g['num_hosts']} host(s))")
    print(f"gpus: {len(g['gpus'])}")
    for c in g["gpus"]:
        mark = "ok" if c["present"] else "MISSING"
        print(f"  nvidia{c['index']}: {c['dev_path']} [{mark}]"
              + (f" pci={c['pci_address']}" if c["pci_address"] else "")
              + (f" numa={c['numa_node']}" if c["numa_node"] is not None else ""))
    for path in report["cdi_specs"]:
        print(f"cdi spec: {path}")
    for model, groups in report.get("vfio", {}).items():
        print(f"vfio {model}: groups {','.join(groups)}")
    if g["worker_hostnames"]:
        print(f"workers: {','.join(g['worker_hostnames'])}")
    if "pod_assignments" in report:
        for a in report["pod_assignments"]:
            print(f"pod {a['namespace']}/{a['pod']}/{a['container']}: "
                  f"{a['resource']} = {','.join(a['device_ids'])}")
    else:
        print(f"pod-resources: unavailable ({report['pod_assignments_error']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
