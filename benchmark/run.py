"""Run one cell of the benchmark of trinity_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (trinity_tpu_torch/)
on a machine with an NVIDIA card. Prints progress on standard error, the
numbers compared with their limits as its last lines there, and one JSON
object as the last line of standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device (and with --trace 1 a breakdown of the trace), and the
checks. It exits non-zero and prints no result when torch sees no card,
when the port is missing, or when a module of JAX or of the JAX package
(trinity_tpu) was loaded. Caches (the native host library, the kernel
build, torch's kernel cache) stay inside the checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its own kernels into trinity_tpu_torch/_build/)
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch-kernels"),
                 ("TORCH_EXTENSIONS_DIR", "torch-extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv-compute")):
    os.environ[var] = os.path.join(BENCH, ".cache", sub)
# one process with few threads: the host path is one Python thread, and
# idle OpenMP workers of torch and numpy would only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def since_process_start() -> float:
    """Seconds from the process's start to STARTED (interpreter start-up),
    read from /proc; 0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - STARTED))
    except (OSError, ValueError, IndexError):
        return 0.0


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "not read"


def fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    started = STARTED - since_process_start()

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{torch.cuda.device_count()} card(s), the cell needs "
             f"{cell.chips}")
    if not os.path.isdir(os.path.join(ROOT, "trinity_tpu_torch")):
        fail(f"no trinity_tpu_torch package beside {BENCH}")
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; nvidia-smi: "
        f"{nvidia_smi()}")
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", started, log)
    except harness.JaxLoaded as e:
        fail(f"modules of JAX or the JAX package were loaded: {e}")
    found = harness.jax_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}")
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
