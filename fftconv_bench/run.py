"""Run one cell of the benchmark once and print its result line.

    python3 -m fftconv_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each number compared beside its limit);
the last lines of standard error repeat the checks. Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_fft_convolution_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (compared whole: the part before
    the first dot) that this benchmark must never load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = pathlib.Path(__file__).resolve().parent.parent
    # kernel caches at fixed paths inside the checkout (the port's own
    # library is built into build/ there): the CUDA driver's, and PyTorch's
    # for the kernels it compiles at run time
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "cuda_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(root / "build" / "torch_kernels")
    import torch

    from fftconv_bench import harness, spec

    t_torch = time.perf_counter()
    cell = spec.cell(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"setup: imports {t_torch - T_PROCESS:.3f} s, "
          f"device query {time.perf_counter() - t_torch:.3f} s", file=sys.stderr, flush=True)
    torch.set_num_threads(2)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
