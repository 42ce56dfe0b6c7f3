"""The readings that a cell's limits are set from, on the card.

    python3 -m fftconv_bench.control --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

For each program seed, one run of the cell as the benchmark makes it, with
a short window (``harness.run``): the numbers its check compares. For each
control seed, the control in the program's place: the reference computed
in the nearest precision below the configuration's (``CONTROL``), on the
same inputs and as many frames as a run compares, judged by the same
check. A limit lies above the program's largest reading and below the
control's smallest. Prints one JSON line and writes it to ``--out``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys

import torch

from fftconv_bench import harness, spec, workload
from fftconv_bench.reference.conv import conv_blocks

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def control_answers(cell: spec.Cell, inputs: workload.Inputs, seed: int) -> dict:
    """The control's answers for the frames a run of ``seed`` compares."""
    cfg, tr = cell.config, cell.traffic
    entry = tr["entry"]
    precision = CONTROL[cfg["precision"]]
    n_pool = int(tr["pool"])
    # as many frames as a run keeps answers, drawn from the seed
    frames = sorted(random.Random(seed).sample(range(n_pool), min(int(tr["check_frames"]), n_pool)))
    fe = cfg.get("front_end")
    if fe:
        x = torch.stack([workload.features(cfg, inputs.pool[p]) for p in frames])
    else:
        x = inputs.pool[frames]
    out_dtype = getattr(torch, entry.get("out_dtype") or "float32")
    maps = torch.cat([m for _, m in conv_blocks(
        x, inputs.bank, mode=entry["mode"], correlation=cfg["entry"]["correlation"],
        precision=precision)], dim=1).to(out_dtype)
    answers = {}
    for b, p in enumerate(frames):
        if entry.get("head") == "peaks":
            flat = maps[b].flatten(1)
            idx = flat.argmax(1)
            w = maps.shape[-1]
            answers[p] = [(flat.gather(1, idx[:, None])[:, 0],
                           torch.stack([idx // w, idx % w], dim=-1))]
        else:
            answers[p] = [maps[b]]
    return answers


def readings(cell: spec.Cell, program_seeds, control_seeds, seconds: float,
             device="cuda:0", tier_seeds=(), tier: dict | None = None) -> dict:
    """The program's numbers on ``program_seeds``, the control's on
    ``control_seeds``, and on ``tier_seeds`` the program's own with the
    port's config set to ``tier`` (its lower-precision path, where it has
    one), restored after."""
    out = {"workload": cell.name, "program": {}, "control": {},
           "control_precision": CONTROL[cell.config["precision"]]}
    if tier_seeds:
        from cuda_fft_convolution_torch.utils.config import get_config, set_config

        before = get_config()
        set_config(**tier)
        try:
            out["program_tier"] = {"config": tier, "readings": {
                str(s): {k: v["value"] for k, v in harness.run(
                    cell, s, seconds, False, device=device)["checks"].items()}
                for s in tier_seeds}}
        finally:
            set_config(**{k: getattr(before, k) for k in tier})
        print(json.dumps(out["program_tier"]), file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    for s in program_seeds:
        r = harness.run(cell, s, seconds, False, device=device)
        out["program"][str(s)] = {k: v["value"] for k, v in r["checks"].items()}
        out.setdefault("device", r["device"])
        print(json.dumps({"seed": s, "program": out["program"][str(s)],
                          "correct": r["correct"]}), file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    for s in control_seeds:
        inputs = workload.make_inputs(cell.config, cell.traffic, s, torch.device(device))
        numbers, _ = harness.check(cell, inputs, control_answers(cell, inputs, s))
        out["control"][str(s)] = numbers
        print(json.dumps({"seed": s, "control": numbers}), file=sys.stderr, flush=True)
        del inputs
        torch.cuda.empty_cache()
    for side in ("program", "control"):
        vals = out[side].values()
        if vals:
            keys = next(iter(vals)).keys()
            pick = max if side == "program" else min
            out[f"{side}_{pick.__name__}"] = {k: pick(v[k] for v in vals) for k in keys}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--tier-seeds", default="")
    p.add_argument("--tier", default="{}",
                   help="JSON of the port's config fields for --tier-seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = spec.cell(a.workload)
    res = readings(cell, seeds(a.program_seeds), seeds(a.control_seeds), a.seconds,
                   tier_seeds=seeds(a.tier_seeds), tier=json.loads(a.tier))
    line = json.dumps(res)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
