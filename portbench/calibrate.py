"""The readings that a cell's correctness limits are set from, on the chip.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 \\
        --controls 3 [--faults name,...] [--set key=json ...]

For each seed, the program's set-up and checked steps (the timed path, at
the cell's sizes, without the window) against the plain fp32 reference:
the program's numbers. For the first ``--controls`` seeds also, each read
the same way against the same reference:

* ``control``: the reference in the program's place, computed in fp8
  (one precision below the configurations' bf16);
* ``half_batch``: the reference in the program's place with half of every
  batch left out (the mean taken over the rest);
* ``no_exchange`` (on several chips): the reference in the program's
  place without its exchange (each rank's own BatchNorm statistics and
  gradients);
* ``bf16``: a witness, not a control: the reference in the program's
  place in the configurations' own precision (products' operands and
  gradients rounded to bf16), which shows what that precision alone
  reads;
* each of ``--faults`` (``faults.PLANTS``): the program with that fault
  planted in its model.

``--set key=json`` changes a key of the configuration for both sides (a
witness at another setting, such as ``zero_init_last_bn=false``).

A state left unchanged reads 1 on ``change_gap`` (every leaf's change is
0) and needs no run. One JSON line a seed, then the summary: each number's
largest over the program's seeds (and the witness's) and smallest over
each control and fault.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from portbench import faults, judge, run as R


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", default="", help="comma-separated plants")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _half(batch):
    return tuple(t[: t.shape[0] // 2] for t in batch)


def _program(run: R.Run) -> dict:
    s = R.setup(run)
    R.free(s)
    return s.reading


def readings(run: R.Run, controls: bool, plants) -> dict:
    """This rank's numbers for ``run.seed``."""
    prog = _program(run)
    ref = R.reference(run)
    out = {"program": judge.gaps(prog, ref)}
    if controls:
        out["control"] = judge.gaps(R.reference(run, "fp8"), ref)
        out["bf16"] = judge.gaps(R.reference(run, "bf16"), ref)
        out["half_batch"] = judge.gaps(R.reference(run, keep=_half), ref)
        if run.world > 1:
            out["no_exchange"] = judge.gaps(R.reference(run, exchange=False),
                                            ref)
        for name in plants:
            planted = dataclasses.replace(run, plant=faults.PLANTS[name])
            out[name] = judge.gaps(_program(planted), ref)
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    mf, wl, cell, cfg = R.load_cell(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cfg[key] = json.loads(value)
    plants = [n for n in args.faults.split(",") if n]
    unknown = sorted(set(plants) - set(faults.PLANTS))
    if unknown:
        print(f"unknown faults {unknown}; known: {sorted(faults.PLANTS)}",
              file=sys.stderr)
        return 2
    chips = wl["chips"]
    if R.card(chips) is None:
        return 3
    rank, store, children = R.ranks("portbench.calibrate", argv, args.rank,
                                    args.port, chips)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    from portbench import program

    lines = []
    try:
        if chips > 1:
            program.init_group(rank, chips, store, device)
        for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
            run = R.Run(mf, wl, cell, cfg, seed, 0.0, False, device, rank,
                        chips, store)
            parts = R.gather(run, readings(run, i < args.controls, plants))
            line = {"seed": seed, **{k: judge.worst(p[k] for p in parts)
                                     for k in parts[0]}}
            lines.append(line)
            if rank == 0:
                print(json.dumps(line), flush=True)
    finally:
        program.destroy_group()
    if rank:
        return 0
    if not R.children_done(children):
        return 1
    summary = {"workload": args.workload, "set": args.set,
               "device": torch.cuda.get_device_name(device)}
    for kind in ("program", "bf16", "control", "half_batch", "no_exchange",
                 *plants):
        got = [ln[kind] for ln in lines if kind in ln]
        if got:
            pick = max if kind in ("program", "bf16") else min
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
