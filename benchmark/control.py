"""The control of the correctness check: the plain reference put in the
program's place in the nearest precision below the configuration's (TF32
for float32 with TF32 off), compared with the float32 reference by the
cell's own numbers. The check's limits lie between what sound runs read
and what this reads; the benchmark's runs never run it.

    python benchmark/control.py --workload <cell> --seeds 11 12 13

on the card, at the cell's own size. For a training cell it also reads
three faults planted in the reference put in the program's place: half of
the batch left out, the mean taken over the rest; each step of the k-step
call fed the call's first slot and draws; each step returning the state
unchanged. With `--program`, the program's
own numbers too; for a serving cell, the reference postprocess on the
CPU against the card's (a sound reordering of its arithmetic). One JSON
line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import harness  # noqa: E402


def _numbers(compared: dict) -> dict:
    return {k: v for k, (v, _) in compared.items()}


def cpu_witness(kind, run, slot: int) -> dict:
    """A sound reordering of the postprocess's arithmetic: the reference
    postprocess on the CPU against the same on the card, on the card's
    reference network output for one request and the same draws."""
    from reference.pose import postprocess_multi
    inp = run.inputs
    (cls, reg), ans = kind.reference_outputs(run, slot)
    cpu = lambda x: x.detach().cpu()
    got = postprocess_multi(inp["rcfg"], cpu(inp["K"]), cpu(inp["kp3d"]), cpu(cls), cpu(reg),
                            cpu(inp["bbox"][slot]), cpu(inp["draws"][slot]))
    return kind.answer_gaps({k: v.to(cls.device) for k, v in got.items()}, ans)


def readings(cell: dict, seed: int, device, program: bool = False) -> dict:
    """The control's numbers on one seed (for a training cell also the
    faults': half of the batch left out, the mean over the rest; each step
    of the k-step call fed its first slot; the state left unchanged); with `program`, also the
    program's own from a run's set-up (training) or from requests answered
    as the window answers them (serving, and the fault of one crop's answer
    altered in each), against the reference, in this process."""
    import time

    import torch
    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0, workload=cell["name"])
    run = harness.Run(args, cell, torch.device(device), time.perf_counter(), "")
    kind = harness.traffic_kind(cell)
    out = {"seed": seed}
    train = cell["traffic_raw"]["kind"] == "train_pool"
    if program:
        kind.setup(run)
        if not train:
            for i in range(cell["traffic_raw"]["pool"]):
                run.prog["request"](i)
        kind.release(run)
    else:
        kind.make_inputs(run)
    if train:
        ref = kind.reference_numbers(run)
        if program:
            out["program"] = _numbers(kind.compare(run.numbers, ref))
        for name, fault in (("control", dict(tf32=True)), ("half_batch", dict(keep_half=True)),
                            ("first_slot", dict(first_slot=True)),
                            ("state_unchanged", dict(frozen=True))):
            out[name] = _numbers(kind.compare(kind.reference_numbers(run, **fault), ref))
    else:
        if program:
            out["program"] = kind.compare(run)
            for slot, (net_out, ans) in run.inputs["last"].items():
                moved = dict(ans, T=ans["T"].clone())
                moved["T"][0, :, 0] += 0.5 * moved["T"][0, :, 2].abs()
                run.inputs["last"][slot] = (net_out, moved)
            out["one_crop_altered"] = kind.compare(run)
        each = {"network_gap": [], "answers_off": [], "pose_gap": []}
        slots = kind.sample_slots(run, range(cell["traffic_raw"]["pool"]))
        for slot in slots:
            ref_out, _ = kind.reference_outputs(run, slot)
            ctl_out, ctl_ans = kind.reference_outputs(run, slot, tf32=True)
            _, ref_on_ctl = kind.reference_outputs(run, slot, net_out=ctl_out)
            each["network_gap"].append(kind.network_gap(ctl_out, ref_out))
            for k, v in kind.answer_gaps(ctl_ans, ref_on_ctl).items():
                each[k].append(v)
        out["control"] = {"network_gap": max(each["network_gap"]),
                          "answers_off": sum(each["answers_off"]) / len(each["answers_off"]),
                          "each": each}
        out["cpu_postprocess"] = cpu_witness(kind, run, slots[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true",
                   help="the program's own numbers too")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    for seed in a.seeds:
        print(json.dumps(readings(cell, seed, "cuda", a.program)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
