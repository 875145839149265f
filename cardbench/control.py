"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m cardbench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults drop30,move30 --fault-seeds 4,5,6] [--seconds 2]

In one process, for each seed: one run of the cell (``harness.run``) with
a short window at the cell's own load and sizes, judged as every run is;
then the same with the control in the program's place: the plain
reference computed on float8 (e4m3) values, one step below the bf16 that
the configuration serves in (``Reference(quant="fp8")``); then the
program with each fault of :data:`FAULTS` planted under its entry.
Prints one JSON line per run and, last, each number's lower reading (the
largest over the program's seeds) and upper reading (the smallest over
the control's), and each fault's smallest reading.  Never part of the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys

from cardbench import harness, judge, spec


def control_call(config, det_state, cls_state, batch, device):
    """The control as a program: the fp8 reference pipeline."""
    import torch

    from cardbench.reference.two_stage import Reference

    ref = Reference(config, det_state, cls_state, device, quant="fp8")
    return lambda frames: ref.run_pipeline(torch.as_tensor(frames).to(device))


def _rows(n: int, share: float):
    """About ``share`` of ``n`` rows, spread over the batch."""
    import torch

    k = max(1, round(share * n))
    return torch.arange(k) * n // k


def rows_left_out(share: float):
    """The outputs of about ``share`` of the batch's rows left out (zeros,
    nothing valid), as a step that serves only the rest would give."""
    def wrap(call):
        def broken(frames):
            out = dict(call(frames))
            rows = _rows(out["valid"].shape[0], share).to(out["valid"].device)
            for k in ("boxes", "det_scores", "cls_probs", "cls_scores"):
                out[k] = out[k].clone()
                out[k][rows] = 0
            out["valid"] = out["valid"].clone()
            out["valid"][rows] = False
            out["det_class_ids"] = out["det_class_ids"].clone()
            out["det_class_ids"][rows] = -1
            return out
        return broken
    return wrap


def boxes_moved(share: float, px: float = 16.0):
    """The boxes of about ``share`` of the batch's rows moved ``px`` frame
    pixels to the right where they are produced."""
    def wrap(call):
        def broken(frames):
            out = dict(call(frames))
            rows = _rows(out["valid"].shape[0], share).to(out["boxes"].device)
            out["boxes"] = out["boxes"].clone()
            out["boxes"][rows, :, 0::2] += px
            return out
        return broken
    return wrap


def labels_altered(share: float):
    """The labels of the classified slots of about ``share`` of the
    batch's rows changed where they are produced."""
    def wrap(call):
        def broken(frames):
            out = dict(call(frames))
            rows = _rows(out["valid"].shape[0], share).to(out["cls_labels"].device)
            labels = out["cls_labels"].clone()
            labels[rows] = (labels[rows] + 1) % out["cls_probs"].shape[-1]
            out["cls_labels"] = labels
            return out
        return broken
    return wrap


FAULTS = {"drop30": rows_left_out(0.3), "half": rows_left_out(0.5), "move30": boxes_moved(0.3),
          "label30": labels_altered(0.3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated names of FAULTS")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dump", default=None,
                   help="directory for each run's per-slot and per-frame gaps (torch.save)")
    args = p.parse_args(argv)
    harness.pin_caches(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("cardbench.control: no CUDA device", file=sys.stderr)
        return 2
    from cardbench import program

    program.build_kernels()
    cell = spec.resolve(args.workload)
    seeds = lambda text: [int(s) for s in text.split(",") if s]  # noqa: E731
    runs = [("program", s) for s in seeds(args.seeds)]
    runs += [("control", s) for s in seeds(args.control_seeds)]
    runs += [(f, s) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]
    readings = {}
    for mode, seed in runs:
        kept = {}
        kw = {"make_call": control_call} if mode == "control" else (
            {"wrap": FAULTS[mode]} if mode != "program" else {})
        out = harness.run(cell, seed, args.seconds, False, keep=kept, **kw)
        if args.dump:
            import os

            os.makedirs(args.dump, exist_ok=True)
            torch.save(kept, os.path.join(args.dump, f"{args.workload}.{mode}.{seed}.pt"))
        numbers = out["info"]["judged"] | {k: v["value"] for k, v in out["result"]["checks"].items()}
        readings.setdefault(mode, []).append(numbers)
        print(json.dumps({"mode": mode, "seed": seed, "numbers": numbers,
                          "correct": out["result"]["correct"],
                          "window": out["info"]["window"]}), flush=True)
    summary = {}
    for k in judge.NUMBERS:
        row = {"lower": max((r[k] for r in readings.get("program", ())), default=None)}
        for mode, got in readings.items():
            if mode != "program":
                row[mode] = min(r[k] for r in got)
        if row["lower"] and row.get("control") is not None:
            row["ratio"] = row["control"] / row["lower"]
        summary[k] = row
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
