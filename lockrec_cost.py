"""What chip_smoke.py's lock-order recording costs its train_resume phase.

Runs `chip_smoke.train_resume` (full-width mamba2-130m at 8 x 2048, runs
A, B and C over the Trainer's own 4-server BuffetFS) in one process: one
warm-up run with the recorder on (it builds the kernels and counts the lock
acquisitions the recorder sees), then four in turns, recorder off, on, on,
off.  "Off" makes `LockOrderRecorder.instrument_server` a no-op, so the
servers keep their own locks and nothing is recorded; "on" is the phase as
chip_smoke.py runs it.  One JSON line a run (the phase's seconds, each
run's median step ms and restore seconds, its gate failures but the
recorder's own "no nesting" when off), then the card's name and power
limit and a summary line: the median phase seconds on and off.

    python3 lockrec_cost.py        # on a card, from the repo's root; writes nothing
"""
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.analysis import lockrec  # noqa: E402


def run(turn, on, count=False):
    instrument, acquire = lockrec.LockOrderRecorder.instrument_server, \
        lockrec._RecordingLock.acquire
    seen = [0]

    def counting(self, *a, **kw):
        seen[0] += 1
        return acquire(self, *a, **kw)
    if not on:
        lockrec.LockOrderRecorder.instrument_server = lambda self, srv: None
    if count:
        lockrec._RecordingLock.acquire = counting
    try:
        rec = cs.train_resume(torch.device("cuda"))
    finally:
        lockrec.LockOrderRecorder.instrument_server = instrument
        lockrec._RecordingLock.acquire = acquire
    failures = [f for f in cs.resume_failures(rec, cs.ssm_train_launches(get_config(cs.SSM_ARCH)))
                if on or not f.endswith("recorded no lock nesting")]
    line = {"turn": turn, "recorder": on, "seconds": rec["seconds"],
            "step_ms": {n: r["step_ms"] for n, r in rec["runs"].items()},
            "init_or_restore_s": {n: r["init_or_restore_s"] for n, r in rec["runs"].items()},
            "lock_pairs": {n: r["lock_pairs"] for n, r in rec["runs"].items()},
            "failures": failures}
    if count:
        line["acquisitions_recorded"] = seen[0]
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("lockrec_cost: no CUDA device", file=sys.stderr)
        return 1
    run("warm-up", True, count=True)
    lines = [run(i, on) for i, on in enumerate((False, True, True, False))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    secs = {on: statistics.median(x["seconds"] for x in lines if x["recorder"] == on)
            for on in (True, False)}
    print(json.dumps({"phase_s_on": secs[True], "phase_s_off": secs[False],
                      "failures": sum(len(x["failures"]) for x in lines)}))
    return 1 if any(x["failures"] for x in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
