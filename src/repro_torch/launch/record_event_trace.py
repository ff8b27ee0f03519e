"""Regenerate the committed synthetic DVS mini-trace fixture (port of
``scripts/record_event_trace.py``; the same file, byte for byte).

    PYTHONPATH=src python -m repro_torch.launch.record_event_trace \\
        --out benchmarks/traces/dvs_synth_mini.jsonl

The fixture is the deterministic synthetic trace the event-serving smoke
replays: a moving edge over the first quarter (steady arrivals) followed
by flicker bursts (ON/OFF arrival bursts with silent gaps; empty windows
are skipped at capture, so the burstiness survives into the arrival
process). Same seed, byte-identical file. The header's ``meta`` names the
reference's script as the generator, so a re-recording equals the
committed file.
"""
from __future__ import annotations

import argparse
import json

from ..events import record_trace
from .serve_spikformer import synth_event_trace

GENERATOR = "scripts/record_event_trace.py"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="benchmarks/traces/dvs_synth_mini.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--height", type=int, default=16)
    ap.add_argument("--width", type=int, default=16)
    args = ap.parse_args(argv)

    trace = synth_event_trace(seed=args.seed, height=args.height,
                              width=args.width)
    n = record_trace(
        args.out, height=trace.height, width=trace.width,
        window_us=trace.window_us, bins=trace.bins, payload=trace.payload,
        arrivals=trace.arrivals,
        meta={"generator": GENERATOR, "seed": args.seed})
    events = sum(len(a.events) for a in trace.arrivals)
    summary = {"out": args.out, "arrivals": n, "events": events,
               "duration_s": trace.duration_s,
               "sensor": [trace.height, trace.width]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
