"""Serve a DVS event stream on the port, synthetic camera to per-window
predictions (on the card unless ``--device cpu`` asks for the CPU):

1. generate a deterministic DVS stream (a moving edge + flicker bursts);
2. show the direct event-to-plane-group encoding and its occupancy;
3. stream the events through an ``EventStreamSession`` over the async
   serving runtime: watermark windowing, per-window labels, explicit
   shedding under backpressure;
4. capture the run as a versioned JSONL trace and replay it, checking the
   replay reproduces the live run's labels bit for bit.

  PYTHONPATH=src python examples/torch_serve_events.py [--window-ms 20]
      [--duration-ms 400] [--seed 0] [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.core.spikformer import SpikformerConfig, init
from repro_torch.events import (EventStreamSession,
                                encode_events_to_plane_groups,
                                flicker_burst_events, load_trace,
                                merge_streams, moving_edge_events,
                                replay_trace, window_occupancy)
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.serve import AsyncServeRuntime, ServePolicy

H = W = 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--window-ms", type=float, default=20.0,
                    help="serving window duration (sensor time)")
    ap.add_argument("--duration-ms", type=float, default=400.0,
                    help="synthetic stream duration (sensor time)")
    ap.add_argument("--slo-ms", type=float, default=2_000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    window_us = int(args.window_ms * 1_000)
    duration_us = int(args.duration_ms * 1_000)
    out = {}

    # -- 1. a deterministic synthetic DVS stream -----------------------------
    stream = merge_streams(
        moving_edge_events(height=H, width=W, duration_us=duration_us,
                           seed=args.seed),
        flicker_burst_events(height=H, width=W, duration_us=duration_us,
                             seed=args.seed + 1, bursts=3))
    out["stream"] = {"events": len(stream), "sensor": [H, W],
                     "duration_ms": args.duration_ms}
    print(json.dumps(out["stream"]))

    # -- 2. direct encoding: events -> packed plane groups -------------------
    planes = encode_events_to_plane_groups(
        stream.slice_time(0, window_us), t=8, window_us=window_us // 8)
    out["encoding"] = {"plane_groups": int(planes.shape[0]),
                       "encoded_shape": list(planes.shape),
                       "chunk_occupancy":
                           round(window_occupancy(planes, t=8), 4)}
    print(json.dumps(out["encoding"]))

    # -- 3. stream through the serving stack ---------------------------------
    # a DVS-shaped model: 2 input channels (OFF/ON), sensor-sized
    cfg = dataclasses.replace(
        SpikformerConfig().scaled(img_size=H, dim=32, depth=1),
        in_channels=2)
    params = init(torch.Generator().manual_seed(args.seed), cfg)
    model = compile(params, cfg, ExecutionPlan(batch_buckets=(2, 8)),
                    device=args.device)
    print(json.dumps({"compile_s": round(model.warmup(), 3),
                      "in_channels": cfg.in_channels}))

    policy = ServePolicy(max_wait_ms=10.0, slo_ms=args.slo_ms,
                         max_queue_images=64)
    fd, trace_path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        with AsyncServeRuntime(model, policy=policy) as rt:
            session = EventStreamSession(
                rt, window_us=window_us, height=H, width=W, capture=True,
                on_window=lambda w, label: print(json.dumps(
                    {"window": w, "label": label})))
            # feed in camera-sized chunks: the watermark closes and serves
            # each window as the stream moves past it
            chunk_us = max(1, duration_us // 10)
            for lo in range(0, duration_us, chunk_us):
                session.feed(stream.slice_time(lo, lo + chunk_us))
            session.close()
            live_labels = session.labels()
            out["session"] = session.stats()
            print(json.dumps({"session": out["session"],
                              "occupancy_trace": session.occupancy_trace(),
                              "queue_depth_peak":
                                  rt.stats()["queue_depth_peak"]}))
            # -- 4. capture -> trace file -> replay --------------------------
            session.save_trace(trace_path, meta={"example": "serve_events"})

        with AsyncServeRuntime(model, policy=policy) as rt2:
            m = replay_trace(load_trace(trace_path), rt2, slo_ms=args.slo_ms)
    finally:
        os.unlink(trace_path)
    replay_labels = [lab[0] for lab in m["labels"]]
    match = replay_labels == [live_labels[w] for w in sorted(live_labels)]
    out["replay"] = {
        "windows": m["windows"],
        "goodput_fps": m["goodput_fps"],
        "slo_attainment": m["slo_attainment"],
        "dispersion_index": m["dispersion_index"],
        "labels_sha": m["labels_sha"],
        "labels_match_live_run": match,
    }
    print(json.dumps({"replay": out["replay"]}))
    assert match, "replay must reproduce the live run's labels"
    out["live_labels"] = live_labels
    return {**out, "model": model}


if __name__ == "__main__":
    main()
