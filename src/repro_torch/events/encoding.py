"""Event-stream → packed-plane-group encoding: the DVS front door (port of
``repro.events.encoding``; numpy throughout, so the streams, planes and
frames equal the reference's element for element).

A dynamic-vision-sensor (DVS) camera does not produce frames; it produces
a sparse stream of events ``(x, y, t_us, polarity)`` — one record per
pixel whose log-intensity crossed a threshold, ON (brighter) or OFF
(darker). That stream is ALREADY spike-form data: binary, temporal,
mostly silence. The packed plane-group representation the whole inference
datapath runs on (``core.spike.pack_timesteps``: bit j of group g =
timestep ``8g + j``) is its native encoding, and this module connects the
two WITHOUT the dense detour: ``encode_events_to_plane_groups`` time-bins
a window of events into ``ceil(T/8)`` uint8 plane groups by OR-ing each
event's bit directly into its byte — no (T, H, W, C) tensor is ever
materialized. ``rasterize_events`` builds exactly that dense tensor as
the test oracle: ``pack_timesteps(rasterize_events(...))`` must be
bit-identical to the direct encoding (``tests/test_torch_events.py``
pins it for T ∈ {1, 8, 9, 16, 17}, both polarities, empty windows
included).

Polarity is the channel axis: channel 0 = OFF, channel 1 = ON — two
binary channels, the DVS convention Spikformer-family models use for
CIFAR10-DVS / DVS128 Gesture.

The module also owns the per-window readouts serving calibrates with
(``window_occupancy`` → chunk occupancy for the zero-chunk-skipping
route's ``sparse_budget``; ``core.spike.packed_occupancy`` → firing
rate), the count-frame encoding (``events_to_frame``) that feeds a
window to the SSSC uint8 front end as a servable image, and seeded
synthetic DVS generators (``moving_edge_events``, ``flicker_burst_events``)
— deterministic stand-ins until real recordings land.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# polarity → channel: OFF (darker) = 0, ON (brighter) = 1
POLARITIES = 2


@dataclasses.dataclass(frozen=True)
class EventStream:
    """A sparse DVS event stream over a ``height`` x ``width`` sensor.

    Four parallel arrays, one entry per event: pixel column ``x``
    (int32, in [0, width)), pixel row ``y`` (int32, in [0, height)),
    microsecond timestamp ``t_us`` (int64, sorted non-decreasing — a
    camera emits in time order and every consumer here depends on it),
    and ``polarity`` (uint8, 0=OFF / 1=ON). Validation is loud and at
    construction: an out-of-range coordinate corrupts a plane silently
    if it reaches the encoder's scatter."""
    height: int
    width: int
    x: np.ndarray
    y: np.ndarray
    t_us: np.ndarray
    polarity: np.ndarray

    def __post_init__(self):
        if self.height < 1 or self.width < 1:
            raise ValueError(f"sensor must be at least 1x1, got "
                             f"{self.height}x{self.width}")
        arrays = {
            "x": np.asarray(self.x, np.int32),
            "y": np.asarray(self.y, np.int32),
            "t_us": np.asarray(self.t_us, np.int64),
            "polarity": np.asarray(self.polarity, np.uint8),
        }
        n = {len(a) for a in arrays.values()}
        if len(n) != 1:
            raise ValueError(
                f"event arrays must be parallel; got lengths "
                f"{ {k: len(v) for k, v in arrays.items()} }")
        for name, lo, hi in (("x", 0, self.width), ("y", 0, self.height),
                             ("polarity", 0, POLARITIES)):
            a = arrays[name]
            if a.size and (int(a.min()) < lo or int(a.max()) >= hi):
                raise ValueError(
                    f"event {name} values must lie in [{lo}, {hi}); got "
                    f"range [{int(a.min())}, {int(a.max())}]")
        t = arrays["t_us"]
        if t.size and np.any(np.diff(t) < 0):
            k = int(np.argmax(np.diff(t) < 0))
            raise ValueError(
                f"event timestamps must be sorted non-decreasing; "
                f"t_us[{k + 1}]={int(t[k + 1])} < t_us[{k}]={int(t[k])}")
        for name, a in arrays.items():
            object.__setattr__(self, name, a)

    def __len__(self) -> int:
        return len(self.x)

    def slice_time(self, lo_us: int, hi_us: int) -> "EventStream":
        """Events with ``lo_us <= t_us < hi_us`` (O(log n) on the sorted
        timestamps), as a new stream."""
        a = int(np.searchsorted(self.t_us, lo_us, side="left"))
        b = int(np.searchsorted(self.t_us, hi_us, side="left"))
        return EventStream(self.height, self.width, self.x[a:b],
                           self.y[a:b], self.t_us[a:b], self.polarity[a:b])

    def shift_time(self, delta_us: int) -> "EventStream":
        """The same events with ``delta_us`` added to every timestamp —
        how a trace stores window-relative times."""
        return EventStream(self.height, self.width, self.x, self.y,
                           self.t_us + np.int64(delta_us), self.polarity)


def empty_stream(height: int, width: int) -> EventStream:
    """An event stream with no events (an all-quiet window)."""
    z = np.zeros(0, np.int64)
    return EventStream(height, width, z, z, z, z)


def merge_streams(*streams: EventStream) -> EventStream:
    """Merge event streams over the SAME sensor into one time-sorted
    stream (stable: simultaneous events keep their argument order)."""
    if not streams:
        raise ValueError("merge_streams needs at least one stream")
    h, w = streams[0].height, streams[0].width
    for s in streams:
        if (s.height, s.width) != (h, w):
            raise ValueError(
                f"cannot merge streams over different sensors: "
                f"{h}x{w} vs {s.height}x{s.width}")
    t = np.concatenate([s.t_us for s in streams])
    order = np.argsort(t, kind="stable")
    return EventStream(
        h, w,
        np.concatenate([s.x for s in streams])[order],
        np.concatenate([s.y for s in streams])[order],
        t[order],
        np.concatenate([s.polarity for s in streams])[order])


# ---------------------------------------------------------------------------
# Encoding: events -> packed plane groups / dense rasterization / count frame
# ---------------------------------------------------------------------------

def encode_events_to_plane_groups(events: EventStream, *, t: int,
                                  window_us: int,
                                  t0_us: int = 0) -> np.ndarray:
    """Time-bin ``t`` windows of ``window_us`` starting at ``t0_us``
    straight into packed plane groups: ``(ceil(t/8), H, W, 2)`` uint8,
    bit j of group g set iff any event hit that pixel/polarity during
    bin ``8g + j`` — the exact layout ``core.spike.pack_timesteps``
    produces from a dense rasterization, built here by OR-ing one bit per
    event (the dense (T, H, W, C) tensor never exists; for a 128x128
    sensor at T=16 that detour would be 170x the size of the events).

    Events outside ``[t0_us, t0_us + t * window_us)`` are ignored — the
    caller slices its stream into windows; stragglers are its policy, not
    a silent wraparound here. Bits past ``t - 1`` in the last group stay
    zero (the packing invariant every popcount readout relies on)."""
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t!r}")
    if window_us < 1:
        raise ValueError(f"window_us must be >= 1, got {window_us!r}")
    g = -(-t // 8)
    planes = np.zeros((g, events.height, events.width, POLARITIES), np.uint8)
    if len(events):
        b = (events.t_us - np.int64(t0_us)) // window_us
        keep = (b >= 0) & (b < t)
        b = b[keep].astype(np.int64)
        np.bitwise_or.at(
            planes,
            (b >> 3, events.y[keep], events.x[keep], events.polarity[keep]),
            np.uint8(1) << (b & 7).astype(np.uint8))
    return planes


def rasterize_events(events: EventStream, *, t: int, window_us: int,
                     t0_us: int = 0) -> np.ndarray:
    """The dense detour, kept as the ORACLE: ``(t, H, W, 2)`` binary uint8
    spike planes (plane i = events in bin i). ``pack_timesteps`` of this
    must equal ``encode_events_to_plane_groups`` bit for bit — the
    equivalence test that proves the direct encoder; production code has
    no reason to call this."""
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t!r}")
    if window_us < 1:
        raise ValueError(f"window_us must be >= 1, got {window_us!r}")
    dense = np.zeros((t, events.height, events.width, POLARITIES), np.uint8)
    if len(events):
        b = (events.t_us - np.int64(t0_us)) // window_us
        keep = (b >= 0) & (b < t)
        dense[b[keep], events.y[keep], events.x[keep],
              events.polarity[keep]] = 1
    return dense


def events_to_frame(events: EventStream, *,
                    clip: int = 255) -> np.ndarray:
    """A window of events as a servable image: per-pixel/polarity event
    COUNTS, saturating at ``clip``, as ``(H, W, 2)`` uint8 — the standard
    DVS "event-count frame". This is what an ``EventStreamSession``
    submits: the SSSC front end consumes uint8 bit-planes natively, so a
    count frame rides the existing serving door (``validate_images``)
    with a model compiled at ``in_channels=2``."""
    if not 1 <= clip <= 255:
        raise ValueError(f"clip must be in [1, 255], got {clip!r}")
    counts = np.zeros((events.height, events.width, POLARITIES), np.int32)
    if len(events):
        np.add.at(counts, (events.y, events.x, events.polarity), 1)
    return np.minimum(counts, clip).astype(np.uint8)


def window_occupancy(planes: np.ndarray, *, t: int) -> float:
    """CHUNK occupancy of an encoded window: the fraction of live planes
    x pixels whose (≤8-channel) chunk holds at least one event — the
    quantity the zero-chunk-skipping route's ``sparse_budget`` and
    ``choose_route`` consume (``infer.backends.chunk_occupancy`` computes
    the same number on packed tensors; ``tests/test_torch_events.py`` pins
    the agreement). Per-window, this is the ingestion-time signal for
    sparse-route calibration: a quiet sensor window should be SERVED like
    the sparse batch it is."""
    g = planes.shape[0]
    if g != -(-t // 8):
        raise ValueError(f"{g} plane groups cannot hold t={t} bins")
    bits = np.unpackbits(planes[..., None], axis=-1, bitorder="little")
    # (g, H, W, C, 8) -> (g*8 planes, H, W): a plane's pixel-chunk is live
    # iff any channel fired that bin
    live = np.moveaxis(bits, -1, 1).reshape(g * 8, *planes.shape[1:-1],
                                            planes.shape[-1]).any(axis=-1)
    return float(live[:t].mean())


# ---------------------------------------------------------------------------
# Seeded synthetic DVS generators
# ---------------------------------------------------------------------------

def moving_edge_events(*, height: int, width: int, duration_us: int,
                       seed: int, sweeps: float = 1.0,
                       fire_prob: float = 0.9) -> EventStream:
    """A vertical edge sweeping left→right across the sensor ``sweeps``
    times over ``duration_us``: the edge's leading column fires ON, the
    trailing column fires OFF, each pixel with probability ``fire_prob``
    and jittered timing within its column's dwell. The classic
    moving-stimulus DVS pattern — steady event rate, spatially coherent.
    Deterministic from ``seed``."""
    if duration_us < 1 or sweeps <= 0:
        raise ValueError(f"need duration_us >= 1 and sweeps > 0, got "
                         f"{duration_us!r}, {sweeps!r}")
    rng = np.random.default_rng(seed)
    steps = max(1, int(round(sweeps * width)))
    dwell = duration_us / steps
    xs, ys, ts, ps = [], [], [], []
    for s in range(steps):
        col = s % width
        t_lo = s * dwell
        for polarity, x in ((1, col), (0, (col - 1) % width)):
            rows = np.flatnonzero(rng.random(height) < fire_prob)
            if not rows.size:
                continue
            jitter = rng.integers(0, max(1, int(dwell)), rows.size)
            xs.append(np.full(rows.size, x, np.int64))
            ys.append(rows.astype(np.int64))
            ts.append((int(t_lo) + jitter).astype(np.int64))
            ps.append(np.full(rows.size, polarity, np.int64))
    if not xs:
        return empty_stream(height, width)
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return EventStream(height, width,
                       np.concatenate(xs)[order], np.concatenate(ys)[order],
                       np.minimum(t[order], duration_us - 1),
                       np.concatenate(ps)[order])


def flicker_burst_events(*, height: int, width: int, duration_us: int,
                         seed: int, bursts: int = 4,
                         burst_us: int | None = None,
                         patch: int | None = None,
                         events_per_burst: int = 400) -> EventStream:
    """ON/OFF burst traffic: ``bursts`` flicker episodes evenly spaced
    over ``duration_us``, each confined to a random ``patch`` x ``patch``
    region and a ``burst_us`` span, dense inside and SILENT between — the
    arrival process that actually stresses a serving queue (a blinking
    LED / flickering luminaire in a DVS recording). Deterministic from
    ``seed``."""
    if duration_us < 1 or bursts < 1 or events_per_burst < 1:
        raise ValueError(f"need duration_us, bursts, events_per_burst >= 1, "
                         f"got {duration_us!r}, {bursts!r}, "
                         f"{events_per_burst!r}")
    patch = patch or max(1, min(height, width) // 4)
    if patch > min(height, width):
        raise ValueError(f"patch {patch} exceeds sensor {height}x{width}")
    period = duration_us // bursts
    burst_us = burst_us or max(1, period // 4)
    if burst_us > period:
        raise ValueError(f"burst_us={burst_us} exceeds the per-burst "
                         f"period {period}")
    rng = np.random.default_rng(seed)
    xs, ys, ts, ps = [], [], [], []
    for k in range(bursts):
        x0 = int(rng.integers(0, width - patch + 1))
        y0 = int(rng.integers(0, height - patch + 1))
        t_lo = k * period
        n = events_per_burst
        xs.append(rng.integers(x0, x0 + patch, n))
        ys.append(rng.integers(y0, y0 + patch, n))
        ts.append(t_lo + np.sort(rng.integers(0, burst_us, n)))
        ps.append(rng.integers(0, POLARITIES, n))
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return EventStream(height, width,
                       np.concatenate(xs)[order], np.concatenate(ys)[order],
                       np.minimum(t[order], duration_us - 1).astype(np.int64),
                       np.concatenate(ps)[order])
