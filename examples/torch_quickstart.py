"""Quickstart on the PyTorch/CUDA port: the VESTA core in six snippets,
each on the card unless ``--device cpu`` asks for the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card, snippet 2 runs the grouped unpack dot (``per_plane``, f32
weights at one plane group) and the shift-sum kernel, snippet 3 the TFLIF
kernel at T=12, snippet 4 the f32 STDP kernel, and snippet 6 the packed
int8 model at T=16 through the kernels its plan routes to.
"""
import argparse

import torch

from repro_torch.core.lif import bn_init, fold_bn
from repro_torch.core.spike import pack_bits, unpack_bits
from repro_torch.core.spikformer import SpikformerConfig, apply, init
from repro_torch.device import resolve_device
from repro_torch.infer import ExecutionPlan, compile
from repro_torch.kernels import ops
from repro_torch.kernels.stdp_attention import stdp_attention


def shape(t) -> tuple:
    return tuple(t.shape)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)

    def uniform(seed, size):
        return torch.rand(size, generator=gen.manual_seed(seed), device=dev)

    def normal(seed, size):
        return torch.randn(size, generator=gen.manual_seed(seed), device=dev)

    out = {"device": str(dev)}

    # --- 1. spikes are bits: pack 8 planes per byte -------------------------
    spikes = uniform(0, (4, 128)) < 0.3
    packed = pack_bits(spikes.to(torch.float32), axis=-1)   # 128 bits -> 16 B
    assert bool((unpack_bits(packed) == spikes).all())
    print(f"1) spikes {shape(spikes)} ({spikes.numel()} bits) packed -> "
          f"{shape(packed)} uint8 = {packed.numel()} bytes (8x smaller than "
          f"int8)")
    out["packed"] = shape(packed)

    # --- 2. the unified PE: one kernel, four dataflows -----------------------
    x_packed = torch.randint(0, 256, (64, 96), generator=gen.manual_seed(1),
                             device=dev, dtype=torch.uint8)
    w = normal(2, (96, 32))
    per_plane = ops.spike_matmul(x_packed, w, mode="per_plane")  # WSSL/ZSC/STDP
    shift_sum = ops.spike_matmul(x_packed, w, mode="shift_sum")  # SSSC
    print(f"2) unified PE: per_plane {shape(per_plane)} (8 timestep-planes), "
          f"shift_sum {shape(shift_sum)} (8-bit input reconstructed)")
    out["per_plane"], out["shift_sum"] = shape(per_plane), shape(shift_sum)

    # --- 3. TFLIF: BN folded into bias, spikes packed on the way out ---------
    kern = normal(3, (96, 32))
    kf, bf = fold_bn(kern, None, {k: v.to(dev) for k, v in bn_init(32).items()})
    acc = normal(4, (12, 32 * 64)) * 2
    packed_out = ops.tflif_pack(acc, bf.repeat(64))
    print(f"3) TFLIF: {shape(acc)} accumulators -> {shape(packed_out)} uint8 "
          f"plane groups (bit j of group g = timestep 8g+j; BN never ran as "
          f"a layer; T=12 -> ceil(12/8)=2 groups, membrane carried across)")
    out["tflif"] = shape(packed_out)

    # --- 4. STDP: softmax-free attention, V consumed as produced -------------
    q = (uniform(5, (8, 256, 64)) < 0.25).to(torch.float32)
    att = stdp_attention(q, q, q, scale=0.125)
    print(f"4) STDP attention {shape(att)}: exact, tile-fused, no N x N "
          f"scores in memory")
    out["stdp"] = shape(att)

    # --- 5. Spikformer V2 end to end -----------------------------------------
    cfg = SpikformerConfig().scaled()          # CPU-sized
    params = init(torch.Generator().manual_seed(6), cfg)
    img = torch.randint(0, 256, (2, 32, 32, 3), generator=gen.manual_seed(7),
                        device=dev, dtype=torch.uint8)
    logits, _ = apply(to_device(params, dev), img, cfg)
    print(f"5) Spikformer V2 (reduced): image {shape(img)} -> logits "
          f"{shape(logits)}, all inter-layer traffic binary spikes")
    out["logits"] = shape(logits)

    # --- 6. packed inference: compile once under a plan, any T, int8 ---------
    cfg16 = cfg.scaled(timesteps=16)           # T=16 -> 2 plane groups
    plan = ExecutionPlan(backend="packed", weight_dtype="int8",
                         batch_buckets=(2,))
    model = compile(params, cfg16, plan, device=dev)
    logits16 = model.logits(img)
    print(f"6) packed int8 inference at T=16: logits {shape(logits16)} "
          f"(uint8 plane-group activations, int8 weights, scale folded into "
          f"the LIF threshold; plan routes {len(model.plan.routes)} layers, "
          f"serializable via model.plan.to_json())")
    out["logits_t16"] = shape(logits16)
    out["routes"] = len(model.plan.routes)
    print("quickstart OK")
    return {**out, "model": model}


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


if __name__ == "__main__":
    main()
