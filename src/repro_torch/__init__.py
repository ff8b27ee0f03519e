"""PyTorch/CUDA port of the VESTA packed-spike Spikformer inference path.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core/``, ``kernels/``, ``infer/``, ``obs/``) and runs the int8
packed-spike serving path on an NVIDIA Hopper card through CUDA kernels
written by hand (``kernels/csrc``). It imports ``torch`` and never ``jax``
or ``repro``.

    from repro_torch.core.spikformer import SpikformerConfig, init
    from repro_torch.infer import ExecutionPlan, MicroBatchEngine, compile

    cfg = SpikformerConfig()
    params = init(torch.Generator().manual_seed(0), cfg)
    model = compile(params, cfg, ExecutionPlan(weight_dtype="int8"))  # cuda
    MicroBatchEngine(model).submit(images_u8).result()

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""
