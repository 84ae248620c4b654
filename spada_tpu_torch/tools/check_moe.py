"""One routed-expert layer's share (``models.moe.ExpertShard``) against the
plain layer (``models.moe_reference``) at DeepSeek-V3's widths, on the card.

    python -m spada_tpu_torch.tools.check_moe
    python -m spada_tpu_torch.tools.check_moe --shared --tokens 16384
    python -m spada_tpu_torch.tools.check_moe --dtype bfloat16 --tokens 16384
    python -m spada_tpu_torch.tools.check_moe --device cpu --hidden 256 \\
        --inter 128 --tokens 512

The card holds experts 0-7 of 256, as one card of 32 that share the layer
(EP32), and the shared expert with ``--shared``.  The tokens x are N(0, 1)
from ``SEED``, the weights the shard's own from ``SEED``; the router's
logits are N(0, 1) from ``ROUTING_SEED``, drawn as the benchmark's expert
cell draws them (NumPy's ``default_rng``, float32, [tokens, experts]), so
that the shard routes the cell's groups.  The shard runs both grouped
products through the port's main path with ``--dtype`` tiles (float32:
3xTF32; bfloat16: the lower precision); the reference runs in f32 with
TF32 off.  The error is max |y - y_ref| / max |y_ref|, judged against
``TOL``.  Prints one JSON line: the card, the layer's seconds and spans,
the largest group, the error, and whether it is within ``TOL``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the experts one card of an EP32 deployment holds: 0-7 of 256
EXPERTS_HELD = 8

#: the seed of the tokens and the weights
SEED = 1

#: the expert cell's ``routing_seed``
#: (``gpu_bench/configs/deepseek-v3-experts-ep32.json``)
ROUTING_SEED = 2025

#: the limit of the error: f32 sums over k = 7168 and 2048 differ by about
#: 1e-6 of the largest output in another order, bf16 tiles (8-bit
#: mantissa) by about 4e-3
TOL = 1e-4

#: DeepSeek-V3's MoE layer (config.json)
DEEPSEEK_V3 = dict(hidden_size=7168, moe_intermediate_size=2048,
                   n_routed_experts=256, num_experts_per_tok=8, n_group=8,
                   topk_group=4, norm_topk_prob=True,
                   routed_scaling_factor=2.5, n_shared_experts=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tokens", type=int, default=131072)
    p.add_argument("--shared", action="store_true",
                   help="the card that counts the shared expert")
    p.add_argument("--hidden", type=int, default=7168)
    p.add_argument("--inter", type=int, default=2048)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    args = p.parse_args(argv)

    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.convert import check_device, synchronize
    from spada_tpu_torch.models import moe_reference
    from spada_tpu_torch.models.moe import ExpertShard
    from spada_tpu_torch.utils import trace

    dev = check_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    config = dict(DEEPSEEK_V3, hidden_size=args.hidden,
                  moe_intermediate_size=args.inter)
    held = range(EXPERTS_HELD)
    shard = ExpertShard(config, held=held, shared=args.shared, device=dev,
                        seed=SEED,
                        spada_config=h100_config(
                            None if dev.type != "cuda" else name,
                            engine_dtype=args.dtype))
    x = torch.randn(args.tokens, args.hidden,
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    logits = torch.from_numpy(np.random.default_rng(
        ROUTING_SEED).standard_normal(
            (args.tokens, config["n_routed_experts"]),
            dtype=np.float32)).to(dev)
    trace.clear()
    t0 = time.perf_counter()
    y = shard(x, logits=logits)
    synchronize(dev)
    layer_s = time.perf_counter() - t0
    spans = {}
    for s in trace.spans():
        if s.parent is None:
            spans[s.name] = (spans.get(s.name, 0.0)
                             + (s.end_ns - s.start_ns) / 1e9)
    routed = trace.spans("moe.route")[-1].attrs
    plans = [s.attrs for s in trace.spans("plan")]
    t0 = time.perf_counter()
    want = moe_reference.expert_layer(x, shard.weights(), config, held=held,
                                      shared=args.shared, logits=logits)
    synchronize(dev)
    ref_s = time.perf_counter() - t0
    err = float((y - want).abs().max() / want.abs().max())
    print(json.dumps({
        "device": name, "tokens": args.tokens, "held": [held.start, held.stop],
        "shared": args.shared, "dtype": args.dtype, "layer_s": layer_s,
        "spans_s": spans, "route": routed, "plans": plans,
        "reference_s": ref_s, "max_abs_ref": float(want.abs().max()),
        "error": err, "tol": TOL, "within": err <= TOL}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
