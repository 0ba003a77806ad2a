"""Tiny configurations and traffic of the cells' kinds, for the CPU tests:
the same code paths as the cells, at sizes a test run holds."""

from __future__ import annotations

import copy
import time

from chipbench import spec

GRANITE = "granite-moe-3b-a800m-l16"
MLA = "tiny-mla-moe"

#: the generate kind on latent attention and routed plus shared experts (the
#: MLA path of the reference), which no cell of BENCHMARK.json runs yet
#: (PERF.md, Open questions): a test cell of its own, with the traffic file
#: a later decode cell can name
DECODE = "tiny-mla-moe.decode-b8p1024g256"
TEST_CELLS = {DECODE: {"config": MLA, "traffic": "decode-b8p1024g256"}}

#: a model block of DeepSeek-V2's layout (the first layer dense, then MLA
#: and MoE with shared experts) at tiny widths
MLA_MODEL = {
    "name": MLA, "vocab_size": 500, "d_model": 64, "n_layers": 2, "n_heads": 4,
    "n_kv_heads": 4, "d_ff": 96, "head_dim": 0, "block_pattern": ["mla", "mla"],
    "mlp_act": "silu", "rope_theta": 10000.0, "norm_eps": 1e-06, "vocab_round": 256,
    "loss_chunk": 16, "remat": True, "remat_policy": "nothing", "sharding_profile": "tp",
    "param_dtype": "bfloat16", "compute_dtype": "bfloat16",
    "mla": {"q_lora": 32, "kv_lora": 16, "qk_nope": 16, "qk_rope": 8, "v_head": 16},
    "moe": {"num_experts": 8, "top_k": 2, "d_expert": 32, "num_shared": 1,
            "first_dense_layers": 1, "dense_d_ff": 96, "capacity_factor": 1.0,
            "serve_capacity_factor": 3.0, "aux_loss_weight": 0.001, "group_tokens": 32,
            "map_chunk_groups": 4096, "dropless": False},
}


def config(name: str) -> dict:
    if name == MLA:
        return {"name": MLA, "reference": "moe_lm", "model": copy.deepcopy(MLA_MODEL)}
    cfg = copy.deepcopy(spec.config(name))
    m = cfg["model"]
    m.update(vocab_size=500, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=32, loss_chunk=16)
    m["moe"].update(num_experts=8, top_k=2, d_expert=32, group_tokens=32)
    return cfg


def traffic(name: str) -> dict:
    tr = copy.deepcopy(spec.traffic(name))
    if tr["kind"] == "train":
        tr.update(batch=2, seq_len=32, shards=2, records_per_shard=16, trace_steps=1)
    elif tr["kind"] == "generate":
        tr.update(batch=3, prompt_len=16, gen=8, warmup_gen=2, trace_steps=2)
    else:
        tr.update(batch=2, prompt_lens=[16, 24, 32, 40], max_len=48, trace_batches=2)
    return tr


def ctx(workload: str, seed: int = 5, seconds: float = 0.0, **kw):
    import torch
    from chipbench.harness import Ctx
    cell = TEST_CELLS.get(workload) or spec.workload(workload)
    return Ctx(workload=workload, config=config(cell["config"]),
               traffic=traffic(cell["traffic"]), seed=seed, seconds=seconds,
               trace=kw.pop("trace", False), device=torch.device("cpu"), t_start=time.perf_counter(), **kw)
