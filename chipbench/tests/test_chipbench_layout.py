"""The benchmark's files and arithmetic, on the CPU: found by name, named
within the contract's characters, the frozen counts, the prefill mix, the
reference's imports and the whole-name check of forbidden modules."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench import frozen, guard, spec
from chipbench.drivers.prefill import lengths

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DEEPSEEK_V2_L8 = {
    "vocab_size": 102400, "d_model": 5120, "n_layers": 8, "n_heads": 128, "n_kv_heads": 128,
    "d_ff": 12288, "head_dim": 0, "block_pattern": ["mla"] * 8, "vocab_round": 256,
    "mla": {"q_lora": 1536, "kv_lora": 512, "qk_nope": 128, "qk_rope": 64, "v_head": 128},
    "moe": {"num_experts": 160, "top_k": 6, "d_expert": 1536, "num_shared": 2,
            "first_dense_layers": 1, "dense_d_ff": 12288}}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_harness_finds_each_cells_files_by_name(cell):
    w = spec.workload(cell)
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert tr["kind"] in ("train", "generate", "prefill")
    assert (HERE / "drivers" / f"{tr['kind']}.py").exists()
    assert spec.limits(cell), f"no limits for {cell}"
    reported = {m["name"] for m in spec.end_to_end_for(cell)}
    assert "setup_s" in reported and len(reported) >= 2
    layer = spec.per_layer_for(cell)
    assert layer
    for m in layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in reported


def test_names_units_and_lines_within_the_contract():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    lines = [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] \
        + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_block_as_run_matches_its_published_keys(name):
    cfg = spec.config(name)
    m = cfg["model"]
    assert m["d_model"] == cfg["hidden_size"]
    assert m["n_layers"] == cfg["num_hidden_layers"]
    assert m["n_heads"] == cfg["num_attention_heads"]
    assert m["n_kv_heads"] == cfg["num_key_value_heads"]
    assert m["vocab_size"] == cfg["vocab_size"]
    assert m["moe"]["top_k"] == cfg["num_experts_per_tok"]
    assert m["norm_eps"] == cfg["rms_norm_eps"] and m["rope_theta"] == cfg["rope_theta"]
    if "n_routed_experts" in cfg:
        assert m["moe"]["num_experts"] == cfg["n_routed_experts"]
        assert m["moe"]["d_expert"] == cfg["moe_intermediate_size"]
        assert m["moe"]["num_shared"] == cfg["n_shared_experts"]
        assert m["moe"]["first_dense_layers"] == cfg["first_k_dense_replace"]
        assert m["d_ff"] == m["moe"]["dense_d_ff"] == cfg["intermediate_size"]
        mla = m["mla"]
        assert (mla["q_lora"], mla["kv_lora"], mla["qk_nope"], mla["qk_rope"], mla["v_head"]) == (
            cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    else:
        assert m["moe"]["num_experts"] == cfg["num_local_experts"]
        assert m["moe"]["d_expert"] == cfg["intermediate_size"]
        assert m["head_dim"] == cfg["head_dim"]
    for key in cfg["reduced"]:
        assert cfg["published"][key] != cfg[key]


def test_frozen_model_flops_gives_the_hand_counts():
    g = frozen.Sizes.of(spec.config("granite-moe-3b-a800m-l16")["model"])
    D, L, hd = 1536, 16, 64
    per_layer = D * hd * (24 + 2 * 8) + 24 * hd * D + 3 * D * 512 * 8
    active = L * per_layer + D * 49408
    assert active == 478_543_872
    train_attn = 6.0 * L * 8 * 1024 ** 2 * 24 * hd
    assert frozen.model_flops(g, 8, 1024, "train") == 6.0 * active * 8 * 1024 + train_attn
    assert round(frozen.model_flops(g, 8, 1024, "train") / 1e12, 2) == 24.76
    for S in (1024, 2048, 3072, 4032):
        assert frozen.model_flops(g, 8, S, "prefill") == \
            2.0 * active * 8 * S + 2.0 * L * 8 * S ** 2 * 24 * hd
    # DeepSeek-V2's widths at 8 of 60 layers, for the decode arithmetic that
    # the mfu.decode and expert_bw_share.decode readers use
    d = frozen.Sizes.of(DEEPSEEK_V2_L8)
    D, H = 5120, 128
    mla = D * 1536 + 1536 * H * 192 + D * 576 + 512 * H * 256 + H * 128 * D
    active = 8 * mla + 3 * D * 12288 + 7 * 3 * D * 1536 * 8 + D * 102400
    assert frozen.model_flops(d, 8, 1152, "decode") == \
        2.0 * active * 8 + 2.0 * 8 * 8 * 2 * 1152 * H * 160
    need = frozen.decode_step_bytes(d, 8, 1152)
    assert need["routed"] == 7 * 48 * 3 * D * 1536 * 2


def test_flash_bound_from_shapes():
    # granite at 1000: the FLOPs bind (PR 21's 0.0249 ms reading of the same bound)
    t = frozen.flash_fwd_bound_s(8, 24, 8, 1000, 1000, 64, True)
    assert 0.0240e-3 < t < 0.0260e-3


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 17, 123456789])
def test_prefill_mix_is_the_same_multiset_for_every_seed(seed):
    lens = spec.traffic("prefill-b8mix")["prompt_lens"]
    order = lengths(seed, lens, 40 * len(lens))
    for c in range(40):
        assert sorted(order[c * len(lens):(c + 1) * len(lens)]) == sorted(lens)
    assert max(lens) + 1 <= spec.config("granite-moe-3b-a800m-l16")["max_position_embeddings"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "torch", "chipbench"}, tops
    assert not {n for n in _imports(path) if n.startswith("chipbench") and
                not n.startswith("chipbench.reference")}


def test_reference_loads_no_program_module():
    code = ("import sys; import chipbench.reference.moe_lm, chipbench.reference.adamw; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_whole_top_level_names_reject_jax_and_repro_allow_repro_torch():
    assert guard.forbidden(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                            "repro", "repro.core.api"]) == ["flax", "jax", "jaxlib", "repro"]
    assert guard.forbidden(["repro_torch", "repro_torch.models.lm", "reprox", "jaxtyping",
                            "chipbench.run"]) == []


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    cmd = [sys.executable, "-m", "chipbench.run", "--workload", BENCH["workloads"][0]["name"],
           "--seed", "2147483700", "--seconds", "1", "--trace", "0"]
    here = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    assert here.returncode != 0 and not here.stdout.strip()
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert alone.returncode != 0 and not alone.stdout.strip()
    assert "not in" in alone.stderr


@pytest.mark.parametrize("precision", ["fp8", "bf16"])
def test_control_precisions_round_each_product(precision):
    import torch
    from chipbench.reference.moe_lm import Prec
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    exact, low = Prec("fp32").mm(a, b), Prec(precision).mm(a, b)
    err = float((low - exact).norm() / exact.norm())
    if precision == "bf16":
        want = (a.bfloat16().float() @ b.bfloat16().float()).bfloat16().float()
        assert torch.equal(low, want)
        assert 1e-4 < err < 1e-2
    else:
        assert 1e-2 < err < 0.2
