"""The port's tensor-parallel serving on the CPU: two ranks over gloo
against the JAX package at ``tensor_parallel_size=2``.

One rank group serves the module (the ``ranks`` fixture: this process is
rank 0, one spawned process rank 1, every collective bounded by
``TIMEOUT_S``); each check builds its runners and engines on it, and each
one's shutdown returns the follower to its loop.

- ``shard_params`` then reassembly along ``shard_axis`` and
  ``shard_top_axis`` gives the tree back leaf for leaf (bf16, int8, int4,
  a tied table, a LoRA bank, MoE banks; ``embed`` and ``lm_head`` cut to
  ``[V, D/2]``, their int8 row scales whole), and
  ``init_params(shard=...)`` and ``load_hf_params(shard=...)`` give
  exactly the slice ``shard_params`` cuts; a model that does not split is
  refused.
- The tp-2 forward (a prefill, then a verify-shaped step with every
  position's logits) of Llama and Gemma-2, and Llama's encode, against
  the JAX ``Llama.forward`` and ``Llama.encode`` under the numerics
  oracle's ``_agree``.
- Greedy tokens of tp-2 engines through a lazy warmup, prefill,
  multi-step bursts, pipelined bursts and the speculative verify step
  equal a JAX engine's
  at ``tensor_parallel_size=2``; seeded sampled bursts draw the JAX
  engine's tokens and the same rows on both ranks (``rank_reports``).
- Pages leave a tp-2 engine whole, ``[L, bs, KH, hd]`` as at one rank,
  an uploaded page comes back bit for bit, and a small pool's swaps give
  the one-rank engine's tokens and swap counts.
- LoRA adapters and a mixture-of-experts model at tp 2 give the JAX
  engine's tokens.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.models.llama import (
    quantize_tree as jax_quantize_tree,
)
from production_stack_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from production_stack_tpu.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import (
    Llama,
    check_tp,
    config_from_hf_json,
    load_hf_params,
    shard_axis,
    shard_leaf,
    shard_params,
    shard_top_axis,
    tp_local_config,
)
from production_stack_tpu_torch.models.registry import get_model_config

from . import test_torch_gemma as gemma
from . import test_torch_model as model_test
from .test_numerics_oracle import _agree
from .test_torch_hf_load import _checkpoint
from .test_torch_kv_swap import LENGTHS, MAX_TOKENS, SMALL, SWAP_KEYS
from .test_torch_lora import _drive, make_adapter
from .test_torch_overlap_decode import PIPELINED, _reqs, _run
from .test_torch_spec_decode import _verify_steps
from .test_torch_spec_engine import RANDOM, REPEAT

TIMEOUT_S = 30.0
COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=128, max_num_seqs=8, max_prefill_tokens=64)
TP = dict(tensor_parallel_size=2, device="cpu")


@pytest.fixture(scope="module")
def ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multihost, "DISTRIBUTED_TIMEOUT_S", TIMEOUT_S)
        r = multihost.start_ranks(EngineConfig(**TP))
    yield r
    r.close()
    assert not any(p.is_alive() for p in r.procs)


@contextlib.contextmanager
def tp_engine(ranks, params=None, **kw):
    eng = LLMEngine(EngineConfig(**{**COMMON, **TP, **kw}), params=params,
                    ranks=ranks)
    try:
        yield eng
    finally:
        eng.shutdown()


@contextlib.contextmanager
def tp_runner(ranks, model_cfg, params, **kw):
    cfg = EngineConfig(**{**COMMON, **TP, "model": model_cfg.name, **kw})
    runner = ranks.build_runner(cfg, model_cfg, params)
    try:
        yield runner
    finally:
        ranks.publisher.shutdown()


def _same_rows(runner):
    reports = runner.rank_reports()
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["rows_digest"] == reports[1]["rows_digest"]
    assert reports[0]["graph_counts"] == reports[1]["graph_counts"]
    return reports


def _reassemble(shards):
    """The whole tree from its rank shards, along ``shard_axis`` (a layer
    leaf) and ``shard_top_axis`` (a top leaf)."""
    out = {"layers": {}}
    for k, v in shards[0]["layers"].items():
        axis = shard_axis(k)
        out["layers"][k] = (v if axis is None else
                            torch.cat([s["layers"][k] for s in shards], axis))
    for k, v in shards[0].items():
        if k == "layers":
            continue
        axis = shard_top_axis(k)
        if axis is None:  # the whole top leaves are the same on every rank
            for s in shards[1:]:
                assert torch.equal(s[k], v), k
            out[k] = v
        else:
            out[k] = torch.cat([s[k] for s in shards], axis)
    return out


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_shard_params_reassembles_every_tree(tmp_path):
    # 16 heads: wo's 256 input rows split into whole 128-row int4 groups.
    base = dataclasses.replace(get_model_config("tiny-llama-debug"),
                               num_heads=16, num_kv_heads=16,
                               attention_bias=True)
    moe = dataclasses.replace(base, num_experts=4, attention_bias=False)
    tied = dataclasses.replace(base, tie_word_embeddings=True)
    cpu = torch.device("cpu")
    for cfg, quant, lora in ((base, None, False), (base, "int8", False),
                             (base, "int4", False), (base, None, True),
                             (tied, "int8", False),
                             (moe, None, False), (moe, "int4", False)):
        model = Llama(cfg)
        tree = model.init_params(torch.Generator().manual_seed(3), cpu,
                                 quantization=quant)
        if lora:
            bank = model.init_lora_bank(2, 4, cpu)
            for v in bank.values():
                v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(v.numel())))
            tree["layers"].update(bank)
        shards = [shard_params(tree, cfg, r, 2) for r in (0, 1)]
        _equal_trees(_reassemble(shards), tree)
        assert shards[0]["layers"]["wq"].shape[-1] == tp_local_config(
            cfg, 2).q_size
        tables = ("embed",) if cfg.tie_word_embeddings else ("embed",
                                                            "lm_head")
        assert [k for k in tree if k in ("embed", "lm_head")] == list(tables)
        for r in (0, 1):  # D/2 columns of each table; row scales whole
            for k in tables:
                assert shards[r][k].shape == (cfg.vocab_size,
                                              cfg.hidden_size // 2)
                if quant:
                    assert torch.equal(shards[r][k + "_qs"], tree[k + "_qs"])
        if not lora:  # drawn whole and cut: the same slice
            for r in (0, 1):
                _equal_trees(model.init_params(
                    torch.Generator().manual_seed(3), cpu,
                    quantization=quant, shard=(r, 2)), shards[r])
        if lora:  # an adapter's host arrays cut as the bank
            a = tree["layers"]["lora_a_wo"].float().numpy()
            assert np.array_equal(shard_leaf("lora_a_wo", a, 1, 2),
                                  shards[1]["layers"]["lora_a_wo"]
                                  .float().numpy())
    # A checkpoint is cut on read: the whole tree's shards (Qwen2's biases
    # and GQA; int8 scales of the row-parallel wo and w_down stay whole;
    # Gemma's one tied table).
    for model_type in ("qwen2", "gemma"):
        path = _checkpoint(tmp_path / model_type, model_type)
        cfg = config_from_hf_json(f"{path}/config.json")
        for quant in (None, "int8"):
            whole = load_hf_params(cfg, path, quantize=quant)
            for r in (0, 1):
                _equal_trees(load_hf_params(cfg, path, quantize=quant,
                                            shard=(r, 2)),
                             shard_params(whole, cfg, r, 2))
    tiny = get_model_config("tiny-llama-debug")
    check_tp(tiny, 2)
    with pytest.raises(ValueError, match="int4 wo"):
        check_tp(tiny, 2, "int4")  # 64 rows of a 128-row group
    with pytest.raises(ValueError, match="num_heads=8 is not divisible"):
        check_tp(tiny, 3)


def _on_tp2_mesh(jmodel, jparams, quant):
    """``jparams`` placed by ``param_pspecs`` on a tp-2 mesh of the
    conftest's virtual CPU devices: the JAX forward and encode then run at
    ``tensor_parallel_size=2``, each table cut on its hidden dim."""
    mesh = build_mesh(JaxMeshConfig(tensor_parallel_size=2),
                      jax.devices()[:2])
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams,
        jmodel.param_pspecs(quantize=quant or False))


def _near_bf16(got, want, label):
    """The repo's rule for bf16 against JAX, 3e-2 * max|want|
    (``test_torch_model.test_forward_bfloat16_near_jax``): the packages
    round intermediate bf16 values at different points, one rank or two."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * float(np.abs(want).max()),
                               err_msg=label)


def test_forward_and_encode_match_jax(ranks):
    """Llama and the tied Gemma-2 (post-block norms after the reduce,
    softcaps) at tp 2 in fp32, forward (a prefill, then a verify-shaped
    step with every position's logits) and encode, against the JAX
    ``forward`` and ``encode`` at ``tensor_parallel_size=2`` under
    ``_agree``, every norm weight moved off 1. Each rank holds ``D/2``
    columns of each table: its lookup is gathered and its partial logits
    summed, one ``tp_vocab`` call each (two a forward step). Mixtral's
    reduce after the experts' combine is held by its engine's tokens
    below."""
    _forward_and_encode(ranks, "float32", None)


@pytest.mark.parametrize("dtype,quant", [("float32", "int8"),
                                         ("bfloat16", None)],
                         ids=["int8", "bf16"])
def test_forward_and_encode_match_jax_quantized_and_bf16(ranks, dtype,
                                                         quant):
    """The same in int8 (a JAX ``quantize_tree`` output: the tables' int8
    rows cut, their row scales whole) under ``_agree``, and in bf16 under
    the repo's bf16 rule."""
    _forward_and_encode(ranks, dtype, quant)


def _forward_and_encode(ranks, dtype, quant):
    agree = _agree if dtype == "float32" else _near_bf16
    prefill, verify = _verify_steps(512)
    names = ("tokens", "positions", "write_idx", "block_tables", "kv_lens",
             "last_idx")
    toks = np.array(REPEAT + RANDOM, np.int32)
    for name in ("tiny-llama-debug", "tiny-gemma2-debug"):
        jcfg, tcfg = gemma._configs(name, dtype=dtype)
        jmodel = JaxLlama(jcfg)
        jparams = gemma._jax_params(jmodel)  # every norm off 1
        if quant:
            jparams = jax_quantize_tree(jparams, quant)
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
        jparams = _on_tp2_mesh(jmodel, jparams, quant)
        jforward = jax.jit(jmodel.forward,
                           static_argnames=("attn_impl", "all_logits"))
        jcache = jmodel.make_kv_cache(model_test.NB, model_test.BS)
        with tp_runner(ranks, tcfg, params, num_kv_blocks=model_test.NB,
                       block_size=model_test.BS) as runner:
            assert runner.kv_cache.shape[-1] == tcfg.kv_size // 2
            assert runner.params["embed"].shape == (tcfg.vocab_size,
                                                    tcfg.hidden_size // 2)
            before = runner.rank_reports()
            for step, all_logits in ((prefill, False), (verify, True)):
                want, jcache = jforward(
                    jparams, *(jnp.asarray(a) for a in step), jcache,
                    attn_impl="gather", all_logits=all_logits)
                got = runner.forward_logits(dict(zip(names, step)),
                                            all_logits=all_logits)
                want = np.asarray(want)
                for row in ((0, 2) if all_logits else (0,)):
                    agree(got.numpy()[row], want[row], f"{name} {row}")
            want = np.asarray(jax.jit(jmodel.encode)(
                jparams, jnp.asarray(toks[None]),
                jnp.asarray([len(toks)], jnp.int32)))[0]
            agree(runner.encode(toks.tolist()), want, f"{name} encode")
            padded = runner.encode_input(toks.tolist())[0].size
            after = runner.rank_reports()
        for b, a in zip(before, after):
            vocab = {k: a["traffic"]["tp_vocab"][k]
                     - b["traffic"]["tp_vocab"][k] for k in ("calls", "bytes")}
            width = tcfg.hidden_size * tcfg.torch_dtype.itemsize
            assert vocab == {"calls": 5, "bytes": (
                (prefill[0].size + verify[0].size) * width  # the gathers
                + (prefill[0].shape[0] + verify[0].size)
                * tcfg.vocab_size * 4  # the fp32 logits
                + padded * width)}, vocab  # the encode's gather


@pytest.fixture(scope="module")
def jax_tp2():
    return JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        tensor_parallel_size=2, **COMMON))


def _tokens(engine, requests):
    return _run(engine, requests)[1]


def test_greedy_tokens_match_the_jax_engine(ranks, jax_tp2):
    params = params_from_jax(jax.tree.map(np.asarray, jax_tp2.runner.params))
    rng = np.random.default_rng(5)
    prompts = [REPEAT, RANDOM, rng.integers(1, 500, 45).tolist(), REPEAT[3:]]

    def reqs(sp_cls):
        return [(f"g{i}", p, sp_cls(max_tokens=10, temperature=0.0,
                                    ignore_eos=True))
                for i, p in enumerate(prompts)]

    want = _tokens(jax_tp2, reqs(JaxSamplingParams))
    modes = {"bursts": dict(num_decode_steps=4, overlap_decode=False),
             "pipelined": dict(num_decode_steps=4, **PIPELINED),
             "verify": dict(speculative_ngram=3, overlap_decode=False)}
    for mode, over in modes.items():
        with tp_engine(ranks, params, **over) as eng:
            if mode == "bursts":  # warmup's buckets run on both ranks
                assert eng.precompile(mode="lazy")["buckets_compiled"] > 0
            assert _tokens(eng, reqs(SamplingParams)) == want, mode
            _same_rows(eng.runner)
            if mode == "pipelined":
                assert eng.pipelined_bursts_total > 0
            if mode == "verify":
                assert eng.spec_proposed_total > 0
            stats = eng.stats()
            assert stats["tensor_parallel_size"] == 2.0
            assert stats["tp_device_backend"] == "gloo"
            assert stats["tp_rank_devices"] == "0/cpu,0/cpu"


def test_seeded_sampling_draws_alike_on_every_rank(ranks, jax_tp2):
    params = params_from_jax(jax.tree.map(np.asarray, jax_tp2.runner.params))

    def reqs(sp_cls):
        return _reqs((21, 9, 33), (12, 16, 10), sp_cls, temperature=0.9,
                     top_p=0.95, seed=17)

    want = _tokens(jax_tp2, reqs(JaxSamplingParams))
    with tp_engine(ranks, params, num_decode_steps=4, **PIPELINED) as eng:
        assert _tokens(eng, reqs(SamplingParams)) == want
        assert eng.pipelined_bursts_total > 0
        _same_rows(eng.runner)


def test_pages_move_in_the_one_rank_layout(ranks, jax_tp2):
    """Pages against a one-rank port engine's (whose pages and swaps
    test_torch_kv_swap.py holds against the JAX runner and engine)."""
    params = params_from_jax(jax.tree.map(np.asarray, jax_tp2.runner.params))
    one = LLMEngine(EngineConfig(device="cpu", **COMMON), params=params)
    prompt = list(range(5, 45))
    sp = SamplingParams(max_tokens=1, temperature=0.0)
    one.generate([prompt], sp)
    cfg = get_model_config("tiny-llama-debug")
    with tp_engine(ranks, params) as eng:
        eng.generate([prompt], sp)
        for b in range(3):  # the prompt's first pages: blocks 0, 1, 2
            got = eng.runner.download_page(b)
            want = one.runner.download_page(b)
            for g, w in zip(got, want):
                assert g.shape == w.shape == (cfg.num_layers, 8,
                                              cfg.num_kv_heads, 16)
                assert torch.equal(g[0], w[0])  # layer 0: no reduce yet
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        free = eng.runner.num_blocks - 1
        eng.runner.upload_page(free, *want)
        for g, w in zip(eng.runner.download_page(free), want):
            assert torch.equal(g, w)
    over = dict(SMALL, kv_swap=True, swap_quantum_tokens=16)
    one = LLMEngine(EngineConfig(device="cpu", **over), params=params)
    _, want = _run(one, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                              temperature=0.0))
    with tp_engine(ranks, params, **over) as eng:
        _, got = _run(eng, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                                 temperature=0.0))
        assert got == want
        for key in SWAP_KEYS:
            assert eng.stats().get(key) == one.stats().get(key), key
        assert eng.stats()["kv_swap_in_total"] > 0


def test_lora_and_moe_match_the_jax_engine(ranks, tmp_path):
    lora = dict(enable_lora=True, max_loras=2, max_lora_rank=8,
                lora_dir=str(tmp_path))
    p1 = make_adapter(tmp_path, "ad1")
    make_adapter(tmp_path, "ad2", targets=("q_proj", "v_proj", "o_proj"),
                 seed=2)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        tensor_parallel_size=2,
                                        **COMMON, **lora))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    reqs = [("base", REPEAT, None, 10), ("a1", RANDOM, "ad1", 10),
            ("a2", REPEAT[2:], "ad2", 12)]
    with tp_engine(ranks, params, overlap_decode=False, **lora) as eng:
        for e in (jeng, eng):
            assert e.load_lora("ad1", p1).slot == 1
            assert e.load_lora("ad2").slot == 2
        assert _drive(eng, reqs, SamplingParams) == _drive(
            jeng, reqs, JaxSamplingParams)
        assert eng.unload_lora("ad1")
        _same_rows(eng.runner)

    moe = dict(COMMON, model="tiny-mixtral-debug")
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        tensor_parallel_size=2, **moe))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    requests = lambda cls: _reqs((50, 13), (10, 12), cls,  # noqa: E731
                                 temperature=0.0)
    want = _tokens(jeng, requests(JaxSamplingParams))
    with tp_engine(ranks, params, num_decode_steps=4, **{
            **moe, "overlap_decode": False}) as eng:
        assert eng.runner.params["layers"]["w_gate"].shape[-1] == 128
        assert _tokens(eng, requests(SamplingParams)) == want
