"""The port's pipeline parallelism on the CPU: two stages over gloo
against the one-rank port and the JAX package at
``pipeline_parallel_size=2``.

One rank group serves the module (the ``ranks`` fixture: this process is
stage 0, one spawned process stage 1, every collective bounded by
``TIMEOUT_S``); each check builds its runners and engines on it.

- ``stage_params`` then reassembly along the layer axis gives the tree
  back leaf for leaf (bf16, int8, int4, a LoRA bank, MoE banks), and
  ``init_params(stage=...)`` and ``load_hf_params(stage=...)`` give
  exactly the cut ``stage_params`` makes, alone and under a ``tp``
  shard; a model whose layers do not split is refused.
- The pp-2 forward (a prefill, then a verify-shaped step with every
  position's logits) equals the one-rank port's bit for bit (no reduce
  enters) and agrees with the JAX ``Llama.forward`` under the numerics
  oracle's ``_agree``: Llama, and a 6-layer ``tiny-gemma2-debug`` whose
  second stage starts on the odd layer 3 (the window pattern follows the
  global index, the cache the stage-local one), over a prompt longer
  than its window; Llama's encode too.
- Greedy tokens of pp-2 engines through a lazy warmup, bursts, pipelined
  bursts and the verify step equal a JAX engine's at
  ``pipeline_parallel_size=2``; seeded sampled bursts draw its tokens and
  the same rows on both stages.
- Pages leave a pp-2 engine whole, ``[L, bs, KH, hd]`` as at one rank,
  an uploaded page comes back bit for bit, and a small pool's swaps give
  the one-rank engine's tokens and swap counts.

The helpers below (``parallel_ranks``, ``check_engines``,
``check_pages``) serve the dp-2 and dp2 x pp2 modules as well.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import (
    Llama,
    check_pp,
    config_from_hf_json,
    load_hf_params,
    rank_local_config,
    shard_params,
    stage_leaf,
    stage_params,
)
from production_stack_tpu_torch.models.registry import get_model_config

from . import test_torch_gemma as gemma
from . import test_torch_model as model_test
from .test_numerics_oracle import _agree
from .test_torch_hf_load import _checkpoint
from .test_torch_kv_swap import LENGTHS, MAX_TOKENS, SMALL, SWAP_KEYS
from .test_torch_overlap_decode import PIPELINED, _reqs, _run
from .test_torch_spec_decode import _verify_steps
from .test_torch_spec_engine import RANDOM, REPEAT

TIMEOUT_S = 30.0
COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=128, max_num_seqs=8, max_prefill_tokens=64)
PP = dict(pipeline_parallel_size=2, device="cpu")
NAMES = ("tokens", "positions", "write_idx", "block_tables", "kv_lens",
         "last_idx")


@contextlib.contextmanager
def parallel_ranks(layout):
    """A module's rank group of ``layout`` (the parallel sizes), every
    collective bounded by ``TIMEOUT_S``; no rank left alive after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multihost, "DISTRIBUTED_TIMEOUT_S", TIMEOUT_S)
        r = multihost.start_ranks(EngineConfig(**layout))
    try:
        yield r
    finally:
        r.close()
        assert not any(p.is_alive() for p in r.procs)


@pytest.fixture(scope="module")
def ranks():
    with parallel_ranks(PP) as r:
        yield r


@contextlib.contextmanager
def engine_on(ranks, layout, params=None, **kw):
    eng = LLMEngine(EngineConfig(**{**COMMON, **layout, **kw}),
                    params=params, ranks=ranks)
    try:
        yield eng
    finally:
        eng.shutdown()


def _tokens(engine, requests):
    return _run(engine, requests)[1]


def same_rows_and_replicas(runner, layout):
    """Every rank's rows digest and graph counts equal, and the ranks
    that differ only in ``dp`` hold equal caches, bit for bit."""
    reports = runner.rank_reports()
    n = runner.cfg.num_ranks
    assert [r["rank"] for r in reports] == list(range(n))
    assert len({r["rows_digest"] for r in reports}) == 1
    assert len({str(r["graph_counts"]) for r in reports}) == 1
    assert all(r["layers"] == runner.local_cfg.num_layers for r in reports)
    parts = runner.page_replicas(list(range(runner.num_blocks)))
    grid = runner.ranks.grid
    for r in range(n):
        c = grid.coords(r)
        first = grid.rank(pp=c["pp"], tp=c["tp"])
        assert torch.equal(parts[r], parts[first]), (r, first)
    return reports


def check_engines(ranks, layout, jeng):
    """Greedy tokens through a lazy warmup and bursts, pipelined bursts
    and the verify step, then seeded sampled pipelined bursts, against
    the JAX engine ``jeng`` of the same layout; the ranks' rows and the
    replicas' caches after each."""
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    rng = np.random.default_rng(5)
    prompts = [REPEAT, RANDOM, rng.integers(1, 500, 45).tolist(), REPEAT[3:]]

    def reqs(sp_cls):
        return [(f"g{i}", p, sp_cls(max_tokens=10, temperature=0.0,
                                    ignore_eos=True))
                for i, p in enumerate(prompts)]

    want = _tokens(jeng, reqs(JaxSamplingParams))
    modes = {"bursts": dict(num_decode_steps=4, overlap_decode=False),
             "pipelined": dict(num_decode_steps=4, **PIPELINED),
             "verify": dict(speculative_ngram=3, overlap_decode=False)}
    for mode, over in modes.items():
        with engine_on(ranks, layout, params, **over) as eng:
            if mode == "bursts":  # warmup's buckets run on every rank
                assert eng.precompile(mode="lazy")["buckets_compiled"] > 0
            assert _tokens(eng, reqs(SamplingParams)) == want, mode
            same_rows_and_replicas(eng.runner, layout)
            if mode == "pipelined":
                assert eng.pipelined_bursts_total > 0
            if mode == "verify":
                assert eng.spec_proposed_total > 0
            stats = eng.stats()
            for axis in ("pipeline", "data"):
                assert stats[f"{axis}_parallel_size"] == layout.get(
                    f"{axis}_parallel_size", 1)

    def sampled(sp_cls):
        return _reqs((21, 9, 33), (12, 16, 10), sp_cls, temperature=0.9,
                     top_p=0.95, seed=17)

    want = _tokens(jeng, sampled(JaxSamplingParams))
    with engine_on(ranks, layout, params, num_decode_steps=4,
                   **PIPELINED) as eng:
        assert _tokens(eng, sampled(SamplingParams)) == want
        assert eng.pipelined_bursts_total > 0
        same_rows_and_replicas(eng.runner, layout)


def check_pages(ranks, layout, params):
    """Pages against a one-rank port engine's (whose pages and swaps
    test_torch_kv_swap.py holds against the JAX runner and engine):
    whole, bit for bit, an upload's round trip, and a small pool's swaps
    with their counts."""
    one = LLMEngine(EngineConfig(device="cpu", **COMMON), params=params)
    prompt = list(range(5, 45))
    sp = SamplingParams(max_tokens=1, temperature=0.0)
    one.generate([prompt], sp)
    cfg = get_model_config("tiny-llama-debug")
    with engine_on(ranks, layout, params) as eng:
        eng.generate([prompt], sp)
        for b in range(3):  # the prompt's first pages: blocks 0, 1, 2
            got = eng.runner.download_page(b)
            want = one.runner.download_page(b)
            for g, w in zip(got, want):
                assert g.shape == w.shape == (cfg.num_layers, 8,
                                              cfg.num_kv_heads, 16)
                assert torch.equal(g, w)
        free = eng.runner.num_blocks - 1
        eng.runner.upload_page(free, *want)
        for g, w in zip(eng.runner.download_page(free), want):
            assert torch.equal(g, w)
        same_rows_and_replicas(eng.runner, layout)
    over = dict(SMALL, kv_swap=True, swap_quantum_tokens=16)
    one = LLMEngine(EngineConfig(device="cpu", **over), params=params)
    _, want = _run(one, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                              temperature=0.0))
    with engine_on(ranks, layout, params, **over) as eng:
        _, got = _run(eng, _reqs(LENGTHS, MAX_TOKENS, SamplingParams,
                                 temperature=0.0))
        assert got == want
        for key in SWAP_KEYS:
            assert eng.stats().get(key) == one.stats().get(key), key
        assert eng.stats()["kv_swap_in_total"] > 0
        same_rows_and_replicas(eng.runner, layout)


def _reassemble(stages):
    out = {k: v for k, v in stages[0].items() if k != "layers"}
    out["layers"] = {k: torch.cat([s["layers"][k] for s in stages])
                     for k in stages[0]["layers"]}
    for s in stages[1:]:  # the top leaves are whole on every stage
        for k, v in s.items():
            if k != "layers":
                assert torch.equal(v, out[k]), k
    return out


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_stage_cuts_reassemble_every_tree(tmp_path):
    # 16 heads: the tp-2 cut keeps whole 128-row int4 groups.
    base = dataclasses.replace(get_model_config("tiny-llama-debug"),
                               num_layers=4, num_heads=16, num_kv_heads=16)
    moe = dataclasses.replace(base, num_experts=4)
    cpu = torch.device("cpu")
    for cfg, quant, lora in ((base, None, False), (base, "int8", False),
                             (base, "int4", False), (base, None, True),
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
        stages = [stage_params(tree, cfg, s, 2) for s in (0, 1)]
        _equal_trees(_reassemble(stages), tree)
        assert stages[1]["layers"]["wq"].shape[0] == rank_local_config(
            cfg, 2, 2).num_layers == 2
        if lora:  # an adapter's host arrays cut as the bank
            a = tree["layers"]["lora_a_wo"].float().numpy()
            assert np.array_equal(stage_leaf(a, 1, 2),
                                  stages[1]["layers"]["lora_a_wo"]
                                  .float().numpy())
            continue
        for s in (0, 1):  # every slice drawn in order: the same cut
            gen = torch.Generator().manual_seed(3)
            _equal_trees(model.init_params(gen, cpu, quantization=quant,
                                           stage=(s, 2)), stages[s])
            # and the generator ends where the whole tree's draw ends
            assert torch.equal(torch.randn(3, generator=gen), torch.randn(
                3, generator=_after_whole(model, quant)))
            _equal_trees(model.init_params(
                torch.Generator().manual_seed(3), cpu, quantization=quant,
                shard=(1, 2), stage=(s, 2)),
                shard_params(stages[s], cfg, 1, 2))
    # A checkpoint is read a stage at a time (Qwen2's biases and GQA).
    path = _checkpoint(tmp_path / "ckpt", "qwen2")
    cfg = config_from_hf_json(f"{path}/config.json")
    for quant in (None, "int4"):
        whole = load_hf_params(cfg, path, quantize=quant)
        for s in (0, 1):
            _equal_trees(load_hf_params(cfg, path, quantize=quant,
                                        stage=(s, 2)),
                         stage_params(whole, cfg, s, 2))
    tiny = get_model_config("tiny-llama-debug")
    check_pp(tiny, 2)
    with pytest.raises(ValueError, match="num_layers=2 not divisible by "
                                         "pipeline_parallel_size=3"):
        check_pp(tiny, 3)
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        multihost.start_ranks(EngineConfig(pipeline_parallel_size=3,
                                           device="cpu"))


def _after_whole(model, quant):
    gen = torch.Generator().manual_seed(3)
    model.init_params(gen, torch.device("cpu"), quantization=quant)
    return gen


def _gemma2_6():
    """``tiny-gemma2-debug`` at 6 layers: stage 1 of 2 starts at layer 3,
    a global layer (pattern 2), where a stage-local index says local."""
    jcfg, tcfg = gemma._configs("tiny-gemma2-debug", dtype="float32")
    return (dataclasses.replace(jcfg, num_layers=6),
            dataclasses.replace(tcfg, num_layers=6))


@contextlib.contextmanager
def runner_on(ranks, layout, model_cfg, params, **kw):
    cfg = EngineConfig(**{**COMMON, **layout, "model": model_cfg.name, **kw})
    runner = ranks.build_runner(cfg, model_cfg, params)
    try:
        yield runner
    finally:
        ranks.publisher.shutdown()


def test_forward_and_encode_match_one_rank_and_jax(ranks):
    """Every norm weight moved off 1; the verify step reads the prefill's
    pages."""
    prefill, verify = _verify_steps(512)
    assert prefill[0].shape[1] > 16  # past Gemma-2's window
    for name in ("tiny-llama-debug", "gemma2-6"):
        jcfg, tcfg = (_gemma2_6() if name == "gemma2-6" else
                      gemma._configs(name, dtype="float32"))
        jmodel = JaxLlama(jcfg)
        jparams = gemma._jax_params(jmodel)
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
        jforward = jax.jit(jmodel.forward,
                           static_argnames=("attn_impl", "all_logits"))
        jcache = jmodel.make_kv_cache(model_test.NB, model_test.BS)
        kw = dict(num_kv_blocks=model_test.NB, block_size=model_test.BS)
        one = ModelRunner(EngineConfig(**{**COMMON, "device": "cpu",
                                          "model": tcfg.name, **kw}),
                          tcfg, params)
        with runner_on(ranks, PP, tcfg, params, **kw) as runner:
            assert runner.kv_cache.shape[0] == jcfg.num_layers // 2
            for step, all_logits in ((prefill, False), (verify, True)):
                batch = dict(zip(NAMES, step))
                want, jcache = jforward(
                    jparams, *(jnp.asarray(a) for a in step), jcache,
                    attn_impl="gather", all_logits=all_logits)
                got = runner.forward_logits(batch, all_logits=all_logits)
                assert torch.equal(got, one.forward_logits(
                    batch, all_logits=all_logits)), name
                want = np.asarray(want)
                for row in ((0, 2) if all_logits else (0,)):
                    _agree(got.numpy()[row], want[row], f"{name} {row}")
            toks = np.array(REPEAT + RANDOM, np.int32)
            got = runner.encode(toks.tolist())
            assert np.array_equal(got, one.encode(toks.tolist()))
            want = np.asarray(jmodel.encode(
                jparams, jnp.asarray(toks[None]),
                jnp.asarray([len(toks)], jnp.int32)))[0]
            np.testing.assert_allclose(got, want,
                                       atol=2e-3 * np.abs(want).max(),
                                       rtol=2e-3)


def test_greedy_and_seeded_engines_match_the_jax_engine(ranks):
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **COMMON,
                                        pipeline_parallel_size=2))
    check_engines(ranks, PP, jeng)


def test_pages_move_in_the_one_rank_layout(ranks):
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather", **COMMON))
    check_pages(ranks, PP, params_from_jax(
        jax.tree.map(np.asarray, jeng.runner.params)))
