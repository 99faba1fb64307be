"""N-gram speculative decoding in the PyTorch port against the JAX package:
its pieces below the engine.

- ``engine/spec.py``: the port's copy of ``propose_ngram`` and
  ``count_accepted`` equals the JAX module's on seeded arrays.
- ``Llama.forward(all_logits=True)``: the logits of every position of a
  verify-shaped step (T = 5 past a prefilled prompt, a row whose
  ``kv_len`` falls short of its last positions, a padding row) against
  the JAX forward's, on tiny-llama-debug and on the softcapped tiny
  Gemma-2, under the numerics oracle's rule (``_agree``).
- ``ModelRunner.execute_spec_verify``: the argmax of every position and
  the fully sampled position 0 equal the JAX runner's on the same batch
  (greedy and seeded rows, logit bias, a row past its pages).
- ``enumerate_lattice`` with ``speculative_ngram=4`` equals the JAX
  lattice (``spec_verify`` buckets included) with and without
  ``async_decode``; a fully warmed tiny spec engine then serves verify
  steps that replay and never capture.
- The prefill wrapper plans a launch's splits at the cache's page count:
  a verify row's split count does not follow its table's width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import precompile as jpre
from production_stack_tpu.engine import spec as jspec
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu_torch.engine import precompile as tpre
from production_stack_tpu_torch.engine import spec as tspec
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.ops import paged_attention_cuda as pac

from . import test_torch_gemma as gemma
from . import test_torch_model as model_test
from .test_torch_precompile import StandInGraph, _drain

E4M3 = torch.float8_e4m3fn


def test_propose_and_count_equal_jax():
    """Seeded token arrays over a small vocabulary (so n-grams recur), as
    lists and as numpy arrays, every k, n range and lookback; then
    ``count_accepted`` over seeded drafts and argmax rows."""
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(300):
        L = int(rng.integers(1, 60))
        ids = rng.integers(0, int(rng.integers(2, 12)), L)
        for arr in (ids.tolist(), ids):
            for k in (0, 1, 4):
                for lo, hi in ((1, 3), (2, 2), (1, 5)):
                    lookback = int(rng.choice([0, 8, 40]))
                    want = jspec.propose_ngram(arr, k, lo, hi, lookback)
                    assert tspec.propose_ngram(arr, k, lo, hi,
                                               lookback) == want
                    hits += want is not None
        draft = rng.integers(0, 4, int(rng.integers(0, 6))).tolist()
        argmax = rng.integers(0, 4, len(draft) + 1)
        assert (tspec.count_accepted(draft, argmax)
                == jspec.count_accepted(draft, argmax))
    assert hits > 100  # the arrays do recur


def _verify_steps(vocab):
    """The prefill of ``test_torch_model._steps`` (20 tokens into row 0's
    pages, row 1 padding), then a verify-shaped step of T = 5 at
    positions 20..24 over three rows: row 0 writes and sees all five;
    row 1 is padding (``kv_len`` 0, writes dropped); row 2 reads row 0's
    pages with ``kv_len`` 22, so its last three positions lie past its
    keys, and drops its writes."""
    prefill = model_test._steps(vocab=vocab)[0]
    tokens, positions, write_idx, tables, _, _ = prefill
    rng = np.random.default_rng(3)
    drop = model_test.NB * model_test.BS
    T, p0 = 5, 20
    pages = tables[0]
    v_tokens = np.zeros((3, T), np.int32)
    v_tokens[0] = rng.integers(1, vocab, T)
    v_tokens[2] = v_tokens[0]
    v_pos = np.zeros((3, T), np.int32)
    v_pos[0] = v_pos[2] = p0 + np.arange(T)
    v_write = np.full((3, T), drop, np.int32)
    v_write[0] = [int(pages[p // model_test.BS]) * model_test.BS
                  + p % model_test.BS for p in v_pos[0]]
    v_tables = np.stack([pages, np.zeros_like(pages), pages])
    verify = (v_tokens, v_pos, v_write, v_tables,
              np.array([p0 + T, 0, 22], np.int32), np.zeros(3, np.int32))
    return prefill, verify


@pytest.mark.parametrize("name", ["tiny-llama-debug", "tiny-gemma2-debug"])
def test_all_logits_matches_jax(name):
    jcfg, tcfg = gemma._configs(name, dtype="float32")
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = (gemma._jax_params(jmodel) if name != "tiny-llama-debug"
               else model_test._jax_params(jmodel, jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jforward = jax.jit(jmodel.forward,
                       static_argnames=("attn_impl", "all_logits"))
    jcache = jmodel.make_kv_cache(model_test.NB, model_test.BS)
    tcache = tmodel.make_kv_cache(model_test.NB, model_test.BS,
                                  device=torch.device("cpu"))
    prefill, verify = _verify_steps(jcfg.vocab_size)
    for step, all_logits in ((prefill, False), (verify, True)):
        want, jcache = jforward(jparams, *(jnp.asarray(a) for a in step),
                                jcache, attn_impl="gather",
                                all_logits=all_logits)
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            attn_impl="gather", all_logits=all_logits)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, 5, jcfg.vocab_size)
    if jcfg.final_logit_softcap:  # the softcap bounds every logit
        assert np.abs(want).max() <= jcfg.final_logit_softcap
    for row in (0, 2):
        model_test._agree(got.numpy()[row], want[row], f"{name} row {row}")
    # Row 2's positions past its keys see keys 0..21 only: they differ
    # from row 0's, which see their own writes.
    assert not np.allclose(want[2, 3:], want[0, 3:])
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(jcache).max()))


COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=128, max_num_seqs=8, max_prefill_tokens=64)


def test_verify_step_equals_jax():
    """Three prompts prefilled in both engines on the same weights, then
    one verify step through each runner with the same drafts: a greedy
    row with a logit bias, a seeded sampled row (its position 0 through
    the full sampler, its drafts zero) with a bias, and a greedy row
    whose 20-token prompt fills three 8-token pages, so its last position
    has no page (dropped write, ``kv_len`` cut to 24)."""
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        speculative_ngram=4, **COMMON))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    teng = LLMEngine(EngineConfig(device="cpu", speculative_ngram=4,
                                  overlap_decode=False, **COMMON),
                     params=params)
    rng = np.random.default_rng(9)
    bias = ((5, 3.5), (77, -2.0), (300, 1.25))
    reqs = [(rng.integers(1, 500, 13).tolist(),
             dict(temperature=0.0, logit_bias=bias)),
            (rng.integers(1, 500, 9).tolist(),
             dict(temperature=0.8, seed=5, logit_bias=bias)),
            (rng.integers(1, 500, 20).tolist(), dict(temperature=0.0))]
    for eng, sp_cls in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
        for i, (prompt, sp) in enumerate(reqs):
            eng.add_request(f"v{i}", prompt_token_ids=prompt,
                            sampling=sp_cls(max_tokens=8, ignore_eos=True,
                                            **sp))
        eng.step()  # the three prefills, one token each
    drafts = rng.integers(1, 500, (3, 4)).astype(np.int32)
    drafts[1] = 0
    out = []
    for eng in (jeng, teng):
        seqs = [eng._seqs[f"v{i}"] for i in range(3)]
        assert all(len(s.output_token_ids) == 1 for s in seqs)
        ids, sampled0 = eng.runner.execute_spec_verify(seqs, drafts)
        out.append((np.asarray(ids), np.asarray(sampled0)))
    (jids, js0), (tids, ts0) = out
    assert tids.shape == (3, 5) and ts0.shape == (3,)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(ts0, js0)
    # A greedy row's sampled position 0 is its argmax.
    assert ts0[0] == tids[0, 0] and ts0[2] == tids[2, 0]
    seq = teng._seqs["v2"]
    batch = teng.runner._spec_batch([seq], drafts[2:])
    assert batch["kv_lens"][0] == 24 == len(seq.block_ids) * 8
    assert batch["write_idx"][0, -1] == teng.runner._drop_slot
    # Recorded as its own dispatch kind, in the flight ring too.
    rendered = teng.runner.telemetry.step_duration.render()
    assert 'kind="spec_verify",batch_bucket="b4xk4"' in rendered
    row = teng.flight.records()[-1]
    assert (row["kind"], row["bucket"], row["tokens"]) == (
        "spec_verify", "b4xk4", 15)


def _lattice_configs(async_decode):
    common = dict(model="tiny-llama-debug", block_size=16, max_num_seqs=6,
                  max_prefill_tokens=48, max_model_len=200,
                  num_decode_steps=1, min_decode_bucket=1,
                  overlap_decode=True, async_decode=async_decode,
                  speculative_ngram=4)
    return EngineConfig(device="cpu", **common), JaxEngineConfig(**common)


def test_lattice_equals_jax_and_warm_verify_steps_replay():
    for async_decode in (False, True):
        cfg, jcfg = _lattice_configs(async_decode)
        got = tpre.enumerate_lattice(cfg)
        want = jpre.enumerate_lattice(jcfg)
        assert ([dataclasses.astuple(b) for b in got]
                == [dataclasses.astuple(b) for b in want])
        assert [b.label for b in got] == [b.label for b in want]
        assert tpre.burst_depths(cfg) == jpre.burst_depths(jcfg)
        kinds = {b.kind for b in got}
        assert "spec_verify" in kinds
        # The overlap at depth 1 defers to speculation; async_decode does
        # not, and turns speculation off.
        assert ("decode_burst" in kinds) == async_decode

    # A full warmup of a tiny spec engine through the stand-in graph, then
    # greedy traffic that speculates: verify steps replay warmed graphs.
    engine = LLMEngine(EngineConfig(
        model="tiny-llama-debug", max_model_len=64, block_size=16,
        num_kv_blocks=16, max_num_seqs=2, max_prefill_tokens=32,
        num_decode_steps=1, overlap_decode=False, speculative_ngram=4,
        device="cpu"))
    runner = engine.runner
    runner._graph_cls = StandInGraph
    summary = engine.precompile(mode="full")
    assert summary["coverage"] == 1.0
    labels = {b.label for b in tpre.enumerate_lattice(engine.cfg)
              if b.kind == "spec_verify"}
    assert labels == {"b1xk4", "b2xk4"}
    keys = set(runner._graphs)
    assert {k for k in keys if k[0] == "spec_verify"}
    warm = dict(runner.graph_counts)
    verified = []
    execute = runner.execute_spec_verify

    def spy(seqs, drafts):
        verified.append(len(seqs))
        return execute(seqs, drafts)

    runner.execute_spec_verify = spy
    for i, n in enumerate((2, 1)):
        for j in range(n):
            engine.add_request(
                f"w{i}{j}", prompt_token_ids=[7, 8, 9, 7, 8, 9, 7, 8][j:],
                sampling=SamplingParams(max_tokens=12, temperature=0.0,
                                        ignore_eos=True))
        _drain(engine)
    assert sorted(set(verified)) == [1, 2]
    assert engine.spec_proposed_total > 0
    assert set(runner._graphs) == keys, "a live step captured a new key"
    assert runner.graph_counts["captured"] == warm["captured"]
    assert runner.graph_counts["replayed"] > warm["replayed"]


# (route, q type, cache type, H, KH, head_dim, the cache's pages): the
# served Llama-3-8B (bf16 and e4m3 caches), gemma2-9b's heads and the tiny
# presets' CUDA-core route.
PLAN_CASES = (
    ("wgmma", torch.bfloat16, torch.bfloat16, 32, 8, 128, 14219),
    ("wgmma", torch.bfloat16, E4M3, 32, 8, 128, 28438),
    ("wgmma", torch.bfloat16, torch.bfloat16, 16, 8, 256, 3000),
    ("simt", torch.float32, torch.float32, 8, 8, 16, 256),
)


def test_verify_launch_plans_at_the_caches_width():
    """Every verify shape's (B in 1..64 rows of T = 5) split count is the
    same at every table width, and is the plan at the cache's page
    count; the served Llama-3-8B heads split B = 8 in two and do not
    split B = 64."""
    bs, n_sm, T = 32, 132, 5
    for route, q_dtype, cache_dtype, H, KH, hd, nb in PLAN_CASES:
        assert pac.kernel_route("prefill", q_dtype, cache_dtype, H, KH,
                                hd) == route
        kv_pages = torch.empty((2, nb, 2, bs, KH * hd), dtype=cache_dtype,
                               device="meta")
        plan = pac.prefill_plan if route == "wgmma" else pac.simt_prefill_plan
        got = {}
        for B in (1, 2, 8, 64):
            q = torch.empty((B, T, H, hd), dtype=q_dtype, device="meta")
            splits = pac.prefill_launch_splits(route, q, kv_pages, n_sm)
            assert splits == plan(B, KH, T, H // KH, nb, bs, n_sm, hd)
            got[B] = splits
            if B == 1:  # the width's plan would have moved with W
                assert len({plan(B, KH, T, H // KH, W, bs, n_sm, hd)
                            for W in (1, 2, 4, 64, 128)}) > 1
        if (route, hd, cache_dtype) == ("wgmma", 128, torch.bfloat16):
            assert got[8] == 2 and got[64] == 1
            assert pac.ticket_count(q_dtype, cache_dtype, H, KH, hd, 64,
                                    T) == 64 * KH
