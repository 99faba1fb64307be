"""LoRA serving in the PyTorch port against the JAX package's.

- ``engine/lora.py``: the port's ``LoraManager`` parses a PEFT directory
  (written with ``safetensors.numpy``) into the JAX manager's arrays,
  rank, scaling and slot order, skips a ``gate_proj`` target, and raises
  as it does on a rank above the maximum, missing files and a full bank.
- ``Llama.forward`` with a bank and rows on slots 0, 1 and 2 against the
  JAX forward on the same tree (bank included): a prefill chunk with
  every position's logits, then decode steps. int8 and int4 (fp32
  activations, as ``tests/test_torch_quant.py``) are held to
  ``tests/test_numerics_oracle.py::_agree``; bf16 to
  ``tests/test_torch_model.py``'s bf16 rule (3e-2 of max|logit|): the
  base bf16 forward alone misses ``_agree`` on the CPU (0.8 % of
  max|logit| and an argmax at a near-tie), since the two packages round
  bf16 intermediates at different points. A slot-0 row equals the
  forward without a bank bit for bit in every mode, and the port's
  ``quantize_tree`` leaves the bank as it is.
- A tiny engine of each package on the same weights: mixed base and
  adapter requests in one batch give equal greedy tokens (the port's
  lattice captured before the adapters load, live traffic capturing no
  new key), which also
  equal a merged-weights port engine's (``W + s * A @ B``, the oracle of
  ``tests/test_lora.py``). The cache salt equals the JAX engine's; a base
  request never hits an adapter's pages, the same adapter does.
- Unload while a request runs, in the synchronous loop and with the
  pipelined loop engaged (replays through a stand-in graph with one
  static output): the tokens equal the uninterrupted run's, and the slot
  is zeroed and freed only after the last reader, a finished member of
  an in-flight burst included, has drained; the bank is written in place.
  A small pool swaps adapter rows out and back in (and recomputes some):
  their tokens equal a large pool's, their chains stay salted.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.lora import LoraManager as JaxLoraManager
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu_torch.engine import runner as runner_mod
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import TARGETS, LoraManager
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.kvcache.hashing import block_hashes
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import get_model_config

from .test_numerics_oracle import _agree
from .test_torch_model import BS, NB, _variant
from .test_torch_overlap_decode import StaticOutputGraph, _capture

RANK, ALPHA = 4, 8.0  # scaling 2.0
ALL = ("q_proj", "k_proj", "v_proj", "o_proj")
COMMON = dict(model="tiny-llama-debug", max_model_len=256, block_size=8,
              num_kv_blocks=96, max_num_seqs=4, max_prefill_tokens=64,
              enable_lora=True, max_loras=2, max_lora_rank=8)


def make_adapter(root, name, targets=ALL, seed=7, rank=RANK, alpha=ALPHA,
                 cfg=None, extra=()):
    """A PEFT directory ``root/name`` for ``cfg`` (the tiny preset): A
    [r, in] and B [out, r] of each target and layer, N(0, 0.3^2), big
    enough to move the tiny model's greedy tokens. ``extra`` targets
    (``gate_proj``) are written too."""
    cfg = cfg or get_model_config("tiny-llama-debug")
    dims = {"q_proj": (cfg.hidden_size, cfg.q_size),
            "k_proj": (cfg.hidden_size, cfg.kv_size),
            "v_proj": (cfg.hidden_size, cfg.kv_size),
            "o_proj": (cfg.q_size, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size)}
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "adapter_config.json").write_text(json.dumps({
        "r": rank, "lora_alpha": alpha, "peft_type": "LORA",
        "target_modules": list(targets) + list(extra)}))
    tensors = {}
    for t in list(targets) + list(extra):
        din, dout = dims[t]
        mod = "mlp" if t == "gate_proj" else "self_attn"
        for i in range(cfg.num_layers):
            key = f"base_model.model.model.layers.{i}.{mod}.{t}"
            tensors[f"{key}.lora_A.weight"] = (
                rng.standard_normal((rank, din)).astype(np.float32) * 0.3)
            tensors[f"{key}.lora_B.weight"] = (
                rng.standard_normal((dout, rank)).astype(np.float32) * 0.3)
    save_file(tensors, str(d / "adapter_model.safetensors"))
    return str(d)


def test_manager_parses_as_the_jax_manager(tmp_path):
    cfg = get_model_config("tiny-llama-debug")
    p1 = make_adapter(tmp_path, "a1", extra=("gate_proj",))
    p2 = make_adapter(tmp_path, "a2", targets=("q_proj", "v_proj"), seed=2,
                      rank=2, alpha=3.0)
    mgrs = {"jax": JaxLoraManager(cfg, 2, 8, str(tmp_path)),
            "port": LoraManager(cfg, 2, 8, str(tmp_path))}
    got = {}
    for side, mgr in mgrs.items():
        got[side] = [mgr.load("a1", p1), mgr.load("a2")]  # a2 from lora_dir
        assert mgr.load("a1")[1] is None  # resident: no arrays
    for (jad, jarr), (pad, parr) in zip(got["jax"], got["port"]):
        assert (pad.name, pad.slot, pad.rank, pad.scaling, pad.path) == (
            jad.name, jad.slot, jad.rank, jad.scaling, jad.path)
        assert parr.keys() == jarr.keys() == set(TARGETS.values())
        for t in parr:
            for a, b in zip(parr[t], jarr[t]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    assert got["port"][0][0].slot == 1
    assert got["port"][1][0].slot == 2 and got["port"][1][0].scaling == 1.5
    # a2 adapts q and v only; its k and o stay zero, as gate_proj is skipped.
    assert not got["port"][1][1]["wk"][0].any()
    assert got["port"][1][1]["wq"][0][:, :, :2].any()
    assert not got["port"][1][1]["wq"][0][:, :, 2:].any()  # rank padding

    big = make_adapter(tmp_path, "big", rank=16)
    empty = tmp_path / "empty"
    empty.mkdir()
    for side in ("jax", "port"):
        cls = JaxLoraManager if side == "jax" else LoraManager
        mgr = cls(cfg, 1, 8, str(tmp_path))
        with pytest.raises(ValueError, match="exceeds max_lora_rank=8"):
            mgr.load("big", big)
        with pytest.raises(FileNotFoundError, match="not a PEFT adapter"):
            mgr.load("empty", str(empty))
        mgr.load("a1", p1)
        with pytest.raises(RuntimeError, match="no free LoRA slots"):
            mgr.load("a2", p2)
        assert mgr.unload("a1").slot == 1 and mgr.get("a1") is None
        with pytest.raises(RuntimeError):  # not freed until released
            mgr.load("a2", p2)
        mgr.release_slot(1)
        assert mgr.load("a2", p2)[0].slot == 1


def _steps(vocab):
    """A 20-token prefill chunk (bucket 24) of three real rows on three
    slots, then three decode steps; row 3 pads. Each row has its own
    pages, none of them page 0."""
    rng = np.random.default_rng(0)
    drop = NB * BS
    pages = rng.permutation(np.arange(1, NB))[:12].astype(np.int32)
    tables = np.zeros((4, 4), np.int32)
    tables[:3] = pages.reshape(3, 4)

    def slot(r, p):
        return int(tables[r, p // BS]) * BS + p % BS

    n, Tb = 20, 24
    tokens = np.zeros((4, Tb), np.int32)
    positions = np.zeros((4, Tb), np.int32)
    write_idx = np.full((4, Tb), drop, np.int32)
    prompt = rng.integers(1, vocab, n)
    for r in range(3):
        tokens[r, :n] = prompt
        positions[r, :n] = np.arange(n)
        positions[r, n:] = n - 1
        write_idx[r, :n] = [slot(r, p) for p in range(n)]
    steps = [(tokens, positions, write_idx, tables,
              np.array([n, n, n, 0], np.int32),
              np.array([n - 1] * 3 + [0], np.int32))]
    for i in range(3):
        p = n + i
        tok = np.zeros((4, 1), np.int32)
        tok[:3] = rng.integers(1, vocab)
        pos = np.zeros((4, 1), np.int32)
        pos[:3] = p
        w = np.full((4, 1), drop, np.int32)
        w[:3, 0] = [slot(r, p) for r in range(3)]
        steps.append((tok, pos, w, tables,
                      np.array([p + 1] * 3 + [0], np.int32),
                      np.zeros(4, np.int32)))
    return steps


def _random_bank(jmodel):
    """A JAX bank with slots 1 and 2 filled (rank 4 of 8), slot 0 zero."""
    bank = jmodel.init_lora_bank(2, 8)
    rng = np.random.default_rng(5)
    for k, v in bank.items():
        a = np.zeros(v.shape, np.float32)
        if k.startswith("lora_a_"):
            a[:, 1:, :, :4] = rng.standard_normal(a[:, 1:, :, :4].shape) * 0.3
        else:
            a[:, 1:, :4, :] = rng.standard_normal(a[:, 1:, :4, :].shape) * 0.3
        bank[k] = jnp.asarray(a, v.dtype)
    return bank


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int4"])
def test_forward_with_bank_matches_jax(mode):
    dtype = "bfloat16" if mode == "bfloat16" else "float32"
    jcfg, tcfg = _variant(dtype=dtype)
    jmodel, tmodel = JaxLlama(jcfg), Llama(tcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    if mode != "bfloat16":
        jparams = jllama.quantize_tree(jax.tree.map(lambda a: a, jparams),
                                       mode)
    bank = _random_bank(jmodel)
    jparams["layers"].update(bank)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    if mode != "bfloat16":
        # The port's quantize_tree leaves a bank as it is, as JAX's does.
        tree = params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(0))))
        tree["layers"].update(params_from_jax(jax.tree.map(np.asarray, bank)))
        tree = tllama.quantize_tree(tree, mode)
        assert tllama.quant_mode(tree) == mode
        for k in bank:
            assert torch.equal(tree["layers"][k], tparams["layers"][k]), k
    bare = {**tparams, "layers": {k: v for k, v in tparams["layers"].items()
                                  if not k.startswith("lora_")}}
    # The bank stays in the model dtype: never quantized.
    assert tparams["layers"]["lora_a_wq"].dtype == tcfg.torch_dtype
    idx = np.array([0, 1, 2, 0], np.int32)
    scale = np.array([0.0, 2.0, 1.5, 0.0], np.float32)
    jforward = jax.jit(jmodel.forward,
                       static_argnames=("attn_impl", "all_logits"))
    jcache = jmodel.make_kv_cache(NB, BS)
    tcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    bcache = tmodel.make_kv_cache(NB, BS, device=torch.device("cpu"))
    for i, step in enumerate(_steps(jcfg.vocab_size)):
        every = i == 0  # the prefill chunk: every position's logits
        want, jcache = jforward(
            jparams, *(jnp.asarray(a) for a in step), jcache,
            lora_idx=jnp.asarray(idx), lora_scale=jnp.asarray(scale),
            attn_impl="gather", all_logits=every)
        got, tcache = tmodel.forward(
            tparams, *(torch.from_numpy(a) for a in step), tcache,
            lora_idx=torch.from_numpy(idx), lora_scale=torch.from_numpy(scale),
            attn_impl="gather", all_logits=every)
        base, bcache = tmodel.forward(
            bare, *(torch.from_numpy(a) for a in step), bcache,
            attn_impl="gather", all_logits=every)
        want, got = np.asarray(want)[:3], got.numpy()[:3]
        if mode == "bfloat16":
            np.testing.assert_allclose(
                got, want, rtol=0, atol=3e-2 * float(np.abs(want).max()),
                err_msg=f"bf16 step {i}")
        else:
            _agree(got, want, f"{mode} step {i}")
        assert torch.equal(torch.from_numpy(got[0]), base[0]), (mode, i)
        for r in (1, 2):  # the adapters move the logits
            assert np.abs(got[r] - got[0]).max() > 0.1, (mode, i, r)
    # Row 0's pages hold the K/V the forward without a bank wrote.
    pages0 = torch.from_numpy(_steps(jcfg.vocab_size)[0][3][0]).long()
    assert torch.equal(tcache[:, pages0], bcache[:, pages0])


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(runner_mod, "capture", _capture)


def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(engine, requests, sp_cls, on_step=None):
    """Add ``(rid, prompt, lora_name, max_tokens)`` requests together and
    step to completion; ``on_step(engine, n)`` runs after step n. Returns
    the tokens by request id."""
    toks = {}
    for rid, prompt, lora, n in requests:
        engine.add_request(rid, prompt_token_ids=list(prompt),
                           sampling=sp_cls(**_greedy(n)), lora_name=lora)
        toks[rid] = []
    for n in range(2000):
        if not engine.has_work():
            return toks
        for out in engine.step():
            toks[out.request_id].extend(out.new_token_ids)
        if on_step is not None:
            on_step(engine, n)
    raise AssertionError("engine did not drain")


PROMPTS = [list(range(3, 40)), list(range(50, 71)), list(range(100, 133)),
           list(range(7, 19))]


def test_engines_serve_mixed_adapters_as_jax_and_merged(tmp_path,
                                                        stand_in_graphs):
    p1 = make_adapter(tmp_path, "ad1")
    p2 = make_adapter(tmp_path, "ad2", targets=("q_proj", "v_proj", "o_proj"),
                      seed=2)
    jeng = JaxLLMEngine(JaxEngineConfig(attn_impl="gather",
                                        lora_dir=str(tmp_path), **COMMON))
    weights = jax.tree.map(np.asarray, jeng.runner.params)
    port = LLMEngine(EngineConfig(device="cpu", overlap_decode=False,
                                  lora_dir=str(tmp_path), **COMMON),
                     params=params_from_jax(weights))
    # The whole lattice captured before the adapters load: the warmup
    # batches carry the LoRA arrays, so live traffic adds no key.
    port.runner._graph_cls = StaticOutputGraph
    port.precompile(mode="full")
    keys = set(port.runner._graphs)
    for eng in (jeng, port):
        assert eng.load_lora("ad1", p1).slot == 1
        assert eng.load_lora("ad2").slot == 2  # from lora_dir
    reqs = [("base", PROMPTS[0], None, 10), ("a1", PROMPTS[1], "ad1", 10),
            ("a2", PROMPTS[2], "ad2", 12), ("a1b", PROMPTS[0], "ad1", 8)]
    want = _drive(jeng, reqs, JaxSamplingParams)
    got = _drive(port, reqs, SamplingParams)
    assert got == want
    assert set(port.runner._graphs) == keys, "live traffic captured a key"
    assert port.runner.graph_counts["replayed"] > 0

    # The merged-weights oracle: a port engine without LoRA whose q, k, v
    # and o are W + scaling * A @ B gives each adapter's tokens.
    mgr = LoraManager(port.model_cfg, 2, 8, str(tmp_path))
    for name, path in (("ad1", p1), ("ad2", p2)):
        ad, arrays = mgr.load(name, path)
        merged = params_from_jax(weights)
        for t, (a, b) in arrays.items():
            w = merged["layers"][t]
            merged["layers"][t] = (w.double() + ad.scaling * torch.einsum(
                "ldr,lro->ldo", torch.from_numpy(a).double(),
                torch.from_numpy(b).double())).to(w.dtype)
        oracle = LLMEngine(EngineConfig(
            device="cpu", overlap_decode=False,
            **{**COMMON, "enable_lora": False}), params=merged)
        mine = [r for r in reqs if r[2] == name]
        toks = _drive(oracle, [(rid, p, None, n) for rid, p, _, n in mine],
                      SamplingParams)
        assert toks == {rid: got[rid] for rid, *_ in mine}, name
    assert got["a1b"] != got["base"][:8]  # same prompt, other weights

    # The salt is the JAX engine's; a base request never hits the
    # adapter's pages, the same adapter does.
    for name in ("ad1", "ad2"):
        seqs = [eng.add_request(f"salt-{name}", prompt_token_ids=[1, 2],
                                sampling=sp(**_greedy(1)), lora_name=name)
                for eng, sp in ((jeng, JaxSamplingParams),
                                (port, SamplingParams))]
        assert seqs[0].cache_salt == seqs[1].cache_salt != 0
        assert seqs[1]._last_hash == seqs[1].cache_salt
        for eng in (jeng, port):
            eng.abort_request(f"salt-{name}")
    prompt = list(range(5, 38))  # 4 full pages of 8
    hits = {}
    for eng, sp in ((jeng, JaxSamplingParams), (port, SamplingParams)):
        out = []
        for rid, lora in (("warm", "ad1"), ("plain", None), ("again", "ad1"),
                          ("other", "ad2")):
            before = eng.allocator.hit_tokens
            _drive(eng, [(rid, prompt, lora, 2)], sp)
            out.append(eng.allocator.hit_tokens - before)
        hits[eng is port] = out
    assert hits[True] == hits[False] == [0, 0, 32, 0]
    committed = port.allocator  # the adapter's pages are keyed by its salt
    salt = port.add_request("k", prompt_token_ids=[1], lora_name="ad1").cache_salt
    port.abort_request("k")
    assert all(h in committed._block_of_hash
               for h in block_hashes(prompt, 8, parent=salt))


def test_unload_in_flight_swap_and_recompute(tmp_path, stand_in_graphs):
    p1 = make_adapter(tmp_path, "ad1")
    p2 = make_adapter(tmp_path, "ad2", seed=3)
    weights = params_from_jax(jax.tree.map(
        np.asarray, JaxLLMEngine(JaxEngineConfig(
            attn_impl="gather", **{**COMMON, "enable_lora": False})
        ).runner.params))

    def engine(**over):
        eng = LLMEngine(EngineConfig(device="cpu", **{**COMMON, **over}),
                        params=weights)
        eng.runner._graph_cls = StaticOutputGraph
        eng.load_lora("ad1", p1)
        return eng

    reqs = [("long", PROMPTS[0], None, 24), ("short", PROMPTS[1], "ad1", 6)]
    ref = _drive(engine(overlap_decode=False), reqs, SamplingParams)

    # The synchronous loop: unload after the prefill; the request finishes
    # under the adapter, then its slot is zeroed and freed.
    sync = engine(overlap_decode=False, num_decode_steps=2)
    bank = sync.runner.params["layers"]["lora_a_wq"]
    ptr = bank.data_ptr()
    release = sync.lora_manager.release_slot

    def release_while_retiring(slot):
        # Freed before it leaves the retiring set: stats(), read from
        # another thread, never shows the slot neither retiring nor free.
        assert slot in sync._retiring_slots
        release(slot)

    sync.lora_manager.release_slot = release_while_retiring

    def unload_at_2(eng, n):
        if n == 2:
            assert eng.unload_lora("ad1")
            assert eng._retiring_slots == {1}
            assert bank[:, 1].any()
    assert _drive(sync, reqs, SamplingParams, unload_at_2) == ref
    assert not sync._retiring_slots and not bank[:, 1].any()
    assert sync.stats()["lora_free_slots"] == 2.0
    with pytest.raises(ValueError, match="not loaded"):
        sync.add_request("gone", prompt_token_ids=[1], lora_name="ad1")
    assert sync.load_lora("ad2", p2).slot == 1  # the freed slot
    assert bank.data_ptr() == ptr and bank[:, 1].any()  # written in place
    assert sync.runner.graph_counts["replayed"] > 0

    # The pipelined loop: "short" finishes while a burst that runs its row
    # is in flight; unloaded then, its slot waits for that burst's drain.
    pipe = engine(overlap_decode=True, adaptive_decode_quiet_s=0.0,
                  adaptive_decode_min_running=0, num_decode_steps=2)
    seen = []

    def unload_when_short_left(eng, n):
        short_gone = "short" not in eng._seqs
        holder = eng.runner.burst_in_flight and any(
            s.request_id == "short" for s in eng._burst_seqs)
        if short_gone and holder and not seen:
            assert eng.unload_lora("ad1")
            seen.append(n)
        if seen and holder:
            assert eng._retiring_slots == {1}
    assert _drive(pipe, reqs, SamplingParams, unload_when_short_left) == ref
    assert seen and pipe.pipelined_bursts_total > 0
    assert not pipe._retiring_slots
    assert not pipe.runner.params["layers"]["lora_b_wo"][:, 1].any()

    # A 28-page pool: adapter rows are parked and resumed (some recompute)
    # with the tokens of a large pool, and their chains stay salted.
    big = engine(overlap_decode=False, num_decode_steps=2)
    big.load_lora("ad2", p2)
    rng = np.random.default_rng(11)
    pool_reqs = [(f"r{i}", rng.integers(1, 500, size=n).tolist(), lora, mt)
                 for i, (n, mt, lora) in enumerate(zip(
                     (30, 34, 27, 38), (40, 40, 44, 36),
                     ("ad1", None, "ad2", "ad1")))]
    want = _drive(big, pool_reqs, SamplingParams)
    small = engine(overlap_decode=False, num_decode_steps=2, num_kv_blocks=28,
                   swap_quantum_tokens=16)
    small.load_lora("ad2", p2)
    chains = {}

    def salted(eng, n):
        for s in eng._seqs.values():
            if s.block_hashes:
                chains[s.request_id] = (s.cache_salt, list(s.block_hashes),
                                        s.all_token_ids)
    assert _drive(small, pool_reqs, SamplingParams, salted) == want
    st = small.stats()
    assert st["kv_swap_in_total"] > 0 and st["kv_swap_fallback_recompute_total"] > 0
    for rid, (salt, hashes, toks) in chains.items():
        assert hashes == block_hashes(toks, 8, parent=salt)[:len(hashes)], rid
    assert {chains[r][0] != 0 for r in ("r0", "r2", "r3")} == {True}
    assert small.allocator.num_free == small.allocator.num_blocks
