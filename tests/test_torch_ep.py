"""The port's expert parallelism on the CPU: ``tiny-mixtral-debug`` at
ep 2 x tp 2 over gloo against the JAX package on an ep x tp mesh.

One rank group serves the module (this process is rank 0 of four:
``ep, tp`` coordinates ``(0, 0), (0, 1), (1, 0), (1, 1)``; every
collective bounded by ``TIMEOUT_S``).

- ``expert_params`` then reassembly along the expert axis gives the tree
  back leaf for leaf (bf16, int8, int4; the router whole on every rank),
  and ``init_params(experts=...)`` and ``load_hf_params(experts=...)``
  give exactly the cut ``expert_params`` makes, alone and under a stage
  and a tensor shard; the JAX start checks refuse ``ep`` on a model
  without experts and one that does not divide ``num_experts``.
- The ep-2 x tp-2 encode and paged forward (a prefill, then decode
  steps) against the JAX ``encode`` and ``forward`` with the params
  sharded by ``param_pspecs`` on an ep 2 x tp 2 mesh of the conftest's
  virtual CPU devices (the encode within JAX's 5e-5; the logits under
  ``_agree``).
- Greedy tokens of ep-2 x tp-2 engines through a lazy warmup, bursts,
  pipelined bursts and the verify step equal a JAX engine's at
  ``expert_parallel_size=2, tensor_parallel_size=2``, seeded sampled
  bursts draw its tokens, and every rank's cache equals its tensor
  rank's on ``ep`` 0, bit for bit, after each run.
- ``python -m production_stack_tpu_torch.engine.server
  --sequence-parallel-size 2 --expert-parallel-size 2 --device cpu``
  answers a completion with the one-rank engine's text and an embedding
  with its encode, and stops every rank.
"""

import dataclasses
import json
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from safetensors.numpy import save_file

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from production_stack_tpu.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine.config import (
    EngineConfig,
    check_parallel,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.registry import get_model_config

from .test_torch_moe import HF_CONFIG, NB, BS, _agree, _configs, _port, _steps
from .test_torch_pp import (
    COMMON,
    _equal_trees,
    check_engines,
    parallel_ranks,
    runner_on,
)
from .test_torch_spec_engine import RANDOM, REPEAT
from .test_torch_tp_server import (
    ROOT,
    _call,
    _children,
    _free_port,
    _gone,
    _wait,
)

NAME = "tiny-mixtral-debug"
EP = dict(model=NAME, expert_parallel_size=2, tensor_parallel_size=2,
          device="cpu")
TOL = 5e-5  # the JAX ep encode's tolerance (tests/test_moe.py)
NAMES = ("tokens", "positions", "write_idx", "block_tables", "kv_lens",
         "last_idx")


@pytest.fixture(scope="module")
def ranks():
    with parallel_ranks(EP) as r:
        yield r


def _reassemble(cuts):
    out = {k: v for k, v in cuts[0].items() if k != "layers"}
    out["layers"] = {}
    for k, v in cuts[0]["layers"].items():
        if tllama.is_expert_leaf(k):
            out["layers"][k] = torch.cat([c["layers"][k] for c in cuts], 1)
        else:  # the router, attention and norms whole on every rank
            for c in cuts[1:]:
                assert torch.equal(c["layers"][k], v), k
            out["layers"][k] = v
    return out


def _mixtral_checkpoint(path):
    """A tiny Mixtral checkpoint in HF names (``[out, in]``), experts'
    w1/w3/w2 in BF16 and F32, the router in F32, norms in F16."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF_CONFIG))
    cfg = tllama.config_from_hf_json(str(path / "config.json"))
    rng = np.random.default_rng(0)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(out, inp, dtype=np.float32):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(dtype)

    bf16 = ml_dtypes.bfloat16
    t = {"model.embed_tokens.weight": w(V, D, bf16),
         "model.norm.weight": np.ones(D, np.float16), "lm_head.weight": w(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for n, (o, d) in (("q", (cfg.q_size, D)), ("k", (cfg.kv_size, D)),
                          ("v", (cfg.kv_size, D)), ("o", (D, cfg.q_size))):
            t[p + f"self_attn.{n}_proj.weight"] = w(o, d)
        t[p + "input_layernorm.weight"] = np.ones(D, np.float16)
        t[p + "post_attention_layernorm.weight"] = np.ones(D, np.float16)
        t[p + "block_sparse_moe.gate.weight"] = w(cfg.num_experts, D)
        for e in range(cfg.num_experts):
            q = p + f"block_sparse_moe.experts.{e}."
            t[q + "w1.weight"] = w(Fi, D, bf16)
            t[q + "w3.weight"] = w(Fi, D)
            t[q + "w2.weight"] = w(D, Fi, bf16)
    save_file(t, str(path / "model.safetensors"))
    return cfg


def test_expert_cuts_reassemble_every_tree(tmp_path):
    cpu = torch.device("cpu")
    tiny = get_model_config(NAME)
    # 16 heads: the tp-2 cut keeps whole 128-row int4 groups.
    wide = dataclasses.replace(tiny, num_heads=16, num_kv_heads=16)
    bf16 = dataclasses.replace(wide, dtype="bfloat16")
    for cfg, quant in ((bf16, None), (wide, "int8"), (wide, "int4")):
        model = tllama.Llama(cfg)
        tree = model.init_params(torch.Generator().manual_seed(3), cpu,
                                 quantization=quant)
        cuts = [tllama.expert_params(tree, cfg, r, 2) for r in (0, 1)]
        _equal_trees(_reassemble(cuts), tree)
        assert cuts[1]["layers"]["w_gate"].shape[1] == \
            tllama.rank_local_config(cfg, ep=2).num_experts == 2
        assert cuts[1]["layers"]["w_router"].shape[-1] == cfg.num_experts
        for r in (0, 1):  # every slice drawn in order: the same cut
            _equal_trees(model.init_params(
                torch.Generator().manual_seed(3), cpu, quantization=quant,
                experts=(r, 2)), cuts[r])
        _equal_trees(model.init_params(
            torch.Generator().manual_seed(3), cpu, quantization=quant,
            shard=(1, 2), stage=(1, 2), experts=(1, 2)),
            tllama.shard_params(tllama.stage_params(cuts[1], cfg, 1, 2),
                                cfg, 1, 2))
    # A checkpoint is read an expert at a time: only the rank's experts.
    cfg = _mixtral_checkpoint(tmp_path / "ckpt")
    path = str(tmp_path / "ckpt")
    for quant in (None, "int8", "int4"):
        whole = tllama.load_hf_params(cfg, path, quantize=quant)
        for r in (0, 1):
            _equal_trees(tllama.load_hf_params(cfg, path, quantize=quant,
                                               experts=(r, 2)),
                         tllama.expert_params(whole, cfg, r, 2))
    # The JAX runner's start checks.
    check_parallel(EngineConfig(**EP), tiny)
    with pytest.raises(ValueError, match=r"needs a MoE model with "
                                         r"num_experts divisible by it "
                                         r"\(model has 0\)"):
        check_parallel(EngineConfig(expert_parallel_size=2),
                       get_model_config("tiny-llama-debug"))
    with pytest.raises(ValueError, match="model has 4"):
        check_parallel(EngineConfig(model=NAME, expert_parallel_size=3), tiny)


def test_encode_and_forward_match_jax_on_an_ep_tp_mesh(ranks):
    jcfg, tcfg = _configs()
    jparams = jllama.Llama(jcfg).init_params(jax.random.PRNGKey(2))
    params = _port(jparams)
    jmodel = jllama.Llama(jcfg)
    mesh = build_mesh(JaxMeshConfig(expert_parallel_size=2,
                                    tensor_parallel_size=2),
                      jax.devices()[:4])
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams,
        jmodel.param_pspecs())
    jencode = jax.jit(lambda p, t, n: jmodel.encode(p, t, n,
                                                    moe_impl="dense"))
    jforward = jax.jit(jmodel.forward,
                       static_argnames=("attn_impl", "moe_impl"))
    steps, _ = _steps(jcfg.vocab_size)
    with runner_on(ranks, EP, tcfg, params, num_kv_blocks=NB,
                   block_size=BS) as runner:
        assert runner.moe_impl == "dense"  # "auto" on a split, as in JAX
        assert runner.params["layers"]["w_gate"].shape[1:] == (
            2, tcfg.hidden_size, tcfg.intermediate_size // 2)
        for ids in (REPEAT + RANDOM, RANDOM[:10]):
            toks, n = runner.encode_input(ids)
            want = np.asarray(jencode(sharded, jnp.asarray(toks),
                                      jnp.asarray([n], jnp.int32)))[0]
            np.testing.assert_allclose(runner.encode(ids), want, rtol=TOL,
                                       atol=TOL)
        jcache = jmodel.make_kv_cache(NB, BS)
        for step in steps:
            want, jcache = jforward(sharded, *(jnp.asarray(a) for a in step),
                                    jcache, attn_impl="gather",
                                    moe_impl="dense")
            got = runner.forward_logits(dict(zip(NAMES, step)))
            _agree(got.numpy()[0], np.asarray(want)[0], "ep2 x tp2 step")
        reports = runner.rank_reports()
    assert [r["coords"]["ep"] for r in reports] == [0, 0, 1, 1]
    for r in reports:  # one combine a layer of each forward and encode
        assert r["traffic"]["ep_reduce"]["calls"] == tcfg.num_layers * (
            len(steps) + 2)


def test_greedy_and_seeded_engines_match_the_jax_engine(ranks):
    jeng = JaxLLMEngine(JaxEngineConfig(
        attn_impl="gather", **{**COMMON, "model": NAME},
        expert_parallel_size=2, tensor_parallel_size=2))
    check_engines(ranks, EP, jeng)


def test_server_serves_sp2_ep2_and_sigterm_stops_every_rank():
    port = _free_port()
    engine = dict(model=NAME, block_size=8, num_kv_blocks=64,
                  max_model_len=128, max_num_seqs=4)
    argv = ["--device", "cpu", "--sequence-parallel-size", "2",
            "--expert-parallel-size", "2", "--port", str(port), "--host",
            "127.0.0.1", "--model", NAME, "--block-size", "8",
            "--num-kv-blocks", "64", "--max-model-len", "128",
            "--max-num-seqs", "4"]
    code = ("import sys; from production_stack_tpu_torch.engine import "
            "multihost, server; multihost.DISTRIBUTED_TIMEOUT_S = 30.0; "
            "server.main(sys.argv[1:])")
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    followers = []
    try:
        def up():
            assert proc.poll() is None, proc.stdout.read()
            try:
                return _call(port, "GET", "/health")[0] == 200
            except OSError:
                return False

        _wait(up, 60, "the server answers /health")
        followers = _children(proc.pid)
        one = LLMEngine(EngineConfig(device="cpu", **engine))
        prompt = "experts over the expert axis"
        want = one.generate([prompt], SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))[0]["text"]
        status, raw = _call(port, "POST", "/v1/completions", {
            "model": NAME, "prompt": prompt, "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True})
        assert status == 200, raw
        assert json.loads(raw)["choices"][0]["text"] == want
        status, raw = _call(port, "POST", "/v1/embeddings", {
            "model": NAME, "input": prompt})
        assert status == 200, raw
        np.testing.assert_allclose(
            json.loads(raw)["data"][0]["embedding"],
            one.runner.encode(one.tokenizer.encode(prompt)), rtol=TOL,
            atol=TOL)
        status, raw = _call(port, "GET", "/debug/state")
        state = json.loads(raw)
        assert [(r["rank"], r["sp"], r["ep"], r["tp"], r["device"])
                for r in state["ranks"]] == [
            (0, 0, 0, 0, "0/cpu"), (1, 0, 1, 0, "0/cpu"),
            (2, 1, 0, 0, "0/cpu"), (3, 1, 1, 0, "0/cpu")]
        assert state["stats"]["expert_parallel_size"] == 2.0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=45)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode is not None
    assert len(followers) >= 3, (followers, out[-2000:])
    for pid in followers:
        _wait(lambda: _gone(pid), 10, f"follower {pid} exits")
    assert out.count("rank report") >= 4, out[-2000:]
