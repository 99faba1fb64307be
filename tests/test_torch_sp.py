"""The port's sequence parallelism on the CPU: the ring encode at sp 2 x
tp 2 over gloo against the JAX package's ring and the one-rank port.

One rank group serves the module (this process is rank 0 of four:
``sp, tp`` coordinates ``(0, 0), (0, 1), (1, 0), (1, 1)``; every
collective bounded by ``TIMEOUT_S``).

- The per-hop flash block and merge against JAX's ``_flash_block`` and
  ``_merge``, a fully masked row included.
- The ring (``ring_self_attention``, each of the four ranks' blocks and
  heads in turn, the rotation handing over the previous rank's block)
  against the JAX ``ring_self_attention`` on an sp 2 x tp 2 mesh of the
  conftest's virtual CPU devices, with one padded row; valid rows only,
  within JAX's 2e-5.
- A length that sp does not divide raises, in the ring and in the
  encode.
- ``Llama.encode`` of ``tiny-llama-debug`` through an sp-2 x tp-2 runner
  against the JAX encode at ``sp_size=2`` and against the one-rank
  port's, within JAX's 5e-5; each rank's ring traffic.
- The JAX start checks: ``sp`` with ``pp`` raises at start and in the
  encode, and so does a ring encode of a windowed or softcapped model.
- ``python -m production_stack_tpu_torch.engine.server
  --sequence-parallel-size 2 --tensor-parallel-size 2 --device cpu``
  answers a greedy completion with the one-rank engine's text and
  ``/v1/embeddings`` with the one-rank encode, and stops every rank.
"""

import dataclasses
import json
import math
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models.llama import Llama as JaxLlama
from production_stack_tpu.ops import ring_attention as jring
from production_stack_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from production_stack_tpu.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_jax
from production_stack_tpu_torch.models.llama import Llama
from production_stack_tpu_torch.models.registry import get_model_config
from production_stack_tpu_torch.ops import ring_attention as ring

from . import test_torch_gemma as gemma
from .test_torch_pp import COMMON, parallel_ranks, runner_on
from .test_torch_spec_engine import RANDOM, REPEAT
from .test_torch_tp_server import (
    ENGINE,
    ROOT,
    _call,
    _children,
    _free_port,
    _gone,
    _wait,
)

SP = dict(sequence_parallel_size=2, tensor_parallel_size=2, device="cpu")
TOL = 5e-5  # the JAX ring encode's tolerance (tests/test_ring_attention.py)


@pytest.fixture(scope="module")
def ranks():
    with parallel_ranks(SP) as r:
        yield r


def _qkv(B, S, H, KH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))


def test_flash_block_and_merge_match_jax():
    q, k, v = _qkv(2, 12, 8, 4, 16)
    rng = np.random.default_rng(1)
    masks = [rng.random((2, 12, 12)) < 0.6 for _ in range(2)]
    masks[1][1, 3] = False  # a fully masked row: merged with weight zero
    scale = 1 / math.sqrt(16)
    states = []
    for mask in masks:
        want = jring._flash_block(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                  scale)
        got = ring.flash_block(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(mask), scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-5)
        states.append((got, want))
    got = ring.merge(states[0][0], states[1][0])
    want = jring._merge(states[0][1], states[1][1])
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_the_ring_matches_the_jax_ring_on_an_sp_tp_mesh():
    sp, tp = 2, 2
    B, S, H, KH, hd = 2, 64, 8, 4, 16
    q, k, v = _qkv(B, S, H, KH, hd)
    lengths = np.array([S, S - 11], np.int32)  # one padded row
    scale = 1 / math.sqrt(hd)
    mesh = build_mesh(JaxMeshConfig(sequence_parallel_size=sp,
                                    tensor_parallel_size=tp),
                      jax.devices()[:sp * tp])
    want = np.asarray(jring.ring_self_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), mesh, scale=scale))
    Sl, Hl, KHl = S // sp, H // tp, KH // tp
    got = np.zeros_like(want)
    for t in range(tp):  # each tensor rank rings its own heads
        heads, kv_heads = slice(t * Hl, (t + 1) * Hl), slice(t * KHl,
                                                              (t + 1) * KHl)
        blocks = [torch.stack([torch.from_numpy(a[:, r * Sl:(r + 1) * Sl,
                                                  kv_heads])
                               for a in (k, v)]) for r in range(sp)]
        for r in range(sp):
            # The rotation hands rank r block r - h - 1 before hop h + 1.
            given = iter(blocks[(r - h - 1) % sp] for h in range(sp - 1))
            out = ring.ring_self_attention(
                torch.from_numpy(q[:, r * Sl:(r + 1) * Sl, heads]),
                blocks[r][0], blocks[r][1], torch.from_numpy(lengths),
                scale=scale, rank=r, size=sp,
                rotate=lambda kv, given=given: next(given))
            got[:, r * Sl:(r + 1) * Sl, heads] = out.numpy()
    for b, n in enumerate(lengths):  # padded rows are garbage in both
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        Llama(get_model_config("tiny-llama-debug")).encode(
            {}, torch.zeros((1, 5), dtype=torch.long), torch.tensor([5]),
            sp_group=_Group(2))


class _Group:
    """A stand-in device group of ``n`` ranks (its size is all the
    encode reads before it raises)."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_encode_matches_the_jax_ring_encode_and_one_rank(ranks):
    jcfg, tcfg = gemma._configs("tiny-llama-debug", dtype="float32")
    jmodel = JaxLlama(jcfg)
    jparams = gemma._jax_params(jmodel)  # every norm off 1
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    mesh = build_mesh(JaxMeshConfig(sequence_parallel_size=2,
                                    tensor_parallel_size=2),
                      jax.devices()[:4])
    one = ModelRunner(EngineConfig(**{**COMMON, "device": "cpu"}), tcfg,
                      params)
    with runner_on(ranks, SP, tcfg, params) as runner:
        assert runner.sp_group.size() == 2 and runner.tp_group.size() == 2
        before = runner.rank_reports()
        rows = 0  # a rank's rows of every encode
        for ids in (REPEAT + RANDOM, RANDOM[:10]):  # 36 -> 64, 10 -> 16
            toks, n = runner.encode_input(ids)
            assert toks.shape[1] % 2 == 0
            rows += toks.shape[1] // 2
            got = runner.encode(ids)
            want = np.asarray(jmodel.encode(
                jparams, jnp.asarray(toks), jnp.asarray([n], jnp.int32),
                sp_size=2, mesh=mesh))[0]
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got, one.encode(ids), rtol=TOL,
                                       atol=TOL)
        after = runner.rank_reports()
    for b, a in zip(before, after):
        # One hop a layer at sp 2, of this rank's K and V block: its rows
        # of 4 kv heads x 16 lanes each in fp32.
        ring_calls = a["traffic"]["sp_ring"]["calls"] - b["traffic"][
            "sp_ring"]["calls"]
        ring_bytes = a["traffic"]["sp_ring"]["bytes"] - b["traffic"][
            "sp_ring"]["bytes"]
        assert ring_calls == 2 * tcfg.num_layers
        assert ring_bytes == tcfg.num_layers * 2 * rows * 4 * 16 * 4
    assert [r["coords"]["sp"] for r in after] == [0, 0, 1, 1]


def test_the_jax_start_checks_refuse_a_ring_over_a_pipeline():
    with pytest.raises(ValueError, match="does not compose with pipeline"):
        multihost.start_ranks(EngineConfig(sequence_parallel_size=2,
                                           pipeline_parallel_size=2,
                                           device="cpu"))
    model = Llama(get_model_config("tiny-llama-debug"))
    tokens, lengths = torch.zeros((1, 4), dtype=torch.long), torch.tensor([4])
    with pytest.raises(ValueError, match="does not compose with pipeline"):
        model.encode({}, tokens, lengths, sp_group=_Group(2),
                      pp_group=_Group(2))
    tiny = get_model_config("tiny-llama-debug")
    for cfg in (get_model_config("tiny-gemma2-debug"),
                dataclasses.replace(tiny, sliding_window=16),
                dataclasses.replace(tiny, attn_logit_softcap=50.0)):
        with pytest.raises(ValueError, match="sliding-window/softcap"):
            Llama(cfg).encode({}, tokens, lengths, sp_group=_Group(2))
    assert EngineConfig(sequence_parallel_size=2).num_ranks == 2


def test_server_serves_sp2_tp2_and_sigterm_stops_every_rank():
    port = _free_port()
    argv = ["--device", "cpu", "--sequence-parallel-size", "2",
            "--tensor-parallel-size", "2", "--port", str(port), "--host",
            "127.0.0.1", "--model", "tiny-llama-debug", "--block-size", "8",
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
        one = LLMEngine(EngineConfig(device="cpu", **ENGINE))
        prompt = "ring attention over the sequence"
        want = one.generate([prompt], SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))[0]["text"]
        status, raw = _call(port, "POST", "/v1/completions", {
            "model": "tiny-llama-debug", "prompt": prompt, "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True})
        assert status == 200, raw
        assert json.loads(raw)["choices"][0]["text"] == want
        status, raw = _call(port, "POST", "/v1/embeddings", {
            "model": "tiny-llama-debug", "input": prompt})
        assert status == 200, raw
        got = json.loads(raw)["data"][0]["embedding"]
        ids = one.tokenizer.encode(prompt)
        np.testing.assert_allclose(got, one.runner.encode(ids), rtol=TOL,
                                   atol=TOL)
        status, raw = _call(port, "GET", "/debug/state")
        state = json.loads(raw)
        assert [(r["rank"], r["sp"], r["ep"], r["tp"])
                for r in state["ranks"]] == [
            (0, 0, 0, 0), (1, 0, 0, 1), (2, 1, 0, 0), (3, 1, 0, 1)]
        assert state["stats"]["sequence_parallel_size"] == 2.0
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
