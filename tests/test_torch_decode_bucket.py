"""Fault 3.8: a decode's split count must not follow the block table's
width bucket.

The split-KV and CUDA-core decodes partition each row's keys into a
planned number of splits, and the partition sets the row's rounding. The
runner pads block tables to a bucket of the pages its sequences hold,
and the overlapped decode holds the next page a step earlier than the
synchronous loop. A plan by the table's width therefore rounded a row
decoded near a bucket boundary by when the pipeline engaged, and one
greedy request's tokens could part with the arrival gates' clock.

Here, on the CPU: the wrappers' launch plan at every table width equals
the plan at the cache's page count; and a tiny engine's prefix hit whose
decode crosses the 64-page bucket, with the pipeline's arrival gate
opened from each of engine steps 0 to 8, decodes the row before the
boundary over the 64-page or the 128-page table by the engagement step,
while every launch plans the same splits, and its tokens equal the
synchronous loop's. The kernels' rounding
itself is held on the card (``chip_smoke.py`` phase 4j(d)).
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.ops import paged_attention_cuda as pac

E4M3 = torch.float8_e4m3fn


@pytest.mark.parametrize("route, q_dtype, cache_dtype, H, KH, hd, nb", [
    ("split", torch.bfloat16, torch.bfloat16, 32, 8, 128, 14219),
    ("split", torch.bfloat16, E4M3, 32, 8, 128, 28438),
    ("split", torch.bfloat16, torch.bfloat16, 16, 8, 256, 3000),
    ("simt", torch.float32, torch.float32, 8, 8, 16, 256),
    ("simt", torch.bfloat16, E4M3, 8, 8, 64, 700),
])
def test_a_launch_plans_at_the_caches_width(route, q_dtype, cache_dtype, H,
                                            KH, hd, nb):
    assert pac.kernel_route("decode", q_dtype, cache_dtype, H, KH,
                            hd) == route
    bs, n_sm = 32, 132
    kv_pages = torch.empty((2, nb, 2, bs, KH * hd), dtype=cache_dtype,
                           device="meta")
    plan = (pac.decode_plan(1, KH, nb, bs, n_sm, hd, cache_dtype == E4M3)
            if route == "split" else
            pac.simt_decode_plan(1, KH, nb, bs, n_sm, hd,
                                 cache_dtype.itemsize))
    for B in (1, 2, 8, 64):
        q3 = torch.empty((B, H, hd), dtype=q_dtype, device="meta")
        splits = {pac.decode_launch_splits(
            route, q3, kv_pages,
            torch.empty((B, W), dtype=torch.int32, device="meta"), n_sm)
            for W in (1, 2, 4, 64, 128, 256, nb)}
        assert len(splits) == 1, (B, splits)
        if B == 1:
            assert splits == {plan}


def _prefix_hit(engage_at=None):
    """A 505-token prompt served for 1 token, then as a prefix hit for 16
    greedy tokens over 8-token pages: the decode crosses the 64-page
    table bucket at position 512. ``engage_at``: the overlapped decode,
    its arrival gate opened from that engine step on (None: the
    synchronous loop). Returns the tokens, the (position, table width)
    of each decode batch built and the engine."""
    cfg = EngineConfig(model="tiny-llama-debug", device="cpu",
                       max_model_len=2048, block_size=8, num_kv_blocks=256,
                       max_prefill_tokens=512,
                       overlap_decode=engage_at is not None)
    eng = LLMEngine(cfg)
    widths = []
    build = eng.runner._decode_batch

    def recorded(seqs, multi=False):
        batch = build(seqs, multi)
        widths.append((int(batch["positions"].reshape(-1)[0]),
                       batch["block_tables"].shape[1]))
        return batch

    eng.runner._decode_batch = recorded
    if engage_at is not None:
        calls = {"n": 0}

        def gate():
            calls["n"] += 1
            return calls["n"] > engage_at

        eng._arrival_safe = gate
    prompt = np.random.default_rng(60).integers(1, 512, 505).tolist()
    toks = []
    for rid, n in (("w", 1), ("r", 16)):
        eng.add_request(rid, prompt_token_ids=prompt,
                        sampling=SamplingParams(max_tokens=n, temperature=0.0,
                                                ignore_eos=True))
        while eng.has_work():
            for out in eng.step():
                toks += out.new_token_ids
    return toks, widths, eng


def test_a_rows_table_width_follows_the_engagement_step():
    ref, ref_widths, eng = _prefix_hit()
    first = min(p for p, w in ref_widths if w == 128)
    kv_pages = eng.runner.kv_cache
    hd = eng.model_cfg.head_dim
    q3 = torch.empty((eng.runner._row_bucket(1), eng.model_cfg.num_heads,
                      hd), dtype=torch.float32, device="meta")
    route = pac.kernel_route("decode", q3.dtype, kv_pages.dtype,
                             q3.shape[1], eng.model_cfg.num_kv_heads, hd)

    def splits(W):
        tables = torch.empty((q3.shape[0], W), dtype=torch.int32,
                             device="meta")
        return pac.decode_launch_splits(route, q3, kv_pages, tables, 132)

    def width_at(widths, pos):
        """The table width row ``pos`` decoded over: its batch's, or the
        in-flight burst's it continued."""
        return [w for p, w in widths if p <= pos][-1]

    assert first == 512 and width_at(ref_widths, 511) == 64
    row_511 = {}
    for k in range(9):
        toks, widths, _ = _prefix_hit(k)
        assert toks == ref and len(ref) == 17, k
        row_511[k] = width_at(widths, 511)
        assert {splits(w) for _, w in widths + ref_widths} == {splits(64)}
    # The pipelined engine holds a page a burst ahead: a burst built on row
    # 511 holds page 64 already and decodes the row over the 128-page
    # table, a burst that continued onto it keeps its 64-page width. Which
    # one ran follows the engagement step.
    assert set(row_511.values()) == {64, 128}, row_511
