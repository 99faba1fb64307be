"""The completion route's ``n``, ``best_of``, ``echo``, ``suffix`` and
batched prompts against the JAX server's, on the CPU.

The JAX server and the port's serve ``tiny-llama-debug`` from the same
weights (the fixtures of ``test_torch_admin_routes.py``). The same
requests to both must give the same status codes and bodies — choices,
logprobs and usage — ids and timestamps aside, logprobs within
``LOGPROB_ATOL``: ``n`` candidates seeded ``seed + i``, ``best_of``
candidates ranked by mean token logprob, an echoed prompt with its null
logprob entries and text offsets, an ignored ``suffix``, a list of
strings and a list of token-id lists, and every 400 the JAX server gives
for these fields.
"""

from .test_torch_admin_routes import (  # noqa: F401 (fixtures)
    MODEL,
    _call,
    _frames,
    _json,
    _same,
    jax_params,
    servers,
)

BASE = {"model": MODEL, "prompt": "Choices, choices.", "max_tokens": 6,
        "temperature": 0.9, "top_k": 40, "seed": 77, "ignore_eos": True}


def _both(servers, body, path="/v1/completions"):
    jport, port, _ = servers
    want, got = (_json(p, "POST", path, body) for p in (jport, port))
    assert got[0] == want[0], (got[1], want[1])
    assert _same(got[1], want[1]), (got[1], want[1])
    return got[1]


def test_n_candidates_are_seeded_and_equal_jax(servers):
    out = _both(servers, dict(BASE, n=3))
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert out["usage"]["completion_tokens"] == 3 * 6
    # Candidate i is the single request seeded seed + i.
    texts = [c["text"] for c in out["choices"]]
    for i in range(3):
        one = _both(servers, dict(BASE, seed=BASE["seed"] + i))
        assert one["choices"][0]["text"] == texts[i]
    # A chat's n, with logprobs.
    chat = {"model": MODEL, "messages": [{"role": "user", "content": "Hi"}],
            "max_tokens": 5, "temperature": 0.9, "seed": 5, "n": 2,
            "logprobs": True, "top_logprobs": 2, "ignore_eos": True}
    out = _both(servers, chat, "/v1/chat/completions")
    assert len(out["choices"]) == 2 and out["usage"]["completion_tokens"] == 10


def test_best_of_keeps_the_best_mean_logprob_as_jax(servers):
    for extra in ({}, {"logprobs": 1}):
        out = _both(servers, dict(BASE, n=2, best_of=4, **extra))
        assert len(out["choices"]) == 2
        assert out["usage"]["completion_tokens"] == 4 * 6  # all billed
        if extra:
            means = [sum(c["logprobs"]["token_logprobs"]) / 6
                     for c in out["choices"]]
            assert means == sorted(means, reverse=True)
        else:
            assert all(c["logprobs"] is None for c in out["choices"])


def test_echo_leads_the_text_and_the_logprobs(servers):
    jport, port, _ = servers
    body = dict(BASE, echo=True, logprobs=2, temperature=0.0)
    out = _both(servers, body)
    lp, text = out["choices"][0]["logprobs"], out["choices"][0]["text"]
    n_prompt = out["usage"]["prompt_tokens"]
    assert text.startswith(BASE["prompt"])
    assert lp["token_logprobs"][:n_prompt] == [None] * n_prompt
    assert lp["top_logprobs"][:n_prompt] == [None] * n_prompt
    assert len(lp["tokens"]) == n_prompt + 6
    assert lp["text_offset"][n_prompt] == len(BASE["prompt"])
    # Echo without logprobs, and echo streamed: the prompt leads the first
    # chunk, whose text_offset starts after it.
    _both(servers, dict(BASE, echo=True))
    stream = dict(body, stream=True)
    want, got = (_call(p, "POST", "/v1/completions", stream)
                 for p in (jport, port))
    assert got[0] == want[0] == 200
    frames = _frames(got[1])
    assert _same(frames, _frames(want[1]))
    assert frames[0]["choices"][0]["text"].startswith(BASE["prompt"])
    assert frames[0]["choices"][0]["logprobs"]["text_offset"] == [
        len(BASE["prompt"])]


def test_suffix_is_accepted_and_ignored(servers):
    plain = _both(servers, BASE)
    out = _both(servers, dict(BASE, suffix=" and so on."))
    assert out["choices"] == plain["choices"] and out["usage"] == plain["usage"]


def test_batched_prompts_one_choice_each(servers):
    texts = ["First prompt.", "Second, longer prompt here.", "Third"]
    out = _both(servers, dict(BASE, prompt=texts, temperature=0.0))
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert out["usage"]["completion_tokens"] == 18
    assert all(c["logprobs"] is None for c in out["choices"])
    ids = [[72, 105, 33], [1, 2, 3, 4, 5, 6, 7], [300]]
    out = _both(servers, dict(BASE, prompt=ids, temperature=0.0))
    assert out["usage"]["prompt_tokens"] == 11
    # One prompt's ids (a flat list) is one choice.
    out = _both(servers, dict(BASE, prompt=ids[1], temperature=0.0))
    assert len(out["choices"]) == 1 and out["usage"]["prompt_tokens"] == 7


def test_refusals_equal_the_jax_servers(servers):
    jport, port, _ = servers
    refused = [
        dict(BASE, prompt=[]),
        dict(BASE, prompt=["a", "b"], stream=True),
        dict(BASE, prompt=["a", "b"], n=2),
        dict(BASE, prompt=[[1, 2], [3]], best_of=2),
        dict(BASE, n=3, best_of=2),
        dict(BASE, best_of=21),
        dict(BASE, n=129),
        dict(BASE, n=2, stream=True),
        dict(BASE, best_of=3, stream=True),
        dict(BASE, prompt="x" * 300),
        dict(BASE, prompt=["ok", "y" * 300]),
    ]
    for body in refused:
        want, got = (_json(p, "POST", "/v1/completions", body)
                     for p in (jport, port))
        assert want[0] == got[0] == 400, (body, want, got)
        # The port's errors keep the OpenAI shape ({"error": {...}}).
        assert got[1]["error"] == {k: want[1][k]
                                   for k in ("message", "type", "code")}
    # Malformed prompts are 400s on both sides (the messages are each
    # parser's own).
    for prompt in ([1, "a"], {"x": 1}, [[1], "a"], None):
        statuses = [_json(p, "POST", "/v1/completions",
                          dict(BASE, prompt=prompt))[0] for p in (jport, port)]
        assert statuses == [400, 400], prompt
