"""The wire half of the OpenAI facade in the PyTorch port
(``veles_tpu_torch/serving/openai_api.py``: request parsing and reply
shaping) held against the JAX package's on the CPU.

Oracle: ``tests/test_streaming.py::test_openai_facade_roundtrip``.

Every body of the table gives the same parse in both packages, or a
``ValueError`` with the same message (the REST layer's 400 bodies).
Replies are compared as JSON values; ``id`` and ``created`` (random and
clock) only by form."""

import json

import numpy
import pytest
import torch

from veles_tpu.serving import openai_api as ref
from veles_tpu_torch.serving import openai_api as port

pytestmark = pytest.mark.torch_port

#: /v1/completions bodies: neutral SDK defaults, every rejected
#: parameter, and bad prompt / max_tokens / stop / seed / sampler values
BODIES = [
    {"prompt": [3, 1, 4], "max_tokens": 6},
    {"prompt": [3, 1, 4]},
    {"prompt": [[3, 1, 4], [5, 2]], "max_tokens": 4, "echo": True},
    {"prompt": [3, 1], "max_tokens": 2, "top_p": 1, "n": 1,
     "best_of": 1, "presence_penalty": 0, "frequency_penalty": 0.0},
    {"prompt": [3, 1], "max_tokens": 2, "temperature": 0.8, "top_k": 4,
     "seed": "5", "stop": "7", "stream": 1, "priority": "high",
     "model": "m2"},
    {"prompt": [3, 1], "max_tokens": "3", "temperature": None,
     "top_k": None, "logprobs": 0, "logit_bias": {}, "suffix": ""},
    {"prompt": ["3", 1.0]},
    {"prompt": [3, 1], "n": 3},
    {"prompt": [3, 1], "best_of": 2},
    {"prompt": [3, 1], "top_p": 0.9},
    {"prompt": [3, 1], "presence_penalty": 0.5},
    {"prompt": [3, 1], "frequency_penalty": -1},
    {"prompt": [3, 1], "logprobs": 5},
    {"prompt": [3, 1], "logit_bias": {"3": 1}},
    {"prompt": [3, 1], "suffix": "end"},
    {"max_tokens": 2},
    {"prompt": "text", "max_tokens": 2},
    {"prompt": [], "max_tokens": 2},
    {"prompt": 7},
    {"prompt": {"a": 1}},
    {"prompt": [[3, 1], []]},
    {"prompt": [[3, 1], 4]},
    {"prompt": [[3, [1]]]},
    {"prompt": [3, "x"]},
    {"prompt": [3, None]},
    {"prompt": [3, 1], "max_tokens": "many"},
    {"prompt": [3, 1], "max_tokens": None},
    {"prompt": [3, 1], "max_tokens": 0},
    {"prompt": [3, 1], "max_tokens": -2},
    {"prompt": [3, 1], "temperature": "hot"},
    {"prompt": [3, 1], "top_k": "k"},
    {"prompt": [3, 1], "top_k": [1]},
    {"prompt": [3, 1], "stop": "eos"},
    {"prompt": [3, 1], "stop": [1]},
    {"prompt": [3, 1], "seed": "s"},
    {"prompt": [3, 1], "seed": [1]},
    {"prompt": [3, 1], "n": "one"},
]


def _outcome(fn, *args):
    """``fn(*args)``'s result, or its exception's type name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # compared across packages below
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("body", BODIES, ids=[json.dumps(b)[:48]
                                              for b in BODIES])
def test_parse_completions_matches_reference(body):
    got = _outcome(port.parse_completions, dict(body))
    want = _outcome(ref.parse_completions, dict(body))
    assert got == want


@pytest.mark.parametrize("raw", [
    [3, 1, 4], [[3, 1], [4]], [], None, "ab", 5, [[]], [[1], "x"],
    [["1", 2.0]], [[1, "y"]], [{"a": 1}]])
@pytest.mark.parametrize("what", ["prompt", "input"])
def test_parse_token_rows_matches_reference(raw, what):
    assert _outcome(port.parse_token_rows, raw, what) \
        == _outcome(ref.parse_token_rows, raw, what)


def test_model_id_is_an_argument():
    assert port.model_id() == ref.model_id() == "veles-lm"
    assert port.model_id("other") == "other"
    assert port.parse_completions({"prompt": [1]}, "mine")["model"] \
        == "mine"
    assert port.parse_completions({"prompt": [1], "model": "m"},
                                  "mine")["model"] == "m"


@pytest.mark.parametrize("echo,stop,generated", [
    (False, None, [5, 6, 7]), (True, None, [5, 6, 7]),
    (False, 7, [5, 6, 7]), (True, 6, [5, 6, 7]), (False, 7, [])])
def test_completion_shaping_matches_reference(echo, stop, generated):
    params = {"echo": echo, "steps": 3, "stop": stop}
    prompt = [3, 1, 4]
    assert port.completion_choice(1, prompt, generated, params) \
        == ref.completion_choice(1, prompt, generated, params)
    assert port.finish_reason(generated, 3, stop) \
        == ref.finish_reason(generated, 3, stop)
    assert port.text_of(numpy.array([3, 1])) == ref.text_of([3, 1]) == "3 1"
    rows = [prompt, [5, 2]]
    assert port.usage_of(rows, [3, 2]) == ref.usage_of(rows, [3, 2])
    choices = [port.completion_choice(0, prompt, generated, params)]
    usage = port.usage_of([prompt], [len(generated)])
    assert port.completion_reply("cmpl-x", 7, "m", choices, usage) \
        == ref.completion_reply("cmpl-x", 7, "m", choices, usage)
    for finish, use, trace in ((None, None, None),
                               ("length", usage, "t1")):
        assert port.completion_chunk("cmpl-x", 7, "m", 0, generated,
                                     finish=finish, usage=use,
                                     trace_id=trace) \
            == ref.completion_chunk("cmpl-x", 7, "m", 0, generated,
                                    finish=finish, usage=use,
                                    trace_id=trace)


def test_ids_and_model_listing():
    cid = port.completion_id()
    assert cid.startswith("cmpl-") and len(cid) == len(ref.completion_id())
    assert cid != port.completion_id()
    got, want = port.models_reply(), ref.models_reply()
    for reply in (got, want):
        assert isinstance(reply["data"][0].pop("created"), int)
    assert got == want
    assert port.models_reply("other")["data"][0]["id"] == "other"


def test_embed_and_classify_replies_hold_plain_numbers():
    """Vectors and log-probabilities given as tensors, arrays or lists
    shape to the reference's reply of the same lists, plain floats
    throughout (a tensor must never reach ``json.dumps(default=str)``)."""
    rng = numpy.random.default_rng(0)
    vecs = rng.standard_normal((2, 5)).astype(numpy.float32)
    rows = [[3, 1, 4], [5, 2]]
    want = ref.embeddings_reply("m", [v.tolist() for v in vecs], rows)
    for given in (torch.from_numpy(vecs), vecs, [v.tolist() for v in vecs],
                  [torch.from_numpy(v) for v in vecs]):
        got = port.embeddings_reply("m", given, rows)
        assert json.loads(json.dumps(got)) == want
    logits = rng.standard_normal((2, 11))
    logp = logits - numpy.log(numpy.exp(logits).sum(-1, keepdims=True))
    want = ref.classify_reply("m", logp, rows, 3)
    for given in (logp, torch.from_numpy(logp)):
        got = port.classify_reply("m", given, rows, 3)
        assert json.dumps(got) == json.dumps(want)
    assert port.classify_reply("m", logp, rows, 0)["data"][0]["top"] \
        == ref.classify_reply("m", logp, rows, 0)["data"][0]["top"]
