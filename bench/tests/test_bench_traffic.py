"""The traffic generator: equal tokens a call, the shapes in equal
shares, the order set by the seed."""

import collections

import pytest
import torch

from harness.manifest import BENCH, load_manifest
from harness.traffic import call_shapes, load_mix, prompt_pool


PREFILL_MIXES = ["prefill_16k_mix", "prefill_16k_to8k"]


@pytest.fixture(params=PREFILL_MIXES)
def mix(request):
    return load_mix(BENCH / "traffic" / f"{request.param}.json")


def test_every_call_holds_16384_tokens(mix):
    assert {B * S for B, S in call_shapes(mix, 5, 64)} == {16384}


def test_shapes_come_in_seeded_cycles(mix):
    k = len(mix["shapes"])
    shapes = call_shapes(mix, 2**31 + 11, 10 * k)
    for i in range(0, 10 * k, k):
        assert sorted(shapes[i:i + k]) == sorted(map(tuple, mix["shapes"]))
    assert set(collections.Counter(shapes).values()) == {10}


def test_order_is_the_seeds(mix):
    a = call_shapes(mix, 2**33 + 1, 32)
    assert a == call_shapes(mix, 2**33 + 1, 32)
    assert a != call_shapes(mix, 2**33 + 2, 32)


def test_qwen_mix_stays_within_its_positions():
    import json

    c = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b.json").read_text())
    w = next(w for w in load_manifest()["workloads"]
             if w["name"] == "qwen_moe.prefill")
    mix = load_mix(BENCH / "traffic" / f"{w['traffic']}.json")
    assert max(S for _, S in mix["shapes"]) <= c["max_position_embeddings"]


def test_prompts_are_the_seeds():
    a = prompt_pool(3, 64, 1000, 2**32 + 5, "cpu")
    assert torch.equal(a, prompt_pool(3, 64, 1000, 2**32 + 5, "cpu"))
    assert not torch.equal(a, prompt_pool(3, 64, 1000, 2**32 + 6, "cpu"))
    assert int(a.min()) >= 1 and int(a.max()) < 1000


def test_a_mix_of_unequal_calls_is_refused(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"loop": "prefill", "shapes": [[1, 8], [2, 8]]}')
    with pytest.raises(ValueError, match="same"):
        load_mix(p)


@pytest.mark.parametrize("name", PREFILL_MIXES + ["decode_32x512"])
def test_every_mix_named_by_a_cell_loads(name):
    used = {w["traffic"] for w in load_manifest()["workloads"]}
    assert name in used
    load_mix(BENCH / "traffic" / f"{name}.json")
