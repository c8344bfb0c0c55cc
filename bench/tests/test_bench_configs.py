"""The configuration files against the port's configs: the published
widths, the layer pattern, and the weights' names and shapes."""

import json

import pytest

from harness.manifest import BENCH, load_manifest
from harness.port import Port
from harness.spec import FAMILIES, leaf_shapes, load_spec, spec_from_dict

CONFIGS = [c["name"] for c in load_manifest()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_ports_config_has_the_files_widths(name):
    Port(load_spec(BENCH / "configs" / f"{name}.json"))  # raises if not


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_ports_parameters(name):
    from repro_torch.models.common import ParamTree
    from repro_torch.models.transformer import abstract_params

    spec = load_spec(BENCH / "configs" / f"{name}.json")
    meta = abstract_params(Port(spec).cfg)

    def walk(module, prefix):
        for k in module.keys():
            v = module[k]
            if isinstance(v, ParamTree):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    port = dict(walk(meta.embed, ("embed",)))
    for i, layer in enumerate(meta.layers):
        port.update(walk(layer, ("layers", i)))
    port.update(walk(meta.final_norm, ("final_norm",)))
    assert dict(leaf_shapes(spec)) == port


@pytest.mark.parametrize("name", CONFIGS)
def test_reduced_lists_what_the_file_changes(name):
    entry = next(c for c in load_manifest()["configs"] if c["name"] == name)
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert sorted(entry["reduced"]) == sorted(c["reduced"])
    for key, cut in c["reduced"].items():
        assert c[key] == cut["run"] != cut["published"]
    assert entry["file"] == f"bench/configs/{name}.json"
    assert entry["source"] in c["source"]


def test_jamba_cut_keeps_every_sublayer_kind():
    spec = load_spec(BENCH / "configs" / "jamba-1.5-large-d5.json")
    assert spec.kinds == (("mamba", "mlp"), ("mamba", "moe"),
                          ("mamba", "mlp"), ("mamba", "moe"),
                          ("attn", "mlp"))
    n = sum(__import__("math").prod(s) for _, s in leaf_shapes(spec))
    assert n == pytest.approx(24.05e9, rel=0.002)


def test_qwen_is_whole():
    spec = load_spec(BENCH / "configs" / "qwen1.5-moe-a2.7b.json")
    assert spec.n_layers == 24 and spec.moe.n_experts == 60
    assert spec.moe.padded == 64 and spec.moe.top_k == 4
    assert spec.moe.shared_ff == 5632 and spec.moe.d_ff == 1408


@pytest.mark.parametrize("name", CONFIGS)
def test_each_family_is_a_file_found_by_model_type(name):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert (FAMILIES / f"{c['model_type']}.py").is_file()


def test_a_family_without_a_file_is_refused():
    c = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b.json").read_text())
    c["model_type"] = "no_such_family"
    with pytest.raises(ValueError, match="no_such_family"):
        spec_from_dict(c)
