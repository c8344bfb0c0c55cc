"""A model configuration of the benchmark, read from its JSON file.

The file holds the published config's keys (the Hugging Face names) with
the cuts listed under ``reduced`` and the departures under ``assumed``.
:class:`ModelSpec` is what the yardstick reads: the widths, the order of
the layer kinds and the MoE and Mamba settings.  The layer pattern of a
family is a file of its own, ``bench/families/<model_type>.py``, whose
``layout(config)`` gives the keys below that differ by family.  It is built from the
file alone and never from the program, so the reference and the counts
stand apart from what they judge.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

FAMILIES = Path(__file__).resolve().parents[1] / "families"

Sublayer = Tuple[str, str]  # (mixer, ffn): mixer attn|mamba, ffn mlp|moe


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    padded: int  # experts held, padding ones never routed
    top_k: int
    d_ff: int  # one expert's hidden width
    shared_ff: int  # the shared experts' hidden width (0: none)
    capacity_factor: float


@dataclass(frozen=True)
class MambaSpec:
    d_state: int
    d_conv: int
    d_inner: int
    dt_rank: int


@dataclass(frozen=True)
class ModelSpec:
    name: str
    d: int
    n_heads: int
    n_kv: int
    hd: int
    d_ff: int  # the dense MLP's hidden width (0: no dense MLP)
    vocab: int
    eps: float
    rope_theta: float
    tie: bool
    kinds: Tuple[Sublayer, ...]
    moe: Optional[MoESpec]
    mamba: Optional[MambaSpec]
    port: Dict

    @property
    def n_layers(self) -> int:
        return len(self.kinds)


def pad(n: int, to: int) -> int:
    """``n`` rounded up to a multiple of ``to``."""
    return -(-n // to) * to


def load_module(path: Path, prefix: str):
    """The Python file ``path`` as a module named ``prefix`` + its stem."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_from_dict(c: Dict) -> ModelSpec:
    path = FAMILIES / f"{c['model_type']}.py"
    if not path.is_file():
        raise ValueError(f"{c['name']}: no layer pattern for model_type "
                         f"{c['model_type']!r} (no {path})")
    layout = load_module(path, "bench_family_").layout
    d, nh = c["hidden_size"], c["num_attention_heads"]
    return ModelSpec(
        name=c["name"], d=d, n_heads=nh, n_kv=c["num_key_value_heads"],
        hd=c.get("head_dim") or d // nh, vocab=c["vocab_size"],
        eps=float(c["rms_norm_eps"]), tie=bool(c["tie_word_embeddings"]),
        port=dict(c.get("port", {})), **layout(c))


def load_spec(path: Path) -> ModelSpec:
    return spec_from_dict(json.loads(Path(path).read_text()))


def leaf_shapes(spec: ModelSpec) -> List[Tuple[Tuple, Tuple[int, ...]]]:
    """Every weight of the model, as (path, shape), in the order they are
    drawn: the embedding (and the head), each layer, the final norm.  A
    path is ``("embed", name)``, ``("layers", i, group, ..., name)`` or
    ``("final_norm", "scale")``; the names are the JAX package's, which
    the port keeps."""
    d, V = spec.d, spec.vocab
    out: List[Tuple[Tuple, Tuple[int, ...]]] = [(("embed", "embedding"),
                                                 (V, d))]
    if not spec.tie:
        out.append((("embed", "unembed"), (d, V)))
    for i, (mixer, ffn) in enumerate(spec.kinds):
        p = ("layers", i)
        out.append((p + ("norm1", "scale"), (d,)))
        if mixer == "attn":
            nq, nkv, hd = spec.n_heads, spec.n_kv, spec.hd
            out += [(p + ("mixer", "wq"), (d, nq, hd)),
                    (p + ("mixer", "wk"), (d, nkv, hd)),
                    (p + ("mixer", "wv"), (d, nkv, hd)),
                    (p + ("mixer", "wo"), (nq, hd, d))]
        else:
            m = spec.mamba
            di, n, r = m.d_inner, m.d_state, m.dt_rank
            out += [(p + ("mixer", "in_proj"), (d, 2, di)),
                    (p + ("mixer", "conv_w"), (m.d_conv, di)),
                    (p + ("mixer", "conv_b"), (di,)),
                    (p + ("mixer", "x_proj"), (di, r + 2 * n)),
                    (p + ("mixer", "dt_proj"), (r, di)),
                    (p + ("mixer", "dt_bias"), (di,)),
                    (p + ("mixer", "A_log"), (di, n)),
                    (p + ("mixer", "D"), (di,)),
                    (p + ("mixer", "out_proj"), (di, d))]
        out.append((p + ("norm2", "scale"), (d,)))
        if ffn == "mlp":
            f = spec.d_ff
            out += [(p + ("ffn", "wi"), (d, 2, f)),
                    (p + ("ffn", "wo"), (f, d))]
        else:
            m = spec.moe
            E, f = m.padded, m.d_ff
            out += [(p + ("ffn", "router"), (d, E)),
                    (p + ("ffn", "wi"), (E, d, 2, f)),
                    (p + ("ffn", "wo"), (E, f, d))]
            if m.shared_ff:
                out += [(p + ("ffn", "shared", "wi"), (d, 2, m.shared_ff)),
                        (p + ("ffn", "shared", "wo"), (m.shared_ff, d))]
    out.append((("final_norm", "scale"), (d,)))
    return out
