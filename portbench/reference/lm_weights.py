"""The inputs of the benchmark's LM cells, made from the seed: the weights
and the sessions' prompts.

The program and the reference both take them from here, each for itself:
the driver before its set-up, the check again after the program's state
is freed.  Plain torch and numpy; nothing here imports the program.

Weights follow the configuration's ``init`` law at a trained model's
scale: every matrix N(0, ``std``), the output projections (``out_leaves``:
attention's ``wo`` and each FFN's ``w2``) N(0, ``std / sqrt(2 *
num_hidden_layers)``), norms 1.  They are drawn on the device in float32
(the type the port stores its parameters in) into one flat buffer, leaf
after leaf in a fixed order, by one ``torch.Generator`` seeded from
(seed, :data:`WEIGHTS`).  The tree has the names and the stacked
``(layers, ...)`` shapes of the port's parameter tree, which are the
published model's matrices: ``embed``, ``final_norm``, and the stacks
``dense_layers`` (the leading ``first_k_dense_replace`` layers) and
``moe_layers``, each with ``attn_norm``, ``ffn_norm``, ``attn`` (``wq``,
``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``) and ``ffn`` (``w1``,
``w3``, ``w2``; in an expert layer ``router``, the experts' stacked
``w1``, ``w3``, ``w2`` and ``shared``); with ``tie_word_embeddings``
false, an ``lm_head`` of the embedding's shape besides.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, PROMPTS = 4, 5       # the generator's streams beside portbench's 1-3
_ALIGN = 64                   # leaves start on 256-byte boundaries


def _seed(seed: int, stream: int) -> int:
    return int(np.random.default_rng([int(seed), stream]).integers(2**62))


def _ffn(d: int, f: int) -> dict:
    return {"w1": (d, f), "w3": (d, f), "w2": (f, d)}


def _layer(cfg: dict, moe: bool) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    lora, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    attn = {"wq": (d, h, nope + rope), "w_dkv": (d, lora + rope),
            "kv_norm": (lora,), "w_uk": (h, lora, nope),
            "w_uv": (h, lora, v), "wo": (h, v, d)}
    if moe:
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        ffn = {"router": (d, e), "w1": (e, d, f), "w3": (e, d, f),
               "w2": (e, f, d),
               "shared": _ffn(d, cfg["n_shared_experts"] * f)}
    else:
        ffn = _ffn(d, cfg["intermediate_size"])
    return {"attn_norm": (d,), "ffn_norm": (d,), "attn": attn, "ffn": ffn}


def shapes(cfg: dict) -> dict:
    """The weight tree's shapes: {name: shape or subtree}."""
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense

    def stack(tree, n):
        return {k: stack(v, n) if isinstance(v, dict) else (n,) + v
                for k, v in tree.items()}

    out = {"embed": (cfg["vocab_size"], cfg["hidden_size"]),
           "final_norm": (cfg["hidden_size"],)}
    if not cfg.get("tie_word_embeddings", True):
        out["lm_head"] = (cfg["vocab_size"], cfg["hidden_size"])
    if n_dense:
        out["dense_layers"] = stack(_layer(cfg, False), n_dense)
    if n_moe:
        out["moe_layers"] = stack(_layer(cfg, True), n_moe)
    return out


def _leaves(tree: dict, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _std(cfg: dict, path: tuple):
    """The leaf's standard deviation, or None for a norm (all ones)."""
    if path[-1].endswith("norm"):
        return None
    init = cfg["init"]
    if path[-1] in init["out_leaves"]:
        return init["std"] / np.sqrt(2 * cfg["num_hidden_layers"])
    return init["std"]


def draw(cfg: dict, seed: int, device) -> dict:
    """The weight tree of ``seed``: views into one flat float32 buffer on
    ``device``, drawn leaf after leaf by one generator."""
    leaves = list(_leaves(shapes(cfg)))
    sizes = [int(np.prod(s)) for _, s in leaves]
    starts = np.cumsum([0] + [-(-n // _ALIGN) * _ALIGN for n in sizes])
    flat = torch.empty(int(starts[-1]), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, WEIGHTS))
    tree: dict = {}
    for (path, shape), n, o in zip(leaves, sizes, starts):
        leaf = flat[o:o + n].view(shape)
        std = _std(cfg, path)
        if std is None:
            leaf.fill_(1.0)
        else:
            leaf.normal_(0.0, std, generator=gen)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def prompts(cfg: dict, sessions: int, length: int, seed: int) -> np.ndarray:
    """(sessions, length) token ids, uniform over the vocabulary."""
    rng = np.random.default_rng([int(seed), PROMPTS])
    return rng.integers(0, cfg["vocab_size"], (sessions, length))
