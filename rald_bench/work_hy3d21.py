"""The yardstick of Hunyuan3D-2.1's shape generator (arXiv:2506.15442): the
matmul work of the published model at a configuration's shapes, whatever
implements it, counted as :mod:`rald_bench.work` counts (a matmul of (m,
k) by (k, n) is 2 m k n operations; norms, activations, softmax, top-k and
the routing's sort and gathers are not counted). A mixture-of-experts
feed-forward counts its gate, its ``top_k`` routed experts and its shared
expert for every token; the time token counts once per evaluation and row,
as published.

The widths come from the configuration file's ``published`` block, not
from the system under test. The ShapeVAE decoder is counted as
:mod:`rald_bench.work_hy3d` counts it."""
from __future__ import annotations

from rald_bench import work_hy3d
from rald_bench.work import PEAK_BF16, PEAK_BYTES


def sizes(config: dict) -> dict:
    """The published widths of a configuration file (``configs/<name>.json``)."""
    pub = config["published"]
    dit, vae, cond = pub["dit"], pub["vae"], pub["condition"]
    return {
        "latents": int(vae["num_latents"]), "channels": int(dit["in_channels"]),
        "cond_tokens": int(cond["tokens"]), "ctx": int(dit["context_dim"]),
        "dim": int(dit["hidden_size"]), "mlp": int(dit["hidden_size"] * dit["mlp_ratio"]),
        "depth": int(dit["depth"]), "heads": int(dit["num_heads"]),
        "moe_layers": int(dit["num_moe_layers"]),
        "experts": int(dit["num_experts"]), "top_k": int(dit["moe_top_k"]),
        "vae_dim": int(vae["width"]), "vae_depth": int(vae["num_decoder_layers"]),
        "vae_mlp": int(vae["width"] * vae["geo_decoder_mlp_expand_ratio"]),
        "fourier": 3 * (2 * int(vae["num_freqs"]) + 1),
    }


def ffn(rows: int, s: dict) -> float:
    """One ``dim -> mlp -> dim`` feed-forward over ``rows`` rows."""
    return 2 * 2 * rows * s["dim"] * s["mlp"]


def dit_row(s: dict) -> float:
    """One DiT evaluation of one batch row: the embeddings and the time
    token's MLP, every block's self-attention (projections, scores and
    values over ``latents + 1`` tokens), cross-attention (the keys and
    values of the ``cond_tokens`` condition tokens included), feed-forward
    (the mixtures' gate, ``top_k`` routed and one shared expert), the long
    skips' linear, and the final layer."""
    n, t, d = s["latents"] + 1, s["cond_tokens"], s["dim"]
    embed = 2 * s["latents"] * s["channels"] * d + 2 * 2 * d * 4 * d
    self_attn = 2 * 4 * n * d * d + 2 * 2 * n * n * d
    cross = 2 * 2 * n * d * d + 2 * 2 * t * s["ctx"] * d + 2 * 2 * n * t * d
    dense = ffn(n, s)
    moe = 2 * n * d * s["experts"] + (s["top_k"] + 1) * ffn(n, s)
    skip = 2 * n * 2 * d * d
    n_moe, n_skip = s["moe_layers"], s["depth"] - s["depth"] // 2 - 1
    blocks = s["depth"] * (self_attn + cross) + (s["depth"] - n_moe) * dense + n_moe * moe
    final = 2 * s["latents"] * d * s["channels"]
    return embed + blocks + n_skip * skip + final


def flow_sample(s: dict, rows: int) -> float:
    """The sampler's DiT work: ``rows`` batch rows of evaluations (2 a frame
    and step under guidance; the engine's ``flow_counts()["rows"]``)."""
    return rows * dit_row(s)


def geo_decode(s: dict, frames: int, queries: int) -> float:
    """The decoder's work over ``frames`` latent sets and ``queries`` points."""
    return work_hy3d.geo_decode(s, frames, queries)


def eval_frame(s: dict, num_steps: int, queries: int, cfg_rows: int = 2) -> float:
    """The model work of one eval frame: ``num_steps`` evaluations of
    ``cfg_rows`` rows and the decode of ``queries`` points."""
    return flow_sample(s, num_steps * cfg_rows) + geo_decode(s, 1, queries)


def parameters(s: dict) -> dict:
    """The published DiT's parameters, counted from the widths: ``dit`` in
    all, ``moe`` in its mixtures (gates, routed and shared experts)."""
    d, f, c, head = s["dim"], s["mlp"], s["channels"], s["dim"] // s["heads"]
    ln = 2 * d
    self_attn = 4 * d * d + d + 2 * head  # q, k, v without bias, out_proj, the QK-norms
    cross = 2 * d * d + d + 2 * s["ctx"] * d + 2 * head
    one_ffn = 2 * d * f + f + d
    moe = s["experts"] * d + (s["experts"] + 1) * one_ffn
    n_moe, n_skip = s["moe_layers"], s["depth"] - s["depth"] // 2 - 1
    blocks = (s["depth"] * (3 * ln + self_attn + cross) + (s["depth"] - n_moe) * one_ffn
              + n_moe * moe + n_skip * (2 * d * d + d + ln))
    embed = c * d + d + (d * 4 * d + 4 * d) + (4 * d * d + d)
    final = ln + d * c + c
    return {"dit": embed + blocks + final, "moe": n_moe * moe}


def grouped_ffn_bound(s: dict, rows: int, calls: int) -> float:
    """The least seconds of ``calls`` calls of the routed experts' grouped
    feed-forward over ``rows`` routed rows in all (``top_k`` a token):
    its operations at the bf16 peak, or its bytes at the HBM peak, the
    larger (each call reads every expert's weights and biases once, and
    its rows and outputs once, its hidden activations twice, in bf16, and
    a float32 gate weight a row)."""
    d, f = s["dim"], s["mlp"]
    flops = ffn(rows, s)
    weights = s["experts"] * (2 * d * f + f + d) * 2
    n_bytes = calls * weights + rows * ((2 * d + 2 * f) * 2 + 4)
    return max(flops / PEAK_BF16, n_bytes / PEAK_BYTES)
