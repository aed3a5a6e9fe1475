"""The yardstick of Hunyuan3D-2.0's shape generator (arXiv:2501.12202): the
matmul work of the published model at a configuration's shapes, whatever
implements it, counted as :mod:`rald_bench.work` counts (a matmul of (m,
k) by (k, n) is 2 m k n operations; norms, activations and softmax are not
counted; a modulation row counts once per evaluation and row, as
published, and a hoisted ``cond_in`` once per evaluation too).

The widths come from the configuration file's ``published`` block, not
from the system under test."""
from __future__ import annotations


def sizes(config: dict) -> dict:
    """The published widths of a configuration file (``configs/<name>.json``)."""
    pub = config["published"]
    dit, vae, cond = pub["dit"], pub["vae"], pub["condition"]
    return {
        "latents": int(vae["num_latents"]), "channels": int(dit["in_channels"]),
        "cond_tokens": int(cond["tokens"]), "ctx": int(dit["context_in_dim"]),
        "dim": int(dit["hidden_size"]), "mlp": int(dit["hidden_size"] * dit["mlp_ratio"]),
        "double": int(dit["depth"]), "single": int(dit["depth_single_blocks"]),
        "vae_dim": int(vae["width"]), "vae_depth": int(vae["num_decoder_layers"]),
        "vae_mlp": int(vae["width"] * vae["geo_decoder_mlp_expand_ratio"]),
        "fourier": 3 * (2 * int(vae["num_freqs"]) + 1),
    }


def dit_row(s: dict) -> float:
    """One DiT evaluation of one batch row: the embeddings, every block's
    modulation, the dual-stream blocks (both streams' projections and MLPs,
    the joint attention's scores and values over all ``latents +
    cond_tokens`` tokens), the single-stream blocks and the final layer."""
    n, t, d, f = s["latents"], s["cond_tokens"], s["dim"], s["mlp"]
    rows = n + t
    embed = 2 * (n * s["channels"] * d + t * s["ctx"] * d + 256 * d + d * d)
    mods = 2 * d * d * (12 * s["double"] + 3 * s["single"] + 2)
    joint = 2 * 2 * rows * rows * d
    double = 2 * rows * d * (3 * d + d + 2 * f) + joint
    single = 2 * rows * d * (3 * d + f) + 2 * rows * (d + f) * d + joint
    final = 2 * n * d * s["channels"]
    return embed + mods + s["double"] * double + s["single"] * single + final


def flow_sample(s: dict, rows: int) -> float:
    """The sampler's DiT work: ``rows`` batch rows of evaluations (2 a frame
    and step under guidance; the engine's ``flow_counts()["rows"]``)."""
    return rows * dit_row(s)


def vae_stack(s: dict) -> float:
    """``post_kl`` and the self-attention stack over one frame's latents,
    and the cross-attention's key / value projection of them."""
    m, w = s["latents"], s["vae_dim"]
    layer = 2 * m * w * (3 * w + w + 2 * s["vae_mlp"]) + 2 * 2 * m * m * w
    return 2 * m * s["channels"] * w + s["vae_depth"] * layer + 2 * m * w * 2 * w


def per_query(s: dict) -> float:
    """One query point through the geometry decoder: ``query_proj``, ``c_q``,
    the scores and values over every latent, ``c_proj``, the MLP and the
    output head."""
    m, w = s["latents"], s["vae_dim"]
    return 2 * (s["fourier"] * w + 2 * w * w + 2 * w * s["vae_mlp"] + w) + 2 * 2 * m * w


def geo_decode(s: dict, frames: int, queries: int) -> float:
    """The decoder's work over ``frames`` latent sets and ``queries`` points
    (the engine's ``flow_counts()["queries_decoded"]``)."""
    return frames * vae_stack(s) + queries * per_query(s)


def eval_frame(s: dict, num_steps: int, queries: int, cfg_rows: int = 2) -> float:
    """The model work of one eval frame: ``num_steps`` evaluations of
    ``cfg_rows`` rows and the decode of ``queries`` points."""
    return flow_sample(s, num_steps * cfg_rows) + geo_decode(s, 1, queries)
