"""The yardstick: the card's published peaks and the model work the
published architecture does at a configuration's shapes, whatever
implements it.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 989 TFLOP/s
bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.

A matmul of (m, k) by (k, n) is 2 m k n operations. Elementwise work
(norms, activations, softmax) is not counted; nor is what an
implementation adds or recomputes (a precomputed modulation table counts
once per evaluation, as published; a folded decode counts as the unfolded
one)."""
from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def attention(nq: int, nk: int, dim: int, ctx_dim: int, inner: int, out_dim: int) -> float:
    """Projections, scores and values of one attention over one frame."""
    return 2 * (nq * dim * inner + 2 * nk * ctx_dim * inner + 2 * nq * nk * inner + nq * inner * out_dim)


def geglu(rows: int, dim: int, mult: int = 4) -> float:
    inner = dim * mult
    return 2 * rows * (dim * 2 * inner + inner * dim)


def dit_nfe(s: dict) -> float:
    """One denoiser evaluation of the latent DiT for one frame."""
    n, d, inner = s["latents"], s["dim"], s["heads"] * s["dim_head"]
    block = (attention(n, n, d, d, inner, d) + attention(n, s["cond_tokens"], d, s["token_channel"], inner, d)
             + geglu(n, d, s["ff_mult"]) + 3 * 2 * d * 2 * d)
    embed = 2 * (256 * inner + inner * inner)
    return 2 * n * s["channels"] * inner * 2 + s["depth"] * block + embed


def _conv(cin: int, cout: int, k: int, voxels: int) -> float:
    return 2 * cin * cout * k ** 3 * voxels


def radar_encoder(s: dict) -> float:
    """The 3D-CNN over one upsampled cube (five levels, multipliers 1, 1,
    2, 2, 4, two ResNet blocks a level, attention at the (8, 4, 2) level
    and in the middle), plus the token projection."""
    ch, mults = s["enc_ch"], (1, 1, 2, 2, 4)
    res = list(s["enc_res"])
    vox = res[0] * res[1] * res[2]
    total, cin = _conv(1, ch, 3, vox), ch
    for i, m in enumerate(mults):
        cout = ch * m
        for _ in range(2):
            total += _conv(cin, cout, 3, vox) + _conv(cout, cout, 3, vox)
            total += _conv(cin, cout, 1, vox) if cin != cout else 0
            cin = cout
            if tuple(res) == (8, 4, 2):
                total += 4 * _conv(cin, cin, 1, vox) + 2 * 2 * vox * vox * cin
        if i != len(mults) - 1:
            res = [r // 2 for r in res]
            vox = res[0] * res[1] * res[2]
            total += _conv(cin, cin, 3, vox)
    total += 2 * (_conv(cin, cin, 3, vox) * 2) + 4 * _conv(cin, cin, 1, vox) + 2 * 2 * vox * vox * cin
    total += _conv(cin, s["enc_z"], 3, vox)
    return total + 2 * vox * s["enc_z"] * s["token_channel"]


def vae_decode(s: dict, queries: int) -> float:
    """The VAE decoder for one frame: latent projection, the
    self-attention stack, and the single-head cross-attention decode of
    ``queries`` points (Fourier embedding, query projection, scores,
    values, output projection, occupancy head)."""
    m, d = s["vae_latents"], s["vae_dim"]
    stack = 2 * m * s["channels"] * d + s["vae_depth"] * (attention(m, m, d, d, d, d) + geglu(m, d))
    per_query = 2 * 51 * d + 2 * d * d + 2 * 2 * m * d + 2 * d * d + 2 * d
    return stack + 2 * 2 * m * d * d + queries * per_query


def vae_encode(s: dict) -> float:
    """The VAE encoder for one cloud of ``lidar_points``: Fourier embedding,
    the mix queries attending to the cloud, the query projection, the
    single-head cross-attention and its FF, the posterior heads."""
    m, d, n = s["vae_latents"], s["vae_dim"], s["lidar_points"]
    return (2 * n * 51 * d + attention(m, n, d, d, d, d) + 2 * m * d * d + attention(m, n, d, d, d, d)
            + geglu(m, d) + 2 * 2 * m * d * s["channels"])


def eval_frame(s: dict, nfe: int, queries: int) -> float:
    """The model work of one eval frame: the radar encoder, ``nfe``
    denoiser evaluations and the decode of ``queries`` points."""
    return radar_encoder(s) + nfe * dit_nfe(s) + vae_decode(s, queries)


def train_frame(s: dict) -> float:
    """The model work of one training frame: the frozen VAE's encode, and
    the DiT and radar encoder forward and backward (three times the
    forward)."""
    return vae_encode(s) + 3 * (dit_nfe(s) + radar_encoder(s))
