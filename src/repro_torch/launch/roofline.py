"""Roofline terms of the compile report, at the H100's published peaks.

Per (arch, shape, mesh), in seconds, from one card's op counts
(:mod:`repro_torch.launch.op_analysis`: one node's program on one card,
or one rank's of a node of several cards under an in-node layout):

    compute    = Σ_dtype FLOPs[dtype] / PEAK_FLOPS[dtype]
    memory     = bytes / HBM_BW
    collective = collective bytes / NVLINK_BW (the rank's redistributions
                 within its node, JAX's byte convention; 0 on one card.
                 The gossip round's bytes between nodes are the
                 ``federate`` entry's, counted by ``launch/wire``)

The peaks are the H100 SXM data sheet's dense rates at 700 W: 989
TFLOP/s in bf16 and fp16, 67 TFLOP/s in fp32 (TF32 is off in the port,
so an fp32 product runs at the fp32 rate; any other dtype is priced at
it too), 3.35 TB/s of HBM and 80 GB; NVLink's 900 GB/s a card is both
directions together, so a card sends at 450 GB/s.  A card capped below
700 W runs slower, so the report carries the card's ``nvidia-smi`` name
and power limit where a card is present.

:func:`roofline_report` keeps the JAX package's report keys, with these
exceptions: ``fits_80gb_hbm`` (the rank's peak against one card's 80 GB)
in place of ``fits_16gb_hbm``; ``xla_cost_analysis_flops`` is dropped
(there is no XLA); ``flops_by_dtype`` is added; ``memory_analysis`` gives
the arguments, the outputs, the peak of temporaries (every storage the
program allocates, its fresh outputs included), the aliases (outputs
that are argument storages: donated state, caches written in place) and
``peak_bytes_estimate`` = arguments + the peak of temporaries.  JAX's
``collective_bytes_from_hlo`` has no counterpart: the counter sees the
collectives themselves (``OpCount.coll``).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, Optional

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
HBM_BW = 3.35e12          # B/s
HBM_BYTES = 80e9          # the card's 80 GB
# NVLink: 900 GB/s a card on the H100 SXM data sheet, both directions
# together; a collective's bytes leave a card at half of it
NVLINK_BW = 450e9         # B/s a card, one direction


# ---------------------------------------------------------------------------
# analytic model FLOPs (6·N·D train / 2·N·D inference, N_active for MoE)
# ---------------------------------------------------------------------------

def approx_params(cfg, *, active_only: bool = False) -> int:
    """Analytic parameter count from the config (transformer families)."""
    if cfg.family in ("cnn", "resnet"):
        return 0  # paper models: counted from the real tree instead
    d, ff, L, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    hd = cfg.head_dim
    attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
        + cfg.num_heads * hd * d
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        nheads = d_inner // 64
        mixer = d * (2 * d_inner + 2 * cfg.ssm_state + nheads) + d_inner * d
        return v * d + L * mixer
    if cfg.ffn == "gated":
        ffn_dense = 3 * d * ff
    else:
        ffn_dense = 2 * d * ff
    if cfg.is_moe:
        e_count = 1 if active_only else cfg.num_experts
        k = cfg.num_experts_per_tok if active_only else 1
        ffn_p = (ffn_dense * e_count * (k if active_only else 1)) + d * cfg.num_experts
    else:
        ffn_p = ffn_dense
    from repro_torch.models.transformer import block_sequence
    seq = block_sequence(cfg)
    total = v * d
    for kind in seq:
        if kind in ("attn", "lattn", "battn"):
            total += attn + ffn_p
        elif kind == "cross":
            total += 2 * attn + ffn_p
        elif kind == "rec":
            total += 3 * d * d + ffn_dense  # in_rec/in_gate/out + gates
    if cfg.family == "audio":
        total += cfg.encoder_layers * (attn + ffn_p)
    return int(total)


def model_flops(cfg, shape) -> float:
    n = approx_params(cfg, active_only=cfg.is_moe)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if shape.kind == "train":
        # teacher (6ND) + student forward/backward: student counted via its
        # own config at the call site; here N is the *teacher*.
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no card."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    return sum(f / PEAK_FLOPS.get(d, PEAK_FLOPS["fp32"])
               for d, f in flops_by_dtype.items())


def roofline_report(cfg, shape, count, *, chips: int = 1,
                    smi: Optional[str] = None) -> Dict[str, Any]:
    """The report of one card's program: ``count`` is its
    :class:`~repro_torch.launch.op_analysis.OpCount` (one node's on one
    card, or one rank's of a node), ``chips`` the cards of the mesh."""
    flops_dev = float(count.total_flops)
    bytes_dev = float(count.bytes)
    coll_dev = count.coll_total
    terms = {"compute_s": compute_seconds(count.flops),
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll_dev / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    flops_total = flops_dev * chips
    return {
        "chips": chips,
        "flops_per_device": flops_dev,
        "flops_by_dtype": {k: float(v)
                           for k, v in sorted(count.flops.items())},
        "flops_total": flops_total,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_by_kind": {k: float(v)
                               for k, v in sorted(count.coll.items())},
        "collective_counts": {k: float(v) for k, v in
                              sorted(count.coll_counts.items())},
        "terms_s": terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_6nd": mf,
        "useful_flops_ratio": (mf / flops_total) if flops_total else None,
        "memory_analysis": memory_analysis(count),
        "peaks": {"flops": dict(PEAK_FLOPS), "hbm_bytes_per_s": HBM_BW,
                  "hbm_bytes": HBM_BYTES, "nvlink_bytes_per_s": NVLINK_BW,
                  "source": "H100 SXM data sheet, dense, 700 W"},
        "card": smi,
    }


def memory_analysis(count) -> Dict[str, Any]:
    out = {"argument_size_in_bytes": int(count.argument_bytes),
           "output_size_in_bytes": int(count.output_bytes),
           "temp_size_in_bytes": int(count.temp_peak_bytes),
           "alias_size_in_bytes": int(count.alias_bytes)}
    out["peak_bytes_estimate"] = (out["argument_size_in_bytes"]
                                  + out["temp_size_in_bytes"])
    out["fits_80gb_hbm"] = out["peak_bytes_estimate"] <= HBM_BYTES
    return out
