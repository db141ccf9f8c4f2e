"""The port's LM serving path held against the JAX package on the CPU,
for each of the ten assigned architectures at ``.smoke()`` size, from
carried weights: ``forward`` (logits, ``f1``, aux), ``prefill`` (last
logits and the cache) and four ``decode_step``s after it (logits and
the cache after each), all in fp32; the port's own decode-after-prefill
against its forward; ``derive_student`` and ``param_count``; the bf16
carry of ``params_from_numpy``; the serve entry point on the CPU.

Tolerances: fp32 outputs within ``1e-5 * max|out|`` (summation order);
bf16 (the configs' own dtypes) within ``2e-2 * max|out|``; the decode
invariant within the JAX package's own ``2e-2`` (``test_models.py``).
"""
import ast
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.models import model as jm
from repro_torch.config import base as tbase
from repro_torch.config import get_config as tget
from repro_torch.configs import ASSIGNED
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS = 2, 8, 4
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _close(want, got, tol=F32_TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(want - got)))
    assert err <= tol * scale, f"max err {err:.3e} > {tol} * {scale:.3e}"


def _close_trees(jtree, ttree, tol=F32_TOL):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [t for t in tree_leaves(ttree) if t is not None]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b, tol)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embed"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embed"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in out.items()})


def _graft(dst, src):
    """A JAX prefill cache pasted into a longer ``init_cache`` one."""
    if isinstance(dst, dict):
        return {k: _graft(dst[k], src[k]) for k in dst}
    if isinstance(dst, list):
        return [_graft(d, s) for d, s in zip(dst, src)]
    if dst.shape != src.shape:
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src.astype(dst.dtype), pad)
    return src.astype(dst.dtype)


@functools.lru_cache(maxsize=None)
def _serve_run(arch: str, overrides: tuple = ()):
    """Both packages through forward, prefill on S-1 tokens and STEPS
    decode steps from token S-1 on, in fp32, from one set of weights."""
    jcfg = jget(arch).smoke().replace(dtype="float32", param_dtype="float32",
                                      **dict(overrides))
    tcfg = _tcfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jb, tb = _batch(jcfg)
    rng = np.random.default_rng(1)
    more = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    steps = np.concatenate([np.asarray(jb["tokens"])[:, S - 1:], more], 1)
    cache_len = S - 1 + STEPS
    out = {"jcfg": jcfg}

    jo = jm.forward(jcfg, jp, jb, remat=False)
    jl, jc = jm.prefill(jcfg, jp, dict(jb, tokens=jb["tokens"][:, :S - 1]))
    out["j"] = {"forward": jo, "prefill": (jl, jc)}
    jmem = jm.build_memory(jcfg, jp, jb)
    jc = _graft(jm.init_cache(jcfg, B, cache_len, jnp.float32), jc)
    jd = []
    for i in range(STEPS):
        logits, jc = jm.decode_step(jcfg, jp, jnp.asarray(steps[:, i:i + 1]),
                                    jnp.int32(S - 1 + i), jc, jmem)
        jd.append(logits)
    out["j"]["decode"] = (jd, jc)

    with torch.no_grad():
        to = tm.forward(tcfg, tp, tb)
        pre = dict(tb, tokens=tb["tokens"][:, :S - 1])
        tl, tc = tm.prefill(tcfg, tp, pre)
        _, tc_long = tm.prefill(tcfg, tp, pre, cache_len=cache_len)
        tmem = tm.build_memory(tcfg, tp, tb)
        td = []
        for i in range(STEPS):
            logits, tc_long = tm.decode_step(
                tcfg, tp, torch.from_numpy(steps[:, i:i + 1]).long(),
                S - 1 + i, tc_long, tmem)
            td.append(logits)
    out["t"] = {"forward": to, "prefill": (tl, tc), "decode": (td, tc_long)}
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_matches_jax(arch):
    run = _serve_run(arch)
    jo, to = run["j"]["forward"], run["t"]["forward"]
    assert to.logits.shape == (B, S, run["jcfg"].vocab_size)
    _close(jo.logits, to.logits)
    _close(jo.f1, to.f1)
    assert abs(float(jo.aux) - float(to.aux)) <= F32_TOL * max(
        abs(float(jo.aux)), 1e-30)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_prefill_matches_jax(arch):
    run = _serve_run(arch)
    (jl, jc), (tl, tc) = run["j"]["prefill"], run["t"]["prefill"]
    _close(jl, tl)
    _close_trees(jc, tc)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_steps_match_jax(arch):
    """Four steps on from the prefill: the logits of each, and every
    cache (KV slots, recurrent and SSM states) after the last."""
    run = _serve_run(arch)
    (jd, jc), (td, tc) = run["j"]["decode"], run["t"]["decode"]
    for want, got in zip(jd, td):
        _close(want, got)
    _close_trees(jc, tc)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_after_prefill_matches_forward(arch):
    """The serving invariant on the port alone: prefill S-1 tokens,
    decode token S-1, and the logits are forward's last position."""
    run = _serve_run(arch)
    got = run["t"]["decode"][0][0]
    want = run["t"]["forward"].logits[:, -1]
    assert float((got - want).abs().max()) < 2e-2


@pytest.mark.parametrize("pattern,window", [(("lattn", "attn"), 16),
                                            (("attn", "lattn"), 4)])
def test_local_attention_matches_jax(pattern, window):
    """No assigned config reaches ``lattn`` (recurrentgemma-9b's pattern
    is ``(rec, rec, attn)``), so it is held through a ``block_pattern``
    override: at S <= the window every step of the serving path, and
    with the window below S (forward's mask and prefill's last-window
    cache) the same comparisons, where the JAX package's decode of a
    wrapped window keeps its own positions."""
    run = _serve_run("yi-6b", (("block_pattern", pattern),
                               ("local_window", window)))
    jo, to = run["j"]["forward"], run["t"]["forward"]
    _close(jo.logits, to.logits)
    (jl, jc), (tl, tc) = run["j"]["prefill"], run["t"]["prefill"]
    _close(jl, tl)
    _close_trees(jc, tc)
    for want, got in zip(run["j"]["decode"][0], run["t"]["decode"][0]):
        _close(want, got)
    if window >= S:
        got = run["t"]["decode"][0][0]
        assert float((got - to.logits[:, -1]).abs().max()) < 2e-2


def test_rolling_decode_matches_jax():
    """Sliding-window serving: 12 steps through an 8-slot rolling cache
    (it wraps at step 8), logits each step against JAX and finite."""
    jcfg = jget("yi-6b").smoke().replace(dtype="float32",
                                         param_dtype="float32",
                                         sliding_window_serve=8)
    tcfg = _tcfg(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (1, 12))
    jc = jm.init_cache(jcfg, 1, 8, jnp.float32)
    tc = tm.init_cache(tcfg, 1, 8, torch.float32)
    with torch.no_grad():
        for i in range(12):
            tok = toks[:, i:i + 1]
            want, jc = jm.decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                      jnp.int32(i), jc, rolling=True)
            got, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok), i, tc,
                                     rolling=True)
            _close(want, got)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("arch", ["grok-1-314b", "yi-6b"])
def test_forward_in_the_configs_own_dtypes_matches_jax(arch):
    """bf16 activations (and grok's bf16 parameters), as configured."""
    jcfg = jget(arch).smoke()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jb, tb = _batch(jcfg)
    jo = jm.forward(jcfg, jp, jb, remat=False)
    with torch.no_grad():
        to = tm.forward(_tcfg(jcfg), tp, tb)
    _close(jo.logits, to.logits, BF16_TOL)
    _close(jo.f1, to.f1, BF16_TOL)


def test_params_from_numpy_carries_bfloat16_bit_for_bit():
    """grok-1-314b's smoke config keeps ``param_dtype="bfloat16"``: every
    leaf comes across as ``torch.bfloat16`` with the same 16 bits."""
    jcfg = jget("grok-1-314b").smoke()
    assert jcfg.param_dtype == "bfloat16"
    nparams = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(nparams)
    jl = jax.tree_util.tree_leaves(nparams)
    tl = tree_leaves(tparams)
    assert len(jl) == len(tl) > 0
    for a, t in zip(jl, tl):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(np.int16),
                                      t.view(torch.int16).numpy())


@pytest.mark.parametrize("arch", ASSIGNED)
def test_student_and_param_count_match_jax(arch):
    """``derive_student`` field for field; ``param_count`` of the smoke
    teacher and student as drawn, and of the full configs from shapes
    (``jax.eval_shape`` against the port's ``device="meta"``)."""
    assert ASSIGNED == J_ASSIGNED
    jcfg = jget(arch)
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jcfg)
    jstu = jm.derive_student(jcfg)
    assert dataclasses.asdict(tm.derive_student(_tcfg(jcfg))) == \
        dataclasses.asdict(jstu)
    for cfg in (jcfg.smoke(), jm.derive_student(jcfg.smoke())):
        want = jm.param_count(jm.init_params(cfg, jax.random.PRNGKey(0)))
        got = tm.param_count(tm.init_params(_tcfg(cfg),
                                            torch.Generator().manual_seed(0)))
        assert got == want
    for cfg in (jcfg, jstu):
        want = jm.param_count(jax.eval_shape(
            lambda: jm.init_params(cfg, jax.random.PRNGKey(0))))
        meta = tm.init_params(_tcfg(cfg), torch.Generator(), device="meta")
        assert tm.param_count(meta) == want
        assert tm.param_bytes(meta, 2) == 2 * want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_serve_counts_are_the_jax_packages():
    """The full-width serve runs on the card hold their parameter counts
    to these constants; here they are the JAX package's, from shapes."""
    full = _chip_smoke().SERVE_FULL
    assert set(full) == {"yi-6b", "mamba2-130m", "whisper-small",
                         "llama4-scout-17b-a16e"}
    for arch, (layers, count) in full.items():
        cfg = jget(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        assert jm.param_count(jax.eval_shape(
            lambda: jm.init_params(cfg, jax.random.PRNGKey(0)))) == count


def test_chip_smoke_serve_phase_on_the_cpu(capsys):
    """``chip_smoke.py``'s serve phase end to end on the CPU: the ten
    smoke configs, the rolling decode, and one full-width run (mamba2-130m
    cut to one layer, a 4-token prompt and 2 new tokens) through the
    launcher with its checks."""
    smoke = _chip_smoke()
    smoke.SERVE_PROMPT, smoke.SERVE_TOKENS = 4, 2
    cfg = tget("mamba2-130m").replace(num_layers=1)
    count = tm.param_count(tm.init_params(cfg, torch.Generator(),
                                          device="meta"))
    lines = smoke.run_serve(torch, "cpu", device="cpu",
                            full={"mamba2-130m": (1, count)})
    assert [ln["arch"] for ln in lines] == ["mamba2-130m"]
    assert lines[0]["params"] == count and lines[0]["layers"] == 1
    assert lines[0]["reduced"].startswith("1 of 24 layers")
    out = capsys.readouterr().out
    assert out.count("decode-after-prefill against forward") == 10
    assert "serve {" in out


def test_serve_entry_point_on_the_cpu(capsys):
    res = tserve.main(["--arch", "mamba2-130m", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    assert tuple(res["generated"].shape) == (2, 3)
    assert int(res["generated"].min()) >= 0
    assert int(res["generated"].max()) < res["cfg"].vocab_size
    assert bool(torch.isfinite(res["last_logits"]).all())
    assert res["step_ms"] > 0 and res["tokens_per_s"] > 0
    assert "tokens/s on cpu" in capsys.readouterr().out


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_serve_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "yi-6b"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=_env())
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_serve_example_runs_on_the_cpu():
    r = subprocess.run([sys.executable, "examples/torch_serve_decode.py",
                        "--arch", "recurrentgemma-9b", "--device", "cpu",
                        "--tokens", "4", "--prompt-len", "6"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stderr
    assert "sample:" in r.stdout


def test_lm_modules_import_neither_jax_nor_the_jax_package():
    files = [*(ROOT / "src" / "repro_torch" / "models").glob("*.py"),
             *(ROOT / "src" / "repro_torch" / "configs").glob("*.py"),
             *(ROOT / "src" / "repro_torch" / "launch").glob("*.py"),
             ROOT / "examples" / "torch_serve_decode.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (f, mod)
