"""The port's serving export (``infer/export.py``, ``run export``) and the
registered ops it rests on, on the CPU at ``tiny_config`` size, against the
port's live synthesis path and the JAX ``VISinger`` (the counterparts of
``tests/test_export.py``'s five tests, plus the port's own).

The port's model holds JAX-initialised parameters (``fill_params`` of the
JAX tree, through ``params_from_jax``), so both packages hold the same
weights.  The artifact's waveform equals the live path's exactly
(``torch.equal``: the same ops on the same inputs) and JAX's within 1e-4
of its peak, the limit of ``tests/test_torch_port_slice.py``, for the same
prior noise eps: JAX's ``infer_prior`` mu/logs, z = mu + eps * exp(logs),
then JAX's ``decode_frames``.  The ops' CPU gradients (through
``register_autograd`` and the plain backward) are held against autograd of
the plain versions within 1e-6 of their peaks."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.models.factory import build_models, init_params
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.models.visinger import VISinger as JVISinger
from visinger_tpu_torch import run
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.infer.export import (ExportedSynthesizer,
                                             export_synthesis, prior_noise)
from visinger_tpu_torch.models.factory import build_model
from visinger_tpu_torch.models.factory import build_models as port_models
from visinger_tpu_torch.ops import rel_attention as ra
from visinger_tpu_torch.ops import wavenet_stack as ws
from visinger_tpu_torch.training.checkpoint import save_checkpoint
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.utils.audio.spk_embed import SPK_EMBED_DIM

from test_torch_port_cores import subprocess_env  # shares the cores
from test_torch_port_modules import fill_params

VOCABS = (20, 30, 12)
SEED = 0
WAV_RTOL = 1e-4    # waveform max abs err, as a share of the reference's peak
GRAD_RTOL = 1e-6   # op gradients against plain autograd, share of the peak
REPO = Path(__file__).resolve().parents[1]
# what the loader must run without
BLOCKED = ("jax", "flax", "visinger_tpu", "visinger_tpu_torch.models",
           "visinger_tpu_torch.modules", "visinger_tpu_torch.config",
           "visinger_tpu_torch.training", "visinger_tpu_torch.data",
           "visinger_tpu_torch.infer.infer")


def score(n_tokens, n_frames, seed=1):
    """One unpadded score: (tokens, pitch, durations, mel2ph) int arrays."""
    raw = synthetic_batch(1, n_tokens, n_frames, *VOCABS, seed=seed)
    n = int(raw["text_lengths"][0])
    return tuple(raw[k][0, :n] for k in ("text_tokens", "note_pitch",
                                        "note_dur")) + (raw["mel2ph"][0],)


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def live(model, inputs) -> torch.Tensor:
    """The live path on the artifact's padded inputs."""
    tokens, pitch, dur, mel2ph, spk, eps, *emb = inputs
    with torch.no_grad():
        z_p, mask = model.infer_prior(tokens, pitch, dur, mel2ph, spk_id=spk,
                                      eps=eps, spk_embed=emb[0] if emb
                                      else None)
        return model.decode_frames(z_p, mask, spk_id=spk,
                                   spk_embed=emb[0] if emb else None)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A one-bucket (24 tokens, 96 frames) artifact of the port's model
    with JAX-initialised weights, and the JAX model's jitted applies."""
    jcfg = jax_tiny_config()
    raw = synthetic_batch(2, 12, 48, *VOCABS, jcfg.num_linear_bins,
                          jcfg.hop_size, seed=SEED)
    jmodel, disc = build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, disc, raw)[0])
    params = fill_params(shapes, SEED)
    model = build_model(tiny_config(), *VOCABS, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    art_dir = str(tmp_path_factory.mktemp("artifact"))
    meta = export_synthesis(tiny_config(), model, art_dir, buckets=[(24, 96)],
                            device="cpu")
    return SimpleNamespace(
        model=model, dir=art_dir, meta=meta, params=params,
        apply=jax.jit(jmodel.apply, static_argnames=("infer",)),
        decode=jax.jit(lambda p, *a, **k: jmodel.apply(
            p, *a, **k, method=JVISinger.decode_frames)))


def test_export_writes_versioned_artifact(art):
    assert sorted(os.listdir(art.dir)) == [
        "meta.json", "synthesis_t24_f96.pt2", "weights.pt"]
    meta = json.loads(Path(art.dir, "meta.json").read_text())
    assert meta == art.meta
    assert meta["buckets"] == [[24, 96]]
    assert meta["device"] == "cpu"
    assert meta["use_spk_embed"] is False
    assert meta["compute_dtype"] == "float32"
    assert meta["torch_version"] == torch.__version__
    # tiny_config's 16 channels: K2 takes them padded to 32 on the card
    assert meta["kernels"] == ["pad_pack", "rel_attention", "wavenet_stack"]
    # the weights are stored once, outside the program
    weights = torch.load(Path(art.dir, "weights.pt"), weights_only=True)
    assert weights.keys() == art.model.state_dict().keys()


def test_exported_matches_live_and_jax(art):
    syn = ExportedSynthesizer(art.dir, device="cpu")
    tok, pitch, dur, mel2ph = score(20, 90)
    wav = syn(tok, pitch, dur, mel2ph, seed=3)
    assert wav.shape == (90 * 300,)
    inputs = syn.pad(tok, pitch, dur, mel2ph, seed=3)
    assert [tuple(a.shape) for a in inputs] == [
        (1, 24), (1, 24), (1, 24), (1, 96), (1,), (1, 96, 16)]
    assert torch.equal(inputs[5], prior_noise(96, 16, 3))
    ref = live(art.model, inputs)
    assert torch.equal(torch.from_numpy(wav), ref[0, :len(wav)])
    # JAX: its prior's mu/logs, the same eps, its decode
    t = {k: jnp.asarray(a.numpy()) for k, a in zip(
        ("text_tokens", "pitch_tokens", "dur_tokens", "mel2ph", "spk_id"),
        inputs)}
    out = art.apply({"params": art.params}, **t, infer=True,
                    rngs={"sample": jax.random.PRNGKey(1)})
    tgt = (inputs[3].numpy() > 0).astype(np.float32)[..., None]
    z_p = (np.asarray(out["mu_p"]) + inputs[5].numpy()
           * np.exp(np.asarray(out["logs_p"]))) * tgt
    jwav = np.asarray(art.decode({"params": art.params}, jnp.asarray(z_p),
                                 jnp.asarray(tgt), spk_id=t["spk_id"]))
    peak = float(np.abs(jwav).max())
    assert peak > 1e-2  # the comparison is not vacuous
    assert max_err(wav, jwav[0, :len(wav)]) < WAV_RTOL * peak
    # another seed, another waveform
    assert max_err(syn(tok, pitch, dur, mel2ph, seed=4), wav) > 0


def test_exported_rejects_oversize_scores(art):
    syn = ExportedSynthesizer(art.dir, device="cpu")
    big = np.ones(500, np.int64)
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        syn(big, big, big, big)
    tok, pitch, dur, _ = score(20, 90)
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        syn(tok, pitch, dur, np.ones(97, np.int64))


def test_loader_refuses_another_device(art, tmp_path):
    """An artifact serves the device type it was exported for: a CPU
    artifact on a card, or a card's artifact on the CPU, is refused."""
    meta = dict(art.meta, device="cuda")
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ExportedSynthesizer(str(tmp_path), device="cpu")
    newer = dict(art.meta, artifact_version=art.meta["artifact_version"] + 1)
    (tmp_path / "meta.json").write_text(json.dumps(newer))
    with pytest.raises(ValueError, match="newer than this loader"):
        ExportedSynthesizer(str(tmp_path), device="cpu")


def test_multibucket_export_picks_smallest_fit(tmp_path):
    """Two bucket programs in one artifact, one weights file: a small score
    routes to the small program, a large one to the large program, each
    equal to the live path at its padding."""
    model = build_model(tiny_config(), *VOCABS, device="cpu")
    art_dir = str(tmp_path / "art")
    meta = export_synthesis(tiny_config(), model, art_dir,
                            buckets=[(48, 192), (24, 96)], device="cpu")
    assert meta["buckets"] == [[48, 192], [24, 96]]
    assert sorted(os.listdir(art_dir)) == [
        "meta.json", "synthesis_t24_f96.pt2", "synthesis_t48_f192.pt2",
        "weights.pt"]
    syn = ExportedSynthesizer(art_dir, device="cpu")
    assert syn.buckets == [(24, 96), (48, 192)]
    small = score(12, 48, seed=1)
    wav_small = syn(*small)
    assert wav_small.shape == (48 * 300,)
    assert list(syn._calls) == [(24, 96)]
    big = score(40, 160, seed=2)
    wav_big = syn(*big)
    assert wav_big.shape == (160 * 300,)
    assert list(syn._calls) == [(24, 96), (48, 192)]
    # more tokens than the small bucket takes, few frames: the large one
    assert syn.bucket_for(30, 50) == (48, 192)
    for s, wav in ((small, wav_small), (big, wav_big)):
        ref = live(model, syn.pad(*s))
        assert torch.equal(torch.from_numpy(wav), ref[0, :len(wav)])


def test_spk_embed_export_roundtrip(tmp_path):
    """A ``use_spk_embed`` model exports with the voice-embedding input; the
    artifact equals the live path and depends on the embedding."""
    cfg = tiny_config().replace(use_spk_embed=True)
    model = build_model(cfg, *VOCABS, device="cpu")
    art_dir = str(tmp_path / "art")
    meta = export_synthesis(cfg, model, art_dir, buckets=[(24, 96)],
                            device="cpu")
    assert meta["use_spk_embed"] is True
    assert meta["spk_embed_dim"] == SPK_EMBED_DIM
    syn = ExportedSynthesizer(art_dir, device="cpu")
    emb = np.random.RandomState(3).randn(SPK_EMBED_DIM).astype(np.float32)
    s = score(20, 90)
    wav = syn(*s, seed=3, spk_embed=emb)
    inputs = syn.pad(*s, seed=3, spk_embed=emb)
    assert tuple(inputs[6].shape) == (1, SPK_EMBED_DIM)
    ref = live(model, inputs)
    assert torch.equal(torch.from_numpy(wav), ref[0, :len(wav)])
    other = syn(*s, seed=3, spk_embed=-emb)
    assert max_err(wav, other) > 0


def test_exported_graph_holds_the_kernel_ops(art):
    """One K1 node per attention layer (text encoder, pitch predictor,
    frame prior) and one K2 node per flow coupling, and none of the plain
    versions' softmax or gate in their place."""
    program = torch.export.load(os.path.join(art.dir, "synthesis_t24_f96.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    cfg = tiny_config()
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers)
    assert targets.count("visinger_torch.rel_attention_fwd.default") == n_attn
    assert targets.count("visinger_torch.wavenet_stack.default") == \
        cfg.flow_n_flows
    assert not [t for t in targets
                if "softmax" in t or "sigmoid" in t or "einsum" in t]
    assert not [n for n in program.graph.nodes if n.op == "get_attr"
                and "weight" in str(n.target)]


def test_loader_runs_without_model_source(art, tmp_path):
    """In a process where jax, flax, visinger_tpu and the port's models,
    modules, config, training, data and ``infer.infer`` cannot be imported,
    the artifact loads and gives the in-process waveform."""
    s = score(20, 90)
    np.savez(tmp_path / "score.npz", *s)
    want = ExportedSynthesizer(art.dir, device="cpu")(*s, seed=5)
    script = f"""
import json, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from visinger_tpu_torch.infer.export import ExportedSynthesizer
s = np.load({str(tmp_path / "score.npz")!r})
syn = ExportedSynthesizer({art.dir!r}, device="cpu")
wav = syn(*(s[f"arr_{{i}}"] for i in range(4)), seed=5)
np.save({str(tmp_path / "wav.npy")!r}, wav)
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if mod is not None
                        and m.startswith("visinger_tpu_torch."))))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=subprocess_env(PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded for b in BLOCKED
                if m == b or m.startswith(b + ".")]
    assert "visinger_tpu_torch.ops.rel_attention" in loaded
    assert np.array_equal(np.load(tmp_path / "wav.npy"), want)


def _k1_case(rate, dtype):
    rng = np.random.RandomState(7)
    b, t, c, dk, w = 2, 20, 16, 8, 4
    ins = [torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(dtype)
           for _ in range(3)]
    ins += [torch.from_numpy(rng.randn(2 * w + 1, dk).astype(np.float32))
            for _ in range(2)]
    mask = (torch.arange(t)[None] < torch.tensor([20, 13])[:, None]
            ).float()[..., None]
    seed = torch.tensor([11], dtype=torch.int32)
    kw = dict(window=w, scale=dk ** -0.5)

    def op(*a):
        return ra.rel_attention(*a, mask, dropout_rate=rate, seed=seed, **kw)

    def plain(*a):
        return ra.rel_attention_plain(*a, ra.prefix_lengths(mask), seed=seed,
                                      rate=rate, **kw)

    return ins, op, plain


def _k2_case():
    rng = np.random.RandomState(8)
    b, t, c, n_layers, k = 2, 20, 16, 2, 5

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3)

    ins = [r(b, t, c), r(n_layers, k, c, 2 * c), r(n_layers, 2 * c),
           r(n_layers, c, 2 * c), r(n_layers, 2 * c), r(b, n_layers, 2 * c)]
    mask = (torch.arange(t)[None] < torch.tensor([20, 9])[:, None]
            ).float()[..., None]
    return (ins, lambda *a: ws.wavenet_stack(*a, mask),
            lambda *a: ws.wavenet_stack_plain(*a, mask))


@pytest.mark.parametrize("case", ["k1", "k1_dropout", "k1_bf16", "k2"])
def test_ops_cpu_route_matches_plain_autograd(case):
    """The registered ops on CPU tensors: the forward equals the plain
    version, and the gradients (the forward op's registered backward: the
    K3 op's plain version for K1, the plain recompute for K2) equal
    autograd of the plain version within 1e-6 of their peaks; dropout
    drops the entries of the same hash mask."""
    if case == "k2":
        ins, op, plain = _k2_case()
    else:
        ins, op, plain = _k1_case(0.1 if case == "k1_dropout" else 0.0,
                                  torch.bfloat16 if case == "k1_bf16"
                                  else torch.float32)
    grads = {}
    for name, fn in (("op", op), ("plain", plain)):
        leaves = [a.clone().requires_grad_(True) for a in ins]
        out = fn(*leaves)
        g = torch.from_numpy(np.random.RandomState(9).randn(
            *out.shape).astype(np.float32)).to(out.dtype)
        grads[name] = (out.detach(), torch.autograd.grad(out, leaves, g))
    assert torch.equal(grads["op"][0], grads["plain"][0])
    for got, ref in zip(grads["op"][1], grads["plain"][1]):
        peak = float(ref.float().abs().max())
        assert peak > 0
        assert max_err(got.float(), ref.float()) <= GRAD_RTOL * peak


@pytest.mark.parametrize("op", ["rel_attention_fwd", "rel_attention_bwd",
                                "wavenet_stack"])
def test_ops_have_cpu_and_cuda_implementations_only(op):
    """Each op has a CPU implementation (the plain version), a CUDA one (the
    kernel) and a fake; no catch-all that CUDA tensors could reach."""
    name = f"visinger_torch::{op}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CPU") and has(name, "CUDA") and has(name, "Meta")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd"):
        assert not has(name, key)


def test_run_export_from_a_checkpoint(tmp_path, capsys):
    """``run export --device cpu`` writes an artifact from a checkpoint saved
    by ``training/checkpoint.py`` from a fresh train state; the artifact
    serves the checkpoint's generator."""
    cfg = tiny_config().replace(work_dir=str(tmp_path / "work"),
                                binary_data_dir=str(tmp_path / "binary"))
    os.makedirs(cfg.binary_data_dir)
    for name, n in zip(("phone_set", "pitch_map", "dur_map"), VOCABS):
        items = [f"p{i}" for i in range(n)] if name == "phone_set" else {
            str(i): i for i in range(n)}
        Path(cfg.binary_data_dir, f"{name}.json").write_text(
            json.dumps(items))
    cfg_fn = tmp_path / "cfg.json"
    cfg_fn.write_text(json.dumps(cfg.to_dict()))
    out_dir = str(tmp_path / "art")
    args = ["export", "--config", str(cfg_fn), "--device", "cpu",
            "--out_dir", out_dir, "--buckets", "24x96"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        run.main(args)
    model, disc = port_models(cfg, *VOCABS, device="cpu", seed=4)
    save_checkpoint(cfg.work_dir, create_train_state(model, disc, seed=0))
    meta = run.main(args)
    assert "| wrote artifact to" in capsys.readouterr().out
    assert meta["buckets"] == [[24, 96]] and meta["device"] == "cpu"
    assert sorted(os.listdir(out_dir)) == [
        "meta.json", "synthesis_t24_f96.pt2", "weights.pt"]
    syn = ExportedSynthesizer(out_dir, device="cpu")
    s = score(20, 90)
    ref = live(model, syn.pad(*s))
    assert torch.equal(torch.from_numpy(syn(*s)), ref[0, :90 * 300])
