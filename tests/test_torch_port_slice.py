"""The synthesis slice end to end against the JAX ``VISinger``: the same
weights (``params_from_jax``), the same token batch and the same prior
noise eps (numpy) go through ``infer_prior`` / ``decode_frames`` /
``TorchSynthesizer`` and the JAX model's infer path.

Tolerances (float32): 1e-4 max abs on mu_p / logs_p / z_p (three
transformer stacks, the same arithmetic summed in another order); on the
waveform (the flow and ~60 HiFi-GAN convolutions in a chain) 1e-4 of its
peak, which the random weights put at ~1e-2 to ~1e-1 (measured error
~1e-6 of the peak).  The voiced flag (uv logit <= 0) is discontinuous, so
it is asserted equal outright: with this seed no logit lies within
rounding of 0."""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from visinger_tpu.models.factory import build_models, init_params
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.models.visinger import VISinger as JVISinger
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.infer.infer import TorchSynthesizer, VISingerInfer
from visinger_tpu_torch.infer.streaming import StreamingSynthesizer
from visinger_tpu_torch.models.factory import build_model
from visinger_tpu_torch.models.factory import build_models as port_build_models
from visinger_tpu_torch.training.train_step import make_train_step

from test_torch_port_modules import fill_params

VOCABS = (20, 30, 25)
B, N, T = 2, 12, 48
SEED = 0
WAV_RTOL = 1e-4   # waveform max abs err, as a share of the reference's peak
REPO = Path(__file__).resolve().parents[1]
TRAIN_ONLY = ("posterior_encoder", "phoneme_predictor")


def jax_inputs(raw, n=None, t=None):
    n = n or raw["text_tokens"].shape[1]
    t = t or raw["mel2ph"].shape[1]
    return dict(text_tokens=jnp.asarray(raw["text_tokens"][:, :n]),
                pitch_tokens=jnp.asarray(raw["note_pitch"][:, :n]),
                dur_tokens=jnp.asarray(raw["note_dur"][:, :n]),
                mel2ph=jnp.asarray(raw["mel2ph"][:, :t]),
                spk_id=jnp.asarray(raw["spk_ids"]))


def port_inputs(raw):
    return [torch.from_numpy(raw[k]).long()
            for k in ("text_tokens", "note_pitch", "note_dur", "mel2ph",
                      "spk_ids")]


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = jax_tiny_config()
    raw = synthetic_batch(B, N, T, *VOCABS, jcfg.num_linear_bins,
                          jcfg.hop_size, seed=SEED)
    jmodel, disc = build_models(jcfg, *VOCABS)
    # the whole generator tree (train branch included), traced, not run
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, disc, raw)[0])
    params = fill_params(shapes, SEED)
    port = build_model(tiny_config(), *VOCABS, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    # jitted applies for every prior and decode below: linen run eagerly
    # dispatches (and compiles) op by op, several times slower at this size
    apply = jax.jit(jmodel.apply, static_argnames=("infer",))
    decode = jax.jit(functools.partial(jmodel.apply,
                                       method=JVISinger.decode_frames))
    return apply, decode, params, port, raw


def jax_prior(apply, params, inputs):
    out = apply({"params": params}, **inputs, infer=True,
                rngs={"sample": jax.random.PRNGKey(1)})
    return {k: np.asarray(out[k]) for k in ("mu_p", "logs_p", "f0_pred")}


def jax_decode(decode, params, z_p, mel2ph, spk_id):
    mask = (np.asarray(mel2ph) > 0).astype(np.float32)[..., None]
    return np.asarray(decode({"params": params}, jnp.asarray(z_p),
                             jnp.asarray(mask), spk_id=spk_id))


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_synthetic_batch_is_the_jax_copy():
    a = synthetic_batch(3, 10, 64, 20, 30, 25, 33, 300, seed=7)
    b = jax_synthetic_batch(3, 10, 64, 20, 30, 25, 33, 300, seed=7)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_infer_prior_matches_jax(slice_pair):
    apply, _, params, port, raw = slice_pair
    ref = jax_prior(apply, params, jax_inputs(raw))
    eps = np.random.RandomState(11).randn(*ref["mu_p"].shape).astype(
        np.float32)
    with torch.no_grad():
        st = port.prior_stats(*port_inputs(raw))
        z_p, mask = port.infer_prior(*port_inputs(raw),
                                     eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(st["f0_pred"][..., 1].numpy() <= 0,
                                  ref["f0_pred"][..., 1] <= 0)
    assert max_err(st["f0_pred"], ref["f0_pred"]) < 1e-4
    assert max_err(st["mu_p"], ref["mu_p"]) < 1e-4
    assert max_err(st["logs_p"], ref["logs_p"]) < 1e-4
    tgt = (raw["mel2ph"] > 0).astype(np.float32)[..., None]
    np.testing.assert_array_equal(mask.numpy(), tgt)
    z_ref = (ref["mu_p"] + eps * np.exp(ref["logs_p"])) * tgt
    assert max_err(z_p, z_ref) < 1e-4


def test_decode_frames_matches_jax(slice_pair):
    _, decode, params, port, raw = slice_pair
    rng = np.random.RandomState(12)
    tgt = (raw["mel2ph"] > 0).astype(np.float32)[..., None]
    z_p = rng.randn(B, T, 16).astype(np.float32) * tgt
    ref = jax_decode(decode, params, z_p, raw["mel2ph"],
                     jnp.asarray(raw["spk_ids"]))
    with torch.no_grad():
        wav = port.decode_frames(torch.from_numpy(z_p), torch.from_numpy(tgt),
                                 spk_id=torch.from_numpy(raw["spk_ids"]).long())
    assert wav.shape == (B, T * 300)
    peak = float(np.abs(ref).max())
    assert peak > 1e-2  # the comparison is not vacuous
    assert max_err(wav, ref) < WAV_RTOL * peak


def test_forward_infer_is_prior_then_decode(slice_pair):
    port, raw = slice_pair[-2:]
    eps = torch.from_numpy(np.random.RandomState(13).randn(B, T, 16).astype(
        np.float32))
    with torch.no_grad():
        out = port(*port_inputs(raw), infer=True, eps=eps)
        z_p, mask = port.infer_prior(*port_inputs(raw), eps=eps)
        wav = port.decode_frames(z_p, mask, spk_id=port_inputs(raw)[-1])
    assert torch.equal(out["wav_out"], wav)
    assert set(out) == {"mu_p", "logs_p", "f0_pred", "wav_out"}


def test_synthesizer_two_requests_match_jax(slice_pair):
    """Two requests of different lengths in one group: each wav is trimmed
    to its own frames and equals the JAX model on the batch padded to the
    group's longest item with the same eps."""
    apply, decode, params, port, _ = slice_pair
    raw = synthetic_batch(B, N, T, *VOCABS, seed=SEED + 1)
    n_len, t_len = raw["text_lengths"], raw["mel_lengths"]
    assert n_len[0] != n_len[1] and t_len[0] != t_len[1]
    requests = [{"text_tokens": raw["text_tokens"][i:i + 1, :n_len[i]],
                 "note_pitch": raw["note_pitch"][i:i + 1, :n_len[i]],
                 "note_dur": raw["note_dur"][i:i + 1, :n_len[i]],
                 "mel2ph": raw["mel2ph"][i:i + 1, :t_len[i]],
                 "spk_ids": raw["spk_ids"][i:i + 1]} for i in range(B)]
    synth = TorchSynthesizer(tiny_config(), port, device="cpu")
    res = synth.synthesize_batch(requests, seed=5)

    n_max, t_max = int(n_len.max()), int(t_len.max())
    inputs = jax_inputs(raw, n_max, t_max)
    ref = jax_prior(apply, params, inputs)
    eps = torch.randn((B, t_max, 16),
                      generator=torch.Generator().manual_seed(5)).numpy()
    tgt = (raw["mel2ph"][:, :t_max] > 0).astype(np.float32)[..., None]
    z_p = (ref["mu_p"] + eps * np.exp(ref["logs_p"])) * tgt
    wav_ref = jax_decode(decode, params, z_p, raw["mel2ph"][:, :t_max],
                         inputs["spk_id"])
    assert len(res.wavs) == B and len(res.group_seconds) == 1
    for i in range(B):
        ref_i = wav_ref[i, :t_len[i] * 300]
        peak = float(np.abs(ref_i).max())
        assert peak > 1e-2  # the comparison is not vacuous
        assert res.wavs[i].shape == (t_len[i] * 300,)
        assert max_err(res.wavs[i], ref_i) < WAV_RTOL * peak
    assert res.rtf > 0


def test_jax_init_params_tree_converts(slice_pair):
    """The tree the JAX package's own initialisation builds
    (``factory.init_params``, train branch included; traced, not compiled,
    and filled from a seed) converts whole — the posterior and phoneme
    subtrees included — and loads strictly, giving the same prior."""
    apply = slice_pair[0]
    jcfg = jax_tiny_config()
    raw = jax_synthetic_batch(B, N, T, *VOCABS,
                              num_linear_bins=jcfg.num_linear_bins, seed=SEED)
    jmodel, disc = build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, disc, raw)[0])
    params = fill_params(shapes, SEED + 2)
    assert set(TRAIN_ONLY) <= set(params)
    state = params_from_jax(params)
    assert any(k.startswith(TRAIN_ONLY) for k in state)
    port = build_model(tiny_config(), *VOCABS, device="cpu")
    port.load_state_dict(state, strict=True)
    ref = jax_prior(apply, params, jax_inputs(raw))
    with torch.no_grad():
        st = port.prior_stats(*port_inputs(raw))
    assert max_err(st["mu_p"], ref["mu_p"]) < 1e-4
    assert max_err(st["logs_p"], ref["logs_p"]) < 1e-4


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|yaml|visinger_tpu)\b|import_module",
    re.M)


def test_port_imports_nothing_of_jax():
    """The port and chip_smoke.py import no jax, flax, yaml or visinger_tpu:
    a CPU synthesis, a CPU training step (``training/``, ``ops/stft.py``) and
    a CPU ``VISingerInfer.synthesize`` of a written MIDI file (the front end,
    ``utils/``, ``data/``) succeed with those modules blocked, and no source
    names them in an import."""
    sources = sorted((REPO / "visinger_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
    script = """
import sys
for name in ("jax", "flax", "yaml", "visinger_tpu"):
    sys.modules[name] = None
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.infer.infer import TorchSynthesizer
from visinger_tpu_torch.models.factory import build_model
from visinger_tpu_torch.models.factory import build_models as port_build_models
from visinger_tpu_torch.training.train_step import make_train_step
cfg = tiny_config()
raw = synthetic_batch(2, 8, 48, 20, 30, 25, 16, cfg.hop_size, seed=0)
reqs = [{k: raw[k][i:i + 1] for k in
         ("text_tokens", "note_pitch", "note_dur", "mel2ph")} for i in range(2)]
model = build_model(cfg, 20, 30, 25, device="cpu")
res = TorchSynthesizer(cfg, model, device="cpu").synthesize_batch(reqs)
assert all(w.size > 0 for w in res.wavs)
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.ops import stft
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.training.train_step import make_train_step
model, disc = build_models(cfg, 20, 30, 25, device="cpu")
raw.pop("spec")  # computed from the waveform instead
state, metrics = make_train_step(cfg, model, disc, device="cpu")(
    create_train_state(model, disc), raw)
assert all(bool(v.isfinite()) for v in metrics.values())
import json, os, tempfile
from visinger_tpu_torch.data.binarizer import build_dur_map, build_pitch_map
from visinger_tpu_torch.infer.infer import VISingerInfer
from visinger_tpu_torch.utils.midi import Note, write_midi
from visinger_tpu_torch.utils.text.token_encoder import TokenTextEncoder
data_dir = tempfile.mkdtemp()
jamo = [chr(c) for c in list(range(0x1100, 0x1113)) + list(range(0x1161, 0x1176))
        + list(range(0x11A8, 0x11C3))]
enc = TokenTextEncoder(jamo + ["<BOS>"])
enc.store_to_file(os.path.join(data_dir, "phone_set.json"))
maps = {"pitch_map": build_pitch_map(cfg.note_range), "dur_map": build_dur_map()}
for name, m in maps.items():
    with open(os.path.join(data_dir, name + ".json"), "w") as f:
        json.dump(m, f)
midi_fn = os.path.join(data_dir, "song.mid")
notes = [Note(480 * i, 480 * i + 400, 60 + i, 80) for i in range(4)]
write_midi(midi_fn, notes, lyrics=[(480 * i, s) for i, s in enumerate("나무소리")])
model = build_model(cfg, len(enc), len(maps["pitch_map"]), len(maps["dur_map"]),
                    device="cpu")
wav, rtf = VISingerInfer(cfg, model, data_dir, device="cpu").synthesize(midi_fn)
assert wav.size > 0 and rtf > 0
import chip_smoke
print("isolated-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_config(), *VOCABS)
    model = build_model(tiny_config(), *VOCABS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSynthesizer(tiny_config(), model)
    with pytest.raises(RuntimeError, match="CUDA"):
        VISingerInfer(tiny_config(), model, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSynthesizer(tiny_config(), model)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_build_models(tiny_config(), *VOCABS)
    model, disc = port_build_models(tiny_config(), *VOCABS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tiny_config(), model, disc)
