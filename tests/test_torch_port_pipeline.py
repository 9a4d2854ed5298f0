"""The port's data pipeline and its render/test path on the CPU, against the
JAX package's numpy modules (no JAX ``Trainer``, no jit): the synthetic
corpus, the preprocessor on a raw CSD layout, the binarizer's records (byte
for byte, serially and through the worker pool, with and without the CWT
and speaker-embedding fields), the audio helpers, the quality metrics,
``Trainer.render_valid`` and ``Trainer.test`` at ``tiny_config`` size,
and ``synth-data`` -> ``binarize`` -> ``train`` -> ``test`` through
``run.main``.

Exact equality is asserted wherever both packages run the same numpy code
on the same inputs; the quality metrics are held within 1e-9 relative
(float64)."""

import builtins
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from visinger_tpu.data import preprocess as jpre
from visinger_tpu.data import wav_processors as jwp
from visinger_tpu.data.binarizer import Binarizer as JBinarizer
from visinger_tpu.data.synthetic_corpus import generate_corpus as j_generate
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.ops.stft import STFTParams as JSTFTParams
from visinger_tpu.utils.audio import cwt as jcwt
from visinger_tpu.utils.audio import loudness as jloud
from visinger_tpu.utils.audio import pitch as jpitch
from visinger_tpu.utils.audio import pitch_extract as jpe
from visinger_tpu.utils.audio import quality as jq
from visinger_tpu.utils.audio import spk_embed as jspk
from visinger_tpu_torch import run
from visinger_tpu_torch.config import Args, tiny_config
from visinger_tpu_torch.data import wav_processors as pwp
from visinger_tpu_torch.data.binarizer import Binarizer
from visinger_tpu_torch.data.dataset import build_dataset
from visinger_tpu_torch.data.synthetic_corpus import (_render_note,
                                                      generate_corpus)
from visinger_tpu_torch.ops.stft import STFTParams
from visinger_tpu_torch.training import trainer as trainer_mod
from visinger_tpu_torch.training.trainer import Trainer, synthesize
from visinger_tpu_torch.utils.audio import cwt as pcwt
from visinger_tpu_torch.utils.audio import loudness as ploud
from visinger_tpu_torch.utils.audio import pitch as ppitch
from visinger_tpu_torch.utils.audio import pitch_extract as ppe
from visinger_tpu_torch.utils.audio import quality as pq
from visinger_tpu_torch.utils.audio import spk_embed as pspk
from visinger_tpu_torch.utils.audio.io import load_wav, save_wav
from visinger_tpu_torch.utils.midi import Note, write_midi

import test_torch_port_cores  # noqa: F401  (shares the cores)

SR, HOP = 24000, 300
QUALITY_RTOL = 1e-9

# a 9-item corpus of 2-3 notes (110-250 frames): 3 test items (batches of
# 2: the second padded with a repeated row), 2 valid, 4 train
SPLITS = dict(test_range=(0, 3), valid_range=(3, 5), train_range=(5, -1),
              min_text=2)
SMALL = dict(frame_buckets=(128, 192, 256), token_buckets=(16, 32),
             max_frames=256, max_sentences=2, max_tokens=520,
             synth_n_items=9, synth_notes=(2, 4), binarize_workers=2,
             save_codes=False)


def _files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_cfg(**kw):
    """JAX ``tiny_config`` with the port config's values for ``kw`` (lists
    for tuples, dicts for ``Args``)."""
    def plain(v):
        if isinstance(v, Args):
            return {k: plain(v[k]) for k in v}
        return list(v) if isinstance(v, tuple) else v
    return jax_tiny_config(**{k: plain(v) for k, v in kw.items()})


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """``run synth-data`` and ``run binarize`` (2 spawned workers) on a
    9-item corpus, all paths absolute -> (config JSON path, config)."""
    root = tmp_path_factory.mktemp("pipeline")
    cfg = tiny_config().replace(
        processed_data_dir=str(root / "processed"),
        binary_data_dir=str(root / "binary"), work_dir=str(root / "work"),
        binarization_args=Args(tiny_config().binarization_args, **SPLITS),
        **SMALL)
    cfg_fn = root / "cfg.json"
    cfg_fn.write_text(json.dumps(cfg.to_dict()))
    run.main(["synth-data", "--config", str(cfg_fn)])
    out = run.main(["binarize", "--config", str(cfg_fn)])
    assert out["counts"] == {"test": 3, "valid": 2, "train": 4}
    return cfg_fn, cfg


# --- the synthetic corpus and the preprocessor ------------------------------

def test_generate_corpus_matches_jax(tmp_path):
    """For one seed: the same wav bytes, metadata (paths aside), phone set
    and speaker map."""
    mine, ref = tmp_path / "port", tmp_path / "jax"
    generate_corpus(str(mine), n_items=5, seed=3, notes_per_item=(3, 6))
    j_generate(str(ref), n_items=5, seed=3, notes_per_item=(3, 6))
    a, b = _files(mine), _files(ref)
    assert set(a) == set(b) and len(a) == 5 + 3
    for name in a:
        if name == "metadata.json":
            assert a[name].replace(str(mine).encode(), b"") == \
                b[name].replace(str(ref).encode(), b"")
        else:
            assert a[name] == b[name], name


def _raw_csd(root: Path) -> None:
    """A raw CSD layout at 48 kHz: 3 scores with Hangul lyric events, one
    of them with a ``text/`` lyric file instead, and a corrupt MIDI file."""
    rng = np.random.RandomState(5)
    for d in ("midi", "wav", "text"):
        (root / d).mkdir(parents=True)
    sylls = list("나무소리가장하늘바다")
    for k in range(3):
        n = 3 + k
        notes = [Note(480 * i, 480 * i + 400, 60 + 2 * i + k, 80)
                 for i in range(n)]
        lyr = [sylls[(i + k) % len(sylls)] for i in range(n)]
        name = f"song{k}"
        write_midi(str(root / "midi" / f"{name}.mid"), notes,
                   lyrics=None if k == 2 else list(zip(
                       [nt.start for nt in notes], lyr)))
        if k == 2:
            (root / "text" / f"{name}.txt").write_text(" ".join(lyr))
        # the audio runs 0.4 s past the score's end
        audio = np.concatenate(
            [_render_note(220.0 * 2 ** (i / 12), int(0.5 * 48000), 48000,
                          rng) for i in range(n)] + [np.zeros(19200)])
        save_wav(audio, str(root / "wav" / f"{name}.wav"), 48000)
    (root / "midi" / "broken.mid").write_bytes(b"MThd\x00\x00\x00\x06junk")
    save_wav(np.zeros(4800), str(root / "wav" / "broken.wav"), 48000)


def test_preprocessor_matches_jax(tmp_path, capsys):
    """``run preprocess`` on a raw CSD layout writes JAX's metadata.json
    (paths aside), phone set, speaker map and processed wavs (resampled
    48 -> 24 kHz, loudness-normalized, silence-trimmed), and skips the
    corrupt MIDI file."""
    raw = tmp_path / "raw"
    _raw_csd(raw)
    wav_procs = ("resample", "loud_norm", "trim_sil")
    pargs = Args(tiny_config().preprocess_args, wav_processors=wav_procs)
    mine, ref = tmp_path / "port", tmp_path / "jax"
    cfg = tiny_config().replace(raw_data_dir=str(raw),
                                processed_data_dir=str(mine),
                                work_dir=str(tmp_path / "work"),
                                preprocess_args=pargs)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    run.main(["preprocess", "--config", str(tmp_path / "cfg.json")])
    assert "preprocess skip broken" in capsys.readouterr().out
    jpre.Preprocessor(_jax_cfg(raw_data_dir=str(raw),
                               processed_data_dir=str(ref),
                               preprocess_args=pargs)).process()
    a, b = _files(mine), _files(ref)
    assert set(a) == set(b) == {
        "metadata.json", "phone_set.json", "spk_map.json",
        *(f"wav_processed/song{k}.wav" for k in range(3))}
    for name in a:
        if name == "metadata.json":
            assert a[name].replace(str(mine).encode(), b"") == \
                b[name].replace(str(ref).encode(), b"")
        else:
            assert a[name] == b[name], name
    meta = json.loads(a["metadata.json"])
    assert [m["item_name"] for m in meta] == ["song0", "song1", "song2"]


# --- the binarizer -----------------------------------------------------------

@pytest.mark.parametrize("workers,extras", [(1, True), (2, True), (2, False)])
def test_binarizer_records_byte_identical_to_jax(synth, tmp_path, workers,
                                                 extras, capsys):
    """The port's records, lengths, maps and copied dictionaries equal the
    JAX ``Binarizer``'s (serial) byte for byte, from a serial run and from
    the spawned pool, with ``with_f0cwt`` and ``with_spk_embed`` on and
    off."""
    _, cfg = synth
    bargs = Args(cfg.binarization_args, with_f0cwt=extras,
                 with_spk_embed=extras)
    mine, ref = tmp_path / "port", tmp_path / "jax"
    counts = Binarizer(cfg.replace(binary_data_dir=str(mine),
                                   binarization_args=bargs,
                                   binarize_workers=workers)).process()
    out = capsys.readouterr().out
    route = "through the pool" if workers > 1 else "serially"
    assert f"| binarize: 4 items {route}" in out
    assert ("| binarize: a pool of 2 spawned workers" in out) == (workers > 1)
    JBinarizer(_jax_cfg(processed_data_dir=cfg.processed_data_dir,
                        binary_data_dir=str(ref), binarization_args=bargs,
                        binarize_workers=1)).process()
    a, b = _files(mine), _files(ref)
    assert set(a) == set(b) and len(a) == 3 * 3 + 5
    for name in a:
        assert a[name] == b[name], name
    assert counts == {"test": 3, "valid": 2, "train": 4}
    from visinger_tpu_torch.data.record_store import RecordReader

    rec = RecordReader(str(mine / "train"))[0]
    assert ("cwt_spec" in rec and "spk_embed" in rec) == extras


# --- audio helpers -----------------------------------------------------------

def _voice(seed: int, seconds: float = 1.2) -> np.ndarray:
    """A sung note between a sixth of silence at each end, float32."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    a = n // 6
    x = np.zeros(n)
    x[a: n - a] = _render_note(180.0 + 40 * seed, n - 2 * a, SR, rng)
    return (x + 1e-4 * rng.randn(n)).astype(np.float32)


class _Cfg(dict):
    """A JAX-style config for the wav processors (``.get`` and
    attributes)."""
    __getattr__ = dict.__getitem__


@pytest.mark.parametrize("what", ["autocorr", "f0_to_coarse", "cwt",
                                  "loudness", "resample", "loud_norm",
                                  "trim_sil", "spk_embed"])
def test_audio_helpers_match_jax(what):
    """Exactly JAX's arrays on seeded inputs."""
    wav = _voice(1)
    if what == "autocorr":
        f0s = [m.extract_pitch("autocorr", wav, SR, HOP, len(wav) // HOP)
               for m in (ppe, jpe)]
        assert f0s[0].dtype == np.float32 and (f0s[0] > 0).any()
        pairs = [f0s]
    elif what == "f0_to_coarse":
        f0 = np.random.RandomState(0).uniform(0, 1400, 200)
        f0[::7] = 0.0
        pairs = [[m.f0_to_coarse(f0) for m in (ppitch, jpitch)]]
    elif what == "cwt":
        f0 = jpe.extract_pitch("autocorr", wav, SR, HOP, len(wav) // HOP)
        pairs = []
        for m in (pcwt, jcwt):
            uv, cont = m.get_cont_logf0(f0)
            spec, scales = m.get_logf0_cwt(cont, dt=HOP / SR)
            pairs.append((uv, cont, spec, scales, m.inverse_cwt(spec),
                          m.norm_cwt(spec)[0]))
        pairs = list(zip(*pairs))
    elif what == "loudness":
        pairs = [[np.float64(m.integrated_loudness(wav, SR))
                  for m in (ploud, jloud)],
                 [m.normalize_loudness(wav, -30.0, -20.0)
                  for m in (ploud, jloud)]]
    elif what == "spk_embed":
        pairs = [[m.extract_spk_embed("mel_stats", wav, SR)
                  for m in (pspk, jspk)]]
    else:
        cfg = _Cfg(sample_rate=16000, loud_norm_db=-23.0,
                   vad_max_silence_length=4)
        pcfg = tiny_config().replace(sample_rate=16000, loud_norm_db=-23.0,
                                     vad_max_silence_length=4)
        pairs = [[c().process(wav, SR, conf)[0] for c, conf in (
            (pwp.get_wav_processor_cls(what), pcfg),
            (jwp.get_wav_processor_cls(what), cfg))]]
    for mine, ref in pairs:
        mine, ref = np.asarray(mine), np.asarray(ref)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    if what == "trim_sil":
        assert 0 < len(pairs[0][0]) < len(wav)     # the silence was cut


# --- quality metrics ---------------------------------------------------------

def _jax_params_with(params: STFTParams) -> JSTFTParams:
    """JAX's ``STFTParams`` holding the port's float32 DFT matrices: the
    port reduces the DFT angle mod n_fft before the cosine, JAX does not,
    so the two sets of matrices differ in the last bit of some entries;
    with the same constants the metrics' code is compared alone."""
    j = JSTFTParams(params.n_fft, params.win_length, params.hop_length,
                    SR, 20.0, 12000.0, params.mel_fb_np.shape[1])
    j.cos_m, j.sin_m, j.mel_fb = params.cos_m, params.sin_m, params.mel_fb_np
    return j


def test_quality_metrics_match_jax():
    """MCD (frame-aligned, silence-gated and DTW-aligned), mel L1, f0 RMSE
    and V/UV error within 1e-9 relative of JAX's on the same wavs, and the
    DTW path exactly."""
    ref, syn = _voice(1), _voice(2)
    params = STFTParams(2048, 1200, HOP, SR, 20.0, 12000.0, 128)
    jparams = _jax_params_with(params)
    short = (ref[:6000], syn[:7200])        # ~20 x 24 frames for the DTW
    got = {"mcd": pq.mcd(ref, syn, params),
           "mcd_gated": pq.mcd(ref, syn, params, silence_gate_db=20.0),
           "mcd_dtw": pq.mcd(*short, params, use_dtw=True),
           "mel_l1": pq.mel_l1_np(ref, syn, params),
           **pq.f0_metrics(ref, syn, SR, HOP)}
    want = {"mcd": jq.mcd(ref, syn, jparams),
            "mcd_gated": jq.mcd(ref, syn, jparams, silence_gate_db=20.0),
            "mcd_dtw": jq.mcd(*short, jparams, use_dtw=True),
            "mel_l1": jq.mel_l1_np(ref, syn, jparams),
            **jq.f0_metrics(ref, syn, SR, HOP)}
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(v) and (v != 0 or k == "vuv_error"), k
        assert abs(got[k] - v) <= QUALITY_RTOL * abs(v), (k, got[k], v)
    cost = np.random.RandomState(4).rand(17, 23)
    for a, b in zip(pq._dtw_path(cost), jq._dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    mels = np.random.RandomState(5).randn(2, 40, 128)
    np.testing.assert_allclose(pq.mel_cepstra(mels[0]),
                               jq.mel_cepstra(mels[0]), rtol=QUALITY_RTOL)


# --- render and test on the CPU ----------------------------------------------

@pytest.fixture(scope="module")
def trainer(synth, tmp_path_factory):
    _, cfg = synth
    tr = Trainer(cfg.replace(work_dir=str(tmp_path_factory.mktemp("tr"))),
                 device="cpu")
    return tr, tr.init_state()


def _expected_wavs(model, batch, seed):
    """``infer_prior`` with the seeded noise, then ``decode_frames``."""
    x = {k: torch.from_numpy(batch[k]) for k in
         ("text_tokens", "note_pitch", "note_dur", "mel2ph", "spk_ids")}
    b, t = x["mel2ph"].shape
    eps = torch.randn(b, t, model.cfg.hidden_size,
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        z_p, mask = model.infer_prior(x["text_tokens"], x["note_pitch"],
                                      x["note_dur"], x["mel2ph"],
                                      x["spk_ids"], eps=eps)
        return model.decode_frames(z_p, mask, x["spk_ids"]).numpy()


def _pcm(wav: np.ndarray) -> np.ndarray:
    """The int16 samples ``save_wav(wav, norm=True)`` writes."""
    w = np.asarray(wav, np.float64)
    w = w / np.abs(w).max() * 0.95
    return np.clip(w * 32767.0, -32768, 32767).astype("<i2")


def _read_pcm(fn: str) -> np.ndarray:
    wav, sr = load_wav(fn)
    assert sr == SR
    return np.round(wav * 32768.0).astype("<i2")


@pytest.mark.parametrize("png,step", [(True, 7), (False, 8)])
def test_render_valid_writes_the_prior_samples(trainer, png, step,
                                               monkeypatch, capsys):
    """``render_valid`` writes, per valid item, the waveform of
    ``infer_prior`` with the step-seeded noise and ``decode_frames`` (the
    same 16-bit samples) and its mel PNG; without matplotlib the wavs only,
    said once."""
    tr, state = trainer
    monkeypatch.setattr(tr.logger, "_tb", None)  # TB media: the CLI test
    if not png:
        monkeypatch.setattr(trainer_mod, "_matplotlib_ok", lambda: False)
        monkeypatch.setattr(tr, "_png_skip_said", False)
    valid = build_dataset(tr.cfg, "valid")
    batch = next(valid.batches(shuffle=False))
    want = _expected_wavs(state.model, batch, step)
    mode = state.model.training
    for _ in range(1 if png else 2):
        written = tr.render_valid(state, valid, step, n_items=2)
    assert state.model.training == mode
    out = capsys.readouterr().out
    assert out.count("mel PNGs and TensorBoard figures skipped") == \
        (0 if png else 1)
    assert len(written) == 2
    for i, fn in enumerate(written):
        t = int(batch["mel_lengths"][i])
        np.testing.assert_array_equal(_read_pcm(fn), _pcm(want[i, : t * HOP]))
        assert os.path.exists(fn[:-4] + "_mel.png") == png


@pytest.mark.parametrize("per_item", [False, True])
def test_test_split_results(trainer, per_item, tmp_path):
    """``Trainer.test`` writes a wav and a result per real test item (the
    repeated padding row of the batch mode left out of both and of the
    audio seconds), with finite quality metrics and the RTF kind of the
    mode; the wavs are ``synthesize`` with noise seeded 0."""
    tr, state = trainer
    tr.cfg = tr.cfg.replace(per_item_rtf=per_item)
    try:
        results = tr.test(state, out_dir=str(tmp_path))
    finally:
        tr.cfg = tr.cfg.replace(per_item_rtf=False)
    test_ds = build_dataset(tr.cfg, "test")
    lengths = [len(test_ds[i]["mel2ph"]) for i in range(len(test_ds))]
    assert len(test_ds) == 3 and len(results) == 3
    assert json.loads((tmp_path / "results.json").read_text()) == results
    assert sorted(r["audio_s"] for r in results) == sorted(
        t * HOP / SR for t in lengths)
    kind = "per_item" if per_item else "batch_mean"
    for r in results:
        assert r["rtf_kind"] == kind and r["rtf"] > 0
        assert all(np.isfinite(r[k]) for k in ("mcd", "mel_l1",
                                                "vuv_error"))
        assert (tmp_path / "wavs" / r["wav_fn_pred"]).exists()
    assert len(os.listdir(tmp_path / "wavs")) == 3
    # the first item, alone or first in its batch, is the seeded sample
    batch = next(test_ds.batches(max_sentences=1 if per_item else 2,
                                 shuffle=False))
    wav, _ = synthesize(state.model, batch, 0)
    t = int(batch["mel_lengths"][0])
    np.testing.assert_array_equal(
        _read_pcm(str(tmp_path / "wavs" / results[0]["wav_fn_pred"])),
        _pcm(wav[0, : t * HOP].numpy()))


# --- the command line --------------------------------------------------------

def test_cli_train_then_test(synth, capsys):
    """``run train`` (2 steps, a render at step 2, ``test_after_train``)
    and ``run test`` in both RTF modes through ``main``; the terminal log
    is copied and stdout restored."""
    cfg_fn, cfg = synth
    work = Path(cfg.work_dir)
    hp = ("max_updates=2,tb_log_interval=1,val_check_interval=2,"
          "num_sanity_val_steps=0,eval_max_batches=1,render_valid=True,"
          "valid_infer_interval=2,num_valid_plots=1,test_after_train=True")
    import sys

    stdout = sys.stdout
    state = run.main(["train", "--config", str(cfg_fn), "-hp", hp,
                      "--device", "cpu"])
    assert sys.stdout is stdout and state.step == 2
    out = capsys.readouterr().out
    assert "| render_valid step 2: 1 items" in out and "| test: 3 items" in out
    logs = list((work / "terminal_logs").iterdir())
    assert len(logs) == 1 and "| test: 3 items" in logs[0].read_text()
    assert sorted(p.name for p in (work / "valid_2").iterdir()) == [
        "item0.wav", "item0_mel.png"]
    assert len(list((work / "tb").iterdir())) == 1
    assert len(json.loads(
        (work / "test_after_train" / "results.json").read_text())) == 3
    for per_item in (False, True):
        results = run.main(["test", "--config", str(cfg_fn), "-hp",
                            f"per_item_rtf={per_item}", "--device", "cpu"])
        assert [r["rtf_kind"] for r in results] == \
            ["per_item" if per_item else "batch_mean"] * 3
        saved = json.loads((work / "generated_2" / "results.json"
                            ).read_text())
        assert saved == results


@pytest.mark.parametrize("answer,removed", [("y", True), ("n", False),
                                            (EOFError, False)])
def test_remove_asks_before_deleting(tmp_path, monkeypatch, answer, removed):
    """``--remove`` deletes the experiment's work dir only on "y"; no answer
    (end of input) keeps it; ``--debug`` lands in the config."""
    monkeypatch.chdir(tmp_path)
    work = tmp_path / "checkpoints" / "x"
    work.mkdir(parents=True)
    (work / "model_ckpt_steps_1.pt").write_bytes(b"old")
    asked = []

    def fake_input(prompt):
        asked.append(prompt)
        if answer is EOFError:
            raise EOFError
        return answer

    monkeypatch.setattr(builtins, "input", fake_input)
    cfg_fn = tmp_path / "cfg.json"
    cfg_fn.write_text(json.dumps(tiny_config().replace(
        processed_data_dir=str(tmp_path / "p")).to_dict()))
    run.main(["synth-data", "--config", str(cfg_fn), "--exp_name", "x",
              "--remove", "--debug", "--n_items", "1"])
    assert len(asked) == 1
    assert (work / "model_ckpt_steps_1.pt").exists() != removed
    saved = json.loads((work / "config.json").read_text())
    assert saved["debug"] is True and saved["work_dir"] == "checkpoints/x"
