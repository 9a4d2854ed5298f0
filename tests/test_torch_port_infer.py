"""The port's ``VISingerInfer`` (MIDI file -> waveform) and streaming decode
against the JAX package's, on the CPU at ``tiny_config`` size, with one
bucket pair (256 frames, 32 tokens) so the JAX side compiles each program
once for the module.

Exact: score rows (with ``pitch_control``), model inputs, padded batches and
phrase splits.  Float32 (converted weights, the same prior noise eps): the
waveform within 1e-4 of its peak of JAX's ``VISingerInfer`` (the limit of
``tests/test_torch_port_slice.py``); the streamed decode within 2e-5 of
JAX's streamed decode and of the port's full decode (the limit of
``tests/test_streaming.py``), and the halo-0 decode not within it (the
negative control).  JAX's eps is recovered from its own ``infer_prior`` and
``__call__(infer=True)`` on a batch whose every frame is valid, with the key
its ``VISingerInfer`` uses; it is passed to the port through
``prior_noise``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from visinger_tpu.infer.infer import VISingerInfer as JVISingerInfer
from visinger_tpu.infer import streaming as j_streaming
from visinger_tpu.config import load_config
from visinger_tpu.models.factory import build_models, init_params
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu_torch.config import tiny_config, visinger_csd
from visinger_tpu_torch.infer import streaming as p_streaming
from visinger_tpu_torch.infer.infer import VISingerInfer

from test_torch_port_frontend import scores  # noqa: F401 (module fixture)
from test_torch_port_modules import fill_params

BUCKETS = dict(frame_buckets=[256], token_buckets=[32], max_sentences=2)
SEED = 0
WAV_RTOL = 1e-4     # waveform max abs err, as a share of the reference's peak
STREAM_ATOL = 2e-5  # tests/test_streaming.py's limit
CHUNK = 64


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.fixture(scope="module")
def pair(scores):  # noqa: F811
    """(JAX VISingerInfer, port VISingerInfer on the CPU, JAX eps [1, 256,
    H] for key ``SEED``), the same random weights on both sides."""
    data_dir, _ = scores
    jcfg = jax_tiny_config().replace(**BUCKETS)
    pcfg = tiny_config().replace(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in BUCKETS.items()})
    port = VISingerInfer(pcfg, _jax_params(jcfg, data_dir), data_dir,
                         device="cpu")
    jinf = JVISingerInfer(jcfg, _jax_params(jcfg, data_dir), data_dir)
    return jinf, port, _jax_eps(jinf, port)


def _jax_params(jcfg, data_dir):
    """A filled JAX generator tree for the data dir's vocabularies (traced,
    not run), as numpy arrays."""
    import json

    with open(f"{data_dir}/phone_set.json") as f:
        vocab = len(json.load(f))
    sizes = []
    for name in ("pitch_map", "dur_map"):
        with open(f"{data_dir}/{name}.json") as f:
            sizes.append(len(json.load(f)))
    raw = jax_synthetic_batch(1, 12, 64, vocab, *sizes,
                              num_linear_bins=jcfg.num_linear_bins,
                              hop_size=jcfg.hop_size)
    model, disc = build_models(jcfg, vocab, *sizes)
    shapes = jax.eval_shape(lambda: init_params(jcfg, model, disc, raw)[0])
    return fill_params(shapes, SEED)


def _jax_eps(jinf, port):
    """JAX's prior noise for key SEED at [1, 256, H]: (z_p - mu_p) /
    exp(logs_p) on a batch whose every frame is valid."""
    cfg = jinf.cfg
    t, n = cfg.frame_buckets[0], cfg.token_buckets[0]
    rng = np.random.RandomState(1)
    batch = {
        "text_tokens": rng.randint(4, len(port.ph_encoder), (1, n)),
        "note_pitch": rng.randint(1, len(port.pitch_map), (1, n)),
        "note_dur": rng.randint(4, len(port.dur_map), (1, n)),
        "mel2ph": np.sort(rng.randint(1, n + 1, (1, t)), axis=1),
    }
    args = [jnp.asarray(batch[k], jnp.int32) for k in
            ("text_tokens", "note_pitch", "note_dur", "mel2ph")]
    key = jax.random.PRNGKey(SEED)
    spk = jnp.zeros((1,), jnp.int32)
    z_p, _ = jax.jit(functools.partial(jinf.model.apply,
                                       method="infer_prior"))(
        {"params": jinf.params_g}, *args, spk_id=spk, rngs={"sample": key})
    # __call__(infer=True) is the program JAX's VISingerInfer runs: share it
    full = jax.jit(functools.partial(jinf.model.apply, infer=True,
                                     deterministic=True))
    out = full({"params": jinf.params_g}, *args, spk_id=spk,
               rngs={"sample": key})
    jinf._infer_fn = lambda params, b, r: full(
        {"params": params}, b["text_tokens"], b["note_pitch"], b["note_dur"],
        b["mel2ph"], spk_id=b["spk_ids"], rngs={"sample": r})["wav_out"]
    eps = (np.asarray(z_p, np.float64) - np.asarray(out["mu_p"], np.float64)) \
        * np.exp(-np.asarray(out["logs_p"], np.float64))
    return torch.from_numpy(eps.astype(np.float32))


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra == rb


def test_front_end_and_padding_match_jax_exactly(pair, scores):  # noqa: F811
    jinf, port, _ = pair
    _, fns = scores
    for name, fn in fns.items():
        for pc in (0, 4):
            rows = port.score_rows(fn, pitch_control=pc)
            _rows_equal(rows, jinf.score_rows(fn, pitch_control=pc))
        moved = [r for r, b in zip(rows, port.score_rows(fn)) if r[2] > 0]
        assert moved and all(r[2] == b[2] + 4 for r, b in zip(
            moved, [b for b in port.score_rows(fn) if b[2] > 0]))
        for phrase in (port._phrases(rows) if name == "split" else [rows]):
            got, want = port.rows_to_inputs(phrase), \
                jinf.rows_to_inputs(phrase)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
            (pb, pt), (jb, jt) = port._pad_to_bucket(got), \
                jinf._pad_to_bucket(want)
            assert pt == jt and pb.keys() == jb.keys()
            for k in pb:
                assert pb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(pb[k], jb[k])
        assert port.preprocess_input(fn).keys() == \
            jinf.preprocess_input(fn).keys()
    rows = port.score_rows(fns["split"])
    for max_frames in (256, 64):
        got = port.divide_phrases(rows, max_frames, 300, 24000)
        _rows_equal(got, jinf.divide_phrases(rows, max_frames, 300, 24000))
    assert len(port._phrases(rows)) >= 2


def test_divide_phrases_bar_fallback_and_giant_bar_match_jax():
    # tests/test_infer.py's cases: 8 bars x 2 notes with no silence row, and
    # one 10-note bar
    rows, t = [], 0.0
    for bar in range(8):
        for pos in range(2):
            rows.append([bar, pos, 60 + pos, 4, t, t + 1.0, 120, [5], ["가"]])
            t += 1.0
    giant = [[0, i, 60, 4, float(i), float(i + 1), 120, [5], ["가"]]
             for i in range(10)]
    for rws, max_frames, n_min in ((rows, 340, 2), (giant, 100, 1)):
        got = VISingerInfer.divide_phrases(rws, max_frames, 300, 24000)
        _rows_equal(got, JVISingerInfer.divide_phrases(rws, max_frames, 300,
                                                       24000))
        assert len(got) >= n_min and sum(map(len, got)) == len(rws)
    assert len(VISingerInfer.divide_phrases(giant, 100, 300, 24000)) == 1


@pytest.mark.parametrize("name", ["short0", "split"])
def test_waveform_matches_jax(pair, scores, name, monkeypatch):  # noqa: F811
    jinf, port, eps = pair
    fn = scores[1][name]
    monkeypatch.setattr(port, "prior_noise", lambda t_pad, seed: eps)
    got, rtf = port.synthesize(fn, seed=SEED)
    want, _ = jinf.synthesize(fn, seed=SEED)
    peak = float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert peak > 1e-2  # the comparison is not vacuous
    assert max_err(got, want) < WAV_RTOL * peak
    assert np.isfinite(rtf) and rtf > 0


def test_synthesize_batch_equals_per_file(pair, scores, tmp_path):  # noqa: F811
    _, port, _ = pair
    fns = [scores[1][k] for k in ("short0", "split", "short1", "short2",
                                  "meter")]
    records = port.synthesize_batch(fns, pitch_control=2, seed=3)
    assert [r["fn"] for r in records] == fns
    assert [r["rtf_kind"] for r in records] == \
        ["batch_mean", "per_item", "batch_mean", "batch_mean", "per_item"]
    # 3 one-bucket scores in groups of max_sentences = 2; the longer two are
    # split into phrases and synthesized alone
    assert len(port.last_group_seconds) == 2
    for r in records:
        single, _ = port.synthesize(r["fn"], pitch_control=2, seed=3)
        assert r["wav"].shape == single.shape
        assert r["audio_s"] == len(single) / 24000 and r["rtf"] > 0
        assert max_err(r["wav"], single) <= 1e-6 * float(np.abs(single).max())
    # a different seed draws different noise
    other, _ = port.synthesize(fns[0], seed=4)
    assert max_err(other, records[0]["wav"]) > 1e-3
    out = str(tmp_path / "out.wav")
    assert port.to_file(fns[0], out) > 0
    from visinger_tpu_torch.utils.audio.io import load_wav

    wav, sr = load_wav(out)
    assert sr == 24000 and len(wav) == len(records[0]["wav"])
    assert abs(float(np.abs(wav).max()) - 0.95) < 1e-3  # out_wav_norm


def test_halo_frames_match_jax():
    for pcfg, jcfg in ((tiny_config(), jax_tiny_config()),
                       (visinger_csd(), load_config(name="visinger_csd"))):
        for fn in ("flow_halo_frames", "decoder_halo_frames", "halo_frames"):
            assert getattr(p_streaming, fn)(pcfg) == \
                getattr(j_streaming, fn)(jcfg)
    # visinger_csd: 4 couplings x 4 layers x (5 // 2) flow frames + 23
    # decoder frames; a streaming window of 256 + 2 x 55 = 366 frames
    assert p_streaming.flow_halo_frames(visinger_csd()) == 32
    assert p_streaming.halo_frames(visinger_csd()) == 55


def test_streaming_decode_matches_jax_full_and_not_halo0(pair):
    jinf, port, _ = pair
    rng = np.random.RandomState(7)
    h = port.cfg.hidden_size
    jstream = j_streaming.StreamingSynthesizer(jinf.cfg, jinf.model,
                                               chunk_frames=CHUNK)
    pstream = p_streaming.StreamingSynthesizer(port.cfg, port.model,
                                               chunk_frames=CHUNK,
                                               device="cpu")
    assert pstream.halo == jstream.halo and pstream.window < 256
    for t, valid in ((256, 230), (pstream.window - 9, 50)):
        mask = (np.arange(t) < valid).astype(np.float32)[None, :, None]
        z_p = (rng.randn(1, t, h) * mask).astype(np.float32)
        want = np.asarray(jstream.decode(jinf.params_g, jnp.asarray(z_p),
                                         jnp.asarray(mask)))
        zt, mt = torch.from_numpy(z_p), torch.from_numpy(mask)
        got = pstream.decode(zt, mt).numpy()
        assert got.shape == want.shape == (1, t * 300)
        assert max_err(got, want) < STREAM_ATOL
        if t > pstream.window:
            assert pstream.n_windows(t) == 4
            with torch.no_grad():
                full = port.model.decode_frames(
                    zt, mt, spk_id=torch.zeros(1, dtype=torch.long)).numpy()
            assert max_err(got, full) < STREAM_ATOL
            halo0 = p_streaming.StreamingSynthesizer(
                port.cfg, port.model, chunk_frames=CHUNK, halo=0,
                device="cpu")
            assert max_err(halo0.decode(zt, mt).numpy(), full) > STREAM_ATOL


def test_stream_infer_serves_the_same_waveform(pair, scores):  # noqa: F811
    _, port, _ = pair
    streamed = VISingerInfer(port.cfg.replace(stream_infer=True,
                                              stream_chunk_frames=CHUNK),
                             port.model, scores[0], device="cpu")
    fn = scores[1]["short1"]
    got, _ = streamed.synthesize(fn, seed=2)
    want, _ = port.synthesize(fn, seed=2)
    assert max_err(got, want) < STREAM_ATOL


def test_malformed_score_and_mode_conflict_raise(pair, scores):  # noqa: F811
    jinf, port, _ = pair
    rows = port.score_rows(scores[1]["short0"])
    bad = [list(r) for r in rows]
    bad[-1][5] = bad[-1][4]  # the <EOS> row covers no frame
    for inf in (port, jinf):
        with pytest.raises(ValueError, match="malformed score"):
            inf.rows_to_inputs(bad)
    with pytest.raises(ValueError, match="mutually exclusive"):
        VISingerInfer(port.cfg.replace(sp_infer=True, stream_infer=True),
                      port.model, scores[0], device="cpu")
    with pytest.raises(NotImplementedError, match="sp_infer"):
        VISingerInfer(port.cfg.replace(sp_infer=True), port.model,
                      scores[0], device="cpu")
