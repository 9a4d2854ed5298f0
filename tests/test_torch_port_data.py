"""The port's data plane against the JAX package's, on a corpus the JAX
pipeline writes (``generate_corpus`` + ``Binarizer`` at ``tiny_config``,
numpy only): the record store, the port's ``Binarizer`` on the same
metadata, the f0 transforms, ``VISingerDataset``
items and epoch batches, ``batch_by_size`` plans, the device store's plans
and gathered batches, the prefetcher and the meters.  Everything here is
held exactly equal: the same arrays, dtypes and values."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.data import dataset as jds
from visinger_tpu.data import device_store as jstore
from visinger_tpu.data.binarizer import Binarizer
from visinger_tpu.data.record_store import RecordReader as JRecordReader
from visinger_tpu.data.synthetic_corpus import generate_corpus
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.utils.audio import pitch as jpitch
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data import dataset as pds
from visinger_tpu_torch.data.device_store import DeviceStore, gather_batch
from visinger_tpu_torch.data.prefetch import prefetch
from visinger_tpu_torch.data.record_store import RecordReader, RecordWriter
from visinger_tpu_torch.utils.audio import pitch as ppitch
from visinger_tpu_torch.utils.meters import AvgMeter, span

import test_torch_port_cores  # noqa: F401  (shares the cores)

# the corpus's items have 240-330 frames: a 700-frame budget makes batches
# of 2 and a padded last batch
CORPUS = dict(frame_buckets=(64, 128, 192, 256, 320, 384, 448, 512),
              token_buckets=(16, 32, 48, 64), max_frames=512,
              max_sentences=2, max_tokens=700)


def build_corpus(root) -> tuple:
    """(JAX config, port config, binary dir) of a 10-item synthetic corpus
    binarized by the JAX package: 7 train, 2 valid and 1 test item."""
    processed, binary = str(root / "processed"), str(root / "binary")
    generate_corpus(processed, n_items=10, seed=0)
    jcfg = jax_tiny_config(
        processed_data_dir=processed, binary_data_dir=binary,
        **{k: list(v) if isinstance(v, tuple) else v
           for k, v in CORPUS.items()})
    jcfg = jcfg.replace(binarization_args=jcfg.binarization_args.to_dict() | {
        "train_range": [3, -1], "valid_range": [1, 3], "test_range": [0, 1],
        "min_text": 2})
    Binarizer(jcfg).process()
    pcfg = tiny_config().replace(binary_data_dir=binary, **CORPUS)
    return jcfg, pcfg, binary


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(tmp_path_factory.mktemp("corpus"))


def assert_same(a, b, where=""):
    """Exactly equal: dict keys, list items, array dtypes and values."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "dtype"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


# --- records and f0 -----------------------------------------------------------

def test_record_store_reads_and_writes_the_jax_records(corpus, tmp_path):
    """Every item of every split as JAX's reader gives it; written back by
    the port's writer, the same bytes."""
    _, _, binary = corpus
    for split in ("train", "valid", "test"):
        mine, ref = RecordReader(f"{binary}/{split}"), \
            JRecordReader(f"{binary}/{split}")
        assert len(mine) == len(ref) > 0
        for i in range(len(ref)):
            assert_same(mine[i], ref[i], f"{split}[{i}]")
        mine.close()
    with RecordWriter(str(tmp_path / "train")) as w:
        for item in JRecordReader(f"{binary}/train"):
            w.add(item)
    for ext in ("data", "idx"):
        assert (tmp_path / f"train.{ext}").read_bytes() == \
            open(f"{binary}/train.{ext}", "rb").read()


def test_binarizer_writes_the_jax_records_serially(corpus, tmp_path):
    """The port's ``Binarizer``, run serially on the metadata the JAX one
    binarized (through its worker pool), writes the same bytes: records,
    index, lengths, token maps and the copied dictionaries."""
    from pathlib import Path

    from visinger_tpu_torch.data.binarizer import Binarizer as PBinarizer

    jcfg, pcfg, binary = corpus
    PBinarizer(pcfg.apply({
        "processed_data_dir": jcfg.processed_data_dir,
        "binary_data_dir": str(tmp_path), "binarize_workers": 1,
        "binarization_args": jcfg.binarization_args.to_dict()})).process()
    mine = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    ref = {p.name: p.read_bytes() for p in Path(binary).iterdir()}
    assert set(mine) == set(ref) and len(ref) == 3 * 3 + 5
    for name in ref:
        assert mine[name] == ref[name], name


def test_f0_transforms_match_jax():
    rng = np.random.RandomState(0)
    f0 = rng.uniform(80, 900, 64)
    f0[[0, 1, 10, 11, 12, 63]] = 0.0                 # unvoiced runs, ends too
    for x in (f0, np.zeros(8), np.full(8, 220.0)):
        assert_same(ppitch.norm_interp_f0(x), jpitch.norm_interp_f0(x))
    norm, uv = ppitch.norm_interp_f0(f0)
    assert_same(ppitch.denorm_f0(norm, uv=uv), jpitch.denorm_f0(norm, uv=uv))
    pad = np.arange(64) > 50
    assert_same(ppitch.denorm_f0(norm, pitch_padding=pad),
                jpitch.denorm_f0(norm, pitch_padding=pad))


# --- dataset --------------------------------------------------------------------

@pytest.mark.parametrize("seed,wav_int16", [(0, False), (7, False), (3, True)])
def test_dataset_items_and_epoch_batches_match_jax(corpus, seed, wav_int16):
    """Items, and one epoch of padded batches shuffled by ``seed`` (every
    array, ``item_weights`` and the repeated padding rows), and the
    unshuffled epoch; ``ship_wav_int16`` ships int16 PCM."""
    jcfg, pcfg, _ = corpus
    jcfg = jcfg.replace(ship_wav_int16=wav_int16)
    pcfg = pcfg.replace(ship_wav_int16=wav_int16)
    mine, ref = pds.VISingerDataset(pcfg, "train"), \
        jds.VISingerDataset(jcfg, "train")
    assert len(mine) == len(ref) == 7
    for i in range(len(ref)):
        assert_same(mine[i], ref[i], f"item {i}")
    got, want = list(mine.batches(seed=seed)), list(ref.batches(seed=seed))
    assert len(got) == len(want) == 4
    assert_same(got, want, "batches")
    assert any(b["item_weights"].min() == 0 for b in got)   # a padded batch
    assert_same(list(mine.batches(shuffle=False)),
                list(ref.batches(shuffle=False)), "unshuffled")


@pytest.mark.parametrize("max_tokens,max_sentences", [
    (1, 4), (100, 3), (700, 2), (1000, 3), (60000, 4)])
def test_batch_by_size_matches_jax(corpus, max_tokens, max_sentences):
    _, pcfg, _ = corpus
    rng = np.random.RandomState(max_tokens)
    for lengths in (pds.VISingerDataset(pcfg, "train").item_lengths(),
                    rng.randint(1, 400, 37)):
        assert_same(pds.batch_by_size(lengths, max_tokens, max_sentences),
                    jds.batch_by_size(lengths, max_tokens, max_sentences))


def test_concat_dataset_and_dict_check_match_jax(corpus, tmp_path):
    """Two corpora with one dictionary set train as one dataset; a
    differing dictionary raises in both packages."""
    jcfg, pcfg, binary = corpus
    dirs = (binary, binary)
    mine = pds.build_dataset(pcfg.replace(binary_data_dirs=dirs), "train")
    ref = jds.build_dataset(jcfg.replace(binary_data_dirs=list(dirs)),
                            "train")
    assert len(mine) == len(ref) == 14
    assert_same(list(mine.batches(seed=2)), list(ref.batches(seed=2)))
    other = tmp_path / "other"
    other.mkdir()
    (other / "phone_set.json").write_text('["a"]')
    for check in (pds.check_dict_consistency, jds.check_dict_consistency):
        with pytest.raises(ValueError, match="phone_set.json"):
            check([binary, str(other)])


# --- device store ------------------------------------------------------------------

@pytest.mark.parametrize("wav_f32", [True, False])
def test_device_store_plans_and_gathers_match_collate_and_jax(corpus,
                                                              wav_f32):
    """The store's epoch plans equal JAX's; each gathered batch equals the
    port's host collate of the same items and JAX's ``gather_batch``."""
    jcfg, pcfg, _ = corpus
    jcfg = jcfg.replace(store_wav_f32=wav_f32, ship_wav_int16=not wav_f32)
    pcfg = pcfg.replace(store_wav_f32=wav_f32, ship_wav_int16=not wav_f32)
    ds = pds.VISingerDataset(pcfg, "train")
    store = DeviceStore(ds, "cpu")
    ref_store = jstore.DeviceStore(jds.VISingerDataset(jcfg, "train"))
    assert store.nbytes == sum(a.nbytes for a in ref_store.arrays.values())
    for seed in (0, 5):
        plans = store.plan_batches(seed=seed)
        assert_same(plans, ref_store.plan_batches(seed=seed), "plans")
        for idxs, t_b, n_b in plans:
            got = gather_batch(store.arrays, torch.from_numpy(idxs), t_b, n_b,
                               pcfg.hop_size)
            n_real = len(set(idxs.tolist()))
            host = ds.collate([ds[int(i)] for i in idxs], n_real=n_real)
            assert_same({k: v.numpy() for k, v in got.items()}, host,
                        "gather vs collate")
            ref = jstore.gather_batch(ref_store.arrays, jnp.asarray(idxs),
                                      t_b, n_b, jcfg.hop_size)
            assert_same({k: v.numpy() for k, v in got.items()},
                        {k: np.asarray(v) for k, v in ref.items()},
                        "gather vs JAX")


# --- prefetch (the four behaviours of tests/test_prefetch.py) ---------------------

def test_prefetch_yields_all_items_in_order():
    assert list(prefetch(range(50), depth=2)) == list(range(50))


def test_prefetch_slow_consumer_terminates():
    """The producer finishes while the queue is full: the sentinel still
    arrives."""
    out = []
    for item in prefetch(range(5), depth=2):
        time.sleep(0.05)
        out.append(item)
    assert out == list(range(5))


def test_prefetch_propagates_producer_exception_to_slow_consumer():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    out = []
    with pytest.raises(RuntimeError, match="boom"):
        for item in prefetch(gen(), depth=1):
            time.sleep(0.05)
            out.append(item)
    assert out == [1, 2]


def test_prefetch_consumer_abandons_early():
    """Closing the generator stops the producer, which would otherwise
    block in ``put`` for good."""
    import threading

    before = threading.active_count()
    it = prefetch(range(100), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# --- meters -----------------------------------------------------------------------

def test_meters():
    m = AvgMeter()
    m.update(2.0)
    m.update(5.0, n=3)
    assert (m.sum, m.cnt, m.avg) == (17.0, 4, 4.25)
    m.reset()
    assert (m.sum, m.cnt, m.avg) == (0.0, 0, 0.0)
    assert span("port_test") is span("port_test", 1)  # off: one no-op
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span("port_test"):
                time.sleep(0.01)
    took = [e.time_range.elapsed_us() / 1e6 for e in prof.events()
            if e.name == "port_test"]
    assert len(took) == 2 and 0.02 <= sum(took) < 1.0
