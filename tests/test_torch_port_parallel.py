"""The port's scale-out (``visinger_tpu_torch/parallel/``) on the CPU: a
2-rank gloo process group against the 1-process port, and the arithmetic
against the JAX package's ``parallel/``.

One module fixture starts the group once per pytest session (under
xdist the first worker computes, the others read its files): two
subprocesses of this file
(``python tests/test_torch_port_parallel.py <spec> <out>``, torchrun's
variables in their environment, one thread each) run every case of the
spec and save their results; the test functions assert them.  Meanwhile
the test process computes the 1-process references.  Cases:

- ``dp``: the data-parallel step on a global batch of 4 (2 rows a rank)
  whose items' valid frame counts differ and whose last row is a padding
  row (item weight 0, on rank 1), against the 1-process step on the whole
  batch: the summed gradients at the first step, the metrics of 2 steps,
  and the parameters after them; and the parameters bit-identical across
  the ranks;
- ``accum``: the same over 4 micro-batches with ``accumulate_grad_batches``
  2, the ranks under ``remat_policy`` "full" (the backward's recompute
  issues no collective; the reference runs without remat);
- ``trainer``: ``Trainer.fit`` for 2 steps, then a new trainer resumed to
  3, on a corpus binarized by the JAX pipeline (``build_corpus``);
- ``sp``: ``VISingerInfer`` with ``sp_infer`` on a 63-frame bucket (padded
  to 64) and ``sp_decode`` with a voice embedding, against the 1-process
  decode of the same padded score and against the JAX package's synthesis
  of it (the JAX model's prior and ``decode_frames`` at 64 frames, with
  the same weights and the same prior noise), with and without
  ``use_spk_embed``.  The JAX weights are drawn (``fill_params``) and the
  JAX waveforms computed in the test process while the ranks run; the
  ranks wait for the weights' file before this case.

The JAX lockstep of the data-parallel step is in
``tests/test_torch_port_train.py``, which starts this file's worker too.

Tolerances: metrics 1e-5 relative, gradients 1e-5 of their peak (the
ranks' sums add the same terms in another order), parameters 2e-4
absolute after Adam's normalised steps (``tests/test_multichip.py``'s
limit), waveforms 1e-4 of their peak.  The attention key projection's bias
has a gradient of zero in exact arithmetic (the softmax removes it), so its
rounding noise is held to 1e-5 of the largest gradient instead, and Adam's
first step turns that noise into updates of ±lr: the reference computes
with one thread, as each rank does, so that the split of the batch is the
only difference (with 8 threads the reference's own reordering moved the
second step's ``gnorm_g`` by 1.5e-4).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from visinger_tpu_torch.config import Config, tiny_config  # noqa: E402
from visinger_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from visinger_tpu_torch.models.factory import (build_model,  # noqa: E402
                                               build_models)
from visinger_tpu_torch.parallel import mesh, multihost, sp  # noqa: E402
from visinger_tpu_torch.training.train_state import \
    create_train_state  # noqa: E402
from visinger_tpu_torch.training.train_step import (  # noqa: E402
    _grads, make_train_step, rank_generator)

import test_torch_port_cores  # noqa: E402,F401  (shares the cores)

VOCABS = (40, 96, 64)
WORLD = 2
METRIC_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 2e-4
WAV_RTOL = 1e-4
# dropout off, so the 1-process step and the DP step draw the same noise;
# the discriminator trains from the second step
STEP_CFG = dict(p_dropout=0.0, disc_start_steps=1, dec_kernel_size=(3,),
                dec_dilation_sizes=((1, 3),))
LOOP = dict(tb_log_interval=2, val_check_interval=2, num_sanity_val_steps=1,
            eval_max_batches=1, num_ckpt_keep=5)


def step_cfg(**kw) -> Config:
    return tiny_config().replace(**{**STEP_CFG, **kw})


def dp_batches() -> list[dict]:
    """Two global batches of 4 items of unequal valid lengths; row 3 is a
    padding copy of row 2 with item weight 0 (on rank 1)."""
    cfg = step_cfg()
    out = []
    for seed in (3, 4):
        b = synthetic_batch(4, 12, 64, *VOCABS, cfg.num_linear_bins,
                            cfg.hop_size, seed=seed)
        b.pop("spec")
        for k in b:
            b[k][3] = b[k][2]
        b["item_weights"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


def run_steps(cfg: Config, batches: list, shard: bool) -> dict:
    """{"grads": the generator's gradients at the first batch (summed over
    the ranks), "metrics": [per step], "params": after the steps, "spread":
    the largest difference of any parameter across the ranks}; ``shard``:
    each rank takes its rows of every batch."""
    model, disc = build_models(cfg, *VOCABS, device="cpu", seed=0)
    step = make_train_step(cfg, model, disc, device="cpu")
    first = mesh.shard_batch(batches[0]) if shard else batches[0]
    state = create_train_state(model, disc, seed=0)
    eps_q = ids = None
    if shard:
        eps_q, ids = step.global_draws(state, first)
    total, _, _ = step.generator_loss(state, first, eps_q, ids)
    grads = mesh.all_reduce_grads(_grads(total, list(model.parameters())))
    state = create_train_state(model, disc, seed=0)
    metrics = []
    for b in batches:
        state, m = step(state, mesh.shard_batch(b) if shard else b)
        metrics.append({k: float(v) for k, v in m.items()})
    params = [p.detach().clone() for p in (*model.parameters(),
                                           *disc.parameters())]
    return {"grads": [g.detach().clone() for g in grads],
            "names": [n for n, _ in model.named_parameters()],
            "metrics": metrics, "params": params, "step": state.step,
            "spread": mesh.replicated_check(params)}


SP_INPUT = dict(n_tokens=10, n_frames=63)


def sp_score(vocabs, seed: int = 5) -> dict:
    """A 63-frame score of 10 tokens (ids within ``vocabs``, the phone,
    pitch and duration vocabulary sizes) for a bucket of 63 frames."""
    rng = np.random.RandomState(seed)
    n, t = SP_INPUT["n_tokens"], SP_INPUT["n_frames"]
    cuts = np.sort(rng.choice(np.arange(1, t), n - 1, replace=False))
    return {"text_tokens": rng.randint(4, vocabs[0], n).astype(np.int32),
            "note_pitch": rng.randint(1, vocabs[1], n).astype(np.int32),
            "note_dur": rng.randint(1, vocabs[2], n).astype(np.int32),
            "mel2ph": np.repeat(np.arange(1, n + 1), np.diff(
                np.concatenate([[0], cuts, [t]]))).astype(np.int32)}


# the sp case's decoder: one resblock kernel, as the step cases'
SP_DECODER = dict(dec_kernel_size=(3,), dec_dilation_sizes=((1, 3),))


def sp_cfg(use_spk_embed: bool, frames: int = 63) -> Config:
    return tiny_config().replace(sp_infer=True, frame_buckets=(frames,),
                                 token_buckets=(12,),
                                 use_spk_embed=use_spk_embed, **SP_DECODER)


def sp_voice() -> torch.Tensor:
    """The voice embedding [1, 256] of the case's second decode."""
    return torch.randn(1, 256, generator=torch.Generator().manual_seed(1))


def sp_case(data_dir: str, use_spk_embed: bool, params: dict) -> dict:
    """The score through ``VISingerInfer`` with ``sp_infer`` (at world 2:
    frames padded 63 -> 64) from the JAX weights ``params``, ``sp_decode``
    of its z_p with a random voice embedding, and the 1-process decodes of
    the same z_p."""
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.run import vocab_sizes

    vocabs = vocab_sizes(data_dir)
    inf = VISingerInfer(sp_cfg(use_spk_embed), params, data_dir,
                        device="cpu")
    model = inf.model
    batch, _ = inf._pad_to_bucket(sp_score(vocabs))
    wav, _ = inf._run([batch], 0)
    x = {k: torch.from_numpy(v) for k, v in batch.items()}
    spk = x.get("spk_embed")
    eps = inf.prior_noise(batch["mel2ph"].shape[1], 0)
    with torch.no_grad():
        z_p, mask = model.infer_prior(
            x["text_tokens"].long(), x["note_pitch"].long(),
            x["note_dur"].long(), x["mel2ph"].long(),
            spk_id=x["spk_ids"].long(), eps=eps, spk_embed=spk)
        ref = model.decode_frames(z_p, mask, spk_id=x["spk_ids"].long(),
                                  spk_embed=spk)
        out = {"frames": batch["mel2ph"].shape[1], "wav": torch.from_numpy(
            wav), "ref": ref}
        if use_spk_embed:
            voice = sp_voice()
            out["voice_wav"] = sp.sp_decode(model, z_p, mask,
                                            spk_id=x["spk_ids"].long(),
                                            spk_embed=voice)
            out["voice_ref"] = model.decode_frames(
                z_p, mask, spk_id=x["spk_ids"].long(), spk_embed=voice)
    return out


def trainer_case(cfg_path: str) -> dict:
    """``run train`` for 2 steps (the command line under torchrun's
    variables: this group), then a new trainer resumed to 3; -> what the
    rank printed, the final parameters' spread across the ranks and the
    work dir's files."""
    import contextlib
    import io

    from visinger_tpu_torch import run
    from visinger_tpu_torch.training.trainer import Trainer

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.main(["train", "--config", cfg_path, "--device", "cpu", "-hp",
                  "max_updates=2"])
        cfg = run.load_config_file(cfg_path)
        state = Trainer(cfg, device="cpu").fit(max_updates=3)
    return {"printed": out.getvalue(), "step": state.step,
            "spread": mesh.replicated_check(
                [*state.model.parameters(), *state.disc.parameters()]),
            "files": sorted(os.listdir(cfg.work_dir))}


def run_rank(spec_path: str, out_dir: str) -> None:
    """One rank of the group: every case of the spec; results to
    ``out_dir/rank{r}.pt``."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    multihost.initialize_distributed(backend="gloo", device="cpu")
    try:
        res = {}
        for case in spec["cases"]:
            if case == "dp":
                res["dp"] = run_steps(step_cfg(), spec["batches"], True)
            elif case == "accum":
                res["accum"] = run_steps(
                    step_cfg(accumulate_grad_batches=2, remat_policy="full"),
                    spec["batches"] * 2, True)
            elif case == "trainer":
                res["trainer"] = trainer_case(spec["trainer_cfg"])
            elif case == "sp":
                params = wait_for(spec["jax_params"])
                res["sp"] = [sp_case(spec["data_dir"], flag, params[flag])
                             for flag in (False, True)]
            elif case == "lockstep":
                res["lockstep"] = lockstep_case(spec["lockstep"])
        torch.save(res, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    finally:
        multihost.shutdown()


def wait_for(path: str, timeout: float = 240.0):
    """The object the test process saves at ``path``, once it is there."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def lockstep_case(spec: dict) -> list:
    """2 steps of the DP step, one item a rank, from given weights and
    with the given draws sliced per rank (the JAX step's, from
    ``tests/test_torch_port_train.py``); -> the metrics of each step."""
    cfg = Config.from_dict(spec["cfg"])
    model, disc = build_models(cfg, *spec["vocabs"], device="cpu")
    model.load_state_dict(spec["model"], strict=True)
    disc.load_state_dict(spec["disc"], strict=True)
    state = create_train_state(model, disc, seed=0)
    step = make_train_step(cfg, model, disc, device="cpu")
    rows = multihost.host_batch_slice(len(spec["batch"]["mel2ph"]))
    metrics = []
    for eps_q, ids in spec["draws"]:
        state, m = step(state, mesh.shard_batch(spec["batch"]),
                        eps_q=eps_q[rows], ids_slice=ids[rows])
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def spawn_group(spec: dict, tmp: Path) -> list:
    """Start the spec's cases in a 2-rank gloo group of subprocesses of
    this file; -> the processes (``collect`` waits for them)."""
    from __graft_entry_torch__ import free_port
    from test_torch_port_cores import subprocess_env

    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    port = free_port()
    procs = []
    for r in range(WORLD):
        env = {**subprocess_env(MASTER_ADDR="localhost",
                                MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
                                RANK=str(r), LOCAL_RANK=str(r),
                                PYTHONPATH=str(REPO)),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(spec_path), str(tmp)], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def collect(procs: list, tmp: Path, timeout: float = 300.0) -> list:
    """Each rank's results, after its process exits 0 within ``timeout``
    seconds (else it is killed and the test fails with its output)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# --- the fixture: one 2-rank group for every case ----------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group's results and the references, computed once per pytest
    session: under xdist the workers share the session's temporary
    directory, and the first worker to take the lock computes them."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) \
        / "torch_port_parallel"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            run_group(root)
            (root / "done").write_text("")
    ref = torch.load(root / "ref.pt", weights_only=False)
    return {"ranks": [torch.load(root / "group" / f"rank{r}.pt",
                                 weights_only=False) for r in range(WORLD)],
            "ref": ref["steps"], "jax_sp": ref["jax_sp"],
            "trainer_cfg": Config.from_dict(
                json.loads((root / "train.json").read_text())),
            "data_dir": ref["data_dir"]}


def jax_sp_params(data_dir: str) -> dict:
    """{use_spk_embed: a filled JAX generator tree (numpy)} for the sp
    case's configurations and the corpus's vocabularies."""
    import jax

    from visinger_tpu.data.synthetic import synthetic_batch as jax_batch
    from visinger_tpu.models.factory import build_models as jax_models
    from visinger_tpu.models.factory import init_params
    from visinger_tpu_torch.run import vocab_sizes

    from test_torch_port_modules import fill_params

    vocabs = vocab_sizes(data_dir)
    out = {}
    for flag in (False, True):
        jcfg = jax_sp_cfg(flag)
        raw = jax_batch(1, 12, 64, *vocabs,
                        num_linear_bins=jcfg.num_linear_bins,
                        hop_size=jcfg.hop_size)
        if flag:
            raw["spk_embed"] = np.zeros((1, 256), np.float32)
        model, disc = jax_models(jcfg, *vocabs)
        shapes = jax.eval_shape(
            lambda: init_params(jcfg, model, disc, raw)[0])
        out[flag] = fill_params(shapes, 0)
    return out


def jax_sp_cfg(use_spk_embed: bool):
    from visinger_tpu.models.factory import tiny_config as jax_tiny_config

    return jax_tiny_config().replace(use_spk_embed=use_spk_embed,
                                     **SP_DECODER)


def jax_sp_waveforms(data_dir: str, params: dict) -> dict:
    """{use_spk_embed: {"wav": JAX's waveform [1, 64 * hop] of the sp
    score padded to 64 frames, "voice_wav": its decode with ``sp_voice``
    (``use_spk_embed`` only)}}: the JAX model's prior (``__call__`` with
    ``infer``), z_p from the port's prior noise for that length, and
    ``decode_frames``, in one jitted function."""
    import functools

    import jax
    import jax.numpy as jnp

    from visinger_tpu.models.factory import build_models as jax_models
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.run import vocab_sizes

    vocabs = vocab_sizes(data_dir)
    out = {}
    for flag in (False, True):
        model, _ = jax_models(jax_sp_cfg(flag), *vocabs)
        inf = VISingerInfer(sp_cfg(flag, frames=64), params[flag], data_dir,
                            device="cpu")
        batch, _ = inf._pad_to_bucket(sp_score(vocabs))
        eps = inf.prior_noise(batch["mel2ph"].shape[1], 0).numpy()
        voice = sp_voice().numpy() if flag else None

        @functools.partial(jax.jit, static_argnums=(3,))
        def synth(p, b, eps, with_voice, voice):
            v = {"params": p}
            spk = b.get("spk_embed")
            o = model.apply(v, b["text_tokens"], b["note_pitch"],
                            b["note_dur"], b["mel2ph"], spk_embed=spk,
                            spk_id=b["spk_ids"], infer=True,
                            deterministic=True,
                            rngs={"sample": jax.random.PRNGKey(0)})
            mask = (b["mel2ph"] > 0).astype(jnp.float32)[..., None]
            z_p = (o["mu_p"] + eps * jnp.exp(o["logs_p"])) * mask
            dec = functools.partial(model.apply, v, method="decode_frames")
            wavs = {"wav": dec(z_p, mask, spk_embed=spk,
                               spk_id=b["spk_ids"])}
            if with_voice:
                wavs["voice_wav"] = dec(z_p, mask, spk_embed=voice,
                                        spk_id=b["spk_ids"])
            return wavs

        got = synth(params[flag], {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jnp.asarray(eps), flag,
                    None if voice is None else jnp.asarray(voice))
        out[flag] = {k: np.asarray(v) for k, v in got.items()}
    return out


def run_group(root: Path) -> None:
    """Every case on the 2-rank group and, meanwhile, the 1-process
    references (one thread, as each rank); -> files under ``root``."""
    from test_torch_port_data import build_corpus

    _, pcfg, binary = build_corpus(root / "corpus")
    trainer_cfg = pcfg.replace(work_dir=str(root / "work"), **LOOP)
    cfg_path = root / "train.json"
    cfg_path.write_text(json.dumps(trainer_cfg.to_dict()))
    batches = dp_batches()
    params_path = root / "group" / "jax_params.pt"
    procs = spawn_group({"cases": ["dp", "accum", "trainer", "sp"],
                         "batches": batches,
                         "trainer_cfg": str(cfg_path),
                         "data_dir": binary,
                         "jax_params": str(params_path)}, root / "group")
    threads = torch.get_num_threads()
    try:
        params = jax_sp_params(binary)
        torch.save(params, root / "group" / "jax_params.part")
        os.replace(root / "group" / "jax_params.part", params_path)
        torch.set_num_threads(1)
        steps = {"dp": run_steps(step_cfg(), batches, False),
                 "accum": run_steps(step_cfg(accumulate_grad_batches=2),
                                    batches * 2, False)}
        torch.set_num_threads(threads)
        jax_sp = jax_sp_waveforms(binary, params)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(threads)
        collect(procs, root / "group")
    torch.save({"steps": steps, "data_dir": binary, "jax_sp": jax_sp},
               root / "ref.pt")


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def assert_steps_match(got: dict, ref: dict):
    assert got["step"] == ref["step"]
    for i, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(g) == set(r)
        for k in r:
            assert np.isfinite(g[k]), (i, k)
            assert rel(g[k], r[k]) <= METRIC_RTOL or abs(g[k] - r[k]) < 1e-9, \
                (i, k, g[k], r[k])
    top = max(float(r.abs().max()) for r in ref["grads"])
    for name, g, r in zip(ref["names"], got["grads"], ref["grads"]):
        peak = top if name.endswith(".conv_k.bias") else float(
            r.abs().max())
        assert float((g - r).abs().max()) <= GRAD_RTOL * peak, name
    worst = max(float((g - r).abs().max())
                for g, r in zip(got["params"], ref["params"]))
    assert worst <= PARAM_ATOL, worst


@pytest.mark.parametrize("case", ["dp", "accum"])
def test_dp_step_equals_the_one_process_step(group, case):
    """Both ranks hold the global step's metrics, gradients and parameters
    (rank 1 with the padding row), and the same parameters bit for bit."""
    for r in range(WORLD):
        got = group["ranks"][r][case]
        assert_steps_match(got, group["ref"][case])
        assert got["spread"] == 0.0
    n = 2 if case == "dp" else 4
    assert group["ref"][case]["step"] == n
    # the second step trained the discriminator, so its gate was honoured
    assert group["ref"][case]["metrics"][-1]["disc"] != 0.0


def test_dp_batch_splits_unequal_frames_and_a_padding_row():
    """The case the loss denominators must get right: the ranks' valid
    frame counts differ and rank 1 holds a row of weight 0."""
    b = dp_batches()[0]
    frames = [int(b["mel_lengths"][rows].sum()) for rows in
              (slice(0, 2), slice(2, 3))]
    assert frames[0] != frames[1]
    assert b["item_weights"][2:].tolist() == [1.0, 0.0]


def test_ranks_draw_different_dropout_masks(monkeypatch):
    """With more than one rank the step's dropout masks come from the
    rank's own generator (``rank_generator``): two ranks given the same
    rows, posterior noise and slices, from the same state, take different
    losses; the same rank twice takes the same."""
    cfg = step_cfg(p_dropout=0.5)
    b = mesh.shard_batch(dp_batches()[0], 0, 2)
    n, t = b["mel2ph"].shape
    eps_q, ids = torch.zeros(n, t, cfg.hidden_size), torch.zeros(
        n, dtype=torch.long)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    totals = []
    for r in (0, 1, 1):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        model, disc = build_models(cfg, *VOCABS, device="cpu", seed=0)
        state = create_train_state(model, disc, seed=0)
        _, m = make_train_step(cfg, model, disc, device="cpu")(
            state, b, eps_q=eps_q, ids_slice=ids)
        totals.append(float(m["total_g"]))
    assert np.isfinite(totals).all()
    assert totals[0] != totals[1] and totals[1] == totals[2]
    g1 = rank_generator(7, 3, 1, "cpu")
    g2 = rank_generator(7, 3, 1, "cpu")
    assert torch.equal(torch.rand(8, generator=g1),
                       torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=rank_generator(7, 3, 0,
                                                                  "cpu")),
                           torch.rand(8, generator=rank_generator(7, 4, 0,
                                                                  "cpu")))


def test_trainer_fit_and_resume_write_one_checkpoint_set(group):
    res = [group["ranks"][r]["trainer"] for r in range(WORLD)]
    for r in res:
        assert r["step"] == 3
        assert r["spread"] == 0.0
        assert "| resumed from step 2" in r["printed"]
    files = res[0]["files"]
    assert [f for f in files if f.startswith("model_ckpt_steps_")] == [
        "model_ckpt_steps_2.pt", "model_ckpt_steps_3.pt"]
    assert not [f for f in files if f.endswith(".part")]
    assert {"best.json", "log.jsonl", "codes", "config.json"} <= set(files)
    wd = group["trainer_cfg"].work_dir
    tees = sorted(os.listdir(os.path.join(wd, "terminal_logs")))
    assert len(tees) == 2 and tees[1].endswith("_rank1.txt")
    with open(os.path.join(wd, "log.jsonl")) as f:
        vals = [line for line in f if '"val"' in line]
    assert len(vals) == 1       # one writer: rank 0's validation at step 2


@pytest.mark.parametrize("spk", [False, True])
def test_sp_waveform_equals_the_single_process_decode(group, spk):
    for r in range(WORLD):
        got = group["ranks"][r]["sp"][int(spk)]
        assert got["frames"] == 64          # 63 padded to the world size
        ref = got["ref"].numpy()
        peak = float(np.abs(ref).max())
        assert peak > 0
        assert float(np.abs(got["wav"].numpy() - ref).max()) \
            <= WAV_RTOL * peak
        if spk:
            vref = got["voice_ref"]
            assert not torch.equal(vref, got["ref"])
            assert float((got["voice_wav"] - vref).abs().max()) \
                <= WAV_RTOL * float(vref.abs().max())


@pytest.mark.parametrize("spk", [False, True])
def test_sp_waveform_matches_jax(group, spk):
    """Each rank's ``sp_infer`` waveform of the score padded to 64 frames
    (and, with ``use_spk_embed``, its ``sp_decode`` with another voice)
    against the JAX package's synthesis of the same padded score with the
    same weights and prior noise, within 1e-4 of JAX's peak."""
    want = group["jax_sp"][spk]
    assert set(want) == ({"wav", "voice_wav"} if spk else {"wav"})
    for r in range(WORLD):
        got = group["ranks"][r]["sp"][int(spk)]
        for key, ref in want.items():
            peak = float(np.abs(ref).max())
            assert peak > 1e-2                  # not vacuous
            wav = np.asarray(got[key])
            assert wav.shape == ref.shape == (1, 64 * tiny_config().hop_size)
            err = float(np.abs(wav - ref).max())
            assert err <= WAV_RTOL * peak, (r, key, err, peak)


def test_graft_entry_dryrun_on_two_cpu_ranks():
    """``python __graft_entry_torch__.py dryrun 2`` without cards: gloo on
    the CPU, said in its output; one DP step and the SP synthesis, with the
    same parameters and waveform on both ranks."""
    from test_torch_port_cores import subprocess_env

    proc = subprocess.run(
        [sys.executable, str(REPO / "__graft_entry_torch__.py"), "dryrun",
         "2"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**subprocess_env(PYTHONPATH=str(REPO)), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "gloo on the CPU with the plain kernels" in proc.stdout
    assert "rank 0 of 2 (gloo, cpu): step 1" in proc.stdout
    assert proc.stdout.rstrip().endswith("dryrun_multichip OK")


# --- in-process --------------------------------------------------------------

def test_sp_pieces_of_every_rank_make_the_full_decode():
    """``sp_piece`` is a pure function: one process runs each rank's piece
    in turn; with halo 0 the pieces miss the context (the control)."""
    cfg = tiny_config()
    model = build_model(cfg, *VOCABS, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    t = 96
    z_p = torch.randn(1, t, cfg.hidden_size, generator=gen)
    mask = torch.ones(1, t, 1)
    mask[:, 80:] = 0
    with torch.no_grad():
        ref = model.decode_frames(z_p, mask)
    peak = float(ref.abs().max())
    for world in (2, 3, 4):
        wav = torch.cat([sp.sp_piece(model, z_p, mask, r, world)
                         for r in range(world)], dim=1)
        assert wav.shape == ref.shape
        assert float((wav - ref).abs().max()) <= WAV_RTOL * peak
    cut = torch.cat([sp.sp_piece(model, z_p, mask, r, 2, halo=0)
                     for r in range(2)], dim=1)
    assert float((cut - ref).abs().max()) > WAV_RTOL * peak
    with pytest.raises(ValueError, match="divisible"):
        sp.sp_piece(model, z_p[:, :95], mask[:, :95], 0, 2)


def test_pad_frames_and_host_batch_slice_match_jax(monkeypatch):
    import jax

    from visinger_tpu.parallel import multihost as jmultihost
    from visinger_tpu.parallel import sp as jsp

    for k in range(1, 9):
        jmesh = jsp.make_sp_mesh(jax.devices()[:k])
        for n in (1, 5, 63, 64, 127, 640, 1237):
            assert sp.pad_frames_for_mesh(n, k) == \
                jsp.pad_frames_for_mesh(n, jmesh)
    for world in (1, 2, 3, 4, 8):
        for r in range(world):
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            monkeypatch.setattr(jax, "process_index", lambda i=r: i)
            monkeypatch.setattr(mesh, "world_size", lambda w=world: w)
            monkeypatch.setattr(mesh, "rank", lambda i=r: i)
            for n in (4, 8, 12, 16, 24):
                if n % world:
                    with pytest.raises(AssertionError):
                        jmultihost.host_batch_slice(n)
                    with pytest.raises(ValueError, match="divisible"):
                        multihost.host_batch_slice(n)
                else:
                    assert multihost.host_batch_slice(n) == \
                        jmultihost.host_batch_slice(n)


def test_no_group_is_the_identity_and_no_fallback(monkeypatch):
    """Without a process group the collectives are the identity; a group
    that cannot start raises, and so does a world size that does not divide
    the batch."""
    assert not mesh.distributed() and mesh.world_size() == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.global_sum(x) is x
    grads = [x, x + 1]
    assert mesh.all_reduce_grads(grads) is grads
    assert mesh.replicated_check([x]) == 0.0
    b = {"a": np.arange(4)}
    assert mesh.shard_batch(b) is b
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch({"a": np.arange(3)}, 0, 2)
    assert mesh.shard_batch(b, 1, 2)["a"].tolist() == [2, 3]
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "VISINGER_COORDINATOR", "VISINGER_NUM_PROCESSES",
                "VISINGER_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost.requested()
    with pytest.raises(ValueError, match="world size"):
        multihost.initialize_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="nccl|NCCL"):
        multihost.initialize_distributed("localhost:1", 1, 0,
                                         backend="nccl", device="cpu")
    assert not mesh.distributed()
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    from visinger_tpu_torch.training.trainer import Trainer

    with pytest.raises(ValueError, match="divisible"):
        Trainer(tiny_config().replace(max_sentences=4), "unused",
                device="cpu")


def test_backend_choice(monkeypatch):
    """NCCL only when the ranks are on CUDA and each local rank has a card
    of its own; gloo on the CPU and for ranks sharing a card."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend("cpu", 1) == "gloo"
    assert multihost.choose_backend("cuda", 1) == "nccl"
    assert multihost.choose_backend("cuda:0", 2) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")     # one card on each host
    assert multihost.choose_backend("cuda", 8) == "nccl"


def test_device_gather_of_a_rank_rows_keeps_the_batch_weights():
    """A rank gathers only its rows of a device-store batch, and its rows
    keep the weights they have in the whole batch: rank 1's first row
    repeats rank 0's last index, so it is padding (weight 0)."""
    from visinger_tpu_torch.data.device_store import gather_batch

    gen = torch.Generator().manual_seed(0)
    n, t, hop = 3, 8, 4
    arrays = {"tokens": torch.randint(0, 9, (n, 3, 6), generator=gen),
              "wavs": torch.randint(-99, 99, (n, t * hop), generator=gen,
                                    dtype=torch.int16),
              "f0": torch.rand(n, t, generator=gen),
              "uv": torch.randint(0, 2, (n, t), generator=gen),
              "mel2ph": torch.randint(0, 6, (n, t), generator=gen),
              "mel_lengths": torch.tensor([8, 5, 7]),
              "text_lengths": torch.tensor([6, 3, 4]),
              "spk_ids": torch.tensor([0, 1, 2])}
    idxs = torch.tensor([0, 1, 1, 1])
    whole = gather_batch(arrays, idxs, 6, 4, hop)
    assert whole["item_weights"].tolist() == [1.0, 1.0, 0.0, 0.0]
    for r in range(2):
        rows = mesh.host_batch_slice(4, r, 2)
        got = gather_batch(arrays, idxs, 6, 4, hop, rows)
        assert set(got) == set(whole)
        for k, v in whole.items():
            assert torch.equal(got[k], v[rows]), (r, k)


def test_sp_infer_at_one_rank_is_the_plain_path(tmp_path):
    """``sp_infer`` builds, and at world size 1 pads and decodes as the
    plain path does (the same bits); with ``stream_infer`` it is
    refused."""
    from visinger_tpu_torch.config import check_supported, visinger_csd
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.run import vocab_sizes

    data_dir = str(tmp_path)
    (tmp_path / "phone_set.json").write_text(json.dumps(
        [f"ph{i}" for i in range(VOCABS[0])]))
    for name, n in (("pitch_map", VOCABS[1]), ("dur_map", VOCABS[2])):
        (tmp_path / f"{name}.json").write_text(json.dumps(
            {str(i): i for i in range(n)}))
    cfg = tiny_config().replace(frame_buckets=(63,), token_buckets=(12,))
    check_supported(visinger_csd().replace(sp_infer=True), "cuda")
    with pytest.raises(ValueError, match="mutually exclusive"):
        check_supported(cfg.replace(sp_infer=True, stream_infer=True))
    vocabs = vocab_sizes(data_dir)
    model = build_model(cfg, *vocabs, device="cpu", seed=0)
    wavs = []
    for flag in (False, True):
        inf = VISingerInfer(cfg.replace(sp_infer=flag), model, data_dir,
                            device="cpu")
        batch, t = inf._pad_to_bucket(sp_score(vocabs))
        assert batch["mel2ph"].shape[1] == 63 and t == 63
        wavs.append(inf._run([batch], 0)[0])
    np.testing.assert_array_equal(wavs[0], wavs[1])


if __name__ == "__main__":
    run_rank(sys.argv[1], sys.argv[2])
