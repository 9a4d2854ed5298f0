"""The port's tests share the CPU's cores between pytest-xdist's workers.

Each worker is a process of its own, and PyTorch starts as many intra-op
threads in each as the machine has cores: six workers on eight cores run
48 threads that spin against each other, and the port's tests ran ~4x
slower under ``-n 6`` than one after another (914 s against 235 s of
test time on 8 cores).  Every port test module imports this one, so each
worker gives PyTorch its share of the cores, ``cores // workers`` threads,
and the Python subprocesses a test starts take the same share through
``OMP_NUM_THREADS`` in ``subprocess_env()``.  The worker's own environment
is left as it is: the binarizer's spawned pool must compute with the
parent's BLAS threads to write the parent's bytes.  Alone, a process keeps
every core.
"""

import os

import torch


def _share() -> int:
    """PyTorch threads for one worker: the cores over the workers."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


THREADS = _share()
torch.set_num_threads(THREADS)


def subprocess_env(**extra) -> dict:
    """The environment for a Python subprocess of a test: this worker's
    share of the cores, and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)


def test_each_worker_takes_its_share_of_the_cores():
    assert torch.get_num_threads() == THREADS == _share()
    env = subprocess_env(A="1")
    assert env["OMP_NUM_THREADS"] == str(THREADS) and env["A"] == "1"
