"""The walker mesh (eftpipe_tpu_torch/parallel/mesh.py) over two CPU
processes joined by gloo: the stretch sampler, HMC with its warmup and the
MCMC driver (stretch and HMC, each resumed from its checkpoint) on two ranks
equal the one-process runs on the same seed, bit for bit.  One spawn of two
processes runs every sharded case; the one-process references run here.
Tiny Gaussian targets, float64; imports no JAX."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from eftpipe_tpu_torch.parallel.hmc import HMC
from eftpipe_tpu_torch.parallel.mcmc import MCMCDriver
from eftpipe_tpu_torch.parallel.mesh import replicate, shard_walkers, walker_mesh
from eftpipe_tpu_torch.parallel.sampler import EnsembleSampler

F64 = torch.float64
MEAN = torch.tensor([1.0, -2.0, 0.5], dtype=F64)
SIGMA = torch.tensor([0.3, 0.7, 1.5], dtype=F64)
NW = 8


def logp(x):
    return -0.5 * (((x - MEAN) / SIGMA) ** 2).sum(-1)


def runs(out: str, mesh=None) -> dict:
    """Every case, on ``mesh`` (or in one process without it); the driver's
    files go under ``out``."""
    res = {}
    x0 = MEAN + 0.1 * torch.randn((NW, 3), generator=torch.Generator().manual_seed(0), dtype=F64)
    chain, lps, acc = EnsembleSampler(logp=logp, nwalkers=NW, ndim=3, mesh=mesh).run(
        torch.Generator().manual_seed(1), x0, nsteps=6)
    res.update(stretch_chain=chain, stretch_logp=lps, stretch_acc=acc)
    chain, lps, info = HMC(logp=logp, ndim=3, n_leapfrog=4, mesh=mesh).sample(
        2, x0, n_warmup=10, n_samples=6)
    res.update(hmc_chain=torch.as_tensor(chain), hmc_logp=torch.as_tensor(lps),
               hmc_inv_mass=torch.as_tensor(info["inv_mass"]))
    for kind in ("stretch", "hmc"):
        kw = dict(logp=logp, ndim=3, nwalkers=NW, block=3, rhat_tol=-1.0, sampler_kind=kind,
                  warmup_steps=6, n_leapfrog=4, out=os.path.join(out, kind), mesh=mesh,
                  device=None if mesh else "cpu")
        first = MCMCDriver(**kw).run(seed=3, x0=MEAN, max_steps=6)
        resumed = MCMCDriver(**kw).run(seed=3, x0=MEAN, max_steps=9)
        res[f"driver_{kind}_first"] = torch.as_tensor(first.chain)
        res[f"driver_{kind}_resumed"] = torch.as_tensor(resumed.chain)
        res[f"driver_{kind}_logps"] = torch.as_tensor(resumed.logps)
    return res


def _rank(rank: int, size: int, tmp: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank, world_size=size)
    try:
        mesh = walker_mesh(devices=["cpu"] * size)
        assert (mesh.rank, mesh.size, mesh.device) == (rank, size, torch.device("cpu"))
        x = torch.arange(8.0, dtype=F64)[:, None] + rank  # rank 1's x differs
        assert torch.equal(shard_walkers(x, mesh), torch.arange(8.0, dtype=F64)[
            4 * rank:4 * rank + 4, None] + rank)
        assert torch.equal(replicate(x, mesh), torch.arange(8.0, dtype=F64)[:, None])
        with pytest.raises(ValueError, match="multiple of twice the mesh size"):
            EnsembleSampler(logp=logp, nwalkers=6, ndim=3, mesh=mesh)
        res = runs(os.path.join(tmp, "out"), mesh)
        res["collectives"] = torch.tensor(mesh.collectives)
        res["writes"] = torch.tensor([MCMCDriver(logp=logp, ndim=3, nwalkers=NW,
                                                 mesh=mesh)._writes])
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_rank_mesh_equals_one_process(tmp_path):
    mp.spawn(_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    want = runs(str(tmp_path / "single"))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for key, ref in want.items():
            assert torch.equal(got[key], ref), (rank, key)
        assert bool(got["writes"]) == (rank == 0)
        # stretch: 1 + 2 a step; HMC: 1 + one a leapfrog step; drivers likewise
        assert int(got["collectives"]) > 2 * 6
    # rank 0 wrote the files, and they are the one-process run's
    for kind in ("stretch", "hmc"):
        mesh_txt = np.loadtxt(tmp_path / "out" / f"{kind}.1.txt")
        np.testing.assert_array_equal(mesh_txt, np.loadtxt(tmp_path / "single" / f"{kind}.1.txt"))


def test_walker_mesh_needs_a_process_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        walker_mesh(devices=["cpu"])
