"""The port stands alone: importing it (and the smoke script) pulls in neither
JAX nor the JAX package, and its entry points refuse a missing card."""

import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_MODULES = [
    "eftpipe_tpu_torch", "eftpipe_tpu_torch.convert",
    "eftpipe_tpu_torch.api.flagship", "eftpipe_tpu_torch.boltzmann.eh98",
    "eftpipe_tpu_torch.boltzmann.background",
    "eftpipe_tpu_torch.likelihood.likelihood", "eftpipe_tpu_torch.likelihood.marginal",
    "eftpipe_tpu_torch.likelihood.parambasis", "eftpipe_tpu_torch.likelihood.reader",
    "eftpipe_tpu_torch.likelihood.covariance",
    "eftpipe_tpu_torch.models.pipeline", "eftpipe_tpu_torch.models.nonlinear",
    "eftpipe_tpu_torch.models.bird", "eftpipe_tpu_torch.models.resum",
    "eftpipe_tpu_torch.models.ap", "eftpipe_tpu_torch.models.transforms",
    "eftpipe_tpu_torch.models.window", "eftpipe_tpu_torch.models.icc",
    "eftpipe_tpu_torch.models.fiber", "eftpipe_tpu_torch.ops.fftlog2d",
    "eftpipe_tpu_torch.boltzmann.emulator", "eftpipe_tpu_torch.boltzmann.providers",
    "eftpipe_tpu_torch.ops.quadform", "eftpipe_tpu_torch.ops.fftlog",
    "eftpipe_tpu_torch.ops.interp", "eftpipe_tpu_torch.ops._build",
    "eftpipe_tpu_torch.tables.loop_matrices", "eftpipe_tpu_torch.tables.qcoef",
    "eftpipe_tpu_torch.parallel", "eftpipe_tpu_torch.parallel.diagnostics",
    "eftpipe_tpu_torch.parallel.sampler", "eftpipe_tpu_torch.parallel.hmc",
    "eftpipe_tpu_torch.parallel.mcmc", "eftpipe_tpu_torch.parallel.mesh",
    "eftpipe_tpu_torch.tools", "eftpipe_tpu_torch.tools.train_solver_emulator",
    "eftpipe_tpu_torch.utils.dicttools", "eftpipe_tpu_torch.utils.safe_expr",
    "eftpipe_tpu_torch.api.products", "eftpipe_tpu_torch.api.model",
    "eftpipe_tpu_torch.api.orchestrate", "eftpipe_tpu_torch.analysis",
    "eftpipe_tpu_torch.analysis.chains", "eftpipe_tpu_torch.analysis.multipole",
    "eftpipe_tpu_torch.analysis.bestfit", "eftpipe_tpu_torch.cli",
    "eftpipe_tpu_torch.compat", "eftpipe_tpu_torch.compat.cobaya",
    "eftpipe_tpu_torch.boltzmann.thermo", "eftpipe_tpu_torch.boltzmann.einstein_boltzmann",
    "eftpipe_tpu_torch.boltzmann._kernels", "eftpipe_tpu_torch.boltzmann.dual",
    "eftpipe_tpu_torch.boltzmann.neutrino",
    "eftpipe_tpu_torch.boltzmann.bridges", "eftpipe_tpu_torch.analysis.kaiser",
    "eftpipe_tpu_torch.analysis.convert", "eftpipe_tpu_torch.analysis.zeff",
    "eftpipe_tpu_torch.native", "eftpipe_tpu_torch.utils.tools",
    "eftpipe_tpu_torch.utils.profiling",
]


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """The interpreters the tests below read, started together: one imports
    every module of the port, then runs ``chip_smoke.py`` and
    ``hmc_flagship.py`` as modules (each stops at its missing card) and
    reports after each step whether JAX or the JAX package got imported
    (``imports``); the others run ``chip_smoke.py`` and ``hmc_flagship.py``
    as scripts, and ``chip_smoke.py`` alone in an empty directory
    (``CompletedProcess``-like (returncode, stdout))."""
    import json

    code = (
        "import sys, importlib, json, runpy\n"
        "def bad():\n"
        "    return [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'eftpipe_tpu' or m.startswith('eftpipe_tpu.')]\n"
        "out = {}\n"
        f"[importlib.import_module(m) for m in {_MODULES!r}]\n"
        "import eftpipe_tpu_torch as p\n"
        "assert (p.EnsembleSampler, p.MCMCDriver, p.HMC)\n"
        "import torch\n"
        "out['port'] = dict(bad=bad(), tf32=torch.backends.cuda.matmul.allow_tf32)\n"
        "for script in ('chip_smoke.py', 'hmc_flagship.py'):\n"
        "    try:\n"
        "        runpy.run_path(script, run_name='not_main')\n"
        "    except SystemExit:\n"
        "        pass\n"
        "    out[script] = dict(bad=bad())\n"
        "print(json.dumps(out))\n"
    )
    alone = tmp_path_factory.mktemp("alone")
    (alone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    run = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {
        "imports": subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, **run),
        "chip_smoke": subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                                       **run),
        "hmc_flagship": subprocess.Popen([sys.executable, str(ROOT / "hmc_flagship.py")],
                                         cwd=ROOT, **run),
        "alone": subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=alone,
                                  env={"PATH": "/usr/bin:/bin", "HOME": str(alone)}, **run),
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = (proc.returncode, stdout, stderr)
    rc, stdout, stderr = out["imports"]
    assert rc == 0, stderr
    out["imports"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_port_imports_without_jax_or_the_jax_package(scripts):
    assert scripts["imports"]["port"] == dict(bad=[], tf32=False)


def test_no_jax_import_statement_in_the_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|eftpipe_tpu)(\s|\.|$)", re.M)
    files = list((ROOT / "eftpipe_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "hmc_flagship.py", ROOT / "tests" / "test_torch_gpu.py",
        ROOT / "tests" / "test_torch_mesh.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_fails_without_a_card_and_imports_no_jax(scripts):
    """Run as a script on a CUDA-less machine: non-zero exit, no result line,
    and the import of jax is never reached."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc, stdout, _ = scripts["chip_smoke"]
    assert rc != 0 and '"ok"' not in stdout
    assert scripts["imports"]["chip_smoke.py"] == dict(bad=[])


def test_hmc_flagship_fails_without_a_card(scripts):
    """The HMC check script needs the card: without one it exits non-zero,
    prints no result and never imports jax."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc, stdout, _ = scripts["hmc_flagship"]
    assert rc != 0 and "hmc_flagship" not in stdout
    assert scripts["imports"]["hmc_flagship.py"] == dict(bad=[])


def test_chip_smoke_alone_in_a_directory_fails(scripts):
    rc, stdout, _ = scripts["alone"]
    assert rc != 0 and '"ok"' not in stdout


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from eftpipe_tpu_torch import resolve_device
    from eftpipe_tpu_torch.api.flagship import build_flagship
    from eftpipe_tpu_torch.models.config import EFTConfig
    from eftpipe_tpu_torch.models.pipeline import TracerPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship(tmp_path)  # default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TracerPipeline.build(EFTConfig(nfft_loop=32, nkin=60), device="cuda")
    from eftpipe_tpu_torch.api.orchestrate import Analysis

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Analysis.from_config({"theory": {"tracers": {}}})  # default device is the card


@pytest.mark.parametrize("kwargs, match", [
    (dict(boltzmann={"name": "emulator"}), "A7"),
    (dict(boltzmann={"name": "solver"}), "A8"),
])
def test_unported_options_raise_not_implemented(tmp_path, kwargs, match):
    """What the port leaves out raises, naming its ROADMAP item: a third
    derivative through the solver on the card (a backward of the double
    backward of its gradient's Function with ``create_graph=True``, here on
    a stand-in for the solver, names A8.2, the second derivative, which is
    ported, as are its first, A8.1).  The Einstein-Boltzmann
    solver provider (A8) is ported:
    ``build_provider`` returns a ``SolverProvider``.  The trained-transfer
    emulator provider (A7) is ported: it builds from a
    ``TransferEmulator.save`` file and gives the JAX package's provider's
    inputs (float64, rtol 1e-12); so are the survey window, the solver
    emulator, the dotted window-builder extension point and cross spectra,
    once listed here."""
    from eftpipe_tpu_torch.api.orchestrate import build_provider
    from eftpipe_tpu_torch.models.config import EFTConfig

    cfg = EFTConfig(nfft_loop=32, nkin=60)
    if match == "A7":
        import jax
        import jax.numpy as jnp
        import numpy as np
        from eftpipe_tpu.api.orchestrate import build_provider as jbuild
        from eftpipe_tpu.models.config import EFTConfig as JConfig
        from test_torch_compat import emulator_params, write_transfer_emulator

        bcfg = dict(kwargs["boltzmann"], path=str(write_transfer_emulator(tmp_path / "e.npz")),
                    om_fid=0.3)
        ours = build_provider(bcfg, cfg, 0.7)
        theirs = jbuild(bcfg, JConfig(nfft_loop=32, nkin=60), 0.7)
        params = emulator_params(seed=8)
        got = ours.inputs({k: torch.as_tensor(v) for k, v in params.items()})
        want = jax.vmap(theirs.inputs)({k: jnp.asarray(v) for k, v in params.items()})
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
        return
    import numpy as np
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as te
    from eftpipe_tpu_torch.boltzmann.einstein_boltzmann import SolverProvider
    from eftpipe_tpu_torch.convert import eb_solver_from_numpy

    # a one-mode schedule, so that nothing is solved or tabulated here
    grid = np.array([[-12.0, -6.0, 0.0]])
    solver = eb_solver_from_numpy(dict(
        k_mpc=[1e-3], z_out=[0.7], lna_out=[np.log(1 / 1.7)], dlna_f=0.02,
        growth_stencil=False, buckets=[(np.array([0]), grid, grid < -10, np.array([[2]]))]),
        device="cpu")
    prov = build_provider(dict(kwargs["boltzmann"], solver=solver, om_fid=0.31), cfg, 0.7,
                          device="cpu")
    assert isinstance(prov, SolverProvider) and prov.solver.device.type == "cpu"
    h = torch.ones(2, dtype=torch.float64, requires_grad=True)
    stand_in = types.SimpleNamespace(
        table_part=lambda par: (2.0 * par.h,),
        table_hessians=lambda par, names: [torch.zeros(2, 1, 1, dtype=torch.float64)])
    par = types.SimpleNamespace(_replace=lambda **kw: types.SimpleNamespace(**kw))
    (out,) = te._SolverTables.apply(stand_in, par, [2.0 * torch.ones(2, 1, dtype=torch.float64)], ("h",), h)
    (g,) = torch.autograd.grad(out.sum(), h, create_graph=True)
    assert torch.equal(g.detach(), 2.0 * torch.ones(2, dtype=torch.float64))
    (hh,) = torch.autograd.grad(g.sum(), h, retain_graph=True)
    assert torch.equal(hh, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match=match):
        torch.autograd.grad(g.sum(), h, create_graph=True)
