"""The recombination kernels' arithmetic on the CPU: ``csrc/recomb.cuh`` (the
pre-pass and the chain of ``recomb_scan``, ``recomb_scan_jvp`` and
``recomb_scan_jvp2``) compiled with ``g++`` through a small shim that
defines ``__device__``, ``__global__`` and ``__forceinline__`` away and runs
each kernel's threads one after another; ``dv()`` and the branch-free
``exp``/``log`` cores take their host forms (the same operations, the
card's reciprocal estimate aside).  Each instance on a 512-point grid that
crosses the end of the Saha block (step 331 here), three cosmologies (ω_b
at the training box's two ends and a fiducial one), against the port's
plain step loop ``thermo.recomb_scan_plain``: the value, its forward AD
(``Dual``) and the loop on hyper-dual operands (``HD``), each output
within 1e-12 of its largest |value|, but the tangent of the forward AD
within 1e-10: in a direction that moves x_Saha (ω_b, Y_He) x_H's tangent at
the Saha block's end is conditioned ~1e6, and an ulp between torch's and
the C library's pow and exp shows there as 5.6e-11 (a build of the
recurrence that takes every rate of every step with the C library's pow
and exp misses the plain loop there by the same).
Skipped where there is no ``g++``."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb, jet, thermo
from eftpipe_tpu_torch.boltzmann.dual import DenseTangents

CSRC = Path(thermo.__file__).resolve().parent.parent / "csrc"
N_GRID = 512
REL = 1e-12
TANGENT_REL = 1e-10  # the forward AD's tangent (see above)

SHIM = r"""
#include <stddef.h>
#include <vector>

struct HostDim { unsigned long long x; };
static HostDim blockIdx, threadIdx, blockDim;

#define __device__
#define __global__
#define __forceinline__ inline
#include "recomb.cuh"

template <class S>
static void run(RecombIn in, RecombIn din, double* out, double* dout, int nw, int n,
                double dlna) {
  std::vector<double> ws(recomb_work_bytes<S>(nw, n) / sizeof(double) + 1);
  const RecombWork<S> work = recomb_work<S>(ws.data(), nw, n);
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long k = 0; k < static_cast<long long>(nw) * n; ++k) {
    blockIdx.x = k;
    recomb_prep_kernel<S>(in, din, work, out, dout, nw, n, dlna);
  }
  for (int w = 0; w < nw; ++w) {
    blockIdx.x = w;
    recomb_scan_kernel<S>(in, din, work, out, dout, nw, n, dlna);
  }
}

extern "C" void host_recomb(int parts, const double* tg, const double* nh, const double* hs,
                            const double* xs, const double* he, const double* f_he,
                            const double* dtg, const double* dnh, const double* dhs,
                            const double* dxs, const double* dhe, const double* df_he,
                            double* out, double* dout, int nw, int n, double dlna) {
  const RecombIn in{tg, nh, hs, xs, he, f_he}, din{dtg, dnh, dhs, dxs, dhe, df_he};
  if (parts == 0) run<double>(in, din, out, dout, nw, n, dlna);
  if (parts == 1) run<Dual>(in, din, out, dout, nw, n, dlna);
  if (parts == 3) run<HD>(in, din, out, dout, nw, n, dlna);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the recombination kernels' host form")
    tmp = tmp_path_factory.mktemp("recomb_host")
    (tmp / "shim.cpp").write_text(SHIM)
    lib = tmp / "librecomb_host.so"
    res = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                          "-I", str(CSRC), "-o", str(lib), str(tmp / "shim.cpp")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(lib)).host_recomb
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 2
                   + [ctypes.c_double])
    fn.restype = None
    return fn


def params():
    lo, hi = eb.BOX_BOUNDS["omega_b"]
    f64 = dict(dtype=torch.float64)
    return thermo.as_batch(thermo.CosmoParams(
        omega_b=torch.tensor([lo, hi, 0.0224], **f64),
        omega_cdm=torch.tensor([0.12, 0.08, 0.25], **f64),
        h=torch.tensor([0.68, 0.6, 0.8], **f64),
        ln10As=3.044, ns=0.9649, m_ncdm=0.02, n_ur=0.00641, deg_ncdm=3.0))


def run_host(fn, parts: int, ins, tans, dlna: float):
    """The host build on ``ins`` (six tensors) and ``tans`` (their tangents,
    or their three parts stacked last; ignored for ``parts`` 0): the outputs
    (3, W, n) and their tangents (3, W, n[, 3])."""
    ins = [t.contiguous() for t in ins]
    nw, n = ins[0].shape
    out = torch.empty((3, nw, n), dtype=torch.float64)
    dshape = (3, nw, n) if parts < 3 else (3, nw, n, 3)
    dout = torch.zeros(dshape if parts else (1,), dtype=torch.float64)
    tans = [t.contiguous() for t in tans] if parts else [ins[0]] * 6
    fn(parts, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in tans), out.data_ptr(),
       dout.data_ptr(), nw, n, dlna)
    return out, dout


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_inputs_cross_the_saha_boundary():
    """The grid of these tests leaves the Saha block inside it, at the same
    step in every row (the rows' ω_b move its end by less than a step)."""
    par = params()
    bg = thermo.background_tables(par, n_grid=N_GRID)
    xs = thermo.recomb_inputs(par, bg)[3]
    ends = [int((~(xs[w] > 0.999)).nonzero()[0]) for w in range(xs.shape[0])]
    assert ends == [331, 331, 331]
    assert not bool((xs[:, 331:] > 0.999).any())


def test_recomb_scan_host_matches_plain(host_lib):
    par = params()
    bg = thermo.background_tables(par, n_grid=N_GRID)
    ins = thermo.recomb_inputs(par, bg)
    dlna = thermo.scan_step(bg)
    out, _ = run_host(host_lib, 0, ins, None, dlna)
    for got, want in zip(out, thermo.recomb_scan_plain(*ins, dlna)):
        assert torch.isfinite(got).all()
        assert rel(got, want) <= REL


def test_recomb_scan_jvp_host_matches_forward_ad_of_plain(host_lib):
    par = params()
    dlna = thermo.scan_step(thermo.background_tables(par, n_grid=N_GRID))
    rng = np.random.default_rng(4)
    with forward_ad.dual_level(), DenseTangents():
        dpar = par._replace(**{n: forward_ad.make_dual(
            getattr(par, n).contiguous(),
            1e-2 * torch.as_tensor(rng.standard_normal(3), dtype=torch.float64))
            for n in eb.TABLE_FIELDS})
        ins = thermo.recomb_inputs(dpar, thermo.background_tables(dpar, n_grid=N_GRID))
        unp = [forward_ad.unpack_dual(t) for t in ins]
        ref = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan_plain(*ins, dlna)]
    prim = [u.primal for u in unp]
    tans = [u.tangent if u.tangent is not None else torch.zeros_like(u.primal) for u in unp]
    out, dout = run_host(host_lib, 1, prim, tans, dlna)
    for got, dgot, r in zip(out, dout, ref):
        assert float(r.tangent.abs().max()) > 0
        assert rel(got, r.primal) <= REL
        assert rel(dgot, r.tangent) <= TANGENT_REL


def test_recomb_scan_jvp2_host_matches_plain_on_hyper_duals(host_lib):
    par = params()
    values = {n: getattr(par, n) for n in thermo.CosmoParams._fields[:-1]}
    rows, pj = jet.pair_rows(values, ("omega_cdm", "h"), par.h)
    base = thermo.CosmoParams(**rows, deg_ncdm=par.deg_ncdm)

    def stage(ocdm, h):
        p = base._replace(omega_cdm=ocdm, h=h)
        return thermo.recomb_inputs(p, thermo.background_tables(p, n_grid=N_GRID))

    with DenseTangents():
        ins = jet.jet_call(stage, pj)
    dlna = thermo.scan_step(thermo.background_tables(base, n_grid=N_GRID))
    parts = [torch.stack(p, -1) for p in zip(ins.a, ins.b, ins.ab)]
    out, dout = run_host(host_lib, 3, ins.v, parts, dlna)
    want = thermo.recomb_scan_jvp2_plain(ins, dlna)
    for k in range(3):
        assert rel(out[k], want.v[k]) <= REL
        for i, part in enumerate((want.a, want.b, want.ab)):
            assert float(part[k].abs().max()) > 0, (k, i)
            assert rel(dout[k, ..., i], part[k]) <= REL, (k, i)
