"""The CG loop's epilogue: the work of one CG iteration between one operator
application and the next, with the CG scalars kept on the card.

``solver/cg.py pcg(..., epilogue=Epilogue(...))`` runs its loop through
these four steps, each on the flat vectors of one solve's ``CGState``:

- ``cg_pap(st, y)``: Ap = free * y, in place of y (the operator's output
  mask); pAp = sum(p * Ap * inv_mult); alpha = gamma / pAp where run and
  pAp > 0, else 0.
- ``cg_xr(st, Ap)``: x += alpha p, r -= alpha Ap; with a Jacobi divisor
  (``st.dmask``) also gamma_new = sum(r * z * inv_mult) with z = r / dmask,
  rr_new = sum(r * r * inv_mult), and the step's scalars (below).
- ``cg_rz(st, z)``: for a preconditioner that is not pointwise, whose z
  stays an eager call between cg_xr and cg_rz: gamma_new and rr_new of that
  z, and the step's scalars.
- ``cg_p(st, z=None)``: p = z + beta p; with z None, z = r / dmask.

The step's scalars are pcg's, its ``where`` freezes included: beta =
gamma_new / gamma where run, else 0; gamma and rr take the new values only
where run; k += run; run = rr > tol2 & k < maxiter & gamma > 0 & live.
They live in ``st.sf`` (the vectors' dtype, slots GAMMA..TOL2) and
``st.si`` (int64, slots K, RUN, LIVE); the host reads ``st.si[RUN]`` only at
pcg's stop checks.

On a CUDA state each step launches one hand-written kernel of
``csrc/cg_epilogue.cu`` (built into the kernels' library by
``ops/_build.py``) on the stream that was current when the state was made,
or raises. On a CPU state it runs the plain PyTorch version, ``*_ref`` in
this module, made of the step functions that pcg's eager loop is written
in (``alpha_step``, ``xr_step``, ``scalar_step``, ``p_step``): a fused
solve on the CPU gives bitwise the iterates of the eager loop. On the card
the kernels sum in float64 in a fixed order (block partials, then the last
block adds them in block order), so two runs give bitwise the same
iterates, equal to the eager loop's to rounding.

The host side is lean because the host still sets the pace: the state
checks its vectors, resolves the library's symbols and the stream, and
allocates the scratch and the scalar state once per solve; a step checks
only the one vector it is handed, writes its address into the solve's
argument block and makes one ctypes call with that block's address.

``cg_pap.launches`` etc. count the kernel launches of this process (CPU
calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

# the slots of CGState.sf and CGState.si (csrc/cg_epilogue.cu)
GAMMA, RR, PAP, ALPHA, BETA, TOL2 = range(6)
K, RUN, LIVE = range(3)
#: threads a block and blocks a grid at most (8 blocks an SM of an H100)
THREADS = 256
MAX_BLOCKS = 132 * 8


class Epilogue(NamedTuple):
    """What pcg's fused loop needs beyond its own arguments. The loop's
    operator is ``free * apply(v)``; its preconditioner ``r / dmask`` where
    ``dmask`` is given (pointwise, folded into the kernels), else pcg's
    own eager ``M_inv``. ``inv_mult`` weights the dot products."""
    apply: Callable
    free: torch.Tensor
    inv_mult: torch.Tensor
    dmask: torch.Tensor | None = None


class _Args(ctypes.Structure):
    """csrc/cg_epilogue.cu's Args, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "r", "p", "ap", "z", "free", "inv", "dmask", "sf", "si",
        "partials", "counter", "stream")] + [
        ("n", ctypes.c_int64), ("maxiter", ctypes.c_int64),
        ("blocks", ctypes.c_int), ("vec", ctypes.c_int),
        ("f64", ctypes.c_int), ("pad", ctypes.c_int)]


class CGState:
    """One fused CG solve: its vectors x, r, p (updated in place; x starts
    as a copy of x0), the loop's constants free, inv_mult and dmask, the
    scalar state sf, si, and on a card the kernels' scratch and argument
    block. Made from pcg's prologue values: gamma, rr, tol2 (0-d tensors of
    the vectors' dtype), live, run (0-d bool) and k (0-d int64)."""

    def __init__(self, ep: Epilogue, x0, r, z, gamma, rr, tol2, live, run,
                 k, maxiter: int):
        self.dtype, self.device, self.shape = r.dtype, r.device, r.shape
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the CG epilogue takes float32 or float64 "
                            f"vectors, not {self.dtype}")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the CG epilogue runs on cpu or cuda, not "
                             f"{self.device}")
        vecs = {"x0": x0, "r": r, "z": z, "free": ep.free,
                "inv_mult": ep.inv_mult}
        if ep.dmask is not None:
            vecs["dmask"] = ep.dmask
        for name, v in vecs.items():
            self.check(v, f"CGState {name}")
        self.x = x0.clone()
        # p is updated in place: never on r's storage (M_inv = identity)
        self.p = z.clone() if z.data_ptr() == r.data_ptr() else z
        self.r, self.free, self.inv, self.dmask = r, ep.free, ep.inv_mult, \
            ep.dmask
        self.maxiter, self.live = int(maxiter), live
        zero = gamma.new_zeros(())
        self.sf = torch.stack([gamma, rr, zero, zero, zero, tol2])
        self.si = torch.stack([k, run.to(torch.int64),
                               live.to(torch.int64)])
        self._run = self.si[RUN]
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self._bind()

    def _bind(self):
        from pynama_tpu_torch.ops._build import load_library
        lib = load_library()
        self._fns = {"cg_pap": lib.pn_cg_pap, "cg_xr": lib.pn_cg_xr,
                     "cg_rz": lib.pn_cg_rz, "cg_p": lib.pn_cg_p}
        self._error = lib.pn_cuda_error_string
        n = self.x.numel()
        pack = 16 // self.x.element_size()
        blocks = max(1, min(-(-n // (THREADS * pack)), MAX_BLOCKS))
        dev = self.device
        self._scratch = (torch.empty(2 * blocks, dtype=torch.float64,
                                     device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev))
        fixed = [self.x, self.r, self.p, self.free, self.inv]
        if self.dmask is not None:
            fixed.append(self.dmask)
        self._vec = all(t.data_ptr() % 16 == 0 for t in fixed)
        a = _Args(x=self.x.data_ptr(), r=self.r.data_ptr(),
                  p=self.p.data_ptr(), free=self.free.data_ptr(),
                  inv=self.inv.data_ptr(),
                  dmask=None if self.dmask is None
                  else self.dmask.data_ptr(),
                  sf=self.sf.data_ptr(), si=self.si.data_ptr(),
                  partials=self._scratch[0].data_ptr(),
                  counter=self._scratch[1].data_ptr(),
                  stream=torch.cuda.current_stream(dev).cuda_stream,
                  n=n, maxiter=self.maxiter, blocks=blocks,
                  vec=int(self._vec),
                  f64=int(self.dtype == torch.float64))
        self.args, self._addr = a, ctypes.addressof(a)

    def check(self, v, name):
        """Raise unless v is a contiguous vector of this solve's dtype,
        device and shape."""
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} takes a torch tensor")
        if v.dtype != self.dtype:
            raise TypeError(f"{name}: dtype {v.dtype}, the solve's is "
                            f"{self.dtype}")
        if v.device != self.device:
            raise ValueError(f"{name}: on {v.device}, the solve on "
                             f"{self.device}")
        if v.shape != self.shape or not v.is_contiguous():
            raise ValueError(f"{name}: a contiguous {tuple(self.shape)} "
                             f"vector, got {tuple(v.shape)}")

    def launch(self, name, ptr):
        """One kernel of the solve; ptr is the address of the one vector
        the step was handed (or None)."""
        a = self.args
        a.vec = self._vec and not (ptr or 0) % 16
        rc = self._fns[name](self._addr)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc} ({self._error(rc).decode()})")

    def running(self) -> bool:
        """The loop's condition, read by the host (a device sync)."""
        return bool(self._run)

    def result(self):
        """(x, iters, residual) as pcg returns them."""
        x = torch.where(self.live, self.x, torch.zeros_like(self.x))
        return x, self.si[K], torch.sqrt(self.sf[RR])


# ------------------------------------------------------- plain versions
# The CG step as pcg's eager loop (solver/cg.py) writes it, on tensors it
# reassigns, with the caller's `dot` / `dots` (the sharded engine's reduce
# across ranks). The kernels' plain versions below run these same functions
# on a state's vectors and slots, so the eager loop and the plain versions
# are one body.
def alpha_step(p, ap, gamma, run, dot):
    """(pAp, alpha): pAp = dot(p, Ap); alpha = gamma / pAp where run and
    pAp > 0, else 0."""
    pap = dot(p, ap)
    ok = run & (pap > 0)
    return pap, torch.where(ok, gamma / torch.where(ok, pap, 1.0), 0.0)


def xr_step(x, r, p, ap, alpha):
    """(x + alpha p, r - alpha Ap)."""
    return x + alpha * p, r - alpha * ap


def scalar_step(r, z, gamma, rr, k, run, tol2, live, maxiter, dots):
    """The step's sums and scalars, pcg's `where` freezes included: (beta,
    gamma, rr, k, run) of the next iteration, from r.z and r.r."""
    gamma_new, rr_new = dots([(r, z), (r, r)])
    beta = torch.where(run, gamma_new / torch.where(run, gamma, 1.0), 0.0)
    gamma = torch.where(run, gamma_new, gamma)
    rr = torch.where(run, rr_new, rr)
    k = k + run.to(k.dtype)
    run = (rr > tol2) & (k < maxiter) & (gamma > 0) & live
    return beta, gamma, rr, k, run


def p_step(z, p, beta):
    """z + beta p."""
    return z + beta * p


def _dot(inv_mult):
    """The kernels' dot product, sum(a * b * inv_mult), as pcg's `dot`."""
    return lambda a, b: (a * b * inv_mult).sum()


def cg_pap_ref(y, p, free, inv_mult, sf, si):
    """Plain version of cg_pap: Ap = free * y in y; pAp, alpha in sf."""
    ap = y.mul_(free)
    sf[PAP], sf[ALPHA] = alpha_step(p, ap, sf[GAMMA], si[RUN] != 0,
                                    _dot(inv_mult))
    return ap


def cg_xr_ref(x, r, p, ap, inv_mult, sf, si, maxiter, dmask=None):
    """Plain version of cg_xr: x and r in place; with dmask, cg_rz_ref of
    z = r / dmask."""
    x_new, r_new = xr_step(x, r, p, ap, sf[ALPHA])
    x.copy_(x_new)
    r.copy_(r_new)
    if dmask is not None:
        cg_rz_ref(r, r / dmask, inv_mult, sf, si, maxiter)


def cg_rz_ref(r, z, inv_mult, sf, si, maxiter):
    """Plain version of cg_rz: the step's scalars into sf and si."""
    dot = _dot(inv_mult)
    sf[BETA], sf[GAMMA], sf[RR], si[K], si[RUN] = scalar_step(
        r, z, sf[GAMMA], sf[RR], si[K], si[RUN] != 0, sf[TOL2],
        si[LIVE] != 0, maxiter, lambda prs: [dot(a, b) for a, b in prs])


def cg_p_ref(p, z, sf):
    """Plain version of cg_p: p = z + beta p, in p."""
    p.copy_(p_step(z, p, sf[BETA]))


# ------------------------------------------------------------- the steps
def cg_pap(st: CGState, y: torch.Tensor) -> torch.Tensor:
    """Ap = free * y, in place of y; pAp and alpha into st.sf. Returns Ap
    (y)."""
    st.check(y, "cg_pap")
    if not st.cuda:
        return cg_pap_ref(y, st.p, st.free, st.inv, st.sf, st.si)
    ptr = st.args.ap = y.data_ptr()
    st.launch("cg_pap", ptr)
    cg_pap.launches += 1
    return y


def cg_xr(st: CGState, ap: torch.Tensor) -> None:
    """x += alpha p, r -= alpha Ap; with st.dmask, the step's sums and
    scalars too."""
    st.check(ap, "cg_xr")
    if not st.cuda:
        return cg_xr_ref(st.x, st.r, st.p, ap, st.inv, st.sf, st.si,
                         st.maxiter, st.dmask)
    ptr = st.args.ap = ap.data_ptr()
    st.launch("cg_xr", ptr)
    cg_xr.launches += 1


def cg_rz(st: CGState, z: torch.Tensor) -> None:
    """The step's sums and scalars from an eager preconditioner's z."""
    st.check(z, "cg_rz")
    if not st.cuda:
        return cg_rz_ref(st.r, z, st.inv, st.sf, st.si, st.maxiter)
    ptr = st.args.z = z.data_ptr()
    st.launch("cg_rz", ptr)
    cg_rz.launches += 1


def cg_p(st: CGState, z: torch.Tensor | None = None) -> None:
    """p = z + beta p; z None takes z = r / st.dmask."""
    if z is None:
        if st.dmask is None:
            raise ValueError("cg_p without z needs the solve's dmask")
    else:
        st.check(z, "cg_p")
    if not st.cuda:
        return cg_p_ref(st.p, st.r / st.dmask if z is None else z, st.sf)
    ptr = st.args.z = None if z is None else z.data_ptr()
    st.launch("cg_p", ptr)
    cg_p.launches += 1


cg_pap.launches = cg_xr.launches = cg_rz.launches = cg_p.launches = 0
