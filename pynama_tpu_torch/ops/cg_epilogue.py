"""The CG loop's state and its four steps: the work of one CG iteration
between one operator application and the next.

``solver/cg.py pcg`` runs every iteration of its one loop through these
steps, each on the vectors and scalars of one solve's ``CGState``:

- ``cg_pap(st, y)``: Ap = free * y, in place of y (the operator's output
  mask; Ap = y for a generic ``System``, whose operator masks its own
  output); pAp = dot(p, Ap); alpha = gamma / pAp where run and pAp > 0,
  else 0.
- ``cg_xr(st, Ap)``: x += alpha p, r -= alpha Ap; with a Jacobi divisor
  (``st.dmask``) also the step's sums and scalars (below) of z = r / dmask.
- ``cg_rz(st, z)``: for a preconditioner that is not pointwise, whose z
  pcg computes between cg_xr and cg_rz: gamma_new = dot(r, z), rr_new =
  dot(r, r), and the step's scalars.
- ``cg_p(st, z=None)``: p = z + beta p; with z None, z = r / dmask.

The step's scalars, ``where`` freezes included: beta = gamma_new / gamma
where run, else 0; gamma and rr take the new values only where run; k +=
run; run = rr > tol2 & k < maxiter & gamma > 0 & live. They live in the
slots GAMMA..TOL2 of ``st.sf`` and K, RUN, LIVE of ``st.si``; the host
reads ``st.si[RUN]`` only at pcg's stop checks.

The state picks how its steps run from what it can observe:

- the hand-written kernels of ``csrc/cg_epilogue.cu`` (built into the
  kernels' library by ``ops/_build.py``), where its vectors are on a CUDA
  device and its system is a ``MaskedSystem`` whose dot products need no
  reduction across ranks (``reduce`` None). Each step is one launch on the
  stream that was current when the state was made, or raises. x, r and p
  are updated in place; sf and si are device tensors (the vectors' dtype;
  int64). The kernels sum in float64 in a fixed order (block partials, then
  the last block adds them in block order): two runs give bitwise the same
  iterates, equal to the plain steps' to rounding. The host side is lean
  because the host sets the pace: the state binds the kernels' argument
  block once per solve (``_build.ArgBlock``); a step writes the address of
  the one vector it is handed and makes one ctypes call.
- otherwise the plain steps, in PyTorch, with the system's ``dot`` and
  ``dots`` (a masked system's inv_mult-weighted sums, summed across ranks
  by its ``reduce``). They replace the vectors and slots rather than write
  them: sf and si are lists of 0-d tensors, run and live bool.

A masked system's state checks its vectors and every vector a step is
handed (dtype, device, shape, contiguity) on either route.

``cg_pap.launches`` etc. count the kernel launches of this process (plain
steps do not count).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple

import torch

# the slots of CGState.sf and CGState.si (csrc/cg_epilogue.cu)
GAMMA, RR, PAP, ALPHA, BETA, TOL2 = range(6)
K, RUN, LIVE = range(3)
#: threads a block and blocks a grid at most (8 blocks an SM of an H100)
THREADS = 256
MAX_BLOCKS = 132 * 8


@dataclasses.dataclass(frozen=True)
class MaskedSystem:
    """A Dirichlet-masked system, as pcg takes it in place of A: `free` is
    1.0 on the free dofs and 0.0 on the constrained ones, `con` = 1 - free
    (formed once, here), `apply` the unmasked operator.

    The loop's operator is free * apply(v). Every loop vector is exactly
    zero on the constrained dofs (r0 = b - A0(x0) is, and Ap, z and p
    inherit the zeros, since `precond` keeps them), so the loop drops the
    input mask and the `con * v` passthrough of the full operator, which
    only the first residual takes: A0(v) = free * apply(free * v) + con *
    v. Dot products are sum(a * b * inv_mult), summed across ranks by
    `reduce` (a sharded engine's psum; None on one rank). `precond` is
    Jacobi's divisor (a tensor dmask: z = r / dmask, folded into the
    kernels) or the preconditioner as a callable."""
    apply: Callable
    free: torch.Tensor
    inv_mult: torch.Tensor
    precond: torch.Tensor | Callable
    reduce: Callable | None = None
    con: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "con", 1.0 - self.free)

    @property
    def dmask(self) -> torch.Tensor | None:
        return self.precond if isinstance(self.precond, torch.Tensor) \
            else None

    def A0(self, v):
        return self.free * self.apply(self.free * v) + self.con * v

    def M_inv(self, r):
        d = self.dmask
        return self.precond(r) if d is None else r / d

    def dot(self, a, b):
        s = (a * b * self.inv_mult).sum()
        return s if self.reduce is None else self.reduce(s)

    def dots(self, pairs):
        """[dot(a, b) for a, b in pairs], in one reduction."""
        s = [(a * b * self.inv_mult).sum() for a, b in pairs]
        return s if self.reduce is None else list(self.reduce(torch.stack(s)))


class System(NamedTuple):
    """A system given generically, as the JAX package's pcg takes it: the
    loop's operator `apply` (A), the preconditioner, the dot product, and
    A0, which only the first residual takes."""
    apply: Callable
    M_inv: Callable
    dot: Callable
    A0: Callable

    def dots(self, pairs):
        return [self.dot(a, b) for a, b in pairs]


class _Args(ctypes.Structure):
    """csrc/cg_epilogue.cu's Args, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "r", "p", "ap", "z", "free", "inv", "dmask", "sf", "si",
        "partials", "counter", "stream")] + [
        ("n", ctypes.c_int64), ("maxiter", ctypes.c_int64),
        ("blocks", ctypes.c_int), ("vec", ctypes.c_int),
        ("f64", ctypes.c_int), ("pad", ctypes.c_int)]


class CGState:
    """One CG solve: its vectors x, r, p, its scalar slots sf and si, its
    system's dot products, and, for a masked system, the loop's constants
    free, inv (inv_mult) and dmask; on the kernels' route also their
    scratch and argument block. Made from pcg's prologue values: x0, r, z
    (p starts as z), gamma, rr, tol2 (0-d tensors of the vectors' dtype),
    live, run (0-d bool) and k (0-d int64)."""

    def __init__(self, system: MaskedSystem | System, x0, r, z, gamma, rr,
                 tol2, live, run, k, maxiter: int):
        self.dtype, self.device, self.shape = r.dtype, r.device, r.shape
        self.maxiter, self.live = int(maxiter), live
        self.dot, self.dots = system.dot, system.dots
        masked = isinstance(system, MaskedSystem)
        #: a masked system on one rank: the kernels' route on a card
        #: (pcg's CGResult.epilogue "fused")
        self.fused = masked and system.reduce is None
        self.cuda = self.fused and self.device.type == "cuda"
        self.free = self.inv = self.dmask = None
        if masked:
            if self.dtype not in (torch.float32, torch.float64):
                raise TypeError(f"the CG state of a masked system takes "
                                f"float32 or float64 vectors, not "
                                f"{self.dtype}")
            if self.device.type not in ("cpu", "cuda"):
                raise ValueError(f"the CG state of a masked system runs on "
                                 f"cpu or cuda, not {self.device}")
            self.free, self.inv, self.dmask = system.free, \
                system.inv_mult, system.dmask
            vecs = {"x0": x0, "r": r, "z": z, "free": self.free,
                    "inv_mult": self.inv, "dmask": self.dmask}
            for name, v in vecs.items():
                if v is not None:
                    self.check(v, f"CGState {name}")
        zero = gamma.new_zeros(())
        if not self.cuda:
            self.x, self.r, self.p = x0, r, z
            self.sf = [gamma, rr, zero, zero, zero, tol2]
            self.si = [k, run, live]
            return
        self.x = x0.clone()
        # p is updated in place: never on r's storage (M_inv = identity)
        self.p = z.clone() if z.data_ptr() == r.data_ptr() else z
        self.r = r
        self.sf = torch.stack([gamma, rr, zero, zero, zero, tol2])
        self.si = torch.stack([k, run.to(torch.int64),
                               live.to(torch.int64)])
        self._run = self.si[RUN]
        self._bind()

    def _bind(self):
        from pynama_tpu_torch.ops._build import ArgBlock
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
        self.args = _Args(
            x=self.x.data_ptr(), r=self.r.data_ptr(), p=self.p.data_ptr(),
            free=self.free.data_ptr(), inv=self.inv.data_ptr(),
            dmask=None if self.dmask is None else self.dmask.data_ptr(),
            sf=self.sf.data_ptr(), si=self.si.data_ptr(),
            partials=self._scratch[0].data_ptr(),
            counter=self._scratch[1].data_ptr(), n=n,
            maxiter=self.maxiter, blocks=blocks, vec=int(self._vec),
            f64=int(self.dtype == torch.float64))
        self._block = ArgBlock(self.args, dev, "pn_cg_pap", "pn_cg_xr",
                               "pn_cg_rz", "pn_cg_p")

    def check(self, v, name):
        """Raise unless v is a contiguous vector of this solve's dtype,
        device and shape (a masked system's state only)."""
        if self.free is None:
            return
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

    def launch(self, symbol, ptr):
        """One kernel of the solve; ptr is the address of the one vector
        the step was handed (or None)."""
        self.args.vec = self._vec and not (ptr or 0) % 16
        self._block.launch(symbol)

    def running(self) -> bool:
        """The loop's condition, read by the host (a device sync)."""
        return bool(self._run if self.cuda else self.si[RUN])

    def result(self):
        """(x, iters, residual) as pcg returns them."""
        x = torch.where(self.live, self.x, torch.zeros_like(self.x))
        return x, self.si[K], torch.sqrt(self.sf[RR])


# ------------------------------------------------------------- the steps
def cg_pap(st: CGState, y: torch.Tensor) -> torch.Tensor:
    """Ap = free * y, in place of y (y itself for a generic system); pAp
    and alpha into st.sf. Returns Ap."""
    st.check(y, "cg_pap")
    if st.cuda:
        ptr = st.args.ap = y.data_ptr()
        st.launch("pn_cg_pap", ptr)
        cg_pap.launches += 1
        return y
    ap = y if st.free is None else y.mul_(st.free)
    sf = st.sf
    sf[PAP] = pap = st.dot(st.p, ap)
    ok = st.si[RUN] & (pap > 0)
    sf[ALPHA] = torch.where(ok, sf[GAMMA] / torch.where(ok, pap, 1.0), 0.0)
    return ap


def cg_xr(st: CGState, ap: torch.Tensor) -> None:
    """x += alpha p, r -= alpha Ap; with st.dmask, the step's sums and
    scalars too."""
    st.check(ap, "cg_xr")
    if st.cuda:
        ptr = st.args.ap = ap.data_ptr()
        st.launch("pn_cg_xr", ptr)
        cg_xr.launches += 1
        return
    alpha = st.sf[ALPHA]
    st.x, st.r = st.x + alpha * st.p, st.r - alpha * ap
    if st.dmask is not None:
        _scalars(st, st.r / st.dmask)


def cg_rz(st: CGState, z: torch.Tensor) -> None:
    """The step's sums and scalars from an eager preconditioner's z."""
    st.check(z, "cg_rz")
    if st.cuda:
        ptr = st.args.z = z.data_ptr()
        st.launch("pn_cg_rz", ptr)
        cg_rz.launches += 1
        return
    _scalars(st, z)


def cg_p(st: CGState, z: torch.Tensor | None = None) -> None:
    """p = z + beta p; z None takes z = r / st.dmask."""
    if z is None:
        if st.dmask is None:
            raise ValueError("cg_p without z needs the solve's dmask")
    else:
        st.check(z, "cg_p")
    if st.cuda:
        ptr = st.args.z = None if z is None else z.data_ptr()
        st.launch("pn_cg_p", ptr)
        cg_p.launches += 1
        return
    st.p = (st.r / st.dmask if z is None else z) + st.sf[BETA] * st.p


def _scalars(st: CGState, z):
    """The plain steps' sums and scalars of the next iteration, from r.z
    and r.r."""
    sf, si, run = st.sf, st.si, st.si[RUN]
    gamma_new, rr_new = st.dots([(st.r, z), (st.r, st.r)])
    sf[BETA] = torch.where(run, gamma_new / torch.where(run, sf[GAMMA], 1.0),
                           0.0)
    sf[GAMMA] = torch.where(run, gamma_new, sf[GAMMA])
    sf[RR] = torch.where(run, rr_new, sf[RR])
    si[K] = si[K] + run.to(si[K].dtype)
    si[RUN] = (sf[RR] > sf[TOL2]) & (si[K] < st.maxiter) & (sf[GAMMA] > 0) \
        & si[LIVE]


cg_pap.launches = cg_xr.launches = cg_rz.launches = cg_p.launches = 0
