"""grape_tpu_torch — the PyTorch/CUDA port of grape_tpu.

A GRAPE quantum-optimal-control engine: piecewise-constant pulse
optimization over Schrödinger and Liouville (vectorized density-matrix)
dynamics for final-time functionals plus pulse- and state-dependent
running costs, exact per-time-step gradients (rank-1 Fréchet traces or the
Taylor recursion), semi-automatic differentiation of functionals via
``torch.autograd``, and a host-side C++ L-BFGS-B optimizer with box
constraints.  Propagation is
ExpProp, the Chebyshev series or the Krylov (Newton) series, chosen per
direction.  The heavy phases of the gate-optimization and the
robust-ensemble paths (one generator shared by all trajectories, per group
of them, or per trajectory) and the Chebyshev scans at large dimension run
in hand-written CUDA kernels for Hopper (``ops.hopper_prop``,
``ops.hopper_frechet``, ``ops.hopper_cheby``).

Public API (the reference's ``__all__``): ``optimize``,
``optimize_problem``, ``optimize_krotov`` and ``KrotovResult`` (Krotov's
method, which continues GRAPE and is continued by it), ``GrapeResult``,
``Trajectory``, ``ControlProblem``, the generator constructors
``hamiltonian`` and ``liouvillian``, the amplitudes, ``propagate`` and
``substitute``, the checkpoint functions ``save_result``, ``load_result``,
``optimize_or_load`` and ``load_optimization``, the checks, the iteration
table, ``set_default_ad_framework`` and the workspace's introspection
helpers; beside them the port's own ``compile_problem``, ``build_fg``,
``build_f``, ``compiled_problem_from_numpy`` and
``hetero_problem_from_numpy``.  Trajectories may carry their own
propagator settings (``fg_hetero``).  Modules: ``functionals``,
``shapes``, ``models``, ``testing`` (seeded fixtures), ``flops`` (the
analytic FLOP count of an evaluation), ``io`` and ``propagate``.

This package imports ``torch``, ``numpy`` and ``scipy`` (the Bessel
functions of the Chebyshev tables) only — nothing of JAX and
nothing of ``grape_tpu``, which stays in the repository as the reference.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from .amplitudes import (
    ComplexAmplitude, CustomAmplitude, LockedAmplitude, ShapedAmplitude,
)
from .controls import discretize, discretize_on_midpoints, get_controls
from .convert import compiled_problem_from_numpy, hetero_problem_from_numpy
from .fg import CompiledProblem, build_f, build_fg, compile_problem
from .generators import Generator, align_generators, hamiltonian, liouvillian
from .info_table import make_grape_print_iters
from .interfaces import check_generator, check_problem, check_state
from .io import load_optimization, load_result, optimize_or_load, save_result
from .krotov import KrotovResult, optimize_krotov
from .optimize import optimize, optimize_problem
from .propagate import propagate, substitute
from .result import GrapeResult
from .trajectory import ControlProblem, Trajectory
from .workspace import (
    GrapeWrk, gradient, norm_search, pulse_update, search_direction,
    step_width, vec_angle,
)
from .functionals import set_default_ad_framework
from . import (
    fg_hetero, flops, functionals, io, models, parallel, shapes, testing,
)

__version__ = "0.1.0"

__all__ = [
    "optimize", "optimize_problem", "optimize_krotov", "KrotovResult",
    "GrapeResult", "Trajectory",
    "ControlProblem", "hamiltonian", "liouvillian", "Generator",
    "align_generators", "ShapedAmplitude", "LockedAmplitude",
    "ComplexAmplitude", "CustomAmplitude",
    "discretize", "discretize_on_midpoints", "get_controls",
    "functionals", "models", "shapes", "testing", "flops", "io",
    "propagate", "substitute",
    "save_result", "load_result", "optimize_or_load", "load_optimization",
    "CompiledProblem", "compile_problem", "build_fg", "build_f",
    "compiled_problem_from_numpy", "hetero_problem_from_numpy",
    "fg_hetero", "check_state", "check_generator", "check_problem",
    "make_grape_print_iters", "set_default_ad_framework",
    "GrapeWrk", "step_width", "search_direction", "norm_search", "gradient",
    "pulse_update", "vec_angle",
]
