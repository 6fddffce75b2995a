"""Host↔device boundary helper: ``cjit``.

``cjit`` wraps a pure-JAX function in ``jax.jit`` so that

* every array argument crosses the boundary as float32/int (complex leaves
  are split into (re, im) pairs outside and rejoined inside the jit),
* every complex output is split inside the jit and rejoined on the host as
  a NUMPY array (results land host-side — the drivers that call these are
  host orchestration anyway),
* all non-array arguments (ints, floats, strings, None, dataclasses) are
  STATIC — part of the compilation cache key — so shape arithmetic and
  host-side design functions keep working unchanged,
* calls made while already inside a trace pass straight through.

Whether the complex split and the host copy of every output still pay for
themselves on a GPU is not measured yet (ROADMAP Q1 item 7).
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["cjit"]


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, jax.Array, np.generic))


def _has_tracer(tree) -> bool:
    return any(isinstance(l, jax.core.Tracer) for l in jax.tree.leaves(tree))


def cjit(fn=None, *, static_argnames=()):
    """jit with a complex-safe host boundary (see module docstring).

    ``static_argnames`` is accepted for symmetry but redundant: every
    non-array argument is already static.
    """
    if fn is None:
        return functools.partial(cjit, static_argnames=static_argnames)

    sig = inspect.signature(fn)
    compiled = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _has_tracer((args, kwargs)):
            return fn(*args, **kwargs)
        ba = sig.bind(*args, **kwargs)
        ba.apply_defaults()
        names = tuple(ba.arguments.keys())
        leaves_per_arg = {}
        statics = {}
        dyn = []          # flat dynamic (real) arrays, in order
        spec = []         # per argument: ('static',) or (treedef, marks)
        for name in names:
            v = ba.arguments[name]
            arr_leaves, treedef = jax.tree.flatten(v)
            if arr_leaves and all(_is_array(l) for l in arr_leaves):
                marks = []
                for l in arr_leaves:
                    if np.iscomplexobj(l):
                        la = np.asarray(l)
                        # NOT ascontiguousarray: it promotes 0-d to 1-d
                        dyn.append(np.asarray(la.real, order="C"))
                        dyn.append(np.asarray(la.imag, order="C"))
                        marks.append("c")
                    else:
                        dyn.append(np.asarray(l))
                        marks.append("r")
                spec.append((name, treedef, tuple(marks)))
            else:
                statics[name] = v
                spec.append((name, None, None))
        key = (
            tuple((n, td, m) for n, td, m in spec),
            tuple(sorted((k, _static_key(v)) for k, v in statics.items())),
            tuple((tuple(d.shape), str(d.dtype)) for d in dyn),
        )
        if key not in compiled:
            spec_c = list(spec)
            statics_c = dict(statics)
            meta = {}   # filled at trace time: output treedef + complex marks

            @jax.jit
            def inner(flat):
                it = iter(flat)
                call_kwargs = {}
                for name, treedef, marks in spec_c:
                    if treedef is None:
                        call_kwargs[name] = statics_c[name]
                        continue
                    leaves = []
                    for m in marks:
                        if m == "c":
                            re = next(it)
                            im = next(it)
                            leaves.append(re + 1j * im)
                        else:
                            leaves.append(next(it))
                    call_kwargs[name] = jax.tree.unflatten(treedef, leaves)
                out = fn(**call_kwargs)
                leaves, out_treedef = jax.tree.flatten(out)
                cmarks = tuple(bool(jnp.iscomplexobj(l)) for l in leaves)
                meta["treedef"] = out_treedef
                meta["complex"] = cmarks
                flat_out = []
                for l, is_c in zip(leaves, cmarks):
                    if is_c:
                        flat_out.append(l.real)
                        flat_out.append(l.imag)
                    else:
                        flat_out.append(l)
                return tuple(flat_out)

            compiled[key] = (inner, meta)
        inner, meta = compiled[key]
        flat_out = inner(dyn)
        it = iter(flat_out)
        leaves = []
        for is_c in meta["complex"]:
            if is_c:
                re = np.asarray(next(it))
                im = np.asarray(next(it))
                leaves.append((re + 1j * im).astype(np.complex64))
            else:
                leaves.append(np.asarray(next(it)))
        return jax.tree.unflatten(meta["treedef"], leaves)

    return wrapper


def _static_key(v):
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def sanitize_iq(iq) -> "np.ndarray":
    """Blank non-finite samples to 0 (receiver input hygiene: a NaN burst
    would otherwise poison cumulative-sum sync metrics for the whole buffer
    and can steer FEC onto the trivial all-zero codeword)."""
    import numpy as np
    a = np.asarray(iq, dtype=np.complex64)
    bad = ~np.isfinite(a.real) | ~np.isfinite(a.imag)
    if bad.any():
        a = a.copy()
        a[bad] = 0
    return a
