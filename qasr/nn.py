"""A small module system: the part of a neural-network library qasr's
models use, and nothing more.

A :class:`Module` is a dataclass of hyperparameters whose ``@compact``
``__call__`` declares parameters with :meth:`Module.param` and builds
submodules inline. :meth:`Module.init` runs it once to create the variables;
:meth:`Module.apply` runs it against given variables. Variables are plain
nested dicts, one per collection::

    {"params": {"qconv_0": {"kernel": ..., "bias": ...}, "Dense_0": {...}},
     "batch_stats": {...}}

A submodule's name is its ``name=`` argument, or ``<ClassName>_<n>``
numbered per class within its parent, so a parameter's tree path depends
only on the model's structure: checkpoints and the sharding rules in
``qasr.parallel.sharding`` key on these paths.

Random streams are keys passed as ``rngs={"params": key, "dropout": key}``
(a bare key to ``init`` means ``{"params": key}``). Each parameter's key is
the stream key folded with a hash of the parameter's path, so adding a layer
does not change how the others are initialized.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers

# modules whose compact method is running, innermost last (per thread)
_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _path_hash(path: tuple[str, ...]) -> int:
    return zlib.crc32("/".join(path).encode())


class _Scope:
    """The variables, random streams and mutability of one init/apply."""

    def __init__(self, variables: dict, rngs: dict, mutable, initializing: bool):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable  # True, or a set of collection names
        self.initializing = initializing
        self.rng_counts: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def node(self, col: str, path: tuple[str, ...], create: bool) -> dict | None:
        node = self.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.variables[col] = {}
        for name in path:
            child = node.get(name)
            if child is None:
                if not create:
                    return None
                child = node[name] = {}
            node = child
        return node

    def make_rng(self, stream: str, path: tuple[str, ...]) -> jax.Array:
        if stream not in self.rngs:
            raise ValueError(
                f"module {'/'.join(path) or '<top>'} needs an rng for stream "
                f"{stream!r}; pass rngs={{{stream!r}: key}}"
            )
        n = self.rng_counts.get((stream, path), 0)
        self.rng_counts[(stream, path)] = n + 1
        key = jax.random.fold_in(self.rngs[stream], _path_hash(path))
        return jax.random.fold_in(key, n)


class Variable:
    """A mutable handle on one entry of a variable collection."""

    def __init__(self, node: dict, name: str, mutable: bool, where: str):
        self._node, self._name, self._mutable, self._where = node, name, mutable, where

    @property
    def value(self):
        return self._node[self._name]

    @value.setter
    def value(self, v):
        if not self._mutable:
            raise ValueError(
                f"{self._where} is in an immutable collection; pass "
                "mutable=[<collection>] to apply"
            )
        self._node[self._name] = v


@dataclasses.dataclass(eq=False)
class Module:
    """Base class. Subclasses are made dataclasses automatically."""

    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False)(cls)

    def __post_init__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self._scope: _Scope | None = None
        self._path: tuple[str, ...] = ()
        self._child_names: set = set()
        self._autoname: dict = {}
        if parent is not None:
            # built inside a parent's compact method: bind as its child
            name = self.name
            if name is None:
                kind = type(self).__name__
                n = parent._autoname.get(kind, 0)
                parent._autoname[kind] = n + 1
                name = f"{kind}_{n}"
            if name in parent._child_names:
                raise ValueError(
                    f"duplicate submodule name {name!r} in "
                    f"{'/'.join(parent._path) or '<top>'}"
                )
            parent._child_names.add(name)
            self._scope = parent._scope
            self._path = parent._path + (name,)

    # -- variables ----------------------------------------------------------

    def _bound_scope(self) -> _Scope:
        if self._scope is None:
            raise ValueError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply, or build it inside a parent's compact method"
            )
        return self._scope

    def param(self, name: str, init_fn: Callable, *init_args) -> Any:
        """This module's parameter ``name``; created by
        ``init_fn(key, *init_args)`` during init."""
        scope = self._bound_scope()
        node = scope.node("params", self._path, create=scope.initializing)
        if node is not None and name in node:
            return node[name]
        where = "/".join(self._path + (name,))
        if not scope.initializing:
            raise KeyError(f"parameter {where!r} missing from the variables")
        if "params" not in scope.rngs:
            raise ValueError("init needs an rng for stream 'params'")
        key = jax.random.fold_in(scope.rngs["params"], _path_hash(self._path + (name,)))
        node[name] = init_fn(key, *init_args)
        return node[name]

    def variable(self, col: str, name: str, init_fn: Callable, *init_args) -> Variable:
        """A variable of collection ``col`` (e.g. ``"batch_stats"``), created
        by ``init_fn(*init_args)`` where the collection is mutable."""
        scope = self._bound_scope()
        mutable = scope.is_mutable(col)
        where = f"{col}:" + "/".join(self._path + (name,))
        node = scope.node(col, self._path, create=mutable)
        if node is None or name not in node:
            if not mutable:
                raise KeyError(f"variable {where!r} missing from the variables")
            node[name] = init_fn(*init_args)
        return Variable(node, name, mutable, where)

    def make_rng(self, stream: str) -> jax.Array:
        """A fresh key from ``stream``, distinct for every call."""
        return self._bound_scope().make_rng(stream, self._path)

    def is_initializing(self) -> bool:
        return self._bound_scope().initializing

    # -- running ------------------------------------------------------------

    def _run(self, scope: _Scope, args, kwargs):
        top = copy.copy(self)
        top._scope, top._path = scope, ()
        return top(*args, **kwargs)

    def init(self, rngs, *args, **kwargs) -> dict:
        """Create this module's variables: ``{collection: nested dict}``."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        scope = _Scope({}, dict(rngs), True, initializing=True)
        self._run(scope, args, kwargs)
        return scope.variables

    def apply(self, variables: dict, *args, rngs: dict | None = None,
              mutable: bool | Sequence[str] = False, **kwargs):
        """Run ``__call__`` with ``variables``. With ``mutable`` (a list of
        collections, or True) returns ``(out, updated collections)``."""
        mut = True if mutable is True else set(mutable or ())
        # fresh containers for the mutable collections, so the caller's
        # dicts are never written
        own = {
            col: (jax.tree.map(lambda x: x, tree) if mut is True or col in mut else tree)
            for col, tree in variables.items()
        }
        scope = _Scope(own, dict(rngs or {}), mut, initializing=False)
        out = self._run(scope, args, kwargs)
        if not mutable:
            return out
        cols = own if mut is True else {c: own[c] for c in mut if c in own}
        return out, cols


def compact(fn):
    """Mark the method that declares parameters and builds submodules."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bound_scope()
        self._child_names = set()
        self._autoname = {}
        stack = _stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


def merge_param(name: str, attr, arg):
    """The one of a module attribute and a call argument that is set."""
    if (attr is None) == (arg is None):
        raise ValueError(
            f"{name!r} must be set exactly once: as an attribute or as a "
            "call argument"
        )
    return attr if attr is not None else arg


def _cast(dtype, *xs):
    if dtype is None:
        dtype = jnp.result_type(*xs)
    return [jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis; params in float32,
    compute in ``dtype``."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features))
        x, kernel = _cast(self.dtype, x, kernel)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,))
            y = y + bias.astype(y.dtype)
        return y


class Conv(Module):
    """Real N-D convolution, channels last (``[B, *spatial, C]``)."""

    features: int
    kernel_size: Sequence[int] = (3, 3)
    strides: Sequence[int] | None = None
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init, (*ks, x.shape[-1], self.features))
        x, kernel = _cast(self.dtype, x, kernel)
        spatial = "DHW"[-len(ks):]
        dn = lax.conv_dimension_numbers(
            x.shape, kernel.shape, (f"N{spatial}C", f"{spatial}IO", f"N{spatial}C")
        )
        y = lax.conv_general_dilated(
            x, kernel, tuple(self.strides or (1,) * len(ks)), self.padding,
            dimension_numbers=dn,
        )
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,))
            y = y + bias.astype(y.dtype)
        return y


class Dropout(Module):
    """Inverted dropout; draws its mask from the ``"dropout"`` stream."""

    rate: float
    deterministic: bool = False

    @compact
    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


def max_pool(x, window_shape: Sequence[int], strides: Sequence[int] | None = None,
             padding: str = "VALID"):
    """Max pooling over the spatial dims of ``[B, *spatial, C]``."""
    dims = (1, *window_shape, 1)
    step = (1, *(strides or window_shape), 1)
    return lax.reduce_window(x, -jnp.inf, lax.max, dims, step, padding)
