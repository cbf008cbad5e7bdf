"""Generic object registries (counterpart of
``incubator_mxnet_tpu/registry.py``): MXNet's ``register``/``alias``/
``create`` function triples for one base class and nickname."""
from __future__ import annotations

import json

__all__ = ["get_register_func", "get_alias_func", "get_create_func"]

_REGISTRIES = {}


def _registry(base_class, nickname):
    return _REGISTRIES.setdefault((base_class, nickname), {})


def get_register_func(base_class, nickname):
    """``register(klass, name=None)``: file a subclass of ``base_class``
    under its lower-cased name."""
    reg = _registry(base_class, nickname)

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise TypeError("%s must subclass %s" % (klass, base_class))
        reg[(name or klass.__name__).lower()] = klass
        return klass

    register.__doc__ = "Register a %s" % nickname
    return register


def get_alias_func(base_class, nickname):
    """``alias(name)``: a decorator filing a class under another name."""
    reg = _registry(base_class, nickname)

    def alias(name):
        def do(klass):
            reg[name.lower()] = klass
            return klass
        return do

    return alias


def get_create_func(base_class, nickname):
    """``create('name', *args, **kw)``, ``create('{"name": ...}')`` (a JSON
    spec), or an instance of ``base_class`` passed through."""
    reg = _registry(base_class, nickname)

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            return args[0]
        name = args[0]
        args = args[1:]
        if name.startswith("{"):
            spec = json.loads(name)
            name = spec.pop("__name__" if "__name__" in spec else "name")
            kwargs = dict(spec, **kwargs)
        if name.lower() not in reg:
            raise ValueError("unknown %s %r (have: %s)"
                             % (nickname, name, sorted(reg)))
        return reg[name.lower()](*args, **kwargs)

    return create
