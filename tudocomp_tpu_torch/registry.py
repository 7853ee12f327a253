"""Algorithm registry: name -> class, algorithm-string evaluation,
configuration enumeration.

Python re-design of the reference's ``Registry.hpp`` + ``eval::cl_eval``:
an algorithm string is parsed (``algostr.py``) and unified against the
``Meta`` declarations of the registered classes — positional args bind in
declaration order, keyword args by name, missing options fall back to
declared defaults (which may themselves be algorithm strings). The result
is a resolved ``Env`` tree ready for instantiation.

``all_configurations`` enumerates every static combination of registered
sub-algorithms for the matrix test (reference
``Registry::all_algorithms_with_static``, recursion-depth capped per type).

A copy of ``tudocomp_tpu/registry.py`` for the port, with one change:
evaluation (and ``create_algo``) takes the torch device
(``torch_device``, ``"cuda"`` by default) and hands it to every ``Env``
of the tree.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Type

from tudocomp_tpu_torch.algostr import Node, parse
from tudocomp_tpu_torch.meta import (
    Algorithm, Env, InputRestrictions, OptionValue,
)


class Registry:
    def __init__(self):
        self._by_type: Dict[str, Dict[str, Type[Algorithm]]] = {}

    # -- registration -------------------------------------------------------

    def register(self, cls: Type[Algorithm]) -> Type[Algorithm]:
        m = cls.meta()
        bucket = self._by_type.setdefault(m.type, {})
        if m.name in bucket and bucket[m.name] is not cls:
            raise ValueError(f"{m.type}:{m.name} already registered")
        bucket[m.name] = cls
        return cls

    def lookup(self, type: str, name: str) -> Type[Algorithm]:
        try:
            return self._by_type[type][name]
        except KeyError:
            known = ", ".join(sorted(self._by_type.get(type, {})))
            raise KeyError(
                f"no {type} named {name!r} (known: {known})"
            ) from None

    def names(self, type: str) -> List[str]:
        return sorted(self._by_type.get(type, {}))

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, node_or_str, type: str = "compressor",
                 torch_device="cuda") -> Env:
        """Evaluate an algorithm string / AST against declarations -> Env
        whose algorithms run on ``torch_device``."""
        node = parse(node_or_str) if isinstance(node_or_str, str) else node_or_str
        return self._eval_node(node, type, torch_device)

    def _eval_node(self, node: Node, type: str, torch_device) -> Env:
        cls = self.lookup(type, node.name)
        meta = cls.meta()
        bound: Dict[str, object] = {}
        decls = meta.options
        pos_i = 0
        for key, val in node.args:
            if key is None:
                if pos_i >= len(decls):
                    raise ValueError(
                        f"too many positional args for {node.name}"
                    )
                decl = decls[pos_i]
                pos_i += 1
            else:
                decl = meta.find(key)
                if decl is None:
                    raise ValueError(
                        f"{node.name} has no option {key!r}"
                    )
            if decl.name in bound:
                raise ValueError(
                    f"option {decl.name!r} bound twice for {node.name}"
                )
            bound[decl.name] = val
        options: Dict[str, OptionValue] = {}
        for decl in decls:
            if decl.name in bound:
                val = bound[decl.name]
            elif decl.default is not None:
                val = decl.default
            elif decl.kind == "dynamic":
                raise ValueError(
                    f"{node.name}: option {decl.name!r} has no value"
                )
            else:
                raise ValueError(
                    f"{node.name}: sub-algorithm {decl.name!r} has no value"
                )
            if decl.kind == "submeta":
                if isinstance(val, str):
                    val = parse(val)
                elif not isinstance(val, Node):
                    raise ValueError(
                        f"{node.name}: option {decl.name!r} needs an "
                        f"algorithm of type {decl.accepted_type!r}"
                    )
                # the reference's static registry simply does not contain
                # combinations outside the declared sub-lists (e.g. the
                # consuming arithmetic coder inside lcpcomp,
                # registry_config.py:138-142); reject them here instead of
                # failing later with a misaligned stream
                if decl.accepts is not None and val.name not in decl.accepts:
                    raise ValueError(
                        f"{node.name}: {decl.accepted_type} "
                        f"{val.name!r} is not accepted for option "
                        f"{decl.name!r} (accepted: "
                        f"{', '.join(decl.accepts)})"
                    )
                sub_env = self._eval_node(val, decl.accepted_type,
                                          torch_device)
                options[decl.name] = OptionValue(
                    algo_cls=sub_env.cls, sub_env=sub_env
                )
            else:
                if isinstance(val, Node):
                    if val.args:
                        raise ValueError(
                            f"{node.name}: option {decl.name!r} is not a "
                            "sub-algorithm"
                        )
                    val = val.name  # bare identifier used as string value
                options[decl.name] = OptionValue(value=val)
        return Env(cls, options, registry=self, torch_device=torch_device)

    def instantiate(self, algostring: str, type: str = "compressor",
                    torch_device="cuda"):
        env = self.evaluate(algostring, type, torch_device)
        return env.cls(env)

    def restrictions_of(self, env: Env) -> InputRestrictions:
        """Combined input restrictions of an Env tree (| over sub-algos).

        Algorithms that apply their sub-algorithms' restrictions themselves
        (the chain compressor) set ``manages_sub_restrictions`` and stop the
        upward merge.
        """
        r = env.cls.meta().restrictions
        if getattr(env.cls, "manages_sub_restrictions", False):
            return r
        for ov in env._options.values():
            if ov.is_algorithm:
                r = r | self.restrictions_of(ov.sub_env)
        return r

    # -- enumeration (matrix test support) -----------------------------------

    def all_configurations(
        self, type: str = "compressor", max_depth_per_type: int = 2
    ) -> Iterator[str]:
        """Yield an algorithm string for every registered static combination.

        Sub-algorithm options range over all registered algorithms of the
        accepted type; dynamic options keep their defaults. Recursion per
        algorithm type is capped (reference ``Registry.hpp:54-63`` caps at 2)
        so self-referential types terminate.
        """
        for name in self.names(type):
            yield from self._enum_cls(type, name, {type: 1}, max_depth_per_type)

    def _enum_cls(self, type, name, depth, cap) -> Iterator[str]:
        cls = self.lookup(type, name)
        meta = cls.meta()
        sub_opts = [o for o in meta.options if o.kind == "submeta"]
        if not sub_opts:
            yield name
            return
        choice_lists: List[List[str]] = []
        for o in sub_opts:
            t = o.accepted_type
            d = dict(depth)
            d[t] = d.get(t, 0) + 1
            if d[t] > cap:
                if o.default is None:
                    return  # cannot instantiate within depth cap
                choice_lists.append([o.default])
                continue
            subs = []
            for sub_name in self.names(t):
                if o.accepts is not None and sub_name not in o.accepts:
                    continue
                subs.extend(self._enum_cls(t, sub_name, d, cap))
            if not subs:
                if o.default is None:
                    return
                subs = [o.default]
            choice_lists.append(subs)
        for combo in itertools.product(*choice_lists):
            args = ", ".join(
                f"{o.name}={c}" for o, c in zip(sub_opts, combo)
            )
            yield f"{name}({args})"

    def doc_listing(self) -> str:
        """Human-readable listing of all registered algorithms (CLI --list)."""
        lines = []
        for type in sorted(self._by_type):
            lines.append(f"[{type}]")
            for name in self.names(type):
                meta = self.lookup(type, name).meta()
                opts = []
                for o in meta.options:
                    if o.kind == "submeta":
                        opts.append(f"{o.name}: {o.accepted_type}")
                    else:
                        opts.append(o.name)
                sig = f"({', '.join(opts)})" if opts else ""
                doc = f" — {meta.doc}" if meta.doc else ""
                lines.append(f"  {name}{sig}{doc}")
        return "\n".join(lines)


# The global registry, populated by tudocomp_tpu_torch.compressors.
REGISTRY = Registry()



def create_algo(cls: Type[Algorithm], options: str = "", registry=None,
                torch_device="cuda"):
    """Instantiate an algorithm class directly with an option string.

    Equivalent to the reference's ``create_algo<T>(options)``
    (``CreateAlgorithm.hpp:117-133``) — the test/library entry point.
    Sub-algorithm defaults resolve against ``registry`` (the global one by
    default); ``cls`` itself is made resolvable in a local copy if needed.
    """
    m = cls.meta()
    reg = registry if registry is not None else REGISTRY
    if reg._by_type.get(m.type, {}).get(m.name) is not cls:
        copy = Registry()
        copy._by_type = {t: dict(b) for t, b in reg._by_type.items()}
        copy._by_type.setdefault(m.type, {})[m.name] = cls
        reg = copy
    text = f"{m.name}({options})" if options else m.name
    return reg.instantiate(text, m.type, torch_device)
