"""Algorithm meta information and the option/Env system.

Python re-design of the reference's ``Meta.hpp`` / ``Env.hpp`` /
``OptionValue.hpp``: every algorithm class declares a ``meta()`` with its
type, name, docs, typed options (``submeta`` = a sub-algorithm of a given
type, ``dynamic`` = a plain value) and input restrictions. The registry
(``registry.py``) evaluates an algorithm string against these declarations
to produce a resolved ``Env`` tree from which algorithms read their options
and instantiate sub-algorithms.

Input restrictions mirror ``io/InputRestrictions.hpp``: a set of bytes that
must be escaped from the input plus an optional null-terminator requirement
(needed by suffix-array based algorithms).

A copy of ``tudocomp_tpu/meta.py``, with one addition: an ``Env`` carries
the torch device its algorithms run on (``torch_device``). The device is
chosen by the caller at run time and is never an option, so it never
enters ``id_string`` and the header reads the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class InputRestrictions:
    """Escaping requirements an algorithm imposes on its input.

    Mirrors the semantics of ``io/InputRestrictions.hpp:10-81``: the union
    operator combines restrictions of composed algorithms.
    """

    escape_bytes: tuple = ()
    null_terminate: bool = False

    def __or__(self, other: "InputRestrictions") -> "InputRestrictions":
        return InputRestrictions(
            tuple(sorted(set(self.escape_bytes) | set(other.escape_bytes))),
            self.null_terminate or other.null_terminate,
        )

    @property
    def has_restrictions(self) -> bool:
        return bool(self.escape_bytes) or self.null_terminate


@dataclass
class OptionDecl:
    name: str
    kind: str  # "dynamic" | "submeta"
    default: Any = None  # value for dynamic; algorithm string for submeta
    accepted_type: Optional[str] = None  # for submeta: required algo type
    accepts: Optional[tuple] = None  # for submeta: names the CLI registry
    #                                  enumerates (None = all); library
    #                                  instantiation is never restricted,
    #                                  like the reference's create_algo
    runtime: bool = False  # runtime-only knob (thread counts etc):
    #                        excluded from the persisted id_string so it
    #                        never becomes part of the format identity


class Meta:
    """Declares an algorithm's type, name, docs, options and restrictions."""

    def __init__(self, type: str, name: str, doc: str = ""):
        self.type = type
        self.name = name
        self.doc = doc
        self.options: list[OptionDecl] = []
        self.restrictions = InputRestrictions()

    def option_dynamic(self, name: str, default: Any = None,
                       runtime: bool = False) -> "Meta":
        self._check(name)
        self.options.append(
            OptionDecl(name, "dynamic", default, runtime=runtime)
        )
        return self

    def option_submeta(
        self, name: str, accepted_type: str, default: Optional[str] = None,
        accepts=None,
    ) -> "Meta":
        """Option taking a sub-algorithm of the given type.

        ``default`` is an algorithm string (e.g. ``"bit"``); if None the
        option is mandatory. ``accepts`` restricts which names the registry
        *enumerates* for this slot (reference ``etc/registry_config.py``
        taxonomy, e.g. consuming coders only where interleaving allows).
        """
        self._check(name)
        self.options.append(
            OptionDecl(
                name, "submeta", default, accepted_type,
                tuple(accepts) if accepts is not None else None,
            )
        )
        return self

    def needs_sentinel_terminator(self) -> "Meta":
        self.restrictions = self.restrictions | InputRestrictions(
            (), True
        )
        return self

    def escapes(self, *byte_values: int) -> "Meta":
        self.restrictions = self.restrictions | InputRestrictions(
            tuple(byte_values), False
        )
        return self

    def _check(self, name: str) -> None:
        if any(o.name == name for o in self.options):
            raise ValueError(f"option {name!r} already declared")

    def find(self, name: str) -> Optional[OptionDecl]:
        for o in self.options:
            if o.name == name:
                return o
        return None


@dataclass
class OptionValue:
    """A resolved option: either a plain value or a sub-algorithm binding."""

    value: Any = None  # str/int/bool for dynamic options
    algo_cls: Any = None  # class, for submeta options
    sub_env: Optional["Env"] = None

    @property
    def is_algorithm(self) -> bool:
        return self.algo_cls is not None

    def as_string(self) -> str:
        return str(self.value)

    def as_int(self) -> int:
        if isinstance(self.value, bool):
            return int(self.value)
        return int(self.value)

    def as_bool(self) -> bool:
        if isinstance(self.value, str):
            return self.value not in ("false", "0", "")
        return bool(self.value)


class Env:
    """Resolved option tree for one algorithm instance, and the torch
    device (``"cuda"`` unless the caller names another) that its
    algorithms run on."""

    def __init__(self, cls, options: dict, registry=None,
                 torch_device="cuda"):
        self.cls = cls
        self._options = options
        self.registry = registry
        self.torch_device = torch_device

    def option(self, name: str) -> OptionValue:
        try:
            return self._options[name]
        except KeyError:
            raise KeyError(
                f"algorithm {self.cls.__name__} has no option {name!r}"
            ) from None

    def has_option(self, name: str) -> bool:
        return name in self._options

    def env_for_option(self, name: str) -> "Env":
        ov = self.option(name)
        if not ov.is_algorithm:
            raise TypeError(f"option {name!r} is not a sub-algorithm")
        return ov.sub_env

    def instantiate(self, name: str):
        """Construct the sub-algorithm bound to option ``name``."""
        sub = self.env_for_option(name)
        return sub.cls(sub)

    def id_string(self) -> str:
        """Canonical algorithm string for this binding (all options explicit).

        Used for the self-describing output header, like the reference
        driver's id string (``tudocomp_driver.cpp:262-266``).
        """
        meta = self.cls.meta()
        parts = []
        for decl in meta.options:
            if decl.runtime:
                continue  # runtime knobs are not format identity
            ov = self._options[decl.name]
            if ov.is_algorithm:
                parts.append(f"{decl.name}={ov.sub_env.id_string()}")
            else:
                v = ov.value
                if isinstance(v, bool):
                    v = "true" if v else "false"
                parts.append(f"{decl.name}={v}")
        if parts:
            return f"{meta.name}({', '.join(parts)})"
        return meta.name


class Algorithm:
    """Base class: an algorithm holds its resolved Env.

    Subclasses implement ``meta()`` returning a :class:`Meta`.
    """

    def __init__(self, env: Env):
        self.env = env

    @classmethod
    def meta(cls) -> Meta:  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def input_restrictions(cls) -> InputRestrictions:
        return cls.meta().restrictions
