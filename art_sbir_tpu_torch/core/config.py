"""String-keyed registries.

Counterpart of ``art_sbir_tpu/core/config.py::Registry``: every
string-keyed factory (the dataset names of ``data.get_datasets``) goes
through an explicit, typo-checked table instead of the reference's
``eval()`` on user strings (reference `data_preparation.py:735-739`).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """An explicit, typo-checked string->factory mapping."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, value: T | None = None) -> Callable[[T], T] | T:
        if value is not None:
            self._check_new(name)
            self._entries[name] = value
            return value

        def deco(v: T) -> T:
            self._check_new(name)
            self._entries[name] = v
            return v

        return deco

    def _check_new(self, name: str) -> None:
        if name in self._entries:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")

    def __getitem__(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def names(self) -> list[str]:
        return sorted(self._entries)
