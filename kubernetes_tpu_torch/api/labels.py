"""Label selectors: requirements (In, NotIn, Exists, DoesNotExist, and the
integer node-field operators Gt, Lt), their conjunction, and the
``LabelSelector`` (matchLabels AND matchExpressions) that affinity terms
and topology-spread constraints carry."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_VALID_OPS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT}


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: tuple = ()

    def __post_init__(self):
        if self.operator not in _VALID_OPS:
            raise ValueError(f"invalid selector operator {self.operator!r}")
        object.__setattr__(self, "values", tuple(self.values))

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        if not has:
            return False
        v = labels[self.key]
        if self.operator == IN:
            return v in self.values
        if self.operator == NOT_IN:
            return v not in self.values
        # Gt / Lt: both sides must parse as integers
        try:
            lhs = int(v)
            rhs = int(self.values[0])
        except (ValueError, IndexError):
            return False
        return lhs > rhs if self.operator == GT else lhs < rhs


@dataclass(frozen=True)
class Selector:
    """Conjunction of requirements. The empty selector matches everything;
    ``Selector.nothing()`` matches nothing (what a nil LabelSelector
    converts to)."""

    requirements: tuple = ()
    _nothing: bool = False

    def __post_init__(self):
        object.__setattr__(self, "requirements", tuple(self.requirements))

    @classmethod
    def nothing(cls) -> "Selector":
        return cls((), _nothing=True)

    @classmethod
    def from_map(cls, m: Optional[Mapping[str, str]]) -> "Selector":
        """Equality on every pair; an empty map matches everything."""
        return cls(tuple(Requirement(k, IN, (v,))
                         for k, v in sorted((m or {}).items())))

    def matches(self, labels: Optional[Mapping[str, str]]) -> bool:
        if self._nothing:
            return False
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    def is_empty(self) -> bool:
        return not self._nothing and not self.requirements


@dataclass
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions."""

    match_labels: dict = field(default_factory=dict)
    match_expressions: list = field(default_factory=list)  # [Requirement]

    def to_selector(self) -> Selector:
        reqs = [Requirement(k, IN, (v,))
                for k, v in sorted(self.match_labels.items())]
        reqs.extend(self.match_expressions)
        return Selector(tuple(reqs))

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["LabelSelector"]:
        if d is None:
            return None
        return cls(
            match_labels=dict(d.get("matchLabels") or {}),
            match_expressions=[
                Requirement(e["key"], e["operator"],
                            tuple(e.get("values") or ()))
                for e in (d.get("matchExpressions") or [])
            ],
        )


def selector_from_label_selector(ls: Optional[LabelSelector]) -> Selector:
    """A nil selector matches nothing; an empty one matches everything."""
    if ls is None:
        return Selector.nothing()
    return ls.to_selector()
