"""Multi-family panels over ONE key intake (counterpart of
``torcheval_tpu/table/panel.py``).

A serving deployment rarely watches one number per key — it watches a
PANEL: CTR + NE + calibration (+ a second CTR lane for conversions, a
drift gauge...). Building N :class:`MetricTable` instances pays the key
intake N times per batch — N hash passes, N slot resolutions, N route
masks, N outbox appends — for identical keys. :class:`TablePanel` pays
it once:

- the member families compose into ONE synthetic
  :class:`~torcheval_tpu_torch.table.TableFamily` whose fields are the
  members' fields under an ``<alias>__`` prefix, so every slot/outbox/
  merge/evict/snapshot mechanism of :class:`MetricTable` applies
  unchanged — the outbox value lane simply carries
  ``sum(member fields)`` columns per entry;
- the composite row kernel (cached per member-kernel tuple, the
  ``_INGEST_KERNEL_CACHE`` identity discipline) splits the concatenated
  per-row arguments and concatenates the members' payload columns, so
  hash, slot resolution, routing and the outbox append run ONCE per batch
  and family accumulators are extra columns of the same segment sum on
  the same resolved slots;
- under ``config.shape_bucketing()`` the masked twin applies to the one
  ingest, so a warmed panel on CUDA replays one CUDA graph per bucket
  across ragged traffic (and across admission rung changes when armed).

Members may mix cumulative and WINDOWED families (ROADMAP 4b): the panel
runs one shared window clock — a single per-key epoch cursor advanced at
each drain when ANY windowed member's traffic column is nonzero — and
every windowed member must agree on one window size. Only the windowed
members' columns get epoch rings; cumulative members accumulate forever,
exactly as standalone. Ingest feeds every member per batch::

    panel = TablePanel(["ctr", ("conversions", "ctr"), "ne"], device="cpu")
    panel.ingest(keys, ctr=(clicks,), conversions=(conv,),
                 ne=(preds, targets))
    panel.compute().values["ctr"]          # per-key CTR array

Everything a single-family table does — hash partitioning, drains,
admission control, elastic resume, Prometheus scrape — works on a panel
unchanged, because a panel IS a ``MetricTable`` with a composed family.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.shardspec import ShardContext
from torcheval_tpu_torch.table._admission import AdmissionController
from torcheval_tpu_torch.table._families import (
    TableFamily,
    resolve_family,
    traffic_fields,
    windowed_fields,
)
from torcheval_tpu_torch.table.table import MetricTable, TableValues, _as_numpy

__all__ = ["PanelValues", "TablePanel"]


class PanelValues(NamedTuple):
    """One panel ``compute()`` snapshot: per-key value arrays PER MEMBER
    alias, over the shared live slots (``keys``/``reprs`` are shared —
    one intake means one key set)."""

    keys: np.ndarray
    values: Dict[str, torch.Tensor]
    reprs: Dict[int, Any]

    def as_dict(self) -> Dict[str, Dict[Any, float]]:
        """``{alias: {original_key_or_hash: float}}`` (host readback)."""
        out: Dict[str, Dict[Any, float]] = {}
        for alias, vals in self.values.items():
            arr = _as_numpy(vals)
            out[alias] = {
                self.reprs.get(int(k), int(k)): float(v)
                for k, v in zip(self.keys, arr)
            }
        return out


class _MemberView:
    """The ``table`` argument member ``prepare`` functions see: member
    attrs (``k``, ``from_logits``) and the member family resolve here,
    everything else (``_input``, device placement, bucketing flags)
    delegates to the panel."""

    __slots__ = ("_panel", "_fam", "_attrs")

    def __init__(self, panel: "TablePanel", fam: TableFamily, attrs: Dict):
        object.__setattr__(self, "_panel", panel)
        object.__setattr__(self, "_fam", fam)
        object.__setattr__(self, "_attrs", attrs)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") and name.endswith("__"):
            # copy/pickle protocol probes (__deepcopy__, __getstate__...)
            # must see a plain AttributeError — delegating them to the
            # panel breaks clone_metric's deepcopy reconstruction
            raise AttributeError(name)
        attrs = object.__getattribute__(self, "_attrs")
        if name in attrs:
            return attrs[name]
        if name == "family":
            return object.__getattribute__(self, "_fam")
        return getattr(object.__getattribute__(self, "_panel"), name)


# one stable composite kernel per member row-kernel tuple: _fuse keys its
# CUDA graphs on the kernel object (_INGEST_KERNEL_CACHE discipline), so
# two panels over the same families share one kernel
_PANEL_KERNEL_CACHE: Dict[Tuple, Any] = {}  # tev: disable=unguarded-state -- idempotent memo keyed by the member kernels: racers build identical composites and one insert wins


def _panel_row_kernel(row_kernels: Tuple[Any, ...]):
    fn = _PANEL_KERNEL_CACHE.get(row_kernels)
    if fn is not None:
        return fn

    def kernel(*rest):
        # trailing config element: ((n_dynamic, member_cfg), ...) —
        # hashable, appended by the ingest transform like any family cfg
        dyn, specs = rest[:-1], rest[-1]
        out: List[Any] = []
        i = 0
        for rk, (n_dyn, cfg) in zip(row_kernels, specs):
            payload = rk(*(tuple(dyn[i : i + n_dyn]) + tuple(cfg)))
            i += n_dyn
            if not isinstance(payload, tuple):
                payload = (payload,)
            out.extend(payload)
        return tuple(out)

    _PANEL_KERNEL_CACHE[row_kernels] = kernel
    return kernel


def _panel_prepare(panel: "TablePanel", *args: Any, **kwargs: Any):
    """Composite prepare: one per-alias argument bundle per member,
    concatenated into the fused plan's dynamic tuple. The config tuple
    records each member's dynamic arity + config so the cached composite
    kernel can split them statically."""
    if args:
        raise TypeError(
            "TablePanel.ingest takes per-member keyword arguments after "
            "the keys: panel.ingest(keys, ctr=(clicks, weights), ...)"
        )
    members = panel._members
    want = {alias for alias, _, _ in members}
    got = set(kwargs)
    if want != got:
        raise TypeError(
            f"TablePanel.ingest: every member needs a batch — missing "
            f"{sorted(want - got)}, unexpected {sorted(got - want)}"
        )
    dynamic: List[Any] = []
    specs: List[Tuple[int, Tuple]] = []
    for alias, fam, view in members:
        batch = kwargs[alias]
        if isinstance(batch, dict):
            d, c = fam.prepare(view, **batch)
        else:
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            d, c = fam.prepare(view, *batch)
        dynamic.extend(d)
        specs.append((len(d), tuple(c)))
    return tuple(dynamic), (tuple(specs),)


def _parse_members(families: Any) -> List[Tuple[str, Any, Dict[str, Any]]]:
    """Normalize the ``families`` argument to ``[(alias, spec, kwargs)]``.

    Accepted member forms: ``"ctr"`` / a :class:`TableFamily` (alias =
    family name), ``(alias, spec)``, ``(alias, spec, kwargs_dict)``, or
    a dict ``{alias: spec_or_(spec, kwargs)}``."""
    items: List[Tuple[str, Any, Dict[str, Any]]] = []
    if isinstance(families, dict):
        for alias, spec in families.items():
            if isinstance(spec, tuple) and len(spec) == 2 and isinstance(
                spec[1], dict
            ):
                items.append((str(alias), spec[0], dict(spec[1])))
            else:
                items.append((str(alias), spec, {}))
        return items
    for member in families:
        if isinstance(member, (str, TableFamily)):
            alias = member if isinstance(member, str) else member.name
            items.append((str(alias), member, {}))
        elif isinstance(member, tuple) and len(member) in (2, 3):
            kwargs = dict(member[2]) if len(member) == 3 else {}
            items.append((str(member[0]), member[1], kwargs))
        else:
            raise TypeError(
                "TablePanel members must be a family name/TableFamily, "
                "(alias, family) or (alias, family, kwargs), got "
                f"{member!r}"
            )
    return items


class TablePanel(MetricTable):
    """N family columns over ONE fused key intake (module docstring).

    Args:
        families: the member list — e.g. ``["ctr", ("conversions",
            "ctr"), ("cal", "weighted_calibration"), "ne"]``. Aliases
            must be unique; windowed members must share one window size.
        shard / ttl / max_keys / repr_limit / admission / device: as
            :class:`MetricTable` (the panel IS a table; one admission
            controller gates the one shared intake).

    Examples::

        >>> import numpy as np
        >>> from torcheval_tpu_torch.table import TablePanel
        >>> p = TablePanel(["ctr", "ne"], device="cpu")
        >>> _ = p.ingest(
        ...     [7, 9],
        ...     ctr=(np.array([1.0, 0.0]),),
        ...     ne=(np.array([0.9, 0.2]), np.array([1.0, 0.0])),
        ... )
        >>> sorted(p.compute().as_dict()["ctr"].items())
        [(7, 1.0), (9, 0.0)]
    """

    def __init__(
        self,
        families: Any = ("ctr",),
        *,
        shard: Optional[ShardContext] = None,
        ttl: Optional[int] = None,
        max_keys: Optional[int] = None,
        repr_limit: int = 4096,
        admission: Optional[AdmissionController] = None,
        staleness_epochs: Optional[int] = None,
        device: Optional[Any] = None,
    ) -> None:
        parsed = _parse_members(families)
        if not parsed:
            raise ValueError("TablePanel needs at least one member family")
        members: List[Tuple[str, TableFamily, _MemberView]] = []
        seen: Dict[str, bool] = {}
        attrs_by_alias: Dict[str, Dict[str, Any]] = {}
        for alias, spec, kwargs in parsed:
            if not alias or not alias.replace("_", "a").isalnum():
                raise ValueError(
                    f"panel member alias {alias!r} must be a non-empty "
                    "alphanumeric/underscore name (it prefixes state "
                    "names and scrape labels)"
                )
            if alias in seen:
                raise ValueError(
                    f"duplicate panel member alias {alias!r}: give "
                    "repeated families explicit aliases, e.g. "
                    "('conversions', 'ctr')"
                )
            seen[alias] = True
            fam, attrs = resolve_family(spec, **kwargs)
            members.append((alias, fam, attrs))  # view built post-init
            attrs_by_alias[alias] = attrs
        # panel-wide window clock (ROADMAP 4b): windowed members join the
        # fused intake as long as they agree on ONE window size — their
        # prefixed fields become the composite's window_fields, their
        # per-member traffic columns OR into one shared epoch-advance
        # decision, and the single MetricTable ring commit serves all of
        # them (cumulative members' columns keep accumulating untouched)
        window_sizes = sorted({fam.window for _, fam, _ in members if fam.window})
        if len(window_sizes) > 1:
            raise ValueError(
                "panel windowed members must share one window size (the "
                "panel has a single epoch-advance clock), got windows "
                f"{window_sizes}"
            )
        window = window_sizes[0] if window_sizes else 0
        window_fields = tuple(
            f"{alias}__{f}"
            for alias, fam, _ in members
            for f in windowed_fields(fam)
        )
        trf_fields = tuple(
            f"{alias}__{f}"
            for alias, fam, _ in members
            for f in traffic_fields(fam)
        )
        fields = tuple(
            f"{alias}__{f}" for alias, fam, _ in members for f in fam.fields
        )
        member_fams = tuple((alias, fam) for alias, fam, _ in members)

        def _compute(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return {
                alias: fam.compute(
                    {f: cols[f"{alias}__{f}"] for f in fam.fields}
                )
                for alias, fam in member_fams
            }

        composite = TableFamily(
            name="panel:" + "+".join(alias for alias, _, _ in members),
            fields=fields,
            prepare=_panel_prepare,
            row_kernel=_panel_row_kernel(
                tuple(fam.row_kernel for _, fam, _ in members)
            ),
            compute=_compute,
            window=window,
            window_fields=window_fields,
            traffic_fields=trf_fields,
        )
        super().__init__(
            composite,
            shard=shard,
            ttl=ttl,
            max_keys=max_keys,
            repr_limit=repr_limit,
            admission=admission,
            staleness_epochs=staleness_epochs,
            device=device,
        )
        self._members = [
            (alias, fam, _MemberView(self, fam, attrs_by_alias[alias]))
            for alias, fam, _ in members
        ]

    @property
    def aliases(self) -> Tuple[str, ...]:
        """Member aliases, in panel order."""
        return tuple(alias for alias, _, _ in self._members)

    def compute(self) -> PanelValues:  # type: ignore[override]
        """Per-key values per member alias over the shared live slots
        (carrier/merged coverage semantics as :meth:`MetricTable.compute`;
        armed panels stamp ``admission_provenance`` the same way)."""
        tv: TableValues = super().compute()
        return PanelValues(keys=tv.keys, values=tv.values, reprs=tv.reprs)

    def scrape_values(
        self, limit: Optional[int] = None
    ) -> Dict[str, float]:
        """Per-member, per-segment gauges for the Prometheus exporter:
        ``value_<alias>_<sanitized key>``. ``limit`` caps KEYS per
        member (bounded cardinality per scrape, as the base table)."""
        import re

        pv = self.compute()
        out: Dict[str, float] = {}
        n = len(pv.keys) if limit is None else min(limit, len(pv.keys))
        for alias, vals in pv.values.items():
            arr = _as_numpy(vals)
            for k, v in zip(pv.keys[:n], arr[:n]):
                label = pv.reprs.get(int(k), f"{int(k):016x}")
                label = re.sub(r"[^a-zA-Z0-9_]", "_", str(label))
                name = f"value_{alias}_{label}"
                if name in out:
                    name = f"value_{alias}_{label}_{int(k) & 0xFFFFFFFF:08x}"
                out[name] = float(v)
        return out