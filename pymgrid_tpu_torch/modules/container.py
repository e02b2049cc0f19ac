"""Two-axis module taxonomy: storage, lookup and aggregation views.

Behavioral mirror of the reference's module container (see
``src/pymgrid/modules/module_container.py``): every module lands in one of
nine cells on the grid ``(fixed | flex | controllable) x (sources | sinks |
source_and_sinks)``; mid-level views are reachable along either axis
(``container.fixed.sources`` == ``container.sources.fixed``); modules are
addressable by name, with auto-naming from ``module_type[0]``.

Iteration order is load-bearing for simulation semantics: ``to_dict`` /
``iterdict`` walk cells fixed -> flex -> controllable, each
sources -> sinks -> source_and_sinks, insertion order within a cell.  The
compiled engine derives its static summation order from this same walk.
"""
import json
from collections import UserDict, UserList

from pymgrid_tpu_torch.modules.base import BaseMicrogridModule

__all__ = ["Container", "ModuleContainer", "ModuleList", "get_subcontainers"]

ROLES = ("fixed", "flex", "controllable")
FLOWS = ("sources", "sinks", "source_and_sinks")


class ModuleList(UserList):
    """A list of same-named modules, unwrappable when it holds exactly one."""

    def item(self):
        if len(self) != 1:
            raise ValueError("Can only convert a ModuleList of length one to a scalar")
        return self[0]

    def to_list(self):
        return self


class Container(UserDict):
    """Mapping of names to :class:`ModuleList`s (or to nested Containers),
    with attribute-style access and flattening helpers."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dir_additions = self._collect_dir_additions()

    def _collect_dir_additions(self):
        names = set(self.keys())
        for child in self.values():
            child_additions = getattr(child, "dir_additions", None)
            if child_additions:
                names |= child_additions
        return names

    @property
    def containers(self):
        return self

    def to_list(self):
        flat = []
        for child in self.containers.values():
            flat += child.to_list()
        return flat

    def to_dict(self):
        out = {}
        for key, child in self.containers.items():
            if isinstance(child, ModuleList):
                # Bottom-level container: already name -> module list.  (The
                # reference crashes on this path, module_container.py:52;
                # documented fixed deviation.)
                out[key] = child
            else:
                out.update(child)
        return out

    def to_tuples(self):
        return [
            (name, module)
            for name, module_list in self.iterdict()
            for module in module_list
        ]

    def iterlist(self):
        yield from self.to_list()

    def iterdict(self):
        yield from self.to_dict().items()

    def names(self):
        return list(self.to_dict().keys())

    def get_attrs(self, *attrs, unique=False, as_pandas=True):
        """Gather named attributes across all modules.

        Missing attributes appear as ``NotImplemented`` (matching the
        reference semantics, ``module_container.py:97-195``).
        """
        import pandas as pd

        if not attrs:
            raise ValueError("Missing attrs to get.")

        gathered = {}
        for child in self.containers.values():
            for name, module_list in child.items():
                gathered[name] = [
                    {a: getattr(m, a, NotImplemented) for a in attrs}
                    for m in module_list
                ]

        if not (unique or as_pandas):
            return gathered

        frame = pd.DataFrame(
            {
                (name, idx): row
                for name, rows in gathered.items()
                for idx, row in enumerate(rows)
            }
        ).T

        empty_attrs, single_valued, multi_valued = [], {}, []
        for attr, col in frame.items():
            defined = col[col != NotImplemented].drop_duplicates().values
            if len(defined) == 1:
                single_valued[attr] = defined.item()
            elif len(defined) == 0:
                empty_attrs.append(attr)
            else:
                multi_valued.append(attr)

        if empty_attrs:
            raise AttributeError(f"No values found for key(s) {empty_attrs}")

        if unique:
            if multi_valued:
                raise ValueError(
                    f"Attribute(s) {multi_valued} have non-unique values, cannot "
                    f"return single unique value."
                )
            if not as_pandas:
                return single_valued
            return pd.Series(
                single_valued, dtype=None if len(single_valued) else float
            )

        return frame if as_pandas else gathered

    def __getitem__(self, item):
        if item in ("data", "module_dict"):
            raise KeyError(item)
        if item in self.data:
            return self.data[item]
        flattened = self.to_dict()
        if item in flattened:
            return flattened[item]
        raise KeyError(item)

    def __getattr__(self, item):
        if item == "data" or item.startswith("__") or item not in dir(self):
            raise AttributeError(item)
        try:
            return self[item]
        except KeyError:
            raise AttributeError(item)

    def __contains__(self, item):
        return item in self.data.keys() or item in self.dir_additions

    def __len__(self):
        return sum(len(child) for child in self.containers.values())

    def __dir__(self):
        return sorted(set(super().__dir__()) | self.dir_additions)

    def __repr__(self):
        try:
            return json.dumps(self.to_dict(), indent=2, default=str)
        except TypeError:
            return super().__repr__()


def _normalized_entries(modules):
    """Yield ``(explicit_name_or_None, module)`` for every entry.

    Accepts bare modules, ``(name, module)`` pairs, and (for convenience —
    beyond the reference) lists/ModuleLists of modules.
    """
    for entry in modules:
        if isinstance(entry, BaseMicrogridModule):
            yield None, entry
        elif isinstance(entry, (list, tuple, ModuleList)):
            if (
                len(entry) == 2
                and isinstance(entry[0], str)
                and isinstance(entry[1], BaseMicrogridModule)
            ):
                yield entry
            else:
                for module in entry:
                    yield None, module
        else:
            yield None, entry


def _classify(module):
    """Return ``(auto_name, role, flow)`` for a module."""
    module_type = module.__class__.module_type
    try:
        auto_name, role = module_type
    except TypeError:
        raise NotImplementedError(
            f"Must define the class attribute module_type for class "
            f"{module.__class__.__name__}"
        )

    if not isinstance(module, BaseMicrogridModule):
        raise AssertionError("Module must inherit from BaseMicrogridModule.")
    if not (module.is_sink or module.is_source):
        raise AssertionError("Module must be sink or source (or both).")

    if module.is_source and module.is_sink:
        flow = "source_and_sinks"
    elif module.is_source:
        flow = "sources"
    else:
        flow = "sinks"

    if role not in ROLES:
        raise TypeError(
            f"Cannot parse fixed_flex_controllable from module type {module_type}"
        )
    return auto_name, role, flow


def get_subcontainers(modules):
    """Place modules into the nine taxonomy cells and assign their names.

    Returns ``{(role, flow): Container}`` over all nine cells.  Each module
    receives ``module.name = (name, index)``; reusing a name across two
    different cells raises.  Mirrors reference ``module_container.py:355-413``.
    """
    cells = {(role, flow): {} for role in ROLES for flow in FLOWS}
    placements = {}

    for explicit_name, module in _normalized_entries(modules):
        auto_name, role, flow = _classify(module)
        name = explicit_name if explicit_name is not None else auto_name

        prior = placements.get(name)
        if prior is not None and prior != (role, flow):
            raise NameError(
                f"Attempted to add module {name} of type {(role, flow)}, "
                f"but there is an identically named module of type {prior}."
            )
        placements[name] = (role, flow)

        bucket = cells[role, flow].setdefault(name, ModuleList())
        bucket.append(module)
        module.name = (name, len(bucket) - 1)

    return {key: Container(cell) for key, cell in cells.items()}


class ModuleContainer(Container):
    """Top-level container over all of a microgrid's modules."""

    def __init__(self, modules):
        self._containers = get_subcontainers(modules)

        views = {}
        for (role, flow), cell in self._containers.items():
            views.setdefault(role, {})[flow] = cell
            views.setdefault(flow, {})[role] = cell
        midlevels = {axis: Container(**sub) for axis, sub in views.items()}

        self._types_by_name = {
            name: key for key, cell in self._containers.items() for name in cell
        }
        super().__init__(**midlevels)

    def names(self):
        return list(self._types_by_name.keys())

    @property
    def containers(self):
        return self._containers
