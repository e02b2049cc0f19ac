"""YAML (de)serialization machinery.

Interop layer for the reference's on-disk microgrid/scenario format
(``src/pymgrid/utils/serialize.py``): custom ``!NDArray`` / ``!DataFrame``
tags, with large arrays written as ``.csv.gz`` sidecar files relative to the
YAML document when dumping to a *named* file stream, and inline lists
otherwise.  This lets the framework both read the packaged ``pymgrid25``
scenario YAMLs unmodified and round-trip its own microgrids.
"""
from pathlib import Path

import numpy as np
import yaml

__all__ = [
    "PymgridLoader",
    "PymgridDumper",
    "add_pymgrid_yaml_representers",
    "add_numpy_pandas_representers",
    "add_numpy_pandas_constructors",
    "add_path_to_arr_like",
    "dump_data",
    "PathedArray",
    "NDArraySubclass",
    "yaml_dump",
    "yaml_load",
]

_ARRAY_TAG = "!NDArray"
_FRAME_TAG = "!DataFrame"


class PymgridLoader(yaml.SafeLoader):
    """Dedicated loader so this framework's tag constructors never collide
    with another pymgrid implementation registered on ``yaml.SafeLoader``."""


class PymgridDumper(yaml.SafeDumper):
    """Dedicated dumper (see :class:`PymgridLoader`)."""


def yaml_dump(obj, stream=None):
    return yaml.dump(obj, stream=stream, Dumper=PymgridDumper)


def yaml_load(stream):
    return yaml.load(stream, Loader=PymgridLoader)


class PathedArray(np.ndarray):
    """ndarray subclass carrying a sidecar file path through the YAML dumper
    (the reference's ``NDArraySubclass``, ``utils/serialize.py:115-128``)."""

    def __new__(cls, input_array, path=None):
        obj = np.asarray(input_array).view(cls)
        obj.path = path
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.path = getattr(obj, "path", None)


# reference name for drop-in imports
NDArraySubclass = PathedArray


def dump_data(data_dict, stream, yaml_tag):
    """Prepare a serialization dict for dumping.

    When ``stream`` is a named file stream, array-like values get annotated
    with a sidecar path ``data/<nested keys>/<Tag>/<key>.csv.gz`` relative to
    the stream location; the representer then writes the sidecar and emits the
    relative path as the scalar node value.
    """
    if not hasattr(stream, "name"):
        return data_dict
    base = Path(stream.name).parent / "data"
    return _annotate_paths(data_dict, base, yaml_tag)


def _annotate_paths(data_dict, path, yaml_tag):
    import pandas as pd

    for key, value in data_dict.items():
        if isinstance(value, dict):
            data_dict[key] = _annotate_paths(value, path / key, yaml_tag)
        elif isinstance(value, (np.ndarray, pd.DataFrame, pd.Series)):
            if isinstance(value, np.ndarray) and not isinstance(value, PathedArray):
                value = PathedArray(value)
            value.path = path / f'{yaml_tag.lstrip("!")}/{key}.csv.gz'
            data_dict[key] = value
    return data_dict


# reference-name aliases for drop-in imports (utils/serialize.py:10-42)
add_path_to_arr_like = _annotate_paths


def add_pymgrid_yaml_representers():
    """Register all pymgrid YAML tags (reference ``serialize.py:10-21``).

    Importing the trajectory / reward-shaping subpackages registers their
    ``yaml.YAMLObject`` tags as a side effect; array/frame representers are
    registered explicitly.
    """
    add_numpy_pandas_representers()
    from pymgrid_tpu_torch.microgrid import reward_shaping, trajectory  # noqa: F401


def _write_sidecar(data, path, stream_loc):
    import pandas as pd

    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(np.asarray(data)).to_csv(path)
    return str(path.relative_to(stream_loc))


def _represent_array_like(dumper, data, tag):
    path = getattr(data, "path", None)
    if path is not None:
        rel_path = _write_sidecar(data, path, Path(dumper.stream.name).parent)
        return dumper.represent_scalar(tag, rel_path)
    if hasattr(data, "to_dict"):
        return dumper.represent_mapping(tag, data.to_dict())
    return dumper.represent_sequence(tag, data.tolist())


def add_numpy_pandas_representers():
    import pandas as pd

    PymgridDumper.add_representer(
        pd.DataFrame, lambda d, data: _represent_array_like(d, data, _FRAME_TAG)
    )
    PymgridDumper.add_multi_representer(
        np.ndarray, lambda d, data: _represent_array_like(d, data, _ARRAY_TAG)
    )
    PymgridDumper.add_multi_representer(
        np.floating, lambda d, data: d.represent_float(data.item())
    )
    PymgridDumper.add_multi_representer(
        np.integer, lambda d, data: d.represent_int(data.item())
    )


def _resolve_path(loader, node):
    data_path = Path(loader.construct_scalar(node))
    if not data_path.is_absolute():
        try:
            stream_name = loader.stream.name
        except AttributeError:
            raise ValueError(
                f"Path {data_path} must be absolute if yaml stream has no 'name'."
            )
        data_path = Path(stream_name).parent / data_path
    return data_path


def _construct_frame(loader, node):
    import pandas as pd

    if isinstance(node, yaml.MappingNode):
        return pd.DataFrame(loader.construct_mapping(node, deep=True))
    return pd.read_csv(_resolve_path(loader, node), index_col=0)


def _construct_array(loader, node):
    if isinstance(node, yaml.SequenceNode):
        return np.array(loader.construct_sequence(node, deep=True))
    return _construct_frame(loader, node).values


def add_numpy_pandas_constructors():
    PymgridLoader.add_constructor(_ARRAY_TAG, _construct_array)
    PymgridLoader.add_constructor(_FRAME_TAG, _construct_frame)
