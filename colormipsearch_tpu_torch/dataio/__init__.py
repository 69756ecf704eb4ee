from colormipsearch_tpu_torch.dataio.json_io import (
    JSONMatchesReader,
    JSONMatchesWriter,
    read_neurons_json,
    write_neurons_json,
)

__all__ = [
    "JSONMatchesReader",
    "JSONMatchesWriter",
    "read_neurons_json",
    "write_neurons_json",
]
