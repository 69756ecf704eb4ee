"""Persisted data model: neurons, matches, file references.

Python analogue of the reference entity model (colormipsearch-api
`model/AbstractNeuronEntity.java`, `EMNeuronEntity.java`,
`LMNeuronEntity.java`, `AbstractMatchEntity.java`, `CDMatchEntity.java`,
`PPPMatchEntity.java`, `FileData.java`) with JSON field names kept
identical so result files interoperate with the reference pipeline.
"""

from colormipsearch_tpu_torch.model.entities import (
    CDMatch,
    ComputeFileType,
    EMNeuron,
    FileData,
    FileType,
    LMNeuron,
    MatchComputeFileType,
    Neuron,
    PPPMatch,
    PPPSkeletonMatch,
    ProcessingType,
    PublishedLMImage,
    neuron_from_json,
)
from colormipsearch_tpu_torch.model.ids import TimebasedIdGenerator

__all__ = [
    "CDMatch",
    "ComputeFileType",
    "EMNeuron",
    "FileData",
    "FileType",
    "LMNeuron",
    "MatchComputeFileType",
    "Neuron",
    "PPPMatch",
    "PPPSkeletonMatch",
    "ProcessingType",
    "PublishedLMImage",
    "TimebasedIdGenerator",
    "neuron_from_json",
]
