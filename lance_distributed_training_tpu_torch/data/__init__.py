"""Host data plane: columnar format, sampler plans, row filters, decode
into pooled pages, the iterable, map-style, eval and image-folder loaders
and the loader graph that composes them, decode worker processes and the
straggler scheduler over them, the batch and replay caches, the placement
plane, and authoring."""

import importlib

# Name -> the submodule that defines it. Imported on first use, so that a
# process that needs one plane (a decode worker: the format, the
# decoders, the shm ring) does not import torch and the trainer with it.
_EXPORTS = {
    "authoring": (
        "IMAGE_SCHEMA", "create_dataset_from_image_folder",
        "create_food101_datasets", "create_synthetic_classification_dataset",
        "create_synthetic_image_folder",
        "create_synthetic_image_text_dataset", "create_text_token_dataset",
        "create_variable_length_token_dataset", "ingest_on_process_zero",
    ),
    "buffers": (
        "BufferPool", "RaggedPage", "default_buffer_pool",
    ),
    "cache": (
        "BatchCache", "DeviceReplayCache", "PlanCache", "decode_fingerprint",
        "default_cache_dir", "folder_fingerprint", "item_fingerprint",
        "plan_fingerprint",
    ),
    "decode": (
        "ImageClassificationDecoder", "ImageTextDecoder", "decoder_for_task",
        "numeric_decoder",
    ),
    "device_decode": (
        "CoeffImageDecoder",
    ),
    "filters": (
        "parse_predicate", "predicate_mask",
    ),
    "folder": (
        "FolderDataPipeline", "read_sample_batch",
    ),
    "format": (
        "Dataset", "Fragment", "write_dataset",
    ),
    "graph": (
        "Buffers", "Cache", "Decode", "DevicePut", "EvalSource",
        "FleetTransport", "FolderSource", "InProcess", "LanceSource",
        "LoaderGraph", "MapStyleSource", "Place", "Pool", "Prefetch",
        "ServiceTransport", "canonical_graphs",
    ),
    "placement": (
        "PlacedLoader", "PlacementPlane",
    ),
    "pipeline": (
        "MapStylePipeline", "make_eval_pipeline", "make_map_style_pipeline",
        "make_train_pipeline",
    ),
    "schedule": (
        "CostModel", "DecodeScheduler", "plan_item_hints",
    ),
    "samplers": (
        "ReadRange", "distributed_index_batches", "distributed_indices",
        "make_plan", "padded_eval_index_batches", "slice_plan",
    ),
    "token_pack": (
        "PackPlan", "TokenDecoder", "TokenPackConfig", "TokenPackPlanner",
    ),
    "workers": (
        "WorkerPool", "columnar_spec", "folder_spec",
    ),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
