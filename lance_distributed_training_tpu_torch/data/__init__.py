"""Host data plane: columnar format, sampler plans, row filters, decode,
the iterable, map-style, eval and image-folder loaders, and authoring."""

from .authoring import (
    IMAGE_SCHEMA,
    create_dataset_from_image_folder,
    create_food101_datasets,
    create_synthetic_classification_dataset,
    create_synthetic_image_folder,
    create_text_token_dataset,
    create_variable_length_token_dataset,
    ingest_on_process_zero,
)
from .decode import ImageClassificationDecoder, decoder_for_task, numeric_decoder
from .device_decode import CoeffImageDecoder
from .filters import parse_predicate, predicate_mask
from .folder import FolderDataPipeline, read_sample_batch
from .format import Dataset, Fragment, write_dataset
from .pipeline import (
    MapStylePipeline,
    make_eval_pipeline,
    make_map_style_pipeline,
    make_train_pipeline,
)
from .samplers import (
    ReadRange,
    distributed_index_batches,
    distributed_indices,
    make_plan,
    padded_eval_index_batches,
    slice_plan,
)
from .token_pack import (
    PackPlan,
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
)

__all__ = ["CoeffImageDecoder", "Dataset", "FolderDataPipeline", "Fragment",
           "IMAGE_SCHEMA", "ImageClassificationDecoder", "MapStylePipeline",
           "PackPlan", "ReadRange", "TokenDecoder", "TokenPackConfig",
           "TokenPackPlanner", "create_dataset_from_image_folder",
           "create_food101_datasets",
           "create_synthetic_classification_dataset",
           "create_synthetic_image_folder", "create_text_token_dataset",
           "create_variable_length_token_dataset", "decoder_for_task",
           "distributed_index_batches", "distributed_indices",
           "ingest_on_process_zero", "make_eval_pipeline",
           "make_map_style_pipeline", "make_plan", "make_train_pipeline",
           "numeric_decoder", "padded_eval_index_batches", "parse_predicate",
           "predicate_mask", "read_sample_batch", "slice_plan",
           "write_dataset"]
