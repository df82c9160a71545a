"""Host data plane: columnar format, sampler plans, decode, pipeline."""

from .authoring import (
    IMAGE_SCHEMA,
    create_synthetic_classification_dataset,
    create_text_token_dataset,
)
from .decode import ImageClassificationDecoder, decoder_for_task, numeric_decoder
from .device_decode import CoeffImageDecoder
from .format import Dataset, Fragment, write_dataset
from .pipeline import make_eval_pipeline, make_train_pipeline
from .samplers import ReadRange, make_plan, padded_eval_index_batches

__all__ = ["CoeffImageDecoder", "Dataset", "Fragment", "IMAGE_SCHEMA", "ImageClassificationDecoder",
           "ReadRange", "create_synthetic_classification_dataset",
           "create_text_token_dataset", "decoder_for_task",
           "make_eval_pipeline", "make_plan", "make_train_pipeline",
           "numeric_decoder", "padded_eval_index_batches", "write_dataset"]
