"""Disaggregated input-data service — decode as an independently-scaled plane.

A copy of ``lance_distributed_training_tpu/service/__init__.py`` for the
port.

The L2 input pipeline (``data/``) confines decode to the training host; this
package serves the same plan-ordered, device-ready host batches over TCP so
decode capacity scales with CPU hosts instead of training-host cores (the tf.data
service disaggregation argument — see README "Disaggregated data service").

* :mod:`.protocol` — length-prefixed frames, versioned handshake, raw-tensor
  batch payloads;
* :mod:`.server` — :class:`DataService`: per-client-shard plan streaming with
  bounded queues, resumable cursors, read retry/backoff;
* :mod:`.client` — :class:`RemoteLoader`: prefetching loader speaking the
  protocol, reconnect-at-cursor, identical batch contract to
  :class:`~..data.pipeline.DataPipeline`.
"""

from .client import RemoteLoader  # noqa: F401
from .protocol import PROTOCOL_VERSION  # noqa: F401
from .server import DataService, ServeConfig, serve  # noqa: F401

__all__ = ["RemoteLoader", "DataService", "ServeConfig", "serve",
           "PROTOCOL_VERSION"]
