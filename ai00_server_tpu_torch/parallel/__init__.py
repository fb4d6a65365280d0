"""Serving on more than one device: a (dp, tp) mesh of places.

Port of ``ai00_server_tpu/parallel``: dp over the continuous-batching slot
axis, tp over the heads (RWKV-4: the channels), the hidden width and the
vocabulary.  One controller owns every shard (``mesh_engine.MeshEngine``,
built by ``Engine(..., mesh=)``); the collectives are peer copies
(``collectives.py``).
"""

from .sharding import (  # noqa: F401
    Mesh, data_specs, make_mesh, param_specs, shard_params,
    shard_sampler_state, shard_state, state_specs, unshard_params,
    unshard_state,
)
