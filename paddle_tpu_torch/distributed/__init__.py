"""Multi-process parallelism for the port: one process per rank over
``torch.distributed`` (counterpart of ``paddle_tpu/distributed/``).

* ``env`` — ``init_parallel_env``: the process group and the mesh of
  named axes; each rank's device and backend;
* ``topology`` — ``CommunicateTopology`` (rank <-> coordinate),
  ``Mesh`` (one process group per axis slice) and the reference's
  ``HybridCommunicateGroup``;
* ``spawn`` — start ranks as processes (spawn start method, a file
  rendezvous);
* ``collective`` — the collectives a train step needs, staged through
  pinned host memory where gloo serves ranks that share a card, and
  Megatron's autograd pair;
* ``megatron`` — the tensor-parallel layers and the vocab-parallel loss;
* ``fleet.base`` — ``zero_shard_spec``;
* ``sharding_rules`` — ordered (regex, spec) rules over a tree's paths;
* ``serving_mesh`` — rank processes a controlling process drives step by
  step (``RankPool``, ``ServingMesh``): what a tensor-parallel
  ``DecodeServer(mesh=)`` runs on.

The parameter-server services:

* ``kvstore`` — the TCP key-value store (rendezvous, barriers,
  heartbeats), wire-compatible with the JAX package's;
* ``ps_service`` — table-server processes over the native table
  (``csrc/host/ps_table.cpp``), the sharded ``PSClient``, the async and
  geo communicators;
* ``ps`` — tables on the device (``SparseEmbeddingTable``, ``TheOnePS``,
  row-sharded over a mesh axis) and the graph table's client handle;
* ``heter`` — ``HeterTrainer``: host tables, the dense step on the card;
* ``role_maker``, ``elastic``, ``launch`` — the launcher's environment,
  elastic membership, and ``python -m paddle_tpu_torch.distributed.launch``.

The functional pipeline and the fleet's helpers:

* ``pipeline`` — ``make_pipeline_loss`` / ``build_pipeline_train_step``
  over embed, stage and head functions, its hop an autograd function
  over ``collective.exchange``;
* ``pp_schedule`` — the interleaved 1F1B schedule tables;
* ``fleet`` — ``strategy``, ``metrics``, ``util``, ``utils.fs``,
  ``data_generator``, ``dataset`` (``InMemoryDataset`` / ``QueueDataset``
  over ``io.native_reader``, also exported here) and ``comm_opt`` (DGC,
  LocalSGD).

Each is a submodule, loaded at first use: the table servers, the
launcher and a data-generator process import this package without
loading torch.  ``parallel.DataParallel``, ``fleet.ShardedTrainStep``
and ``fleet.strategy_compiler`` are not ported (ROADMAP A2).
"""
import importlib

__all__ = ["collective", "elastic", "env", "fleet", "heter", "kvstore",
           "launch", "megatron", "pipeline", "pp_schedule", "ps",
           "ps_service", "role_maker", "serving_mesh", "sharding_rules",
           "spawn", "topology", "InMemoryDataset", "QueueDataset"]
_DATASETS = ("InMemoryDataset", "QueueDataset")


def __getattr__(name):
    if name in _DATASETS:
        return getattr(importlib.import_module(f"{__name__}.fleet.dataset"),
                       name)
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
