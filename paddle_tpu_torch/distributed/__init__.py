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

The JAX package's services (ps, kvstore, launch, elastic, heter,
``parallel.DataParallel``) are not ported (ROADMAP A2).
"""
