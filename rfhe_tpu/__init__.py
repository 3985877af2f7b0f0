"""rfhe_tpu: fault-tolerant FHE framework in JAX (ReliaFHE capabilities,
rebuilt as accelerator programs over u32 RNS limbs).

Layer map (SURVEY.md §7):
  numth      L0 host-side number theory (primes, roots, Barrett/Mont/CRT consts)
  oracle     golden Python-int models used by tests
  ops        L1 device kernels: u32 modmul, int8 digit matmul, NTT, baseConv
  transform  L2 four-step NTT (single-chip + mesh-sharded all-to-all version)
  protect    L3 ABFT detectors (folds, projections, range windows, ECC rows)
  fhe        L4 CKKS/BGV scheme layer (RNS polys, keys, evaluator)
  faults     L5 fault injection + Monte-Carlo campaign harness
  models     end-to-end workloads (encrypted dotprod, BSGS matvec, linear layers)
  parallel   mesh/sharding helpers
  trace      L6 op-level tracing & aggregation
  bench      benchmark drivers
  figures    L7 figure pipeline
"""
__version__ = "0.1.0"
