"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels from kubernetes_tpu_torch/csrc, one nvcc a source,
   all started together: the solve kernels (the cluster kernel, the slot
   kernel and the wide kernel, its four instances: with and without sv,
   slices in shared memory or at L2; the sharded kernel, its eight: those
   and with or without the hard-spread round; the feasibility counts
   kernel) and the scan kernel; print ptxas's
   registers, shared memory and spills for each;
3. hold the kernels against their plain PyTorch version, on the card,
   over seeded problems (the test cases' shapes, forced ties within and
   across the cluster's slices, a ragged last slice, the only feasible
   node in the last slice, two batches carrying state, constraint spaces
   wider than eight, 5,000 nodes x 512 pods with SC, T and U of 16, a
   cluster of eight, and a shape past the cluster's shared memory with a
   pod of nine term references): assignments and state planes must be
   equal. Each case runs on the kernel the launch plan picks, and again
   on the wide kernel. Then the slot kernel on slot streams (T of
   16 to 100, a ragged last slice, a cluster of eight, two batches
   carrying state) against the plain slot solve, the dense plain solve
   and the wide kernel; the shared-volume attach planes on the
   cluster and wide kernels (SV of 8, 16, 64 and 512, sentinel pods
   mixed in, full nodes, volumes reused within a batch, a cluster of
   eight, a shape past the cluster's shared memory, two batches carrying
   state); and the wide kernel's hazards (``wide_cases``): pod chunks of
   1 and 7 (a buffer refilled every pod; a chunk past the batch's end),
   rows read in place (chunk 0), B = 0, a batch all padding, pods with
   no constraint or term and pods of 9 and 13 term references at
   T = 100, 512 pods mixing hard spread (the exchange slots' parity), a
   ragged last slice, N = 65,536 at T = 1 (slices at L2) with hard
   spread and with sv, T = 4,096 (a chunk of one pod), SV of 8, 16, 64
   and 512 past the cluster's shared memory; each of these launched
   five times on fresh copies, every result identical; then the sharded
   kernel at 1, 2, 4 and (where the card holds eight clusters at once) 8
   shards against its plain version and against the single-card kernel
   the wrapper plans (assignments, the planes but their totals row, each
   shard's totals against that row), and the feasibility counts kernel
   against its plain version on 1 x S and 2 x S meshes, on seeded
   problems (``sharded_cases``: a hard spread constraint and none,
   SV = 64, T = 100 dense, identical nodes and pods whose ties cross the
   shards' boundaries);
4. the main path: SchedulingBasic, 5,000 nodes / 30,000 pods, batches of
   4,096, through ``run_workload`` on the card, in the default arms
   (pipelined, device mirror on, the latency-budget tuner on). Every pod
   bound, the cluster kernel launched once per solve, the other solve
   kernels and the plain version never;
5. TopologySpreading, 5,000 nodes / 5,000 pods: the same, and zone skew
   at most one;
6. small SchedulingBasic and TopologySpreading runs on the card and on
   the CPU (the plain version) give identical pod -> node maps;
7. time the cluster kernel and the wide kernel (forced) on the main
   paths' largest batches and on the SchedulingBasic batch cut to 1,024
   columns, in turns (wide, cluster, cluster, wide), with CUDA events
   around the bare launch
   (the wrapper's input checks outside the window, its whole call timed
   beside it); the cluster kernel on the two largest batches at cluster
   sizes 16, 8, 4 and 2; and the plain version once on each of the two
   largest batches, which must equal the kernels;
8. SchedulingBasic 5,000 / 30,000 in turns, serialized, pipelined,
   pipelined, serialized: the same pods bound to the same nodes in all
   four; each dispatch (``solve_lazy``, host clock, the cyclic GC's
   pauses taken out) under half its kernel's CUDA-event time, and the
   card still busy right after some of them. A dispatch over that bound
   passes only as host noise: the card still busy right after it, and
   the same dispatch of the arm's other run under the bound (a wait for
   the card lies on the dispatch's code path and recurs in both);
9. the churn path (``workloads.churn``: 6 waves of 5,000 pods over 5,000
   nodes, a seeded 10% of the bound pods deleted and 2% of the nodes
   given a new allocatable cpu after each wave, one pod deleted while a
   batch is held) with the mirror on and off: the same bound sets, no
   pod lost, the held batch discarded, catch-ups in the mirror-on run and
   its planes equal to a fresh ``prepare`` after each;
10. the sustained-arrival row (30,000 pods at 5,000 a second, seed 14,
    32-cpu nodes), pipelined and serialized: no pod lost, every arrival
    injected;
11. the Preemption row (``workloads.preemption``: 5,000 nodes of 4 cpu,
    5,000 priority-1 pods of 3 cpu, then 5,000 priority-100 pods of 3
    cpu) in the default arms and again serialized: every measured pod
    bound, exactly one priority-1 pod deleted per measured pod, no other
    pod lost, the same bound pods on the same nodes and the same victims
    in both arms; the host seconds of the preemption screen, the victim
    planner, plan execution and the serial path;
12. the Unschedulable row (5,000 nodes, 1,000 pods whose node selector
    no node matches, their op not waited for, then 10,000 plain pods):
    the 10,000 bound, each of the 1,000 pending with ``PodScheduled=
    False`` and the FitError message built from the static masks, and
    PostFilter run for none;
13. a small Preemption row (50 nodes / 50 / 50) and a small mixed row
    (host-port pods, which take the serial path, among plain ones) on
    the card and on the CPU: the same pod -> node maps and the same
    victims;
14. the GangScheduling row (``workloads.gang_scheduling``: 5,000 nodes,
    30,000 pods in coscheduling gangs of 10 with a hard zone spread of
    skew 5), pipelined and serialized: every pod bound, every gang whole,
    zone skew at most 5, no pod left waiting at Permit and none rejected
    there (no ``PodScheduled=False`` condition), the cluster kernel
    launched once per solve, the same pods on the same nodes in both
    arms; the binding pool's cycles, Permit waits, rebuilds and
    catch-ups;
15. the SchedulingPodAntiAffinity row (5,000 nodes, 1,000 plain pods,
    then 30,000 pods in 100 colours, each with a required hostname
    anti-affinity to its own colour: T = 100): every measured pod bound,
    no node with two measured pods of one colour, each launch on the
    kernel ``plan_launch`` picks for its batch (the slot kernel for every
    T = 100 batch, where the cluster's dense layout outgrows a block's
    shared memory and each pod references one term); on the largest
    batch the slot kernel, the wide kernel (forced, on the dense stream
    the slots were packed from) and the plain versions timed in turns
    (slots, wide, wide, slots) and held against each other;
16. the three other wide-term families at ``bench.py``'s sizes (5,000
    nodes, 5,000 init pods, 1,000 measured): SchedulingPodAffinity and
    SchedulingPreferredPodAffinity (T = 50), SchedulingPreferredPod-
    AntiAffinity (T = 100): every measured pod bound, each required-
    affinity pod in a zone holding a pod of its group, the launches as
    planned, and the slot kernel equal to the plain version on each
    row's largest batch;
17. the four PV rows at ``bench.py``'s sizes: SchedulingInTreePVs,
    SchedulingMigratedInTreePVs and SchedulingCSIPVs at 1,000 nodes / 0 /
    5,000, SchedulingSharedPVs at 1,000 / 0 / 3,000: every measured pod
    bound, no node over its CSINode limit of 39 ``csi.fake.driver``
    volumes, each WaitForFirstConsumer claim bound to a PV of its own,
    the launches as ``plan_launch`` plans them;
18. PreemptionPVs (``workloads.preemption_pvs``: 5,000 nodes / 5,000 /
    5,000, a bound claim on every preemptor), pipelined and serialized:
    every measured pod bound with exactly one victim each, the same bound
    and victim sets in both arms, every claim still bound to its PV;
19. the shared-volume attach planes at size (the fixture of the JAX
    package's shared-volume tests, grown): 1,000 nodes with a CSINode
    limit of 2 for one driver, 300 shared ReadWriteMany CSI claims, 3,000
    pods, ten a claim, in batches of 1,024 on the carried state: every
    pod bound, no node with more than 2 distinct shared volumes, every
    launch the cluster kernel with SV = 512, and after the run the
    carried ``sv`` planes equal to a fresh ``prepare``'s; on the largest
    batch the cluster kernel, the wide kernel (forced) and the plain
    version timed in turns and held against each other.

20. BASELINE configs 1-3 as named rows: SchedulingBasic at 100 / 0 /
    1,000 and 1,000 / 0 / 10,000, TopologySpreading at 5,000 / 0 /
    30,000 (zone skew at most one);
21. the four families ported last at ``bench.py``'s sizes:
    SchedulingSecrets and SchedulingNodeAffinity at 5,000 / 5,000 /
    1,000, PreferredTopologySpreading at 5,000 / 5,000 / 2,000,
    MixedSchedulingBasePod at 5,000 / 1,000 / 30,000: every pod bound,
    each node-affinity pod in its zone, the launches as planned;
22. the tracer's cost: SchedulingBasic 5,000 / 30,000 pipelined with the
    process tracer and device profiler on, off, off, on (``KTPU_TRACE``
    and ``KTPU_DEVPROF`` off, in process);
23. the latency-budget tuner forced to shrink: SchedulingBasic 5,000 /
    12,000 with the budget cut to 1 us after the warm-up: the pad steps
    down one bucket a batch to 512, 1,024 and 512 warmed by ``warm_pad``
    between cycles before their first solve; the warm-up (cold) books
    the pinned staging buffers, and no pad allocates any after it.
24. the scan kernel (``solve_scan_kernel``, the cluster autoscaler's
    what-if) against the plain scan, bit for bit (assignments and every
    final table), on seeded what-ifs (``whatif_problem``): hostname keys
    (V = N) and zone keys only, hard and soft spread, (anti-)affinity,
    preferred weights, graded penalty tiers 300 upcoming and 256 virtual
    columns deep over 2,000 pods, more than 1,024 columns, the tables
    forced out of shared memory, two batches carrying the state, padded
    rows; and ``scan_cases`` (N at each boundary of the columns a thread
    owns, zone keys, hard spread only, terms only, the tables and the
    column arrays forced to global memory, B not a multiple of the chunk,
    all padding, B = 0, the federation's what-ifs at N = 1-3 and as
    encoded: one column enabled, none, a column with both penalty
    tiers). Every case is launched ten times on fresh
    copies of the state, and every result must be identical (a race
    would show as a difference);
25. ``bench.py``'s autoscale row at a burst of 5,000 pods (its own is
    30,000: ``phase_autoscale(burst=AUTOSCALE_ROW_BURST)``; every shape
    kept: 500m pods on 32-cpu
    nodes, a fifth of the needed nodes up at the start, the group's max
    at needed + 2, boot latency 1 s, K = 256, at most 2,048 pods a
    what-if, batches of 4,096): every pod bound within needed + 2 nodes,
    at least one what-if, every what-if one scan-kernel launch (none on
    the plain scan), every batch solve one cluster-kernel launch;
    pods/s, time to all bound, scale-ups, nodes provisioned and each
    what-if's ms (CUDA events on its own stream); the compiles booked in
    measured cycles reported (node columns grow by design). Then ten
    bare launches of the scan kernel on the row's what-if shape
    (``autoscale_whatif``: 94 full nodes, 162 booting, 256 new, 2,048
    pods of 500m, N = 512) and on the fixed yardstick
    (``SCAN_YARDSTICK``: 2,000 pods with constraints, N = 512), and the
    plain scan once on each, which must agree;
26. mesh-block gangs on the batch path: 256 nodes labelled 16 x 16, 24
    gangs of 8 one-cpu pods, a mesh block each: every pod bound, the same
    map as on the CPU, and the members' mean ring from their anchors less
    than half of the adjacency-blind arm's (MeshLocality off);
27. the federation cells at ``bench.py``'s federation row's sizes (3
    clusters, 900 pods open loop at 300 a second, 16-cpu nodes, batches
    of 256, seed 18), in process: ``spill`` and ``loss-mid`` with the
    reference's policy (the numpy oracle decides) and with the scan
    kernel deciding (one launch a decision, none on the plain scan),
    every cell's batch solves on the cluster kernel; zero lost, gangs
    whole on one cluster, each cluster's p99 arrival -> bind within
    budget, on loss a failover with 80% of the orphans bound again in
    time, on spill pods spilled and every cluster loaded; every decision
    replayed on the oracle (host clock), the plain scan and the kernel
    (CUDA events), all equal; then the degradation differential (the
    layer up and down bind the identical set);
28. the wide kernel unforced on a main path: the SchedulingPodAntiAffinity
    row at ``bench.py``'s sizes (5,000 nodes, 1,000 plain pods, 30,000
    measured pods in 100 colours, batches of 4,096) with every 64th
    measured pod also carrying 12 weighted preferred pod-affinity terms
    (weights 1-10) on 12 other colours over the hostname
    (``wide_pods_workload``): such a pod references 13 terms, so no
    batch packs into slots and every T = 100 batch runs the wide kernel.
    Every measured pod bound, no node with two measured pods of one
    colour, every launch as planned, the wide kernel equal to the plain
    version on the largest batch and timed there (ten bare launches);
    pods/s, p50 / p99 enqueue-to-bind, launches and kernel ms beside
    phase 15's row;
29. the sharded tier (``kubernetes_tpu_torch/parallel``): (a) on phase
    4's largest batch, ten bare launches each of the cluster kernel and
    the sharded kernel at 1, 2 and 4 shards in turns, ms a launch and us
    a pod, the counts kernel's launches, the plain versions once, all
    equal; (b) SchedulingBasic 5,000 / 30,000 through ``run_workload``
    on ``ShardedBackend(make_mesh(4))``: every pod bound, no node over
    capacity, one sharded launch a solve and no other solve kernel, the
    row's largest batch solved again by the kernel and the plain version,
    equal to the row's assignments; pods/s, p50 / p99 enqueue-to-bind and
    ms a launch beside phase 4's; (c) ``solve_scan_sharded`` on a
    4,096-pod SchedulingBasic batch: one launch of each kernel, the
    assignments equal to the cluster kernel's; (d) one batch of capacity
    deltas forced on ``ShardedBackend``'s scatters on (b)'s largest
    batch's planes (``time_sharded_scatters``: a set of the cpu
    allocatable row and adds of five request rows on a seeded quarter
    of the columns, ten times each, CUDA events), equal to the plain
    ``index_put_`` on the CPU bit for bit;
30. the scheduler's configuration and HA modes (``harness/ha.py``): (a)
    SchedulingBasic 5,000 / 30,000 through ``Scheduler.create`` from a
    v1beta1 dict (``parallelism`` 16, the adaptive
    ``percentageOfNodesToScore``, the profiles ``default-scheduler`` and
    ``packing`` (MostAllocated in LeastAllocated's place), an HTTP
    extender on 127.0.0.1 with filter and prioritize verbs managing
    ``example.com/ext``, which every node advertises): 150 pods request
    it and take the extender and the serial path, 150 run under
    ``packing`` (serial), the rest batch on the cluster kernel; every pod
    bound, every extender pod on a node the extender passed, every
    packing pod on a node of its attempt's highest total with
    MostAllocated's scores equal to a plain re-score; (b) the same row on
    ``SchedulerReplicaSet(count=2, shard_nodes=True, use_batch=True)``
    (pods sharded by hash) over one store, two sessions and batch paths
    on the card: zero lost, no pod bound twice, each pod on its replica's pool;
    (c) the set with ``shard_nodes=False`` at 1,000 nodes of six pod
    slots and 6,000 pods (the nodes full), pipelined and serialized, and
    at five slots (1,000 pods more than the slots) serialized: the
    capacity guard's rejects and the held batches discarded, no node
    over its allocatable, every pod bound or unschedulable (at five
    slots every slot filled); (d)
    two schedulers on one store under ``run_with_leader_election`` (lease
    2.0 s, renew deadline 1.5 s, retry 0.25 s), each with its batch path,
    SchedulingBasic 5,000 / 30,000, the leader stopped at 10,000 bound:
    the time from the stop to the standby's first bind; zero lost, none
    bound twice, nothing bound by the stopped leader after its stop, the
    rest bound by the standby on its own session. Each row's launches
    are the cluster kernel's (and the wide kernel's where a batch plans
    it), one a solve;
31. ``bench.py``'s rest row once (``harness/rest_perf.py``): SchedulingBasic
    5,000 / 30,000 with every object crossing the REST fabric: the
    apiserver process (the WAL, the RBAC bootstrap policy, admission, the
    watch cache, API Priority and Fairness) and a creator process posting
    PodLists through two clients at 5,000 QPS each, the scheduler here on
    watch streams, binding through BindingList on its binding pool: the
    apiserver's bound count equal to the scheduler's and to 30,000, at
    least 65,000 WAL lines, every launch the cluster kernel's and one a
    solve, the kernel equal to the plain version on the row's largest
    drained batch, two federation instances, watch delivery observed, a
    ``rest_availability`` verdict, no torch in the children; pods/s, p50
    / p90 / p99, the critical path with the apiserver's spans, and the
    fabric overhead against phases 4 and 8's pipelined runs;
32. ``bench.py``'s qos row (``harness/qos.py``): phase 31's row again
    while 3 aggressor tenants of 6 threads each (list storms, watch
    reconnect herds, 200-item ConfigMapList POSTs) hammer the apiserver
    from the measurement's start, phase 31 standing as the solo arm:
    every pod bound in the apiserver's store and by the scheduler, the
    aggressors' requests sent, APF's workload level dispatching, no
    torch in any child, every launch the cluster kernel's and one a
    solve, the kernel equal to the plain version on the largest batch;
    both arms' pods/s and e2e p99, create-to-bind, the p99 ratio and
    ``qos_ok`` (reported, not gated), APF's counts by level;
33. ``bench.py``'s three replay rows (``workloads/replay_bench.py``;
    seed 11, batches of at most 1,024) at scale and time scale 0.3, cut
    from 1.0 for the script's time (the same rate a node, 30% of the pods
    and of the trace), over the REST fabric, pods arriving open loop on the
    trace's clock and expiring into deletions: the preemption storm (at
    full size 702 pods over 45 s on 120 nodes), the mesh gangs in a
    scored and an adjacency-blind arm (747 over 30 s on 64), serve and
    batch tenants with the autoscaler buying nodes from 20 (880 over 45
    s): each row's
    own verdicts (zero lost, gangs whole, no priority inversion, scored
    beating blind, the serve p99 within 2 s, the SLO gate), every launch
    of the cluster kernel and of the scan kernel (the tenancy row's
    what-ifs) held against its plain version; pods/s, arrival-to-bind
    p50 / p99, preemptions, expiries, launches and device seconds.
34. the partitioned control plane (``harness/scale.py``) at 5,000 nodes
    / 15,000 pods, cut from ``bench.py``'s scale10x row (50,000 /
    500,000) for this script's time: (a) the in-process arm, four store
    partitions with a watch dispatch thread each under a hollow fleet,
    two node-sharded replicas with batch paths of at most 1,024 pods;
    (b) ``run_scale10x_row``: the REST arm with four partition apiserver
    processes and a kubemark and creator child, the same arm with one
    partition (the A/B), and the conflict cell (10 nodes / 38 pods,
    serial, replicas racing on every pod over shared nodes, the
    partitioned store's bind-time ledger arbitrating). Zero lost pods
    and zero double binds in every arm, no node over its allocatable by
    the partition servers' own counts, the conflict cell's ``ok``
    (conflicts that happened, all resolved), no torch in any child,
    every launch on the kernel its plan gives, one a solve, and held
    against the plain version; a ``row {...}`` line an arm with pods/s,
    e2e p50 / p99, the A/B speedup, the partition balance, the watch
    streams, the stale binds refused by path, the launches by kernel and
    the plan of each replica's pool, and the card's busy share.
35. the reshard chaos cells (``harness/chaos_reshard.py``, seed 11) at
    their own sizes: midstorm (20 nodes / 120 pods: a move, a split and
    a move under three writer threads), rebalance (20 / 300: the
    rebalancer splitting a hot tenant) and sigkill (20 / 80: a spawned
    WAL-backed partition server SIGKILLed mid migration, restored from
    its log and re-pointed). No scheduler, no kernel. Each cell's
    verdict and zero lost pods; the relists beyond the moved slices, the
    epoch and the freeze reported;
36. ``bench.py``'s hotspot row (``harness/hotspot.py``): 24,000 pods, 3
    partition apiservers, 80% of the writes to one namespace from 3
    creator children; the balanced, hotspot and rebalanced arms, no
    scheduler. Zero lost pods and watch events, no duplicate, no relist
    of an unmoved slice, no resourceVersion regression, the rebalancer
    acting; each arm's pods/s, the recovery ratio against its bar of 0.8
    (reported, not gated), the splits and moves committed and the
    freeze;
37. ``bench.py``'s rolling-upgrade row (``harness/upgrade.py``,
    ``run_upgrade_row()``'s defaults): 2,400 pods at 100 a second, 3
    spawned partition apiservers on synchronous WALs with prespawned
    standbys, 2 scheduler replicas with batch paths of at most 256 pods
    on the card and a codec-v1 witness client, every process restarted
    exactly once under the arrivals. Zero lost pods and watch events,
    none duplicated, no relist of an unmoved slice, every pod bound,
    one epoch, the v1 pin clean, no torch in the children, and every
    launch on the kernel its plan gives, held against the plain version
    bit for bit; pods/s, p50 / p99 arrival-to-bind against the 500 ms
    budget and the longest freeze against 2 s (reported), codec
    renegotiations, handoff fetches and the card's busy share by CUDA
    events;
38. the read tier (``harness/watchherd.py``) at ``bench.py``'s
    ``--quick`` sizes: ``run_watchherd_row`` with 64 informers in 2
    spawned herd children, 120 seeded creates at 20 a second (and their
    deletes) into a spawned owner on a synchronous WAL, 20 hollow nodes,
    an arm without replicas and one with 4 spawned read replicas, then
    the replica-kill cell; then ``run_chaos_readtier`` for owner_restart
    and lag_fence at their defaults. No scheduler, no kernel. Gated:
    nothing lost and no informer unconverged anywhere, no duplicate frame
    and no relist on the arms' steady streams, the same truth hash in
    both arms, relists only on the killed replica's informers (at least
    one there), owner_restart resumed at least once with no reseed and
    no relist, lag_fence fenced. Reported beside the JAX package's bars
    (not gated): the read scaling per owner CPU-second against 1.5x, the
    write ratio against 0.85, and events/s, replication-lag p99,
    reroutes and replica reads;
39. federation over REST (``run_federation_row``) at ``bench.py``'s
    sizes: 3 spawned cells (the upgrade harness's apiserver child), each
    scheduled by a one-replica fleet whose batch path (at most 256 pods)
    runs on the card, 900 pods at 300 a second, 16-cpu nodes; the spill
    row (cluster 0 pinned under its tenants' demand) and the loss row (a
    cell SIGKILLed mid-storm). Gated: zero lost, every pod bound, gangs
    whole, no relist in a surviving cell, spill spilled and loss failed
    over with a recovery ratio of at least 0.8, no torch in a cell, and
    every launch on the kernel its plan gives, held against the plain
    version bit for bit. Each cluster's p99 arrival-to-bind is reported
    beside its 2,500 ms bar;
40. chaos over REST (``harness/chaos_rest.py``) at the JAX package's
    defaults: seed 11, the mixed fault profile (resets, 429 bursts,
    latency, pod watch drops, armed through ``/debug/faults``), 20 nodes
    and 120 pods in 6 waves through a spawned apiserver child on an
    inline WAL, SIGKILLed and restored from its WAL after a seeded wave,
    a serial scheduler binding over ``RestClusterClient``. Gated: all
    bound exactly once, no oversubscription, the WAL's restore equal to
    the live assignment, no list version regressed, one kill, faults
    injected, no torch in the child, no kernel launched; the retries and
    degraded seconds reported;
41. the mirror ring (``harness/chaos_mirror.py``): the three
    ``MIRROR_SCENARIOS`` (node_kill, mesh_resize at 2 then 4 node shards
    on the sharded kernel, event_storm) at seed 11, 20 nodes / 120 pods,
    both arms on the card. Gated: each cell's placements bit-identical
    across the arms, nothing lost, deltas scattered, event_storm
    reseeded, every launch (cluster and sharded) held against its plain
    version bit for bit;
42. node churn (``harness/chaos_nodes.py``): seed 3, the mixed churn
    profile at the JAX package's defaults (16 nodes, 96 pods in 6 waves
    over REST, the lifecycle and pod GC controllers beside the store,
    batches of 64 on the card), then the JAX package's
    churn-with-autoscaler case (seed 29, killer, 10 nodes of 4 cpu, 70
    pods, the autoscaler's what-ifs on the scan kernel). Gated: every
    invariant (no bind into the void, nothing lost, no
    oversubscription, taints healed, the cache equal to the store), a
    kill or flap that happened, one cluster launch a solve and one scan
    launch a what-if, the autoscale cell buying a node, every launch
    held against its plain version; the churn actions, evictions,
    rescues and their p99, the stale commits refused reported.

``phase_mirror_ab()`` runs ``bench.py``'s mirror A/B as a call of its
own (not from ``main``): ``run_mirror_ab`` at ``bench.py``'s full size
(the sustained row, 30,000 pods at 5,000 a second, 32-cpu nodes,
batches of 4,096, mirror on and off, both arms run alike) and its
seed-14 node_kill cell, every launch held against its plain version.
Gated: the on arm's encode share at most 0.05, at most one reseed, p99
within 500 ms, invariants held, the differential matched with nothing
lost, and the on arm's h2d bytes a cycle at most 1.10 times the off
arm's (the reference's A/B bar; strictly below is reported). The
sustained trace is arrivals only, so neither arm's mirror has anything
to scatter (the on arm's mirror events are logged): the A/B does not
exercise the scatter path, which the cells of phase 41 do.

``phase_chaos_matrix()`` runs the chaos ring's seeded matrix as a call
of its own (not from ``main``): the rest cells at seeds 11, 23, 37, 41
and 53 (mixed) and 11 on the other three profiles, the node-churn cells
at seeds 3, 17, 29, 47 and 61 (mixed) and 3 on the other three, the
mirror cells at seeds 11 and 23 on each scenario.

Phases 4, 5, 11 and 14 report their rebuilds by kind with devprof's h2d
bytes each; at the first state-only rebuilds (the static planes kept on
the card) the resident static planes must equal a fresh ``prepare``'s,
and at least one must happen.

Every row any phase runs (through ``run_workload`` or the sustained
harness; phase 19's batch loop too, which now warms up first) prints its
``telemetry``, ``critical_path`` and ``freshness`` as a ``row {...}``
line, and a row on the card fails on a compile inside a measured cycle
(a library load, a kernel instance's first launch, or the pinned
staging ring's first allocation of a capacity). The rows whose every cycle
follows their warm-up (phases 4, 5, 8, 20, 22, 23) start cold: no kernel
instance counted as launched and the staging ring empty.
Phase 4 also holds the aggregate unattributed share of the sampled pods'
windows to at most 0.05.

Every main-path run (4, 5, 8 to 23, 25 to 34, 37, 39, 41 and 42) resets the
kernels' launch counts just before and reads them just after; the kernel
table sums them.
Before the last line come the script's wall time, the scatters' counts
and times as JSON, the kernel table as JSON and the card's name and
power limit; the last line is the JSON ok line.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import (
    CSINode,
    CSINodeDriver,
    Node,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.autoscaler.simulator import _serial_whatif
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.federation import FederationPolicy
from kubernetes_tpu_torch.harness import elastic, perf, sustained, workloads
from kubernetes_tpu_torch.harness import federation as fed_harness
from kubernetes_tpu_torch.harness import ha
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.harness.problems import (
    autoscale_whatif,
    random_planes,
    random_slot_planes,
    scan_case_inputs,
    scan_cases,
    whatif_problem,
)
from kubernetes_tpu_torch.ops import build
from kubernetes_tpu_torch.ops import mirror as mirror_mod
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops import solver as solver_mod
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    state_planes,
    static_planes,
)
from kubernetes_tpu_torch.ops.slots import SPARSE_K, slot_stream
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.scheduler.framework.plugins import mesh_locality
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from kubernetes_tpu_torch.parallel import (
    ShardedBackend,
    SState,
    make_mesh,
    solve_scan_sharded,
)
from kubernetes_tpu_torch.parallel import sharded as sharded_mod
from kubernetes_tpu_torch.sidecar import BatchScheduler, attach_batch_scheduler

PARAMS = SolverParams()
KERNEL_SOURCE = "kubernetes_tpu_torch/csrc/solve_kernel.cu"
SCAN_SOURCE = "kubernetes_tpu_torch/csrc/scan_kernel.cu"
REPLACES = "kubernetes_tpu/ops/pallas_solver.py:225"
# the legacy scan's step (an XLA lax.scan program, _solve_packed at :351)
REPLACES_SCAN = "kubernetes_tpu/ops/solver.py:88"
# the reference's sparse scan (an XLA program), which it runs instead of its
# Pallas kernel on wide term axes
REPLACES_SPARSE = "kubernetes_tpu/ops/pallas_solver.py:754"
# the sharded tier: _build_solve's shard_map of lax.scan over _step, and
# the batched static feasibility counts
REPLACES_SHARDED = "kubernetes_tpu/parallel/sharded.py:342"
REPLACES_COUNTS = "kubernetes_tpu/parallel/sharded.py:319"
SOLVE_REASON = "no single PyTorch call computes the solve"
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, f32 operations/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
RACK = "example.com/rack"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


T_START = time.monotonic()


def log(msg: str) -> None:
    if msg[:1] == "[" and msg[1:2].isdigit():
        # a phase header: the script's seconds so far
        msg += f" (at {time.monotonic() - T_START:.1f} s)"
    print(msg, flush=True)


# ----------------------------------------------------------------------
# seeded problems
def _term(key, value, topo):
    return {"labelSelector": {"matchExpressions": [
        {"key": key, "operator": "In", "values": [value]}]},
        "topologyKey": topo}


def make_nodes(rng, n):
    nodes = []
    for i in range(n):
        labels = {HOST: f"node-{i}", RACK: f"r{i % 20}",
                  "pool": f"p{i % 4}"}
        if i != n - 1:
            labels[ZONE] = f"z{i % 10}"
        d = {"metadata": {"name": f"node-{i}", "labels": labels},
             "spec": {"unschedulable": i % 97 == 13, "taints": []},
             "status": {"capacity": {
                 "cpu": str(rng.choice([4, 8, 16, 32])),
                 "memory": str(rng.choice(["8Gi", "16Gi", "32Gi", "64Gi"])),
                 "pods": "110"}}}
        if i % 50 == 7:
            d["spec"]["taints"] = [{"key": "dedicated", "value": "infra",
                                    "effect": "NoSchedule"}]
        if i % 3 == 0:
            d["status"]["images"] = [{"names": [f"img/{i % 16}"],
                                      "sizeBytes": int(rng.integers(1, 3))
                                      << 30}]
        nodes.append(d)
    return nodes


def make_pods(rng, n, groups, profiles, prefix="p"):
    """Hard and soft spread per group, required affinity per group (its
    first pod matches nothing yet), anti-affinity per color, preferred
    (anti-)affinity weights, ``profiles`` distinct static profiles."""
    pods = []
    for i in range(n):
        g = int(rng.integers(groups))
        kind = int(rng.integers(5))
        requests = {"cpu": str(rng.choice(["100m", "250m", "500m", "1"])),
                    "memory": str(rng.choice(["128Mi", "256Mi", "1Gi"]))}
        spec = {"containers": [{"name": "c", "image": f"img/{i % profiles}",
                                "resources": {"requests": requests}}]}
        if i % profiles == 1:
            spec["nodeSelector"] = {"pool": "p1"}
        if i % profiles == 2:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if kind == 0:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1 + g % 3, "topologyKey": ZONE,
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"grp": f"g{g}"}}}]
        elif kind == 1:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": RACK,
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"grp": f"g{g}"}}}]
        elif kind == 2:
            spec["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term("grp", f"g{g}", ZONE)]}}
        elif kind == 3:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term("color", f"c{g}", HOST)]}}
        else:
            spec["affinity"] = {
                "podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 1 + g % 7,
                         "podAffinityTerm": _term("grp", f"g{g}", ZONE)}]},
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 2, "podAffinityTerm":
                         _term("color", f"c{(g + 1) % groups}", HOST)}]}}
        pods.append({"metadata": {"name": f"{prefix}{i}", "labels": {
            "grp": f"g{g}", "color": f"c{g}"}}, "spec": spec})
    return pods


def encode(node_dicts, pod_dicts, pad):
    enc = BatchEncoder(new_snapshot([], [Node.from_dict(d)
                                         for d in node_dicts]))
    cluster, batch = enc.encode([Pod.from_dict(d) for d in pod_dicts],
                                pad_pods=pad)
    return cluster, batch


def on(device, ps: PStatic, state, ints, floats):
    moved = PStatic(ps.ints.to(device), ps.f32s.to(device),
                    ps.sc_meta.to(device), *ps[3:])
    return (moved, state.to(device).clone(),
            torch.as_tensor(ints).to(device), torch.as_tensor(floats).to(device))


def _solve_on_card(ps, state, ints, floats, plan=None):
    """One kernel launch on copies of the inputs on the card: the kernel
    the wrapper plans, or ``plan``'s (a slot plan takes a slot stream).
    Returns (assignments, final state, the kernel that ran)."""
    kernel = solve_mod.solve_kernel
    a = on("cuda", ps, state, ints, floats)
    before = dict(kernel.counts)
    if plan is None:
        got = kernel(PARAMS, *a)
    else:
        kernel.check(*a, slots=plan.kernel == "slots")
        got = kernel.launch(PARAMS, *a, plan)
    torch.cuda.synchronize()
    ran = [k for k in kernel.counts if kernel.counts[k] != before[k]]
    check(len(ran) == 1, "one kernel launch")
    return got, a[1], ran[0]


def compare_kernel_plain(name, ps, state, ints, floats, plan=None):
    """The planned kernel (or ``plan``'s), the wide kernel and the plain
    version on the card, on the same inputs (the state planes copied for
    each). Returns ({kernel: largest absolute difference over
    assignments and final planes}, the planned kernel's final state)."""
    b = on("cuda", ps, state, ints, floats)
    want = solve_mod.solve_plain(PARAMS, *b)
    torch.cuda.synchronize()
    errs, final = {}, None
    n = ps.ints.shape[1]
    runs = [plan, solve_mod.solve_kernel.wide_plan(ps)]
    for i, p in enumerate(runs):
        got, st, ran = _solve_on_card(ps, state, ints, floats, p)
        err = max(int((got - want).abs().max()), int((st - b[1]).abs().max()))
        errs[ran] = max(errs.get(ran, 0), err)
        final = st if i == 0 else final
        check(err == 0, f"{ran} kernel equals plain on {name}")
    planned = plan or solve_mod.solve_kernel.plan(ps)
    log(f"  {name}: N={n} B={ints.shape[0]} SC={ps.sc} T={ps.t} U={ps.u} "
        f"SV={ps.sv} placed={int((want >= 0).sum())} "
        f"kernel={planned.kernel} "
        f"cluster={planned.cluster}x{planned.cols_per_block} cols "
        f"max_abs_err " + " ".join(f"{k}={v}" for k, v in errs.items()))
    return errs, final


def dense_from_slots(ps: PStatic, ints, floats):
    """The dense pod stream a slot stream was packed from (the pack loses
    nothing when it succeeds): base | match_by[T] | own_aff[T] |
    own_anti[T], and the weights [B, T]. Arrays on the CPU."""
    rows, w = np.asarray(ints.cpu()), np.asarray(floats.cpu())
    b, t, c = rows.shape[0], ps.t, ps.r + 4 + 2 * ps.sc
    idx, fl = rows[:, c:c + SPARSE_K], rows[:, c + SPARSE_K:]
    dense = np.zeros((b, c + 3 * t), dtype=np.int32)
    dense[:, :c] = rows[:, :c]
    dense_w = np.zeros((b, t), dtype=np.float32)
    pod = np.repeat(np.arange(b), SPARSE_K).reshape(b, SPARSE_K)
    active = (fl != 0) | (w != 0)
    for bit in range(3):
        on_bit = active & (((fl >> bit) & 1) > 0)
        dense[pod[on_bit], c + bit * t + idx[on_bit]] = 1
    dense_w[pod[active], idx[active]] = w[active]
    return torch.from_numpy(dense), torch.from_numpy(dense_w)


def _err(a, b, sa, sb):
    """The largest absolute difference over assignments (none at B = 0)
    and final planes."""
    return max(int((a.cpu() - b.cpu()).abs().max()) if a.numel() else 0,
               int((sa.cpu() - sb.cpu()).abs().max()))


def compare_slots_plain(name, ps, state, ints, floats, plan=None):
    """The slot kernel (the wrapper's slot plan, or ``plan``) on the slot
    stream packed from the dense (ints, floats); the plain slot solve and
    the dense plain solve on the card; the wide kernel on the dense
    stream. All must agree on assignments and final planes. Returns
    ({kernel: largest absolute difference}, the slot kernel's final
    state)."""
    kernel = solve_mod.solve_kernel
    stream = slot_stream(np.asarray(torch.as_tensor(ints)),
                         np.asarray(torch.as_tensor(floats)), ps.r, ps.sc,
                         ps.t)
    check(stream is not None, f"{name} packs into slots")
    sints, sfloats = (torch.from_numpy(a) for a in stream)
    b = on("cuda", ps, state, sints, sfloats)
    want = solve_mod.solve_plain_slots(PARAMS, *b)
    d = on("cuda", ps, state, ints, floats)
    dense = solve_mod.solve_plain(PARAMS, *d)
    torch.cuda.synchronize()
    check(_err(want, dense, b[1], d[1]) == 0,
          f"plain slot solve equals the dense plain solve on {name}")
    plan = plan or kernel.slots_plan(ps)
    got, st, ran = _solve_on_card(ps, state, sints, sfloats, plan)
    check(ran == "slots", f"{name} ran the slot kernel")
    errs = {ran: _err(got, want, st, b[1])}
    check(errs[ran] == 0, f"slot kernel equals plain on {name}")
    got_w, st_w, ran = _solve_on_card(ps, state, ints, floats,
                                      kernel.wide_plan(ps))
    errs[ran] = _err(got_w, want, st_w, b[1])
    check(errs[ran] == 0, f"wide kernel equals plain on {name}")
    log(f"  {name}: N={ps.ints.shape[1]} B={sints.shape[0]} SC={ps.sc} "
        f"T={ps.t} U={ps.u} placed={int((want >= 0).sum())} slot kernel "
        f"cluster={plan.cluster}x{plan.cols_per_block} cols, "
        f"{plan.smem_bytes} B a block; max_abs_err "
        + " ".join(f"{k}={v}" for k, v in errs.items()))
    return errs, st


def slot_cases():
    """Seeded slot problems: (name, (planes, state, dense pod ints, pod
    floats), a forced slot plan or None)."""
    out = [("slots-anti-5120", random_slot_planes(20, 5120, 256, 100,
                                                  real=5000), None),
           ("slots-t50-5120", random_slot_planes(21, 5120, 128, 50, sc=2,
                                                 u=2), None),
           ("slots-ragged-1408", random_slot_planes(22, 1408, 96, 40, sc=2,
                                                    u=2, real=1400), None),
           ("slots-t16-1024", random_slot_planes(23, 1024, 64, 16, sc=3,
                                                 u=3, real=1000), None)]
    check(solve_mod.plan_launch(1024, 3, 3, 16, 3, packs=True).kernel
          == "cluster", "slots-t16-1024 is a shape the cluster kernel takes")
    out.append(("slots-portable-8", random_slot_planes(24, 5120, 96, 100,
                                                       sc=2, u=2),
                solve_mod.slots_candidate(5120, 3, 2, 100, 2,
                                          max_cluster=8)))
    return out


def phase_compare():
    errs = {"cluster": 0, "slots": 0, "wide": 0, "sharded": 0, "counts": 0}

    def keep(result):
        for k, v in result[0].items():
            errs[k] = max(errs[k], v)
        return result[1]

    rng = np.random.default_rng(0)
    cases = [("mixed-64", 64, 96, 4, 3), ("groups-64", 64, 96, 6, 5),
             ("wide-128", 128, 120, 12, 9)]
    for name, n, b, groups, profiles in cases:
        cluster, batch = encode(make_nodes(rng, n),
                                make_pods(rng, b, groups, profiles), 128)
        ps, state = prepare(cluster, batch, "cpu")
        ints, floats = pack_podin(batch)
        keep(compare_kernel_plain(name, ps, state, ints, floats))
        if name == "wide-128":
            check(ps.sc > 8 and ps.t > 8, "wide case is wider than eight")
    # identical nodes and pods: forced ties
    nodes = [workloads.node_template(i) for i in range(40)]
    cluster, batch = encode(nodes, [workloads.basic_pod(i)
                                    for i in range(300)], 304)
    ps, state = prepare(cluster, batch, "cpu")
    keep(compare_kernel_plain("ties-40", ps, state, *pack_podin(batch)))
    # two batches carrying the state: the second starts from the first's
    # final planes
    nodes = make_nodes(rng, 64)
    cluster, batch = encode(nodes, make_pods(rng, 64, 4, 3), 64)
    ps, state = prepare(cluster, batch, "cpu")
    ints, floats = pack_podin(batch)
    half = np.zeros_like(ints), np.zeros_like(floats)
    half[0][:32], half[1][:32] = ints[:32], floats[:32]
    carried = keep(compare_kernel_plain("carry-1", ps, state, *half))
    rest = np.zeros_like(ints), np.zeros_like(floats)
    rest[0][:32], rest[1][:32] = ints[32:], floats[32:]
    keep(compare_kernel_plain("carry-2", ps, carried.cpu(), *rest))
    # the headline width with a wide constraint space
    cluster, batch = encode(make_nodes(rng, 5000),
                            make_pods(rng, 512, 8, 16, prefix="h"), 512)
    ps, state = prepare(cluster, batch, "cpu")
    check(ps.ints.shape[1] == 5120, "headline width pads to 5120 columns")
    check(max(ps.sc, ps.t, ps.u) > 8, "headline case wider than eight")
    keep(compare_kernel_plain("headline-5120x512", ps, state,
                              *pack_podin(batch)))
    for name, args, plan, want in planes_cases():
        ran = (plan or solve_mod.solve_kernel.plan(args[0])).kernel
        check(ran == want, f"{name} plans the {want} kernel")
        keep(compare_kernel_plain(name, *args, plan=plan))
    for name, args, plan in slot_cases():
        keep(compare_slots_plain(name, *args, plan=plan))
    # two slot batches carrying the state
    ps, state, ints, floats = random_slot_planes(27, 5120, 128, 100, sc=2,
                                                 u=2)
    carried = keep(compare_slots_plain("slots-carry-1", ps, state,
                                       ints[:64], floats[:64]))
    keep(compare_slots_plain("slots-carry-2", ps, carried.cpu(),
                             ints[64:].clone(), floats[64:].clone()))
    # two shared-volume batches carrying the state (attached bits too)
    ps, state, ints, floats = random_planes(35, 2048, 256, r=4, sc=2, t=2,
                                            u=2, sv=32)
    carried = keep(compare_kernel_plain("sv-carry-1", ps, state, ints[:128],
                                        floats[:128]))
    keep(compare_kernel_plain("sv-carry-2", ps, carried.cpu(),
                              ints[128:].clone(), floats[128:].clone()))
    for name, args, plan in wide_cases():
        errs["wide"] = max(errs["wide"], compare_wide(name, *args, plan=plan))
    for name, args in sharded_cases():
        err, counts_err = compare_sharded(name, *args)
        errs["sharded"] = max(errs["sharded"], err)
        errs["counts"] = max(errs["counts"], counts_err)
    return errs


def planes_cases():
    """Seeded cases made in the planes layout: (name, (planes, state,
    pod ints, pod floats), a forced launch plan or None, the kernel that
    must run)."""
    out = [("ragged-1408", random_planes(3, 1408, 96, sc=2, t=2, u=2,
                                         real=1400), None, "cluster")]
    ps, state, ints, floats = random_planes(4, 5120, 40)
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    do, _ = state_planes(ps.r, ps.sc, ps.t)
    ps.ints[so["masks"]:so["masks"] + ps.u] = 0
    ps.ints[so["masks"]:so["masks"] + ps.u, 5100] = 1
    ps.ints[so["alloc"]:so["alloc"] + ps.r, 5100] = 10 ** 7
    ps.ints[so["max_pods"], 5100] = 1000
    state[do["requested"]:do["pod_count"] + 1, 5100] = 0
    ints[:, ps.r + 4:] = 0
    out.append(("only-last-slice", (ps, state, ints, floats), None,
                "cluster"))
    ps, state, ints, floats = random_planes(5, 5120, 64)
    for planes in (ps.ints, ps.f32s, state):
        planes[:] = planes[:, :1].clone()
    ps.ints[so["node_valid"], :330] = 0
    ints[:, ps.r + 4:] = 0
    floats[:] = 0
    out.append(("ties-across-slices", (ps, state, ints, floats), None,
                "cluster"))
    out.append(("wide16-5120", random_planes(6, 5120, 128, sc=16, t=16,
                                             u=16, real=5000), None,
                "cluster"))
    out.append(("portable-8", random_planes(9, 5120, 96, sc=2, t=2, u=2),
                solve_mod.plan_launch(5120, 3, 2, 2, 2, max_cluster=8),
                "cluster"))
    out.append(("past-budget", random_planes(8, 5120, 32, sc=40, t=40, u=2),
                None, "wide"))
    # the shared-volume attach planes (the last resource an attach
    # column): both dense kernels carry them
    out += [
        ("sv8-1024", random_planes(30, 1024, 256, r=4, sc=2, t=2, u=2,
                                   real=1000, sv=8), None, "cluster"),
        ("sv64-5120", random_planes(31, 5120, 256, r=4, real=5000, sv=64),
         None, "cluster"),
        ("sv512-1024x1024", random_planes(32, 1024, 1024, r=4, real=1000,
                                          sv=512), None, "cluster"),
        ("sv16-portable-8", random_planes(33, 5120, 96, r=4, sc=2, t=2, u=2,
                                          sv=16),
         solve_mod.plan_launch(5120, 4, 2, 2, 2, max_cluster=8, sv=16),
         "cluster"),
        ("sv8-past-budget", random_planes(34, 5120, 32, r=4, sc=40, t=40,
                                          u=2, sv=8), None, "wide")]
    # T = 100 with one pod of nine term references: the batch does not
    # pack, so the dense stream runs on the wide kernel
    ps, state, ints, floats = random_slot_planes(25, 5120, 64, 100)
    ints[3, ps.r + 4 + 2 * ps.sc:ps.r + 4 + 2 * ps.sc + 9] = 1
    check(slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc, ps.t)
          is None, "the nine-reference batch does not pack")
    out.append(("nine-refs-t100", (ps, state, ints, floats), None, "wide"))
    return out


def _term_refs(ints, floats, ps: PStatic, pod, refs, rng):
    """Pod row ``pod`` of a dense stream rewritten to reference exactly
    ``refs`` terms: each matched, required-affinity, anti-affinity or
    weighted (both signs), at least one of them."""
    c, t = ps.r + 4 + 2 * ps.sc, ps.t
    ints[pod, c:c + 3 * t] = 0
    floats[pod] = 0
    for k in rng.choice(t, refs, replace=False):
        kind = int(rng.integers(4))
        if kind < 3:
            ints[pod, c + kind * t + k] = 1
        else:
            floats[pod, k] = float(rng.choice([-3.0, 1.0, 2.0, 7.0]))


def _fewer_affinities(case):
    """A ``random_planes`` case with required affinity kept on every
    eighth pod only (about five affinity terms a pod leave few pods a
    node): most pods place, so commits and attachments run."""
    ps, state, ints, floats = case
    c = ps.r + 4 + 2 * ps.sc + ps.t
    keep = torch.arange(ints.shape[0]) % 8 == 0
    ints[~keep, c:c + ps.t] = 0
    return ps, state, ints, floats


def wide_cases():
    """The wide kernel's hazards: (name, (planes, state, pod ints, pod
    floats), a forced wide plan or None). Every case runs on the wide
    kernel."""
    rng = np.random.default_rng(60)
    out = []
    ps, state, ints, floats = _fewer_affinities(random_planes(
        61, 5120, 100, sc=2, t=100, u=2, real=5000))
    for chunk in (1, 7, 0):   # a buffer refilled every pod; past the end;
        out.append((f"wide-chunk{chunk}", (ps, state, ints, floats),
                    solve_mod.wide_candidate(5120, ps.r, ps.sc, ps.t, ps.u,
                                             chunk=chunk)))
    out.append(("wide-b0", (ps, state, ints[:0].clone(), floats[:0].clone()),
                None))
    pad = ints.clone()
    pad[:, ps.r + 3] = 0
    out.append(("wide-all-padding", (ps, state, pad, floats), None))
    # pods with no constraint and no term (empty fact lists), and pods of
    # 9 and 13 term references, in one batch
    ps, state, ints, floats = random_slot_planes(62, 5120, 96, 100, sc=2,
                                                 u=2)
    c = ps.r + 4 + 2 * ps.sc
    for pod in range(0, 96, 3):
        ints[pod, ps.r + 4:c + 3 * ps.t] = 0
        floats[pod] = 0
    for pod in range(1, 96, 6):
        _term_refs(ints, floats, ps, pod, 9, rng)
    for pod in range(4, 96, 6):
        _term_refs(ints, floats, ps, pod, 13, rng)
    check(slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc, ps.t)
          is None, "the 9- and 13-reference batch does not pack")
    out.append(("wide-empty-9-13-refs", (ps, state, ints, floats), None))
    # many pods through the exchange slots, hard spread mixed in
    ps, state, ints, floats = _fewer_affinities(random_planes(
        63, 5120, 512, sc=3, t=64, u=2))
    ps.sc_meta[1] = 1
    out.append(("wide-parity-512", (ps, state, ints, floats), None))
    out.append(("wide-ragged-1408", _fewer_affinities(random_planes(
        64, 1408, 128, sc=2, t=100, u=2, real=1400)), None))
    ps, state, ints, floats = random_planes(65, 65536, 128, sc=2, t=1, u=2,
                                            real=65000)
    ps.sc_meta[1] = 1
    out.append(("wide-65536-hard", (ps, state, ints, floats), None))
    out.append(("wide-65536-sv8", random_planes(66, 65536, 128, r=4,
                                                real=65000, sv=8), None))
    out.append(("wide-t4096", random_planes(67, 5120, 16, t=4096,
                                            real=5000), None))
    for seed, sv in ((70, 8), (71, 16), (72, 64), (73, 512)):
        out.append((f"wide-sv{sv}-t100", _fewer_affinities(random_planes(
            seed, 1024, 256, r=4, sc=2, t=100, u=2, real=1000, sv=sv)),
            None))
    return out


def compare_wide(name, ps, state, ints, floats, plan=None, repeats=5):
    """The wide kernel (the wrapper's plan, which must be the wide
    kernel's, or ``plan``) launched ``repeats`` times on fresh copies of
    the inputs, each result equal to the plain version's on the card
    (a race would show as a difference). Returns the largest absolute
    difference."""
    b = on("cuda", ps, state, ints, floats)
    want = solve_mod.solve_plain(PARAMS, *b)
    torch.cuda.synchronize()
    planned = plan or solve_mod.solve_kernel.plan(ps)
    check(planned.kernel == "wide", f"{name} plans the wide kernel")
    worst = 0
    for _ in range(repeats):
        got, st, ran = _solve_on_card(ps, state, ints, floats, plan)
        check(ran == "wide", f"{name} ran the wide kernel")
        err = _err(got, want, st, b[1])
        worst = max(worst, err)
        check(err == 0, f"wide kernel equals plain on {name}")
    slices = solve_mod.wide_slices(planned, ps.r, ps.sc, ps.t, ps.u, ps.sv)
    log(f"  {name}: N={ps.ints.shape[1]} B={ints.shape[0]} SC={ps.sc} "
        f"T={ps.t} U={ps.u} SV={ps.sv} placed={int((want >= 0).sum())} "
        f"wide cluster={planned.cluster}x{planned.cols_per_block} cols "
        f"chunk={planned.chunk} slices "
        f"{'in shared memory' if slices else 'at L2'}, "
        f"{planned.smem_bytes} B a block; {repeats} launches, max_abs_err "
        f"{worst}")
    return worst


# ----------------------------------------------------------------------
# the sharded tier's kernels against their plain versions
def sharded_on_card(ps: PStatic, state, shards):
    """Planes on the CPU as sharded planes on the card (``shard_planes``:
    each profile's domain existence from the planes, as the single card's
    rule)."""
    ss, st = sharded_mod.shard_planes(ps, state, shards)
    return (ss._replace(sc_meta=ss.sc_meta.cuda(), ints=ss.ints.cuda(),
                        f32s=ss.f32s.cuda(), has_dom=ss.has_dom.cuda()),
            SState(st.planes.cuda(), st.totals.cuda()))


def sharded_cases():
    """Seeded problems for the sharded kernel: (name, (planes, state, pod
    ints, pod floats)) on the CPU: a hard spread constraint and none,
    SV = 64, T = 100 on the dense stream, and identical nodes and pods
    (every score ties, across the shards' boundaries too)."""
    out = []
    for name, seed, hard in (("sharded-hard-2048", 50, 1),
                             ("sharded-soft-2048", 51, 0)):
        case = random_planes(seed, 2048, 512, sc=2, t=3, u=2, real=2000)
        case[0].sc_meta[1] = hard
        out.append((name, case))
    out.append(("sharded-sv64-1024", random_planes(
        52, 1024, 512, r=4, sc=2, t=2, u=2, sv=64)))
    out.append(("sharded-t100-5120", _fewer_affinities(random_planes(
        53, 5120, 256, t=100))))
    nodes = [workloads.node_template(i) for i in range(300)]
    cluster, batch = encode(nodes, [workloads.basic_pod(i)
                                    for i in range(400)], 512)
    ps, state = prepare(cluster, batch, "cpu")
    out.append(("sharded-ties-512", (ps, state, *(
        torch.from_numpy(a) for a in pack_podin(batch)))))
    return out


def compare_sharded(name, ps, state, ints, floats, widths=(1, 2, 4, 8)):
    """The sharded kernel at each mesh width against its plain version on
    the card and against the single-card kernel the wrapper plans on the
    same problem: assignments, planes (all but the totals row, which the
    sharded solve leaves as found) and each shard's totals (against the
    single card's totals row); the counts kernel against its plain
    version on 1 x S and 2 x S meshes. Eight shards only where the card
    holds eight clusters at once. Returns the largest absolute
    differences (sharded, counts)."""
    kernel = solve_mod.solve_kernel
    single, single_state, ran = _solve_on_card(ps, state, ints, floats)
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    rows = [i for i in range(single_state.shape[0]) if i != do["totals"]]
    ints_c, floats_c = ints.cuda(), floats.cuda()
    worst = worst_counts = 0
    for s in widths:
        ss, st = sharded_on_card(ps, state, s)
        try:
            plan = kernel.sharded_plan(ss, s)
        except RuntimeError as e:
            check(s == 8, f"{name}: {s} clusters co-reside ({e})")
            log(f"  {name}: S=8 skipped, the card holds no eight such "
                f"clusters at once ({e})")
            continue
        plain_st = SState(st.planes.clone(), st.totals.clone())
        want = sharded_mod.solve_sharded_plain(PARAMS, ss, plain_st, ints_c,
                                               floats_c)
        got, word = kernel.launch_sharded(PARAMS, ss, st.planes, st.totals,
                                          ints_c, floats_c, plan)
        torch.cuda.synchronize()
        check(int(word[0]) == 0, f"{name}: the exchange at S={s} ran out")
        err = max(_err(got, want, st.planes, plain_st.planes),
                  int((st.totals - plain_st.totals).abs().max()))
        check(err == 0, f"sharded kernel equals plain on {name} at S={s}")
        same = (torch.equal(got, single)
                and torch.equal(st.planes[rows], single_state[rows])
                and all(torch.equal(st.totals[q],
                                    single_state[do["totals"], :ps.t])
                        for q in range(s)))
        check(same, f"sharded kernel at S={s} equals the {ran} kernel on "
              f"{name}")
        for axis in (1, 2):
            c = kernel.launch_counts(ss, ints_c, s, axis)
            w = sharded_mod.feasible_counts_plain(ss, ints_c, s, axis)
            e = int((c - w).abs().max()) if len(c) else 0
            worst_counts = max(worst_counts, e)
            check(e == 0, f"counts kernel equals plain on {name} at "
                  f"{axis} x {s}")
        worst = max(worst, err)
        log(f"  {name}: N={ps.ints.shape[1]} B={ints.shape[0]} SC={ps.sc} "
            f"T={ps.t} SV={ps.sv} hard={ss.any_hard} S={s}: "
            f"{plan.cluster} blocks x {plan.cols_per_block} columns a "
            f"shard, chunk {plan.chunk}; placed {int((want >= 0).sum())}; "
            f"equal to plain and to the {ran} kernel; counts equal")
    return worst, worst_counts


# ----------------------------------------------------------------------
class _Recorder:
    """Stands in for the kernel wrapper during a run: CUDA events around
    each launch and, with ``keep``, copies of each launch's inputs, taken
    on the stream without waiting for it; with ``keep="all"`` also the
    static planes, the parameters and each launch's outputs (assignments
    and final state), so every launch can be held against the plain
    version after the run. The launch, and its count, stay the
    wrapper's."""

    def __init__(self, kernel, keep=False):
        self.kernel = kernel
        self.keep = keep
        self.events = []
        self.inputs = []
        self.slots = []     # per kept launch: a slot stream or not
        self.params = []    # with keep="all": each launch's parameters
        self.outputs = []   # with keep="all": (assignments, final state)
        # one launch's records go into the lists together: replicas on
        # threads of their own launch at once
        self._lock = threading.Lock()

    def __getattr__(self, name):   # plan, slots_plan: the wrapper's
        return getattr(self.kernel, name)

    def __call__(self, params, ps, state, ints, floats, **kw):
        kept = None
        if self.keep:
            kept_ps = ps
            if self.keep == "all":
                kept_ps = ps._replace(ints=ps.ints.clone(),
                                      f32s=ps.f32s.clone(),
                                      sc_meta=ps.sc_meta.clone())
            kept = (kept_ps, state.clone(), ints.clone(), floats.clone())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.kernel(params, ps, state, ints, floats, **kw)
        end.record()
        outputs = (out.clone(), state.clone()) if self.keep == "all" \
            else None
        with self._lock:
            self.events.append((start, end))
            if kept is not None:
                self.inputs.append(kept)
                self.slots.append(kw.get("slots", False))
            if outputs is not None:
                self.params.append(params)
                self.outputs.append(outputs)
        return out

    def kernel_ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def largest(self, slots=False):
        """The kept inputs of the launch with the most valid pods, among
        the slot-stream launches with ``slots``, else the dense ones."""
        kept = [i for i, s in zip(self.inputs, self.slots) if s == slots]
        valid = [int((i[2][:, i[0].r + 3] > 0).sum()) for i in kept]
        return kept[int(np.argmax(valid))]


class _Dispatches:
    """While entered: every ``CudaPlanesBackend.solve_lazy`` call's host
    wall time and the cyclic GC's pauses inside it, the waits its
    staging ring made for a buffer still in use, whether its event still
    reported the card busy right after it returned, and whether it ran
    inside a warmup."""

    def __init__(self):
        self.calls = []
        self._warming = False
        self._gc_s = 0.0
        self._gc_t0 = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._gc_s += time.perf_counter() - self._gc_t0

    def __enter__(self):
        self._solve = CudaPlanesBackend.solve_lazy
        self._warmup = BatchScheduler.warmup
        real_solve, real_warmup = self._solve, self._warmup

        def solve_lazy(backend, *args):
            waits = backend.staging.waits
            gc_s = self._gc_s
            t0 = time.perf_counter()
            handle = real_solve(backend, *args)
            wall = (time.perf_counter() - t0) * 1000
            busy = handle.event is not None and not handle.event.query()
            self.calls.append({
                "wall_ms": wall, "gc_ms": (self._gc_s - gc_s) * 1000,
                "busy": busy, "warming": self._warming,
                "ring_waits": backend.staging.waits - waits})
            return handle

        def warmup(bs, pods):
            self._warming = True
            try:
                return real_warmup(bs, pods)
            finally:
                self._warming = False

        CudaPlanesBackend.solve_lazy = solve_lazy
        BatchScheduler.warmup = warmup
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        CudaPlanesBackend.solve_lazy = self._solve
        BatchScheduler.warmup = self._warmup
        gc.callbacks.remove(self._on_gc)


# main-path launches of each kernel
LAUNCHES = {"cluster": 0, "slots": 0, "wide": 0, "sharded": 0,
            "counts": 0, "scan": 0}


def run_path(name, run, keep=False, kernel="cluster", cold=False,
             sharded_kept=False):
    """``run()`` on the card with the kernels' launch counts reset just
    before and read just after, the plain version trapped, each launch
    timed with CUDA events and each dispatch with the host clock. Every
    launch must be ``kernel``'s (None: the caller checks the launch plan
    of each). With ``cold`` (a row whose every cycle follows its warm-up)
    no kernel instance counts as launched and the pinned staging ring is
    empty: the warm-up must book each first launch and allocation, or a
    measured cycle does, and ``row_report`` fails it. ``sharded_kept``:
    the caller keeps the sharded kernel's launches, which pass the
    recorder and the single-card dispatch (``held_run``). Returns (run's
    result, counts, kernel ms per launch, dispatches, the recorder, wall
    seconds)."""
    plain_calls = []
    real_plain, real_kernel = solve_mod.solve_plain, solve_mod.solve_kernel
    recorder = _Recorder(real_kernel, keep)

    def trapped_plain(*args):
        plain_calls.append(1)
        return real_plain(*args)

    solve_mod.solve_plain, solve_mod.solve_kernel = trapped_plain, recorder
    real_kernel.reset_counts()
    if cold:
        real_kernel.launched.clear()
        solve_mod.STAGING.clear()
    try:
        with _Dispatches() as dispatches:
            t0 = time.monotonic()
            out = run()
            wall = time.monotonic() - t0
    finally:
        counts = dict(real_kernel.counts)
        solve_mod.solve_plain, solve_mod.solve_kernel = real_plain, real_kernel
    for k in counts:
        LAUNCHES[k] += counts[k]
    kernel_ms = recorder.kernel_ms()
    if kernel is not None:
        check(counts[kernel] > 0, f"{name}: the {kernel} kernel launched")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{name}: other kernels launched: {others}")
    check(not plain_calls, f"{name}: plain version called on the card")
    single = sum(v for k, v in counts.items()
                 if not (sharded_kept and k == "sharded"))
    check(len(kernel_ms) == single == len(dispatches.calls),
          f"{name}: one timed launch and one dispatch per launch")
    return out, counts, kernel_ms, dispatches.calls, recorder, wall


# state-only rebuilds checked against a fresh prepare, over the script
STATE_ONLY = {"checked": 0, "equal": 0}


def trap_state_only(bs, limit=2):
    """Wrap the session backend's ``prepare_state_only``: at each of the
    first ``limit`` state-only rebuilds the resident static planes must
    equal those ``prepare`` builds from the same encoding, bit for bit
    (the fresh planes go straight to the card, outside the backend's
    byte counts)."""
    session, backend = bs.session, bs.session.backend
    real = backend.prepare_state_only
    seen = [0]

    def prepare_state_only(cluster, batch):
        state = real(cluster, batch)
        if seen[0] < limit:
            seen[0] += 1
            fresh, _ = prepare(cluster, batch, backend.device)
            ps = session._static
            same = (ps[3:] == fresh[3:] and all(
                torch.equal(a, b) for a, b in zip(ps[:3], fresh[:3])))
            STATE_ONLY["checked"] += 1
            STATE_ONLY["equal"] += same
            check(same, "state-only rebuild: the resident static planes "
                  "equal a fresh prepare's")
        return state

    backend.prepare_state_only = prepare_state_only


def rebuild_report(name, res):
    """The row's rebuilds by kind from its profiled cycles, the warm-up's
    apart: count and h2d bytes each (the pod stream included), logged and
    returned. With the profiler on, the measured state-only rebuilds
    equal the session's count."""
    kinds = {}
    dp = get_devprof()
    for rec in dp.cycles(include_warming=True):
        if rec["rebuild"] != "none":
            kind = rec["rebuild"] + (" (warm-up)" if rec["warming"] else "")
            k = kinds.setdefault(kind, {"n": 0, "h2d_bytes": 0})
            k["n"] += 1
            k["h2d_bytes"] += rec["h2d_bytes"]
    if dp.enabled:
        check(kinds.get("state_only", {}).get("n", 0)
              == res.state_only_rebuilds,
              f"{name}: profiled state-only rebuilds equal the session's")
    log(f"    rebuilds {res.rebuilds}, state-only {res.state_only_rebuilds}; "
        + ", ".join(f"{k}: {v['n']} x {v['h2d_bytes'] / max(v['n'], 1):.0f} "
                    f"h2d bytes" for k, v in sorted(kinds.items())))
    return {"rebuilds": res.rebuilds,
            "state_only_rebuilds": res.state_only_rebuilds,
            "by_kind": kinds}


def run_main_path(name, nodes, pods, max_batch=4096):
    """One workload on the card through run_workload (default arms:
    pipelined, mirror on), cold (``run_path``). Every pod bound, the
    cluster kernel launched once per solve."""
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.make_workload(name, nodes, 0, pods),
            max_batch=max_batch, device="cuda", configure=trap_state_only),
        keep=True, cold=True)
    launches = counts["cluster"]
    check(res.device.startswith("cuda"), f"{name} ran on the card")
    check(len(res.placements) == pods, f"{name} created {pods} pods")
    unbound = sum(1 for v in res.placements.values() if not v)
    check(unbound == 0, f"{name}: {unbound} pods left unbound")
    check(launches == res.solves, f"{name}: cluster kernel launches "
          f"{launches} == solves {res.solves}")
    busy = sum(kernel_ms) / 1000
    log(f"  {name} {nodes} nodes / {pods} pods on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s)")
    log(f"    enqueue->bind ms p50/p90/p99: "
        + "/".join(f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90",
                                                      "Perc99"))
        + "; solve-start->bind ms p50/p90/p99: "
        + "/".join(f"{res.metrics[k]:.1f}" for k in ("Perc50", "Perc90",
                                                      "Perc99")))
    log(f"    solves={res.solves} rebuilds={res.rebuilds} launches "
        f"cluster={launches} wide={counts['wide']} kernel ms/launch "
        f"(wrapper call) mean={np.mean(kernel_ms):.3f} "
        f"max={np.max(kernel_ms):.3f} kernel busy {busy:.3f} s")
    log("    host seconds: " + ", ".join(
        f"{k}={v:.3f}" for k, v in res.seconds.items()))
    res.rebuild_kinds = rebuild_report(name, res)
    return res, counts, kernel_ms, recorder.largest()


def zone_skew(res):
    per_zone = {}
    for node in res.placements.values():
        z = int(node.split("-")[1]) % 10
        per_zone[z] = per_zone.get(z, 0) + 1
    return max(per_zone.values()) - min(per_zone.values())


def phase_small_slices():
    for name, nodes, pods in (("SchedulingBasic", 200, 1000),
                              ("TopologySpreading", 200, 600)):
        ops = workloads.make_workload(name, nodes, 0, pods)
        card = perf.run_workload(name, ops, max_batch=128, device="cuda")
        ops = workloads.make_workload(name, nodes, 0, pods)
        cpu = perf.run_workload(name, ops, max_batch=128, device="cpu")
        check(all(card.placements.values()), f"{name} small: all bound")
        check(card.placements == cpu.placements,
              f"{name} small: card and CPU place every pod alike")
        log(f"  {name} {nodes}/{pods}: card == CPU on {pods} placements")


def bound_ms(ps: PStatic, state, ints, floats):
    """Least time for one launch on these inputs: bytes (each input read
    once, each output written once) over HBM bandwidth, and the
    operations these pods need (counted per valid pod x node from their
    flags) over the f32 peak; the larger of the two. Shared-volume rows
    no valid pod references are neither read nor written."""
    n = ps.ints.shape[1]
    rows = ints.cpu().numpy()
    w = floats.cpu().numpy()
    c, t = ps.r + 4 + 2 * ps.sc, ps.t
    flags = rows[:, c:c + 3 * t] > 0
    slotted = np.zeros(rows.shape[0], dtype=bool)
    unused_sv = 0
    if ps.sv:
        slot = rows[:, c + 3 * t]
        slotted = (slot < ps.sv) & (rows[:, ps.r + 3] > 0)
        unused_sv = ps.sv - len(np.unique(slot[slotted]))
    nbytes = sum(t.numel() * t.element_size() for t in (
        ps.ints, ps.f32s, ps.sc_meta, ints, floats)) \
        + 2 * (state.numel() - unused_sv * n) * state.element_size() \
        + ints.shape[0] * 4
    return _bound(ps, nbytes, rows, (w != 0).sum(1), flags.sum(1),
                  flags[:, :t].sum(1), slotted)


def bound_ms_slots(ps: PStatic, state, ints, floats):
    """``bound_ms`` for a slot stream, counting what these slots need: the
    term rows no valid pod references are neither read nor written."""
    n = ps.ints.shape[1]
    rows = ints.cpu().numpy()
    w = floats.cpu().numpy()
    c = ps.r + 4 + 2 * ps.sc
    idx, fl = rows[:, c:c + SPARSE_K], rows[:, c + SPARSE_K:]
    active = ((fl != 0) | (w != 0)) & (rows[:, ps.r + 3:ps.r + 4] > 0)
    unused = ps.t - len(np.unique(idx[active]))
    nbytes = sum(t.numel() * t.element_size() for t in (
        ps.ints, ps.f32s, ps.sc_meta, ints, floats)) - unused * n * 4 \
        + 2 * (state.numel() - 2 * unused * n) * state.element_size() \
        + ints.shape[0] * 4
    bits = [(fl >> bit) & 1 for bit in range(3)]
    return _bound(ps, nbytes, rows, (w != 0).sum(1),
                  sum(b.sum(1) for b in bits), bits[0].sum(1))


def _bound(ps: PStatic, nbytes, rows, weights, flags, matched,
           slotted=0):
    """The larger of ``nbytes`` over HBM bandwidth and the pods'
    operations over the f32 peak, from each pod's counts of preferred
    weights, term flags and matched terms, and whether it references a
    shared-volume slot."""
    n = ps.ints.shape[1]
    r, sc = ps.r, ps.sc
    hard = ps.sc_meta[1].cpu().numpy() > 0
    valid = rows[:, r + 3] > 0
    pod_sc = rows[:, r + 4:r + 4 + sc] > 0
    sc_match = rows[:, r + 4 + sc:r + 4 + 2 * sc] != 0
    per_pod = (
        3 + r                      # validity, pod count, mask, fit
        + 27                       # balanced, least, score sum, argmax
        + 5 * (pod_sc & hard).sum(1)         # domain min, skew check
        + 2 * (pod_sc & ~hard).sum(1)        # soft counts
        + 2 * (pod_sc & ~hard).any(1)        # spread score
        + 3 * weights                        # preferred weights
        + 2 * flags                          # (anti-)affinity checks
        + 2 * sc_match.sum(1)                # domain commits
        + 3 * matched                        # term commits
        + 4 * slotted                        # attach demand and fit
    )
    ops = float((per_pod * valid).sum()) * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1000
    t_ops = ops / PEAK_F32_OPS_PER_S * 1000
    log(f"  bound inputs: {nbytes} bytes -> {t_bytes:.6f} ms, {ops:.0f} "
        f"operations -> {t_ops:.6f} ms")
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def cut_columns(batch, n):
    """A batch on the first ``n`` node columns of its planes."""
    ps, state, ints, floats = batch
    cut = PStatic(ps.ints[:, :n].contiguous(), ps.f32s[:, :n].contiguous(),
                  ps.sc_meta, *ps[3:])
    return cut, state[:, :n].contiguous(), ints, floats


def _event_ms(fn, state, repeats):
    """Mean ms of ``repeats`` calls of ``fn(fresh state copy)``, CUDA
    events around each call only."""
    times = []
    for _ in range(repeats):
        st = state.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(st)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def time_batch(name, batch, repeats=10):
    """The cluster kernel and the wide kernel (forced) on one batch, in
    turns (wide, cluster, cluster, wide), each a mean over ``repeats``
    bare launches after one warm-up, with the wrapper's whole call
    (input checks included) timed beside them. The two kernels must
    agree on the batch. Returns the timings and the cluster kernel's
    (assignments, final state)."""
    kernel = solve_mod.solve_kernel
    ps, state, ints, floats = batch
    kernel.check(ps, state, ints, floats)
    plans = {"cluster": kernel.plan(ps), "wide": kernel.wide_plan(ps)}
    check(plans["cluster"].kernel == "cluster",
          f"{name} plans the cluster kernel")
    turns, finals = {}, {}
    for which in ("wide", "cluster", "cluster", "wide"):
        plan = plans[which]

        def bare(st, plan=plan):
            finals[plan.kernel] = (kernel.launch(PARAMS, ps, st, ints,
                                                 floats, plan), st)

        _event_ms(bare, state, 1)
        turns.setdefault(which, []).append(_event_ms(bare, state, repeats))
    (a, sa), (b, sb) = finals["cluster"], finals["wide"]
    err = max(int((a - b).abs().max()), int((sa - sb).abs().max()))
    check(err == 0, f"{name}: cluster kernel equals wide kernel")
    whole = _event_ms(lambda st: kernel(PARAMS, ps, st, ints, floats), state,
                      repeats)
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    valid = int((ints[:, ps.r + 3] > 0).sum())
    p = plans["cluster"]
    log(f"  {name}: N={ps.ints.shape[1]} B={ints.shape[0]} valid={valid}; "
        f"cluster of {p.cluster} x {p.cols_per_block} columns, {p.threads} "
        f"threads, {p.smem_bytes} B shared a block")
    w = plans["wide"]
    log(f"    wide ms {turns['wide'][0]:.3f} / {turns['wide'][1]:.3f};"
        f" cluster ms {turns['cluster'][0]:.3f} / {turns['cluster'][1]:.3f};"
        f" per pod cluster {ms['cluster'] / valid * 1000:.3f} us, wide "
        f"{ms['wide'] / valid * 1000:.3f} us (chunk {w.chunk}, {w.smem_bytes}"
        f" B a block); wrapper call (cluster, checks included) {whole:.3f} "
        f"ms")
    return {"n": ps.ints.shape[1], "valid_pods": valid, "ms": ms,
            "turns": turns, "wrapper_ms": whole, "err": err,
            "plan": p._asdict()}, finals["cluster"]


def cluster_sweep(name, batch, repeats=10):
    """The cluster kernel on one batch at cluster sizes 16, 8, 4 and 2
    (each plan the size rule keeps on the cluster kernel): ms per launch,
    a mean over ``repeats`` bare launches after one warm-up. Every size
    must give the same assignments and planes."""
    kernel = solve_mod.solve_kernel
    ps, state, ints, floats = batch
    kernel.check(ps, state, ints, floats)
    out, first = {}, None
    for size in (16, 8, 4, 2):
        plan = solve_mod.plan_launch(ps.ints.shape[1], ps.r, ps.sc, ps.t,
                                     ps.u, max_cluster=size)
        if plan.kernel != "cluster":
            continue
        got = {}

        def bare(st, plan=plan):
            got["a"] = (kernel.launch(PARAMS, ps, st, ints, floats, plan), st)

        _event_ms(bare, state, 1)
        out[plan.cluster] = _event_ms(bare, state, repeats)
        a, st = got["a"]
        first = first or (a, st)
        check(bool((a == first[0]).all()) and bool((st == first[1]).all()),
              f"{name}: cluster of {plan.cluster} equals the others")
    log(f"  {name}, cluster kernel ms by cluster size: " + ", ".join(
        f"{k}: {v:.3f}" for k, v in out.items()))
    return out


def plain_against(name, batch, got, kernel="cluster"):
    """One run of the plain version on the card (host clock) against the
    kernel's (assignments, final state) on the same batch. Returns (ms,
    largest absolute difference), which must be 0."""
    ps, state, ints, floats = batch
    st = state.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = solve_mod.solve_plain(PARAMS, ps, st, ints, floats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000
    err = max(int((got[0] - want).abs().max()),
              int((got[1] - st).abs().max()))
    check(err == 0, f"{kernel} kernel equals plain on the {name} batch")
    log(f"  plain version on the {name} batch {ms:.1f} ms, max_abs_err "
        f"{err}")
    return ms, err


def split_per_pod(big, small):
    """Per-pod time as a fixed cost plus a cost per column, from the same
    pods on two plane widths: (fixed us, per-column ns) per kernel."""
    out = {}
    for k in big["ms"]:
        per_col = ((big["ms"][k] - small["ms"][k]) / (big["n"] - small["n"])
                   / big["valid_pods"] * 1e6)
        fixed = big["ms"][k] / big["valid_pods"] * 1000 \
            - per_col * big["n"] / 1000
        out[k] = (fixed, per_col)
        log(f"  {k} kernel per pod: {fixed:.3f} us fixed + {per_col:.4f} ns "
            f"per column (N={small['n']} and N={big['n']})")
    return out


def print_ptxas(lib):
    """ptxas's registers, shared memory and spills of each kernel."""
    report = build.ptxas_report_path(lib).read_text().splitlines()
    for i, line in enumerate(report):
        if "Compiling entry function" in line:
            log(f"  {line.strip()}")
            for follow in report[i + 1:i + 4]:
                if "ptxas info" in follow or "bytes stack frame" in follow:
                    log(f"    {follow.strip()}")


# ----------------------------------------------------------------------
def _ms_list(xs):
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def split_slow_dispatches(run, other):
    """A phase_pipeline run's dispatches over half their kernel's time,
    as (slow, noise) lists of (index, wall ms, GC ms, kernel ms). Noise:
    the card still busy right after the dispatch, and the same dispatch
    of ``other`` (the arm's other run) under the bound. Slow: the rest."""
    slow, noise = [], []
    for i, flagged in enumerate(run["over_half_kernel"]):
        if not flagged:
            continue
        recurs = i >= len(other["over_half_kernel"]) \
            or other["over_half_kernel"][i]
        seen = (i, round(run["dispatch_ms"][i], 3),
                round(run["dispatch_gc_ms"][i], 3),
                round(run["kernel_ms"][i], 3))
        if recurs or not run["busy_after_dispatch"][i]:
            slow.append(seen)
        else:
            noise.append(seen)
    return slow, noise


def phase_pipeline(nodes=5000, pods=30000, max_batch=4096):
    """SchedulingBasic in turns: serialized, pipelined, pipelined,
    serialized. Every run binds every pod, to the same nodes; every
    dispatch returns in under half its kernel's time, and some return
    while their kernel still runs. The host clock also counts time the
    thread spent off its core on a shared host, so a dispatch over the
    bound is host noise, not a hidden wait for the card, only when its
    kernel was still running when it returned and the same dispatch in
    the arm's other run (serialized: runs 1 and 4, pipelined: 2 and 3,
    the same batches) stayed under the bound. Such dispatches are
    logged and reported."""
    runs = []
    for pipeline in (False, True, True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"SchedulingBasic {arm}"
        res, counts, kernel_ms, calls, _, wall = run_path(
            name, lambda: perf.run_workload(
                "SchedulingBasic",
                workloads.make_workload("SchedulingBasic", nodes, 0, pods),
                max_batch=max_batch, device="cuda", pipeline=pipeline),
            cold=True)
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(len(res.placements) == pods and all(res.placements.values()),
              f"{name}: every pod bound")
        check(counts["cluster"] == res.solves,
              f"{name}: one cluster launch per solve")
        measured = [(c, k) for c, k in zip(calls, kernel_ms)
                    if not c["warming"]]
        # the cyclic GC's pauses are host time, not a wait for the card
        over = [c["wall_ms"] - c["gc_ms"] > 0.5 * k for c, k in measured]
        waits = sum(c["ring_waits"] for c, _ in measured)
        check(waits == 0, f"{name}: {waits} staging buffers still in use")
        check(any(c["busy"] for c, _ in measured),
              f"{name}: every dispatch returned after its kernel ended")
        depth = (res.pipeline_info or {}).get("depth", 0)
        log(f"  {name}: {res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"enqueue->bind p99 {res.latency['Perc99']:.1f} ms; solves "
            f"{res.solves} rebuilds {res.rebuilds} carry_chained "
            f"{res.carry_chained} pipeline depth {depth}")
        log(f"    dispatch ms {_ms_list(c['wall_ms'] for c, _ in measured)}"
            f" (GC in them {_ms_list(c['gc_ms'] for c, _ in measured)}) "
            f"against kernel ms {_ms_list(k for _, k in measured)}; busy "
            f"after dispatch {[c['busy'] for c, _ in measured]}")
        log("    host s from dispatch to materialize "
            f"{_ms_list(h[0] for h in res.handoffs)}, waited "
            f"{_ms_list(h[1] for h in res.handoffs)}")
        log("    host seconds: " + ", ".join(
            f"{k}={v:.3f}" for k, v in res.seconds.items()))
        runs.append({
            "arm": arm, "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency,
            "solve_to_bind_ms": res.metrics, "solves": res.solves,
            "rebuilds": res.rebuilds, "carry_chained": res.carry_chained,
            "pipeline_depth_max": depth, "handoffs_s": res.handoffs,
            "dispatch_ms": [c["wall_ms"] for c, _ in measured],
            "dispatch_gc_ms": [c["gc_ms"] for c, _ in measured],
            "kernel_ms": [k for _, k in measured],
            "busy_after_dispatch": [c["busy"] for c, _ in measured],
            "over_half_kernel": over,
            "host_seconds": res.seconds, "placements": res.placements})
    for r, other in zip(runs, runs[::-1]):
        slow, noise = split_slow_dispatches(r, other)
        check(not slow, f"SchedulingBasic {r['arm']}: dispatches over half "
              f"their kernel's time with the card idle after them or in "
              f"both runs of the arm (a hidden wait for the card; index, "
              f"wall ms, GC ms, kernel ms): {slow}")
        if noise:
            log(f"  SchedulingBasic {r['arm']}: host noise, dispatches over "
                f"half their kernel's time in this run alone, the card busy "
                f"after each (index, wall ms, GC ms, kernel ms): {noise}")
        r["host_noise"] = noise
    first = runs[0].pop("placements")
    for r in runs[1:]:
        check(r.pop("placements") == first,
              f"{r['arm']} run binds like the first serialized run")
    log(f"  all four runs bound the same {len(first)} pods to the same "
        "nodes")
    return runs


def scatter_bound_ms(kind, entries):
    """The least time of one scatter of ``entries`` (row, column, value)
    int32 triples: the triples read once, each target cell read and
    written once (an add) or written once (a set), over the card's
    memory rate."""
    nbytes = entries * (12 + (8 if kind == "add" else 4))
    return nbytes / PEAK_BYTES_PER_S * 1e3


class _ScatterTimer:
    """While entered: CUDA events around each of the backend's scatters
    and each one's bound (``scatter_bound_ms``); ``ms()`` their device
    times."""

    def __enter__(self):
        self.events = {"add": [], "set": []}
        self.bounds = {"add": [], "set": []}
        self._real = {"add": CudaPlanesBackend.scatter_state_add,
                      "set": CudaPlanesBackend.scatter_static_set}

        def timed(kind):
            real = self._real[kind]

            def scatter(backend, planes, *entries):
                self.bounds[kind].append(
                    scatter_bound_ms(kind, len(entries[0])))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = real(backend, planes, *entries)
                end.record()
                self.events[kind].append((start, end))
                return out
            return scatter

        CudaPlanesBackend.scatter_state_add = timed("add")
        CudaPlanesBackend.scatter_static_set = timed("set")
        return self

    def __exit__(self, *exc):
        CudaPlanesBackend.scatter_state_add = self._real["add"]
        CudaPlanesBackend.scatter_static_set = self._real["set"]

    def ms(self):
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


def phase_churn(nodes=5000, waves=6, per_wave=5000, max_batch=4096):
    """The churn path (``workloads.churn``: bulk pod deletes and
    allocatable-only node updates after each wave, a pod deleted while a
    batch is held) with the mirror on and off: the same pods bound to
    the same nodes, none lost; the mirror-on run catches up, and after
    every catch-up its planes equal a fresh prepare from the cache."""
    sample = [Pod.from_dict(workloads.basic_pod(0))]
    real_catch_up = mirror_mod.DeviceClusterMirror.catch_up
    compared = []

    def catch_up(mirror, lo, hi):
        out = real_catch_up(mirror, lo, hi)
        if out is not None:
            sess = mirror._session
            ps, state = sess.fresh_planes(sample, 8)
            same = (torch.equal(sess._state, state)
                    and torch.equal(sess._static.ints, ps.ints)
                    and torch.equal(sess._static.f32s, ps.f32s))
            check(same, "planes after a catch-up equal a fresh prepare")
            compared.append(hi - lo)
        return out

    runs = {}
    mirror_mod.DeviceClusterMirror.catch_up = catch_up
    try:
        for mirror in (True, False):
            arm = "on" if mirror else "off"
            name = f"churn mirror {arm}"
            with _ScatterTimer() as timer:
                res, counts, kernel_ms, _, _, wall = run_path(
                    name, lambda: perf.run_workload(
                        "churn", workloads.churn(nodes, waves, per_wave,
                                                 seed=9),
                        max_batch=max_batch, device="cuda", mirror=mirror))
            scatter_ms = timer.ms()
            scatter_bounds = timer.bounds
            left = res.total_pods - res.deleted_pods
            check(len(res.placements) == left
                  and all(res.placements.values()),
                  f"{name}: every pod not deleted is bound ({left})")
            check(counts["cluster"] == res.solves,
                  f"{name}: one cluster launch per solve")
            check(res.pipeline_info["discards"] >= 1,
                  f"{name}: the held batch was discarded")
            info = res.mirror_info or {}
            if mirror:
                check(info["catch_ups"] > 0 and info["events"] > 0,
                      f"{name}: catch-ups scattered the churn")
                check(len(compared) == info["catch_ups"],
                      f"{name}: every catch-up compared")
            log(f"  {name}: {res.pods_per_second:.1f} pods/s over "
                f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
                f"{res.total_pods} created, {res.deleted_pods} deleted; "
                f"solves {res.solves} rebuilds {res.rebuilds} "
                f"discards {res.pipeline_info['discards']}")
            log(f"    mirror {info}; scatters {res.scatters}; scatter host "
                f"s {res.seconds['scatter']:.4f}; scatter device ms add "
                f"{_ms_list(scatter_ms['add'])} set "
                f"{_ms_list(scatter_ms['set'])}; bound ms add "
                f"{[f'{x:.6f}' for x in scatter_bounds['add']]} set "
                f"{[f'{x:.6f}' for x in scatter_bounds['set']]}")
            runs[arm] = {
                "pods_per_s": res.pods_per_second,
                "duration_s": res.duration_seconds, "wall_s": wall,
                "created": res.total_pods, "deleted": res.deleted_pods,
                "solves": res.solves, "rebuilds": res.rebuilds,
                "mirror": res.mirror_info, "pipeline": res.pipeline_info,
                "scatters": res.scatters, "scatter_device_ms": scatter_ms,
                "scatter_bound_ms": scatter_bounds,
                "host_seconds": res.seconds,
                "enqueue_to_bind_ms": res.latency,
                "kernel_ms": kernel_ms, "placements": res.placements}
    finally:
        mirror_mod.DeviceClusterMirror.catch_up = real_catch_up
    check(runs["on"].pop("placements") == runs["off"].pop("placements"),
          "churn: mirror on and off bind the same pods to the same nodes")
    log(f"  mirror on == off; {len(compared)} catch-ups (windows of "
        f"{compared} mutations) equal a fresh prepare")
    return runs


def phase_sustained(pods=30000, qps=5000.0, seed=14, max_batch=4096):
    """The sustained-arrival row, pipelined and serialized: no pod lost,
    every arrival injected."""
    rows = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"sustained {arm}"
        row, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: sustained.run_sustained_row(
                pods=pods, qps=qps, seed=seed, node_cpu=32,
                max_batch=max_batch, device="cuda", pipeline=pipeline))
        check(row["device"].startswith("cuda"), f"{name} ran on the card")
        check(row["lost_pods"] == 0 and row["injected"] == row["expected"]
              == pods and not row["send_errors"],
              f"{name}: {row['lost_pods']} lost, {row['injected']} of "
              f"{row['expected']} injected")
        check(counts["cluster"] == row["session"]["solves"],
              f"{name}: one cluster launch per solve")
        depth = (row["pipeline"] or {}).get("depth", 0)
        log(f"  {name}: {row['metric']}: arrival->bind p50 "
            f"{row['p50_arrival_to_bind_ms']:.1f} ms p99 "
            f"{row['p99_arrival_to_bind_ms']:.1f} ms; {row['value']:.1f} "
            f"pods/s, rate-normalized {row['rate_normalized_throughput']:.4f}"
            f"; pipeline depth {depth}; solves {row['session']['solves']} "
            f"carry_chained {row['session']['carry_chained']}; kernel busy "
            f"{sum(kernel_ms) / 1000:.3f} s of {row['wall_s']:.3f} s")
        session = row["session"]
        log(f"    rebuilds {session['rebuilds']} incremental "
            f"{session['incremental_hits']}; host seconds " + ", ".join(
                f"{k}={v:.3f}" for k, v in session["seconds"].items()))
        row["kernel_ms"] = kernel_ms
        rows[arm] = row
    return rows


def _host_split(res):
    """The host seconds of the paths behind the solve, and the batch
    path's own."""
    return (", ".join(f"{k}={v:.3f}" for k, v in res.host_paths.items())
            + "; " + ", ".join(f"{k}={v:.3f}" for k, v in res.seconds.items()))


def check_preemption_row(name, res, nodes):
    """Every measured pod bound, exactly one priority-1 pod deleted per
    measured pod, every other pod still there and bound, one pod a node.
    Returns (pod -> node map, victim names)."""
    init = {f"pod-{i}" for i in range(nodes)}
    measured = {f"pod-{nodes + i}" for i in range(nodes)}
    unbound = sorted(n for n in measured if not res.placements.get(n))
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound "
          f"({unbound[:5]})")
    victims = init - set(res.placements)
    check(len(victims) == nodes == res.victims,
          f"{name}: {len(victims)} priority-1 pods deleted ({res.victims} "
          f"gone in all) for {nodes} measured pods")
    check(set(res.placements) == measured | (init - victims)
          and all(res.placements.values()),
          f"{name}: every pod left is bound and none is lost")
    per_node = {}
    for node in res.placements.values():
        per_node[node] = per_node.get(node, 0) + 1
    check(len(per_node) == nodes and max(per_node.values()) == 1,
          f"{name}: one pod a node")
    return res.placements, victims


def phase_preemption(nodes=5000, seed=11, max_batch=4096):
    """The Preemption row in the default arms (pipelined, mirror on) and
    serialized: checked, and both arms bind alike and evict alike."""
    runs = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"Preemption {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "Preemption", workloads.preemption(nodes, nodes, nodes),
                max_batch=max_batch, device="cuda", pipeline=pipeline,
                seed=seed, configure=trap_state_only))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        placements, victims = check_preemption_row(name, res, nodes)
        rebuilds = rebuild_report(name, res)
        log(f"  {name} {nodes} nodes / {nodes} / {nodes} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"{len(victims)} victims, PostFilter runs "
            f"{res.post_filter_runs}; solves {res.solves} rebuilds "
            f"{res.rebuilds}; kernel busy {sum(kernel_ms) / 1000:.3f} s")
        log(f"    host seconds: {_host_split(res)}")
        runs[arm] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "victims": len(victims), "solves": res.solves,
            "rebuilds": rebuilds, "launches": counts,
            "post_filter_runs": res.post_filter_runs,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "enqueue_to_bind_ms": res.latency, "kernel_ms": kernel_ms,
            "placements": placements, "victim_set": victims}
    piped, serial = runs["pipelined"], runs["serialized"]
    check(piped.pop("placements") == serial.pop("placements"),
          "Preemption: both arms bind the same pods to the same nodes")
    check(piped.pop("victim_set") == serial.pop("victim_set"),
          "Preemption: both arms evict the same pods")
    log("  pipelined == serialized: bound set and victim set")
    return runs


def phase_unschedulable(nodes=5000, impossible=1000, pods=10000,
                        max_batch=4096):
    """The Unschedulable row: the measured pods bound around pods no node
    can take, which carry the FitError status of the static masks and
    never ran PostFilter."""
    name = "Unschedulable"
    res, counts, kernel_ms, _, _, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.unschedulable(nodes, impossible, pods),
            max_batch=max_batch, device="cuda"))
    check(counts["cluster"] == res.solves,
          f"{name}: cluster kernel launches {counts['cluster']} == solves "
          f"{res.solves}")
    unbound = [f"pod-{impossible + i}" for i in range(pods)
               if not res.placements.get(f"pod-{impossible + i}")]
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
    msg = (f"0/{nodes} nodes are available: {nodes} node(s) didn't satisfy "
           "the pod's node-static predicates.")
    wrong = [n for n in (f"pod-{i}" for i in range(impossible))
             if res.placements.get(n) != ""
             or res.conditions.get(n) != ("False", "Unschedulable", msg)]
    check(not wrong, f"{name}: {len(wrong)} impossible pods without the "
          f"FitError condition (first {wrong[:3]}: "
          f"{[res.conditions.get(n) for n in wrong[:3]]})")
    check(res.post_filter_runs == 0,
          f"{name}: PostFilter ran {res.post_filter_runs} times")
    log(f"  {name} {nodes} nodes, {impossible} impossible + {pods} pods on "
        f"{res.device}: {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); the "
        f"{impossible} carry \"{msg}\"; PostFilter runs 0; solves "
        f"{res.solves} rebuilds {res.rebuilds}; kernel busy "
        f"{sum(kernel_ms) / 1000:.3f} s")
    log(f"    host seconds: {_host_split(res)}")
    return {"pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "solves": res.solves, "rebuilds": res.rebuilds,
            "launches": counts, "post_filter_runs": res.post_filter_runs,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "enqueue_to_bind_ms": res.latency, "kernel_ms": kernel_ms}


def host_port_mix(nodes, pods):
    """Plain pods on 8-cpu nodes, every fifth asking for one of two host
    ports (the serial path places those)."""
    def pod(i):
        d = workloads.basic_pod(i)
        if i % 5 == 0:
            d["spec"]["containers"][0]["ports"] = [
                {"containerPort": 80, "hostPort": 8080 + (i // 5) % 2}]
        return d

    return [{"opcode": "createNodes", "count": nodes,
             "nodeTemplate": lambda i: workloads.node_template(i, cpu="8")},
            {"opcode": "createPods", "count": pods, "podTemplate": pod,
             "collectMetrics": True}]


def phase_small_rows(seed=13):
    """Small Preemption and mixed serial rows on the card and on the CPU:
    the same maps and victims."""
    rows = (("Preemption", lambda: workloads.preemption(50, 50, 50), 64),
            ("host-port mix", lambda: host_port_mix(50, 200), 64))
    for name, ops, max_batch in rows:
        card, _, _, _, _, _ = run_path(
            f"{name} small", lambda: perf.run_workload(
                name, ops(), max_batch=max_batch, device="cuda", seed=seed))
        cpu = perf.run_workload(name, ops(), max_batch=max_batch,
                                device="cpu", seed=seed)
        check(all(card.placements.values()), f"{name} small: all bound")
        check(card.placements == cpu.placements,
              f"{name} small: card and CPU place every pod alike")
        check(card.victims == cpu.victims,
              f"{name} small: card and CPU evict alike")
        log(f"  {name} small: card == CPU on {len(card.placements)} "
            f"placements, {card.victims} victims")


def phase_gang(nodes=5000, pods=30000, gang=10, max_batch=4096):
    """The GangScheduling row pipelined and serialized: checked, and both
    arms bind alike."""
    runs = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"GangScheduling {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "GangScheduling",
                workloads.gang_scheduling(nodes, 0, pods, gang_size=gang),
                max_batch=max_batch, device="cuda", pipeline=pipeline,
                configure=trap_state_only))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(len(res.placements) == pods, f"{name} created {pods} pods")
        unbound = sum(1 for v in res.placements.values() if not v)
        check(unbound == 0, f"{name}: {unbound} pods left unbound")
        whole = {}
        for pod, node in res.placements.items():
            g = int(pod.split("-")[1]) // gang
            whole[g] = whole.get(g, 0) + bool(node)
        partial = sorted(g for g, n in whole.items() if n != gang)
        check(len(whole) == pods // gang and not partial,
              f"{name}: gangs not bound whole: {partial[:5]}")
        skew = zone_skew(res)
        check(skew <= 5, f"{name}: zone skew {skew} <= 5")
        check(res.waiting_at_end == 0,
              f"{name}: {res.waiting_at_end} pods still waiting at Permit")
        check(not res.conditions, f"{name}: pods failed on the way: "
              f"{list(res.conditions.items())[:3]}")
        check(res.binding["cycles"] == pods - pods // gang
              and res.binding["errors"] == 0,
              f"{name}: binding cycles {res.binding}")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        mirror = res.mirror_info or {}
        b = res.binding
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} nodes / {pods} pods in gangs of {gang} on "
            f"{res.device}: {res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"zone skew {skew}")
        log("    enqueue->bind ms p50/p90/p99: " + "/".join(
            f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99")))
        log(f"    solves {res.solves} rebuilds {res.rebuilds} catch-ups "
            f"{mirror.get('catch_ups', 0)} discards "
            f"{(res.pipeline_info or {}).get('discards', 0)}; kernel busy "
            f"{busy:.3f} s; binding pool: {b['cycles']} cycles, "
            f"{b['wait_s']:.3f} s waiting at Permit, {b['bind_s']:.3f} s "
            f"binding (summed over cycles)")
        log(f"    host seconds: {_host_split(res)}")
        rebuilds = rebuild_report(name, res)
        runs[arm] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency,
            "solve_to_bind_ms": res.metrics, "zone_skew": skew,
            "solves": res.solves, "rebuilds": rebuilds,
            "mirror": res.mirror_info, "pipeline": res.pipeline_info,
            "launches": counts, "kernel_ms": kernel_ms,
            "kernel_busy_s": busy, "binding": b,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "placements": res.placements}
    check(runs["pipelined"].pop("placements")
          == runs["serialized"].pop("placements"),
          "GangScheduling: both arms bind the same pods to the same nodes")
    log("  pipelined == serialized: bound set")
    return runs


def planned_kernel(ps: PStatic, ints, floats, slots: bool) -> str:
    """The kernel the launch plan gives a recorded launch: a slot stream
    plans with ``packs``; a dense stream plans with ``packs`` when it
    would have packed (at T >= 12), which must not give the slot kernel,
    or the backend routed it wrongly."""
    key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u)
    packs = slots or (ps.t >= solve_mod.SPARSE_MIN_T and not ps.sv
                      and slot_stream(ints.cpu().numpy(),
                                      floats.cpu().numpy(), ps.r, ps.sc,
                                      ps.t) is not None)
    return solve_mod.plan_launch(*key, packs=packs, sv=ps.sv).kernel


def check_plans(name, counts, recorder):
    """Every recorded launch on the kernel the plan gives it; logs each
    shape's plan. Returns the plans by shape."""
    predicted = dict.fromkeys(counts, 0)
    shapes = {}
    for (ps, _, ints, floats), slots in zip(recorder.inputs,
                                             recorder.slots):
        kernel = planned_kernel(ps, ints, floats, slots)
        check(slots == (kernel == "slots"), f"{name}: a launch took the "
              f"{'slot' if slots else 'dense'} stream where the plan "
              f"gives the {kernel} kernel")
        predicted[kernel] += 1
        key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u, ps.sv)
        shapes.setdefault(key, [kernel, 0])[1] += 1
    for (n, r, sc, t, u, sv), (kernel, launches) in shapes.items():
        dense = solve_mod.cluster_candidate(n, r, sc, t, u, sv=sv)
        slots = solve_mod.slots_candidate(n, r, sc, t, u)
        log(f"  plan N={n} R={r} SC={sc} T={t} U={u} SV={sv}: {kernel} "
            f"kernel x "
            f"{launches} launches; a block needs {dense.smem_bytes} B in the "
            f"cluster layout of {dense.cluster}, {slots.smem_bytes} B in the "
            f"slot layout, against {solve_mod.SMEM_LIMIT} B")
    check(counts == predicted, f"{name}: launches {counts} == the plans' "
          f"{predicted}")
    return {str(k): v for k, v in shapes.items()}


def time_slots_batch(name, batch, repeats=10):
    """On a slot-route batch: the slot kernel and the wide kernel
    (forced, on the dense stream the slots were packed from) in turns
    (slots, wide, wide, slots), then the plain slot solve and the dense
    plain solve once each; both kernels must equal the plain versions.
    Returns the numbers."""
    kernel = solve_mod.solve_kernel
    ps, state, sints, sfloats = batch
    dints, dfloats = (a.to("cuda") for a in dense_from_slots(ps, sints,
                                                             sfloats))
    kernel.check(ps, state, sints, sfloats, slots=True)
    kernel.check(ps, state, dints, dfloats)
    plans = {"slots": kernel.slots_plan(ps), "wide": kernel.wide_plan(ps)}
    streams = {"slots": (sints, sfloats), "wide": (dints, dfloats)}
    turns, finals = {}, {}
    for which in ("slots", "wide", "wide", "slots"):
        plan, (ints, floats) = plans[which], streams[which]

        def bare(st, plan=plan, ints=ints, floats=floats):
            finals[plan.kernel] = (kernel.launch(PARAMS, ps, st, ints,
                                                 floats, plan), st)

        _event_ms(bare, state, 1)
        turns.setdefault(which, []).append(_event_ms(bare, state, repeats))
    plain = {}
    for which, fn in (("slots", solve_mod.solve_plain_slots),
                      ("wide", solve_mod.solve_plain)):
        st = state.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(PARAMS, ps, st, *streams[which])
        torch.cuda.synchronize()
        plain[which] = ((time.perf_counter() - t0) * 1000, got, st)
    errs = {k: _err(finals[k][0], plain[k][1], finals[k][1], plain[k][2])
            for k in finals}
    errs["plain"] = _err(plain["slots"][1], plain["wide"][1],
                         plain["slots"][2], plain["wide"][2])
    check(not any(errs.values()), f"{name}: both kernels and both plain "
          f"versions agree bit for bit: {errs}")
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    valid = int((sints[:, ps.r + 3] > 0).sum())
    p = plans["slots"]
    b_ms, b_by = bound_ms_slots(*batch)
    wide_bound = bound_ms(ps, state, dints, dfloats)
    log(f"  {name} largest batch: N={ps.ints.shape[1]} B={sints.shape[0]} "
        f"valid={valid} T={ps.t}; slot kernel cluster of {p.cluster} x "
        f"{p.cols_per_block} columns, {p.smem_bytes} B shared a block")
    us = {k: v / valid * 1000 for k, v in ms.items()}
    w = plans["wide"]
    log(f"    slot kernel ms {_ms_list(turns['slots'])}, {us['slots']:.3f} "
        f"us a pod; wide kernel ms {_ms_list(turns['wide'])}, "
        f"{us['wide']:.3f} us a pod (chunk {w.chunk}, {w.smem_bytes} B a "
        f"block); plain slot solve {plain['slots'][0]:.1f} ms, dense plain "
        f"{plain['wide'][0]:.1f} ms; max_abs_err {errs}; bound "
        f"{b_ms:.6f} ms ({b_by}), dense {wide_bound[0]:.6f} ms")
    return {"n": ps.ints.shape[1], "t": ps.t, "valid_pods": valid,
            "ms": ms, "turns": turns,
            "us_per_pod": us,
            "plain_ms": {k: v[0] for k, v in plain.items()},
            "err": max(errs.values()), "bound_ms": b_ms, "bound_by": b_by,
            "wide_bound_ms": wide_bound[0],
            "wide_bound_by": wide_bound[1], "plan": p._asdict(),
            "wide_plan": w._asdict()}


def phase_anti_affinity(nodes=5000, init=1000, pods=30000, colours=100,
                        max_batch=4096):
    """The SchedulingPodAntiAffinity row: checked, each launch on the
    kernel the plan gives its batch (every T = 100 batch on the slot
    kernel); then on the largest batch the slot kernel, the wide kernel
    and the plain versions, timed and held against each other. Returns
    the row and the kernel numbers."""
    name = "SchedulingPodAntiAffinity"
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.scheduling_pod_anti_affinity(nodes, init, pods),
            max_batch=max_batch, device="cuda"), keep=True, kernel=None)
    measured = [f"pod-{init + i}" for i in range(pods)]
    unbound = [n for n in measured if not res.placements.get(n)]
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
    pairs = {(res.placements[f"pod-{init + i}"], (init + i) % colours)
             for i in range(pods)}
    check(len(pairs) == pods, f"{name}: {pods - len(pairs)} nodes hold two "
          "measured pods of one colour")
    plans = check_plans(name, counts, recorder)
    wide = [slots for (ps, _, _, _), slots in zip(recorder.inputs,
                                                   recorder.slots)
            if ps.t >= colours]
    check(wide and all(wide) and counts["wide"] == 0,
          f"{name}: every T = {colours} batch ran the slot kernel "
          f"({len(wide)} batches, launches {counts})")
    busy = sum(kernel_ms) / 1000
    log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s); launches {counts}; kernel busy "
        f"{busy:.3f} s")
    log("    enqueue->bind ms p50/p90/p99: " + "/".join(
        f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99")))
    log(f"    kernel ms (wrapper call) {_ms_list(kernel_ms)}")
    log(f"    solves {res.solves} rebuilds {res.rebuilds} catch-ups "
        f"{(res.mirror_info or {}).get('catch_ups', 0)}; host seconds: "
        f"{_host_split(res)}")
    timed = time_slots_batch(name, recorder.largest(slots=True))
    return {
        "pods_per_s": res.pods_per_second,
        "duration_s": res.duration_seconds, "wall_s": wall,
        "enqueue_to_bind_ms": res.latency, "solve_to_bind_ms": res.metrics,
        "solves": res.solves, "rebuilds": res.rebuilds,
        "mirror": res.mirror_info, "launches": counts,
        "kernel_ms": kernel_ms, "kernel_busy_s": busy,
        "host_paths_s": res.host_paths, "host_seconds": res.seconds,
        "plans": plans,
    }, timed


WIDE_FAMILIES = ("SchedulingPodAffinity", "SchedulingPreferredPodAffinity",
                 "SchedulingPreferredPodAntiAffinity")


def phase_wide_terms(nodes=5000, init=5000, pods=1000, max_batch=4096):
    """The three other wide-term families at bench.py's sizes: every
    measured pod bound, each required-affinity pod in a zone holding a
    pod of its group, every launch as planned (the measured batches on
    the slot kernel), and the slot kernel equal to the plain slot solve
    on each row's largest batch. Returns the rows and the largest
    slot-kernel error."""
    rows, worst = {}, 0
    for name in WIDE_FAMILIES:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        measured = [init + i for i in range(pods)]
        unbound = [i for i in measured if not res.placements.get(f"pod-{i}")]
        check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
        if name == "SchedulingPodAffinity":
            zone = {i: int(res.placements[f"pod-{i}"].split("-")[1]) % 10
                    for i in range(init + pods)}
            together = {}
            for i, z in zone.items():
                together[i % 50, z] = together.get((i % 50, z), 0) + 1
            apart = [i for i in measured if together[i % 50, zone[i]] < 2]
            check(not apart, f"{name}: {len(apart)} measured pods in a zone "
                  "without another pod of their group")
        plans = check_plans(name, counts, recorder)
        check(counts["slots"] > 0 and counts["wide"] == 0,
              f"{name}: the measured batches ran the slot kernel: {counts}")
        ps, state, ints, floats = recorder.largest(slots=True)
        got, st, _ = _solve_on_card(ps, state, ints, floats,
                                    solve_mod.solve_kernel.slots_plan(ps))
        b = on("cuda", ps, state, ints, floats)
        want = solve_mod.solve_plain_slots(PARAMS, *b)
        err = _err(got, want, st, b[1])
        check(err == 0, f"{name}: slot kernel equals plain on its largest "
              "batch")
        worst = max(worst, err)
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel ms {_ms_list(kernel_ms)} (busy "
            f"{busy:.3f} s); max_abs_err {err}")
        log(f"    enqueue->bind ms p50/p99: {res.latency['Perc50']:.1f}/"
            f"{res.latency['Perc99']:.1f}; solves {res.solves} rebuilds "
            f"{res.rebuilds}; host seconds: {_host_split(res)}")
        rows[name] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "rebuilds": res.rebuilds, "launches": counts,
            "kernel_ms": kernel_ms, "kernel_busy_s": busy, "plans": plans,
            "host_seconds": res.seconds, "max_abs_err": err}
    return rows, worst


PV_ROWS = (("SchedulingInTreePVs", 1000, 0, 5000),
           ("SchedulingMigratedInTreePVs", 1000, 0, 5000),
           ("SchedulingCSIPVs", 1000, 0, 5000),
           ("SchedulingSharedPVs", 1000, 0, 3000))


def _row_numbers(res, counts, kernel_ms, wall):
    busy = sum(kernel_ms) / 1000
    return {"pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "rebuilds": res.rebuilds, "launches": counts,
            "kernel_ms": kernel_ms, "kernel_busy_s": busy,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds}


def phase_pv_rows(max_batch=4096):
    """The four PV rows at bench.py's sizes: every measured pod bound, no
    node over the CSINode limit, every WaitForFirstConsumer claim bound to
    a PV of its own, the launches as planned."""
    rows = {}
    for name, nodes, init, pods in PV_ROWS:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        measured = [f"pod-{init + i}" for i in range(pods)]
        unbound = [n for n in measured if not res.placements.get(n)]
        check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
        most = max(len(v) for v in res.node_volumes.values())
        if name == "SchedulingCSIPVs":
            # every PV of the row is a csi.fake.driver volume
            check(most <= 39, f"{name}: a node holds {most} csi.fake.driver "
                  "volumes, over its limit of 39")
        wfc = [pv for c, pv in res.claims.items() if c.startswith("claim-")]
        check(all(wfc) and len(set(wfc)) == len(wfc),
              f"{name}: every claim bound to a PV of its own")
        if name == "SchedulingSharedPVs":
            check(res.volumes_bound == len(wfc) > 0,
                  f"{name}: {res.volumes_bound} claims bound at commit for "
                  f"{len(wfc)} WaitForFirstConsumer claims")
        plans = check_plans(name, counts, recorder)
        row = _row_numbers(res, counts, kernel_ms, wall)
        row.update(plans=plans, most_volumes_a_node=most,
                   volumes_bound_at_commit=res.volumes_bound)
        log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel busy {row['kernel_busy_s']:.3f} s; "
            f"most volumes a node {most}; claims bound at commit "
            f"{res.volumes_bound}")
        log("    enqueue->bind ms p50/p90/p99: " + "/".join(
            f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99"))
            + f"; solves {res.solves} rebuilds {res.rebuilds}; host "
            f"seconds: {_host_split(res)}")
        rows[name] = row
    return rows


def phase_preemption_pvs(nodes=5000, seed=11, max_batch=4096):
    """PreemptionPVs in the default arms and serialized: checked as the
    Preemption row, both arms bind and evict alike, and every claim is
    still bound to its PV."""
    runs, sets = {}, {}
    want_claims = {f"claim-{nodes + i}": f"pv-{nodes + i}"
                   for i in range(nodes)}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"PreemptionPVs {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "PreemptionPVs", workloads.preemption_pvs(nodes, nodes,
                                                          nodes),
                max_batch=max_batch, device="cuda", pipeline=pipeline,
                seed=seed))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        sets[arm] = check_preemption_row(name, res, nodes)
        check(res.claims == want_claims,
              f"{name}: every claim still bound to its PV")
        runs[arm] = _row_numbers(res, counts, kernel_ms, wall)
        runs[arm].update(victims=res.victims,
                         post_filter_runs=res.post_filter_runs)
        log(f"  {name} {nodes} nodes / {nodes} / {nodes} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"{res.victims} victims, PostFilter runs {res.post_filter_runs}; "
            f"solves {res.solves} rebuilds {res.rebuilds}; kernel busy "
            f"{runs[arm]['kernel_busy_s']:.3f} s")
        log("    enqueue->bind ms p50/p99: "
            f"{res.latency['Perc50']:.1f}/{res.latency['Perc99']:.1f}; host "
            f"seconds: {_host_split(res)}")
    check(sets["pipelined"] == sets["serialized"],
          "PreemptionPVs: both arms bind the same pods to the same nodes and "
          "evict the same pods")
    log("  pipelined == serialized: bound set and victim set")
    return runs


SHARED_DRIVER = "rwx.csi.example.com"


def shared_volume_store(nodes, claims, limit):
    """The JAX package's shared-volume test fixture, grown: ``nodes``
    SchedulingBasic nodes with a CSINode limit of ``limit`` for one
    driver, and ``claims`` shared ReadWriteMany CSI claims, each bound to
    its PV."""
    store = ClusterStore()
    for i in range(nodes):
        store.add_node(Node.from_dict(workloads.node_template(i)))
        store.add_csi_node(CSINode(
            metadata=ObjectMeta(name=f"node-{i}"),
            drivers=[CSINodeDriver(name=SHARED_DRIVER, node_id=f"node-{i}",
                                   allocatable_count=limit)]))
    store.add_storage_class(StorageClass(
        metadata=ObjectMeta(name="shared-csi"), provisioner=SHARED_DRIVER))
    for c in range(claims):
        store.add_pv(PersistentVolume(
            metadata=ObjectMeta(name=f"pv-shared-{c}"),
            capacity={"storage": parse_quantity("10Gi")},
            access_modes=["ReadWriteMany"], storage_class_name="shared-csi",
            claim_ref=f"default/shared-{c}", phase="Bound",
            csi_driver=SHARED_DRIVER))
        store.add_pvc(PersistentVolumeClaim(
            metadata=ObjectMeta(name=f"shared-{c}", namespace="default"),
            storage_class_name="shared-csi", access_modes=["ReadWriteMany"],
            requests={"storage": parse_quantity("1Gi")},
            volume_name=f"pv-shared-{c}", phase="Bound"))
    return store


def run_shared_volumes(device, nodes, claims, pods, limit, max_batch):
    """``pods`` pods, pod i on claim i mod ``claims`` (so once every node
    holds ``limit`` volumes, the later pods fit only where their volume is
    already attached), through the batch loop on
    ``device`` in batches of ``max_batch``. Returns (store, batch loop,
    pod dicts); the scheduler is stopped."""
    store = shared_volume_store(nodes, claims, limit)
    sched = Scheduler(store, config=SchedulerConfiguration(
        provider="GangSchedulingProvider"),
        feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    get_tracer().clear()
    get_devprof().reset(workload="shared volumes")
    perf.reset_sli_window()
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=device)
    sched.start()
    dicts = []
    for i in range(pods):
        d = workloads.basic_pod(i)
        d["spec"]["volumes"] = [{"name": "data", "persistentVolumeClaim": {
            "claimName": f"shared-{i % claims}"}}]
        dicts.append(d)
    try:
        # one pod a claim: the warm-up's epoch has every volume's slot
        bs.warmup([Pod.from_dict(d) for d in dicts[:claims]])
        store.create_pods([Pod.from_dict(d) for d in dicts])
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            sched.queue.flush_backoff_completed()
            if bs.run_batch(pop_timeout=0.0):
                continue
            if sched.queue.pending_active_count() == 0 and not bs.holding:
                break
            time.sleep(0.005)
        bs.flush()
        check(sched.wait_for_inflight_bindings(timeout=60.0),
              "shared volumes: bindings settled")
    finally:
        sched.stop()
    telemetry = get_devprof().summary()
    row_report("shared volumes", str(bs.session.backend.device), {
        "telemetry": telemetry,
        "critical_path": perf.collect_critical_path()[0],
        "freshness": perf.collect_freshness(telemetry)})
    return store, bs, dicts


def phase_shared_volumes(nodes=1000, claims=300, pods=3000, limit=2,
                         max_batch=1024):
    """The shared-volume attach planes at size: checked, the carried
    planes equal to a fresh prepare's, and the cluster kernel, the wide
    kernel and the plain version on the largest batch."""
    name = "shared volumes"
    (store, bs, dicts), counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_shared_volumes("cuda", nodes, claims, pods, limit,
                                         max_batch), keep=True)
    bound = {p.metadata.name: p.spec.node_name for p in store.list_pods()}
    unbound = [n for n, v in bound.items() if not v]
    check(len(bound) == pods and not unbound,
          f"{name}: {len(unbound)} of {pods} pods unbound")
    per_node = {}
    for p in store.list_pods():
        per_node.setdefault(p.spec.node_name, set()).add(
            p.spec.volumes[0].persistent_volume_claim)
    most = max(len(v) for v in per_node.values())
    check(most <= limit, f"{name}: a node holds {most} shared volumes, over "
          f"its limit of {limit}")
    svs = {ps.sv for ps, _, _, _ in recorder.inputs}
    want_sv = max(8, 1 << (claims - 1).bit_length())   # 512 for 300
    check(svs == {want_sv}, f"{name}: every launch with SV = {want_sv} "
          f"({svs})")
    session = bs.session
    check(session.mirror_current(), f"{name}: the carried state is current")
    sample = [Pod.from_dict(dicts[0])]
    fresh_static, fresh = session.fresh_planes(sample, max_batch)
    ps = session._static
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    col = ps.r - 1
    rows = list(range(do["sv_attached"], do["sv_attached"] + ps.sv)) + [
        do["requested"] + col]
    check(fresh_static.sv == ps.sv, f"{name}: fresh planes' SV")
    err = int((session._state[rows] - fresh[rows]).abs().max())
    check(err == 0, f"{name}: the carried sv planes and attach column equal "
          "a fresh prepare's")
    attached = int(session._state[rows[:-1]].sum())
    busy = sum(kernel_ms) / 1000
    log(f"  {name}: {nodes} nodes (limit {limit}), {claims} claims, {pods} "
        f"pods in batches of {max_batch}: all bound in {wall:.1f} s; "
        f"launches {counts}; kernel ms {_ms_list(kernel_ms)}; most shared "
        f"volumes a node {most}; {attached} attachments; carried planes "
        f"equal a fresh prepare's")
    largest = recorder.largest()
    timed, final = time_batch(f"{name} largest batch", largest)
    plain_ms, plain_err = plain_against(f"{name} largest", largest, final)
    b_ms, b_by = bound_ms(*largest)
    log(f"  bound on the shared-volume batch {b_ms:.6f} ms ({b_by})")
    return {"wall_s": wall, "launches": counts, "kernel_ms": kernel_ms,
            "kernel_busy_s": busy, "most_volumes_a_node": most,
            "attachments": attached, "timed": timed, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "err": max(timed["err"], plain_err)}

# phase 28: every 64th measured pod of the anti-affinity row also carries
# 12 weighted preferred pod-affinity terms
WIDE_PODS_EVERY = 64
WIDE_POD_TERMS = 12


def wide_pods_workload(wl, nodes, init, pods, every=WIDE_PODS_EVERY,
                       terms=WIDE_POD_TERMS, colours=100):
    """``wl.scheduling_pod_anti_affinity`` (``wl``: a package's harness
    workloads module) with every ``every``-th measured pod also carrying
    ``terms`` weighted ``preferredDuringSchedulingIgnoredDuringExecution``
    pod-affinity terms (weights 1-10) on the next ``terms`` colours over
    the hostname: one ``podAffinity`` block, each term in the shape
    ``wl._affinity`` gives a single one, beside the row's
    ``podAntiAffinity`` block. Such a pod references 13 terms."""
    ops = wl.scheduling_pod_anti_affinity(nodes, init, pods)
    template = ops[3]["podTemplate"]

    def pod(i):
        p = template(i)
        if (i - init) % every == 0:
            prefs = [wl._affinity(
                "podAffinity", "color", [f"blue-{(i + x) % colours}"], HOST,
                weight=1 + (x - 1) % 10)["affinity"]["podAffinity"][
                "preferredDuringSchedulingIgnoredDuringExecution"][0]
                for x in range(1, terms + 1)]
            p["spec"]["affinity"]["podAffinity"] = {
                "preferredDuringSchedulingIgnoredDuringExecution": prefs}
        return p

    ops[3]["podTemplate"] = pod
    return ops


def phase_wide_pods(anti, nodes=5000, init=1000, pods=30000, colours=100,
                    max_batch=4096, repeats=10):
    """Phase 28: the anti-affinity row with wide pods (``wide_pods_workload``)
    on the card: checked, every launch as planned and every T = 100 batch
    on the wide kernel (the dense stream: no batch packs); on the largest
    batch the wide kernel against the plain version and timed (``repeats``
    bare launches). ``anti``: phase 15's row, printed beside. Returns the
    row and the kernel numbers."""
    name = "SchedulingPodAntiAffinity with wide pods"
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: perf.run_workload(
            name, wide_pods_workload(workloads, nodes, init, pods),
            max_batch=max_batch, device="cuda"), keep=True, kernel=None)
    measured = [f"pod-{init + i}" for i in range(pods)]
    unbound = [n for n in measured if not res.placements.get(n)]
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
    pairs = {(res.placements[f"pod-{init + i}"], (init + i) % colours)
             for i in range(pods)}
    check(len(pairs) == pods, f"{name}: {pods - len(pairs)} nodes hold two "
          "measured pods of one colour")
    plans = check_plans(name, counts, recorder)
    wide = [slots for (ps, _, _, _), slots in zip(recorder.inputs,
                                                   recorder.slots)
            if ps.t >= colours]
    check(wide and not any(wide) and counts["wide"] == len(wide)
          and counts["slots"] == 0,
          f"{name}: every T = {colours} batch ran the wide kernel "
          f"({len(wide)} batches, launches {counts})")
    busy = sum(kernel_ms) / 1000
    log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s); launches {counts}; kernel busy "
        f"{busy:.3f} s")
    log("    enqueue->bind ms p50/p99: " + "/".join(
        f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc99"))
        + f"; phase 15's row without the wide pods: "
        f"{anti['pods_per_s']:.1f} pods/s, p50/p99 "
        f"{anti['enqueue_to_bind_ms']['Perc50']:.1f}/"
        f"{anti['enqueue_to_bind_ms']['Perc99']:.1f}")
    log(f"    kernel ms (wrapper call) {_ms_list(kernel_ms)}")
    log(f"    solves {res.solves} rebuilds {res.rebuilds}; host seconds: "
        f"{_host_split(res)}")
    largest = recorder.largest()
    ps, state, ints, floats = largest
    plan = solve_mod.solve_kernel.plan(ps)
    check(plan.kernel == "wide", f"{name}: the largest batch plans the wide "
          "kernel")
    got = {}

    def bare(st):
        got["a"] = (solve_mod.solve_kernel.launch(PARAMS, ps, st, ints,
                                                  floats, plan), st)

    _event_ms(bare, state, 1)
    ms = _event_ms(bare, state, repeats)
    plain_ms, err = plain_against(f"{name} largest", largest, got["a"],
                                  kernel="wide")
    b_ms, b_by = bound_ms(*largest)
    valid = int((ints[:, ps.r + 3] > 0).sum())
    refs = ints[:, ps.r + 4 + 2 * ps.sc:ps.r + 4 + 2 * ps.sc + 3 * ps.t] > 0
    wide_pods = int(((refs.reshape(ints.shape[0], 3, ps.t).any(1).sum(1)
                      + (floats != 0).sum(1)) > 8).sum())
    log(f"  {name} largest batch: N={ps.ints.shape[1]} B={ints.shape[0]} "
        f"valid={valid} T={ps.t}, {wide_pods} pods of more than "
        f"{SPARSE_K} term references; wide kernel {ms:.3f} ms, "
        f"{ms / valid * 1000:.3f} us a pod (chunk {plan.chunk}, "
        f"{plan.smem_bytes} B a block); plain {plain_ms:.1f} ms; bound "
        f"{b_ms:.6f} ms ({b_by}); max_abs_err {err}")
    return {
        "pods_per_s": res.pods_per_second,
        "duration_s": res.duration_seconds, "wall_s": wall,
        "enqueue_to_bind_ms": res.latency, "solve_to_bind_ms": res.metrics,
        "solves": res.solves, "rebuilds": res.rebuilds,
        "launches": counts, "kernel_ms": kernel_ms, "kernel_busy_s": busy,
        "host_seconds": res.seconds, "plans": plans,
    }, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "err": err, "valid_pods": valid, "wide_pods": wide_pods,
        "us_per_pod": ms / valid * 1000, "n": ps.ints.shape[1], "t": ps.t,
        "plan": plan._asdict()}


# every row's telemetry, critical path and freshness, in the order run
ROW_REPORTS = []


def row_report(name, device, res):
    """Log a row's ``telemetry``, ``critical_path`` and ``freshness`` (a
    ``BenchmarkResult`` or a sustained row's dict) as one JSON line; on
    the card, no compile may land inside a measured cycle."""
    get = res.get if isinstance(res, dict) else (
        lambda k: getattr(res, k))
    report = {"row": name, "device": device,
              "telemetry": get("telemetry"),
              "critical_path": get("critical_path"),
              "freshness": get("freshness"),
              # the span totals of the row's ring: count, seconds
              "spans": {k: [v["count"], round(v["total_s"], 6)] for k, v
                        in sorted(get_tracer().phase_stats().items())}}
    ROW_REPORTS.append(report)
    print("row " + json.dumps(report, default=str), flush=True)
    telemetry = report["telemetry"] or {}
    if device.startswith("cuda") and telemetry:
        check(telemetry["unexpected_compiles"] == 0,
              f"{name}: {telemetry['unexpected_compiles']} compiles inside "
              "measured cycles")
    return report


def observe_rows():
    """Wrap ``perf.run_workload`` and ``sustained.run_sustained_row`` so
    every row any phase runs reports (``row_report``)."""
    run_workload, run_sustained = perf.run_workload, \
        sustained.run_sustained_row

    def observed_workload(name, ops, **kw):
        res = run_workload(name, ops, **kw)
        row_report(name, res.device, res)
        return res

    def observed_sustained(**kw):
        row = run_sustained(**kw)
        row_report("sustained", row["device"], row)
        return row

    perf.run_workload = observed_workload
    sustained.run_sustained_row = observed_sustained


def check_attribution(name, res, bar=0.05):
    """The row's aggregate unattributed share of the sampled pods'
    windows at most ``bar`` (the JAX package's bar for batch rows)."""
    cp = res.critical_path
    check(cp.get("pods", 0) > 0, f"{name}: sampled pods in the critical "
          "path")
    share = cp["unattributed_share"]
    check(share <= bar, f"{name}: unattributed share {share} > {bar}")
    log(f"    critical path over {cp['pods']} sampled pods: "
        + ", ".join(f"{k}={v}" for k, v in cp["phase_shares"].items())
        + f"; unattributed {share}")


CONFIG_ROWS = (("SchedulingBasic", 100, 1000),      # BASELINE config 1
               ("SchedulingBasic", 1000, 10000),    # config 2
               ("TopologySpreading", 5000, 30000))  # config 3


def phase_configs():
    """BASELINE configs 1-3 as named rows on the card: every pod bound,
    the cluster kernel once per solve; config 3's zone skew at most
    one."""
    rows = {}
    for name, nodes, pods in CONFIG_ROWS:
        res, counts, kernel_ms, _ = run_main_path(name, nodes, pods)
        if name == "TopologySpreading":
            skew = zone_skew(res)
            check(skew <= 1, f"{name} zone skew {skew} <= 1")
            log(f"  zone skew {skew}")
        rows[f"{name} {nodes}/{pods}"] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "launches": counts, "kernel_ms": kernel_ms,
            "host_seconds": res.seconds, "telemetry": res.telemetry,
            "critical_path": res.critical_path}
    return rows


FAMILIES = (("SchedulingSecrets", 5000, 5000, 1000),
            ("SchedulingNodeAffinity", 5000, 5000, 1000),
            ("PreferredTopologySpreading", 5000, 5000, 2000),
            ("MixedSchedulingBasePod", 5000, 1000, 30000))


def phase_families(max_batch=4096):
    """The four families ported last, at bench.py's sizes: every pod
    bound (measured and init), each node-affinity pod in its zone, every
    launch on the kernel its plan gives it."""
    rows = {}
    for name, nodes, init, pods in FAMILIES:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        unbound = [k for k, v in res.placements.items() if not v]
        check(len(res.placements) == init + pods and not unbound,
              f"{name}: {len(unbound)} of {init + pods} pods unbound")
        if name == "SchedulingNodeAffinity":
            off = [i for i in range(init, init + pods)
                   if int(res.placements[f"pod-{i}"].split("-")[1]) % 10
                   != i % 10]
            check(not off, f"{name}: {len(off)} pods outside their zone")
        plans = check_plans(name, counts, recorder)
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel busy {busy:.3f} s; enqueue->bind "
            f"p99 {res.latency['Perc99']:.1f} ms; host seconds: "
            f"{_host_split(res)}")
        rows[name] = {**_row_numbers(res, counts, kernel_ms, wall),
                      "plans": plans, "telemetry": res.telemetry,
                      "critical_path": res.critical_path}
    return rows


def phase_tracing_cost(nodes=5000, pods=30000, max_batch=4096):
    """SchedulingBasic pipelined with the tracer and the device profiler
    on and off (``KTPU_TRACE=off``, ``KTPU_DEVPROF=off`` in process), in
    turns: on, off, off, on. Every pod bound in every turn; the off turns
    record nothing."""
    tracer, prof = get_tracer(), get_devprof()
    turns = []
    for on_ in (True, False, False, True):
        tracer.configure(enabled=on_)
        prof.configure(enabled=on_)
        try:
            res, counts, kernel_ms, _ = run_main_path(
                "SchedulingBasic", nodes, pods, max_batch)
        finally:
            tracer.configure(enabled=True)
            prof.configure(enabled=True)
        check(bool(res.telemetry) == on_ and bool(res.critical_path) == on_,
              f"tracing {'on' if on_ else 'off'}: the row's telemetry and "
              "critical path present only with tracing on")
        turns.append({"tracing": on_, "pods_per_s": res.pods_per_second,
                      "duration_s": res.duration_seconds,
                      "enqueue_to_bind_ms": res.latency,
                      "solves": res.solves,
                      "kernel_busy_s": sum(kernel_ms) / 1000})
        log(f"  tracing {'on ' if on_ else 'off'}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s, enqueue->bind p99 "
            f"{res.latency['Perc99']:.1f} ms")
    return turns


def phase_tuner(nodes=5000, pods=12000, max_batch=4096):
    """The latency-budget tuner forced to shrink: SchedulingBasic with
    the instance's budget cut to 1 µs after its warm-up (which warmed 4096
    and 2048). The pad steps down one bucket a batch to ``MIN_CHUNK``;
    each bucket the warm-up did not warm is warmed by ``warm_pad``
    between cycles before its first solve; no compile lands in a measured
    cycle. The row starts cold: its warm-up books the kernel's first
    launch and the pinned staging buffers, and no smaller pad allocates
    any after it (nor its warm: a smaller pad's streams are views of the
    buffers held). Every pod bound."""
    pads, warms, allocated = [], [], []

    def configure(bs):
        warmup, solve = bs.warmup, bs.session.solve
        warm_pad = bs.session.warm_pad

        def cut_after_warmup(samples):
            before = len(solve_mod.STAGING.allocations)
            out = warmup(samples)
            bs.LATENCY_BUDGET_S = 1e-6
            allocated.append(solve_mod.STAGING.allocations[before:])
            allocated.append(len(solve_mod.STAGING.allocations))
            return out

        def solve_at(pods_, pad, **kw):
            if not kw.get("warming"):
                pads.append(pad)
            return solve(pods_, pad, **kw)

        def warm_pad_at(pods_, pad):
            t0 = time.monotonic()
            got = warm_pad(pods_, pad)
            warms.append({"pad": pad, "solves_before": len(pads),
                          "compiles": got,
                          "ms": (time.monotonic() - t0) * 1000})
            return got

        bs.warmup, bs.session.solve = cut_after_warmup, solve_at
        bs.session.warm_pad = warm_pad_at

    name = "SchedulingBasic tuner"
    res, counts, kernel_ms, _, _, wall = run_path(
        name, lambda: perf.run_workload(
            "SchedulingBasic", workloads.make_workload(
                "SchedulingBasic", nodes, 0, pods),
            max_batch=max_batch, device="cuda", configure=configure),
        cold=True)
    check(all(res.placements.values()), f"{name}: every pod bound")
    check(all(b in (a, a // 2) for a, b in zip(pads, pads[1:])),
          f"{name}: the pad moved more than one bucket a batch: {pads}")
    between = [w for w in warms if w["solves_before"] > 0]
    for w in between:
        check(w["pad"] not in pads[:w["solves_before"]],
              f"{name}: pad {w['pad']} solved before its warm")
        check(w["compiles"] == 0, f"{name}: the warm of pad {w['pad']} "
              f"booked {w['compiles']} compiles")
    check(res.chunk == 512 and {1024, 512} <= {w["pad"] for w in between},
          f"{name}: chunk {res.chunk}, warms between cycles {between}")
    check(res.telemetry["unexpected_compiles"] == 0,
          f"{name}: a compile inside a measured cycle")
    check(res.telemetry["warm_compiles"] >= 3 and len(allocated[0]) >= 2,
          f"{name}: the cold warm-up booked {res.telemetry['warm_compiles']}"
          f" compiles, {len(allocated[0])} staging allocations")
    after = solve_mod.STAGING.allocations[allocated[1]:]
    check(not after, f"{name}: staging allocations after the warm-up: "
          f"{after}")
    log(f"  {name}: pads {pads}; warms {warms}; chunk {res.chunk}; "
        f"warmed {res.warmed_pads}; warm-up compiles "
        f"{res.telemetry['warm_compiles']}, staging allocations "
        f"{allocated[0]}; {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s; enqueue->bind p99 "
        f"{res.latency['Perc99']:.1f} ms")
    return {"pads": pads, "warms": warms, "chunk": res.chunk,
            "warmed_pads": res.warmed_pads, "launches": counts,
            "staging_allocations": allocated[0],
            "pods_per_s": res.pods_per_second,
            "enqueue_to_bind_ms": res.latency, "wall_s": wall,
            "telemetry": res.telemetry}


# ----------------------------------------------------------------------
# the legacy scan: the cluster autoscaler's what-if
def scan_batch(cluster, batch, pen, dis, device):
    """(static, state, pod ints, pod floats) of a what-if on ``device``,
    its penalties and disabled columns applied."""
    scores, valid = solver_mod.whatif_overrides(cluster, batch, pen, dis)
    return solver_mod.scan_inputs(cluster, batch, device, scores, valid)


SCAN_REPEATS = 10
# the autoscale row's burst here (10,000 until phases 40-42 came), and
# bench.py's
AUTOSCALE_BURST = 5000
AUTOSCALE_ROW_BURST = 30000
# the fixed seeded yardstick: N = 512 with constraints
SCAN_YARDSTICK = dict(seed=10, n_nodes=94, n_upcoming=162, n_virtual=256,
                      n_pods=2000, pad=2048)


def _max_err(xs, ys):
    return max((int((x - y).abs().max()) for x, y in zip(xs, ys)
                if x.numel()), default=0)


def scan_against_plain(name, cuda_batch, repeats=SCAN_REPEATS, **plan):
    """The scan kernel on the card (``plan``: ``tables``, ``cols``
    forced) ``repeats`` times, on fresh copies of the state, against the
    plain scan on CPU copies of the same inputs: the assignments and
    every final table. Every launch must give the same result. Returns
    the largest absolute difference, which must be 0."""
    static, state, ints, floats = cuda_batch
    cpu = [solver_mod.ScanStatic(*(t.cpu() for t in static)),
           solver_mod.ScanState(*(t.to("cpu", copy=True) for t in state)),
           ints.cpu(), floats.cpu()]
    outs = []
    for _ in range(repeats):
        st = solver_mod.ScanState(*(t.clone() for t in state))
        got = solver_mod.scan_kernel(PARAMS, static, st, ints, floats,
                                     **plan)
        torch.cuda.synchronize()
        outs.append([got.cpu(), *(t.cpu() for t in st)])
    check(all(_max_err(o, outs[0]) == 0 for o in outs[1:]),
          f"{name}: {repeats} launches give one result")
    want = solver_mod.solve_scan_plain(PARAMS, *cpu)
    err = _max_err(outs[0], [want, *cpu[1]])
    check(err == 0, f"scan kernel equals plain on {name}")
    placed = int((want >= 0).sum())
    r = static.allocatable.shape[1]
    # something placed, unless no row or no column is valid
    check(placed > 0 or not bool((ints[:, r + 3] > 0).any())
          or not bool(static.node_valid.any()), f"{name}: some pod placed")
    log(f"  {name}: N={static.allocatable.shape[0]} "
        f"B={ints.shape[0]} SC={static.sc_codes.shape[0]} "
        f"T={static.term_codes.shape[0]} V={static.sc_domain.shape[2] - 1} "
        f"plan {tuple(solver_mod.scan_kernel.plan(static, ints.shape[0], **plan))}"
        f": {placed} placed, {repeats} launches alike, max_abs_err {err}")
    return err


def phase_scan_compare():
    """The scan kernel against the plain scan, bit for bit, on seeded
    what-ifs (``whatif_problem``): hostname keys (V = N) and zone keys
    only; graded tiers hundreds of columns deep; more than 1,024 columns;
    the tables forced out of shared memory; two batches carrying the
    state; padded rows in every case; then ``scan_cases``. Each case ten
    launches, all alike."""
    cases = [
        ("host keys", whatif_problem(0), {}),
        ("zone keys", whatif_problem(1, host_key=False), {}),
        ("deep tiers", whatif_problem(2, n_nodes=94, n_bound=200,
                                      n_pods=2000, n_upcoming=300,
                                      n_virtual=256, pad=2048), {}),
        ("1,536 columns", whatif_problem(3, n_nodes=900, n_bound=1500,
                                         n_pods=1000, n_upcoming=100,
                                         n_virtual=200, pad=1024), {}),
        ("global tables", whatif_problem(4, n_nodes=300, n_pods=500,
                                         pad=512), {"tables": False})]
    err = 0
    for name, (cluster, batch, pen, dis), plan in cases:
        err = max(err, scan_against_plain(
            name, scan_batch(cluster, batch, pen, dis, "cuda"), **plan))
    for case in scan_cases(seed=20, n_pods=600):
        err = max(err, scan_against_plain(
            case.name, scan_case_inputs(case, "cuda"), **case.plan))
    # two batches on one carried state
    cluster, batch, pen, dis = whatif_problem(5, n_pods=300, pad=512)
    static, state, ints, floats = scan_batch(cluster, batch, pen, dis,
                                             "cuda")
    half = ints.shape[0] // 2
    cst = solver_mod.ScanState(*(t.to("cpu", copy=True) for t in state))
    cs = solver_mod.ScanStatic(*(t.cpu() for t in static))
    got = [solver_mod.scan_kernel(PARAMS, static, state, ints[a:b], floats[
        a:b]) for a, b in ((0, half), (half, ints.shape[0]))]
    want = [solver_mod.solve_scan_plain(PARAMS, cs, cst, ints[a:b].cpu(),
                                        floats[a:b].cpu())
            for a, b in ((0, half), (half, ints.shape[0]))]
    torch.cuda.synchronize()
    e = max(int((x.cpu() - y).abs().max()) for x, y in zip(
        [*got, *state], [*want, *cst]))
    check(e == 0, "scan kernel equals plain over two carried batches")
    log(f"  two carried batches: max_abs_err {e}")
    return max(err, e)


def scan_bound_ms(static, state, ints, floats):
    """Least time for one scan launch on these inputs: bytes (each input
    read once, the state and the assignments written once) over HBM
    bandwidth, and the operations these pods need (per valid pod and
    column, from its flags) over the f32 peak; the larger."""
    tensors = (*static, *state, ints, floats)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + sum(t.numel() * t.element_size() for t in state) + ints.shape[0] * 4
    n, r = static.allocatable.shape
    sc, t = static.sc_codes.shape[0], static.term_codes.shape[0]
    rows, w = ints.cpu().numpy(), floats.cpu().numpy()
    hard = static.sc_hard.cpu().numpy() > 0
    valid = rows[:, r + 3] > 0
    pod_sc = rows[:, r + 4:r + 4 + sc] > 0
    flags = rows[:, r + 4 + 2 * sc:r + 4 + 2 * sc + 3 * t] > 0
    per_pod = (3 + r + 27 + 5 * (pod_sc & hard).sum(1)
               + 2 * (pod_sc & ~hard).sum(1) + 2 * (pod_sc & ~hard).any(1)
               + 3 * (w != 0).sum(1) + 2 * flags.sum(1))
    ops = float((per_pod * valid).sum()) * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1000
    t_ops = ops / PEAK_F32_OPS_PER_S * 1000
    log(f"  scan bound inputs: {nbytes} bytes -> {t_bytes:.6f} ms, "
        f"{ops:.0f} operations -> {t_ops:.6f} ms")
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def time_scan(name, batch, repeats=10):
    """Ten bare launches of the scan kernel (CUDA events around the
    launch only, a fresh copy of the state each), and one run of the
    plain version on the card (host clock), which must agree. Returns
    (kernel ms, plain ms, max abs err)."""
    static, state, ints, floats = batch
    plan = solver_mod.scan_kernel.plan(static, ints.shape[0])
    times = []
    for _ in range(repeats + 1):
        st = solver_mod.ScanState(*(t.clone() for t in state))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = solver_mod.scan_kernel.launch(PARAMS, static, st, ints, floats,
                                            plan)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.mean(times[1:]))
    pst = solver_mod.ScanState(*(t.clone() for t in state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = solver_mod.solve_scan_plain(PARAMS, static, pst, ints, floats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000
    err = max(int((x - y).abs().max()) for x, y in zip([got, *st],
                                                       [want, *pst]))
    check(err == 0, f"scan kernel equals plain on the {name}")
    valid = int((ints[:, static.allocatable.shape[1] + 3] > 0).sum())
    log(f"  scan kernel on the {name} ({valid} pods, N="
        f"{static.allocatable.shape[0]}, plan {plan}): {ms:.3f} ms a "
        f"launch ({1000 * ms / max(valid, 1):.3f} us a pod), plain "
        f"{plain_ms:.1f} ms, max_abs_err {err}")
    return ms, plain_ms, err, valid


def phase_autoscale(burst=AUTOSCALE_BURST, node_cpu=32, boot_latency=1.0,
                    max_batch=4096, wait_timeout=1800.0):
    """``bench.py``'s autoscale row on the card at a burst of ``burst``
    pods (``bench.py``'s is ``AUTOSCALE_ROW_BURST``: the script's depth
    is cut to keep it inside its time limit, every shape kept): a fifth
    of the nodes the burst needs up, the autoscaler buying the rest (boot
    latency 1 s) while the batch loop binds. Every pod bound within
    needed + 2 nodes; at least one what-if; every what-if on the scan
    kernel (one launch a solve, none on the plain version); every batch
    solve on the cluster kernel. The what-ifs' launches are timed with
    CUDA events on their own stream. Node columns grow during the row,
    so the compiles booked in its measured cycles are reported, not
    gated."""
    scan = solver_mod.scan_kernel
    real_plain = solver_mod.solve_scan_plain
    events, plain_calls = [], []

    class ScanRecorder:
        """Stands in for the scan wrapper during the row: CUDA events
        around each launch (on the what-if's stream)."""

        def __getattr__(self, name):
            return getattr(scan, name)

        def __call__(self, params, static, state, ints, floats, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = scan(params, static, state, ints, floats, **kw)
            end.record()
            events.append((start, end))
            return out

    def trapped_plain(*args):
        plain_calls.append(1)
        return real_plain(*args)

    holder = {}

    def configure(ca, bs):
        holder["ca"], holder["bs"] = ca, bs

    solver_mod.scan_kernel = ScanRecorder()
    solver_mod.solve_scan_plain = trapped_plain
    scan.reset_counts()
    get_devprof().reset(workload="autoscale")
    try:
        row, counts, kernel_ms, _, _, wall = run_path(
            "autoscale", lambda: elastic.run_autoscale_bench(
                burst=burst, node_cpu=node_cpu, boot_latency=boot_latency,
                max_batch=max_batch, wait_timeout=wait_timeout,
                device="cuda", configure=configure, progress=log))
    finally:
        solver_mod.scan_kernel, solver_mod.solve_scan_plain = scan, \
            real_plain
    launches = scan.launches
    LAUNCHES["scan"] += launches
    torch.cuda.synchronize()
    whatif_ms = [a.elapsed_time(b) for a, b in events]
    ca, bs = holder["ca"], holder["bs"]
    check(row["bound"] == burst and "error" not in row,
          f"autoscale: {row['bound']}/{burst} bound ({row.get('error')})")
    check(row["nodes_end"] <= row["needed"] + 2,
          f"autoscale: {row['nodes_end']} nodes > needed + 2")
    check(row["whatif_solves"] >= 1, "autoscale: no what-if solve")
    check(launches == row["whatif_solves"] == len(events),
          f"autoscale: scan launches {launches}, what-ifs "
          f"{row['whatif_solves']}, on the card {len(events)}")
    check(not plain_calls, "autoscale: the plain scan ran on the card path")
    check(counts["cluster"] == row["batch_solves"],
          f"autoscale: cluster launches {counts['cluster']} == batch "
          f"solves {row['batch_solves']}")
    telemetry = get_devprof().summary()
    log(f"  autoscale row: {row['value']} pods/s, time to all bound "
        f"{row['time_to_all_bound_s']} s, nodes {row['nodes_start']} -> "
        f"{row['nodes_end']} (needed {row['needed']}), scale-ups "
        f"{row['scaleup_decisions']}, provisioned "
        f"{row['nodes_provisioned']}, what-ifs {row['whatif_solves']}, "
        f"batch solves {row['batch_solves']} (whole run {wall:.1f} s)")
    log("    host seconds: " + ", ".join(
        f"{k}={v:.3f}" for k, v in row["host_seconds"].items()))
    q = np.percentile(whatif_ms, [50, 90, 100]) if whatif_ms else [0] * 3
    log(f"    what-if spans on their stream (CUDA events around the "
        f"wrapper: its input checks, host waits and the launch), ms: "
        f"n={len(whatif_ms)} p50={q[0]:.3f} p90={q[1]:.3f} "
        f"max={q[2]:.3f}; batch kernel ms a launch mean "
        f"{np.mean(kernel_ms):.3f}; compiles in measured cycles "
        f"{telemetry.get('unexpected_compiles')}")
    return {"row": row, "whatif_ms": whatif_ms, "batch_launches": counts,
            "batch_kernel_ms_mean": float(np.mean(kernel_ms)),
            "unexpected_compiles": telemetry.get("unexpected_compiles"),
            "wall_s": wall}


def mesh_node(i, cols, rows):
    labels = {HOST: f"node-{i}", ZONE: f"zone-{i % 10}"}
    labels.update(mesh_locality.mesh_node_labels(i, cols, rows))
    return {"metadata": {"name": f"node-{i}", "labels": labels},
            "status": {"capacity": {"cpu": "4", "memory": "32Gi",
                                    "pods": "110"}}}


def mesh_pod(i, size):
    g = i // size
    return {"metadata": {"name": f"mesh-{i}", "labels": {
        "pod-group.scheduling.k8s.io/name": f"gang-{g}",
        "pod-group.scheduling.k8s.io/min-available": str(size),
        mesh_locality.MESH_BLOCK_LABEL: f"block-{g}"}},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {
            "cpu": "1", "memory": "1Gi"}}}]}}


def phase_mesh(cols=16, rows=16, gangs=24, size=8, max_batch=256):
    """Mesh-block gangs through the batch path on the card: 256 nodes
    labelled 16 x 16 (``mesh_node_labels``), 24 gangs of 8 one-cpu pods,
    each gang a mesh block. Every pod bound, the same pod -> node map as
    the same row on the CPU (the plain solve), and the members on average
    less than half as far from their blocks' anchors (Manhattan rings) as
    with MeshLocality off (also on the card): the reference's criterion,
    the scored arm beating the adjacency-blind one."""
    ops = [{"opcode": "createNodes", "count": cols * rows,
            "nodeTemplate": lambda i: mesh_node(i, cols, rows)},
           {"opcode": "createPods", "count": gangs * size,
            "podTemplate": lambda i: mesh_pod(i, size),
            "collectMetrics": True}]
    res, counts, _, _, _, _ = run_path(
        "mesh gangs", lambda: perf.run_workload(
            "MeshGangs", ops, max_batch=max_batch, device="cuda"))
    cpu = perf.run_workload("MeshGangs", ops, max_batch=max_batch,
                            device="cpu")
    mesh_locality.configure(False)
    try:
        blind = perf.run_workload("MeshGangs", ops, max_batch=max_batch,
                                  device="cuda")
    finally:
        mesh_locality.configure(True)

    def rings(placements):
        out = []
        for pod, node in placements.items():
            i = int(node.split("-")[1])
            ax, ay = mesh_locality.block_anchor(
                f"block-{int(pod.split('-')[1]) // size}", cols, rows)
            out.append(abs(i % cols - ax) + abs(i // cols - ay))
        return out

    check(all(res.placements.values()), "mesh gangs: every pod bound")
    check(res.placements == cpu.placements,
          "mesh gangs: card and CPU bind alike")
    got, off = rings(res.placements), rings(blind.placements)
    check(np.mean(got) < np.mean(off) / 2,
          f"mesh gangs: mean ring {np.mean(got)} not under half the "
          f"blind arm's {np.mean(off)}")
    log(f"  mesh gangs: {gangs} x {size} on {cols}x{rows}: mean ring "
        f"{np.mean(got):.3f} (max {max(got)}), MeshLocality off "
        f"{np.mean(off):.3f}; launches {counts}")
    return {"mean_ring": float(np.mean(got)), "max_ring": int(max(got)),
            "blind_mean_ring": float(np.mean(off)), "launches": counts}


# ----------------------------------------------------------------------
# the federation tier: clusters as what-if columns
FED_SCENARIOS = ("spill", "loss-mid")


def check_federation_cell(name, res, scenario, clusters):
    """The verdicts the reference's cell tests hold: zero lost, every
    arrival bound, gangs whole and on one cluster, each cluster's p99
    arrival -> bind within budget; on loss a failover with the orphans
    bound again in time; on spill pods spilled and every cluster
    loaded."""
    check(res["lost"] == 0 and res["ever_bound"] == res["injected"] > 0
          and not res["send_errors"],
          f"{name}: {res['lost']} lost, {res['ever_bound']} of "
          f"{res['injected']} bound ({res['send_errors'][:2]})")
    check(res["gang_splits"] == 0 and res["gangs_partial"] == 0,
          f"{name}: gangs split {res['gang_splits']}, partial "
          f"{res['gangs_partial']}")
    check(res["per_cluster_slo_ok"], f"{name}: a cluster's p99 over "
          f"{fed_harness.P99_PER_CLUSTER_BUDGET_MS} ms: {res['per_cluster']}")
    if scenario.startswith("loss"):
        check(res["victim"] is not None and res["failovers"] >= 1
              and "failover" in res["rebalancer_actions"],
              f"{name}: no cluster failed over")
        check(res["recovery_ratio"] >= fed_harness.RECOVERY_RATIO_FLOOR,
              f"{name}: recovery ratio {res['recovery_ratio']}")
    else:
        bound = {k: v["bound"] for k, v in res["per_cluster"].items()}
        check(res["spilled"] > 0 and len(bound) == clusters
              and all(v > 0 for v in bound.values()),
              f"{name}: spilled {res['spilled']}, per cluster {bound}")


def replay_decisions(name, decisions):
    """Each recorded federation decision again: the numpy oracle (host
    clock), the plain scan on the CPU and a bare launch of the scan
    kernel (CUDA events) on the same encoded inputs, all equal to the
    decision the run took. Returns (card ms, oracle ms) lists."""
    card_ms, oracle_ms = [], []
    for cluster, batch, pen, dis, got in decisions:
        t0 = time.perf_counter()
        want, _ = _serial_whatif(cluster, batch, PARAMS,
                                 deprioritized_cols=pen, disabled_cols=dis)
        oracle_ms.append((time.perf_counter() - t0) * 1000)
        static, state, ints, floats = scan_batch(cluster, batch, pen, dis,
                                                 "cuda")
        cpu = [solver_mod.ScanStatic(*(t.cpu() for t in static)),
               solver_mod.ScanState(*(t.to("cpu", copy=True)
                                      for t in state)),
               ints.cpu(), floats.cpu()]
        plain = solver_mod.solve_scan_plain(PARAMS, *cpu).numpy()
        plan = solver_mod.scan_kernel.plan(static, ints.shape[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kern = solver_mod.scan_kernel.launch(PARAMS, static, state, ints,
                                             floats, plan)
        end.record()
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end))
        b = batch.num_real_pods
        kern = kern.cpu().numpy()[:b]
        check(np.array_equal(got, want) and np.array_equal(got, plain[:b])
              and np.array_equal(got, kern),
              f"{name}: a decision differs from the oracle, the plain "
              f"scan or the kernel")
    return card_ms, oracle_ms


def phase_federation(card, pods=900, qps=300.0, seed=18, clusters=3,
                     node_cpu=16, max_batch=256):
    """The federation cells at ``bench.py``'s federation row's sizes (3
    clusters, 900 pods open loop at 300 a second, 16-cpu nodes, batches
    of 256, seed 18), in process: ``spill`` and ``loss-mid`` with the
    reference's policy (the numpy oracle decides) and with
    ``serial=False`` (the scan kernel decides), every cell's batch
    solves on the cluster kernel; then the degradation differential at
    900 pods."""
    out = {}
    for serial in (True, False):
        arm = "oracle" if serial else "scan kernel"
        for scenario in FED_SCENARIOS:
            name = f"federation {scenario}, {arm}"
            scan, real_plain = solver_mod.scan_kernel, \
                solver_mod.solve_scan_plain
            plain_calls = []

            def trapped_plain(*a):
                plain_calls.append(1)
                return real_plain(*a)

            solver_mod.solve_scan_plain = trapped_plain
            scan.reset_counts()
            try:
                res, counts, kernel_ms, _, _, wall = run_path(
                    name, lambda: fed_harness.run_federation_mini_cell(
                        clusters=clusters, pods=pods, qps=qps, seed=seed,
                        scenario=scenario, node_cpu=node_cpu,
                        max_batch=max_batch, device="cuda",
                        policy=FederationPolicy(serial=serial),
                        record_decisions=True, wait_timeout=300.0))
            finally:
                solver_mod.solve_scan_plain = real_plain
            launches = scan.launches
            LAUNCHES["scan"] += launches
            check(res["device"].startswith("cuda"), f"{name} on the card")
            check_federation_cell(name, res, scenario, clusters)
            check(counts["cluster"] == res["batch_solves"],
                  f"{name}: cluster launches {counts['cluster']} == batch "
                  f"solves {res['batch_solves']}")
            check(not plain_calls, f"{name}: the plain scan ran")
            want = 0 if serial else res["fed_solves"]
            check(launches == want and res["fed_solves"] > 0,
                  f"{name}: scan launches {launches}, want {want} "
                  f"(decisions {res['fed_solves']})")
            decisions = res.pop("decisions")
            card_ms, oracle_ms = replay_decisions(name, decisions)
            log(f"  {name} ({card}): {res['pods_per_s']:.1f} pods/s over "
                f"{res['wall_s']:.3f} s, arrival->bind p50 "
                f"{res['p50_arrival_to_bind_ms']} ms p99 "
                f"{res['p99_arrival_to_bind_ms']} ms; per cluster "
                f"{res['per_cluster']}; spilled {res['spilled']}, victim "
                f"{res['victim']}, failed over {res['failover_replaced']}, "
                f"recovery {res['recovery_ratio']:.3f}; gangs "
                f"{res['gangs_total']} whole")
            log(f"    decisions {res['fed_solves']}, scan launches "
                f"{launches}, batch solves {res['batch_solves']}; replayed: "
                f"kernel ms p50 {np.median(card_ms):.4f} mean "
                f"{np.mean(card_ms):.4f} (CUDA events), oracle ms p50 "
                f"{np.median(oracle_ms):.4f} mean {np.mean(oracle_ms):.4f} "
                f"(host clock); every decision equal to the oracle, the "
                f"plain scan and the kernel")
            res.update(launches=counts, scan_launches=launches, wall=wall,
                       replay_kernel_ms=card_ms, replay_oracle_ms=oracle_ms)
            out[name] = res
    name = "federation degradation differential"
    deg, counts, _, _, _, wall = run_path(
        name, lambda: fed_harness.run_degradation_differential(
            pods=pods, qps=qps, seed=seed, node_cpu=node_cpu,
            max_batch=max_batch, device="cuda"))
    check(deg["identical"] and deg["on"]["lost"] == 0
          and deg["down"]["lost"] == 0 and deg["down"]["fallbacks"] > 0
          and deg["on"]["fallbacks"] == 0,
          f"{name}: on {len(deg['bound_on'])} bound {deg['on']}, down "
          f"{len(deg['bound_down'])} {deg['down']}")
    log(f"  {name}: {len(deg['bound_on'])} bound in both arms, identical; "
        f"fallbacks up {deg['on']['fallbacks']}, down "
        f"{deg['down']['fallbacks']}; launches {counts} ({wall:.1f} s)")
    out[name] = {"bound": len(deg["bound_on"]), "on": deg["on"],
                 "down": deg["down"], "launches": counts}
    return out


# ----------------------------------------------------------------------
# phase 29: the sharded tier
SHARDED_WIDTHS = (1, 2, 4)


def counts_bound_ms(ps: PStatic, ints):
    """Least time for the feasibility counts on these inputs: the pods'
    requests and profiles, the alloc, mask and validity rows read once and
    the counts written once, over HBM bandwidth; a comparison a resource,
    the mask, the validity and the count's add per pod x node over the f32
    peak; the larger of the two."""
    n, b = ps.ints.shape[1], ints.shape[0]
    nbytes = 4 * (b * (ps.r + 1) + (ps.r + ps.u + 1) * n + b)
    ops = float(b) * n * (ps.r + 3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1000
    t_ops = ops / PEAK_F32_OPS_PER_S * 1000
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def _bare_ms(fn, make, repeats):
    """Mean ms of ``repeats`` calls of ``fn(*make())``, CUDA events around
    each call only, after one warm-up call."""
    fn(*make())
    times = []
    for _ in range(repeats):
        args = make()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def time_sharded(batch, repeats=10):
    """Phase 29 (a): on one batch, ``repeats`` bare launches of the
    cluster kernel and of the sharded kernel at each of
    ``SHARDED_WIDTHS``, in turns (cluster, S ascending, S descending,
    cluster); the counts kernel's launches; the plain versions once each
    at the widest mesh. Every sharded result equals the cluster kernel's
    and the plain version's."""
    kernel = solve_mod.solve_kernel
    ps, state, ints, floats = batch
    valid = int((ints[:, ps.r + 3] > 0).sum())
    cluster_plan = kernel.plan(ps)
    check(cluster_plan.kernel == "cluster", "phase 29 batch plans the "
          "cluster kernel")
    finals, meshes = {}, {}
    for s in SHARDED_WIDTHS:
        ss, st = sharded_mod.shard_planes(ps, state, s)
        meshes[s] = (ss, st, kernel.sharded_plan(ss, s))

    def run_cluster(st):
        finals["cluster"] = (kernel.launch(PARAMS, ps, st, ints, floats,
                                           cluster_plan), st)

    def run_sharded(s, st):
        ss, _, plan = meshes[s]
        finals[s] = kernel.launch_sharded(PARAMS, ss, st.planes, st.totals,
                                          ints, floats, plan) + (st,)

    def fresh(s):
        st = meshes[s][1]
        return lambda: (s, SState(st.planes.clone(), st.totals.clone()))

    turns = {}
    order = ["cluster", *SHARDED_WIDTHS, *reversed(SHARDED_WIDTHS),
             "cluster"]
    for which in order:
        if which == "cluster":
            ms = _bare_ms(run_cluster, lambda: (state.clone(),), repeats)
        else:
            ms = _bare_ms(run_sharded, fresh(which), repeats)
        turns.setdefault(which, []).append(ms)
    want, want_state = finals["cluster"]
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    rows = [i for i in range(state.shape[0]) if i != do["totals"]]
    err = 0
    for s in SHARDED_WIDTHS:
        got, word, st = finals[s]
        check(int(word[0]) == 0, f"phase 29: the exchange at S={s} ran out")
        e = max(_err(got, want, st.planes[rows], want_state[rows]),
                int((st.totals - want_state[do["totals"], :ps.t]).abs()
                    .max()))
        err = max(err, e)
        check(e == 0, f"phase 29: sharded kernel at S={s} equals the "
              "cluster kernel")
    widest = SHARDED_WIDTHS[-1]
    ss, st0, _ = meshes[widest]
    counts_ms = _bare_ms(
        lambda: finals.__setitem__("counts", kernel.launch_counts(
            ss, ints, widest)), tuple, repeats)
    plain_st = SState(st0.planes.clone(), st0.totals.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sharded_mod.solve_sharded_plain(PARAMS, ss, plain_st, ints,
                                            floats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000
    got, _, st = finals[widest]
    e = max(_err(got, plain, st.planes, plain_st.planes),
            int((st.totals - plain_st.totals).abs().max()))
    check(e == 0, "phase 29: sharded kernel equals plain")
    t0 = time.perf_counter()
    counts_plain = sharded_mod.feasible_counts_plain(ss, ints, widest)
    torch.cuda.synchronize()
    counts_plain_ms = (time.perf_counter() - t0) * 1000
    counts_err = int((finals["counts"] - counts_plain).abs().max())
    check(counts_err == 0, "phase 29: counts kernel equals plain")
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    b_ms, b_by = bound_ms(*batch)
    c_ms, c_by = counts_bound_ms(ps, ints)
    log(f"  SchedulingBasic batch N={ps.ints.shape[1]} B={ints.shape[0]} "
        f"valid={valid}: cluster kernel ms {turns['cluster'][0]:.3f} / "
        f"{turns['cluster'][1]:.3f} ({ms['cluster'] / valid * 1000:.3f} us "
        "a pod)")
    for s in SHARDED_WIDTHS:
        plan = meshes[s][2]
        log(f"    sharded S={s} ({plan.cluster} blocks x "
            f"{plan.cols_per_block} columns a shard): ms "
            f"{turns[s][0]:.3f} / {turns[s][1]:.3f} "
            f"({ms[s] / valid * 1000:.3f} us a pod)")
    log(f"    counts kernel {counts_ms:.4f} ms (bound {c_ms:.6f}, {c_by}), "
        f"plain {counts_plain_ms:.1f} ms; sharded plain (S={widest}) "
        f"{plain_ms:.1f} ms; bound {b_ms:.6f} ms ({b_by})")
    return {"valid_pods": valid, "ms": {str(k): v for k, v in ms.items()},
            "turns": {str(k): v for k, v in turns.items()},
            "us_per_pod": {str(k): v / valid * 1000 for k, v in ms.items()},
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "err": max(err, e), "counts_ms": counts_ms,
            "counts_plain_ms": counts_plain_ms, "counts_bound_ms": c_ms,
            "counts_bound_by": c_by, "counts_err": counts_err,
            "plans": {str(s): meshes[s][2]._asdict() for s in meshes}}


def phase_sharded(basic, largest, nodes=5000, pods=30000, shards=4,
                  max_batch=4096, repeats=10):
    """Phase 29: (a) ``time_sharded`` on phase 4's largest batch; (b)
    SchedulingBasic at ``nodes`` / ``pods`` through ``run_workload`` on
    ``ShardedBackend(make_mesh(shards))``, the kernels' counts reset just
    before and read just after: every pod bound, no node over its
    capacity, one sharded launch a solve and no other solve kernel; the
    row's largest batch solved again by the kernel and by the plain
    version, all equal to the row's own assignments; (c)
    ``solve_scan_sharded`` on a SchedulingBasic batch of ``max_batch``
    pods over ``nodes``, counted the same way: one sharded and one counts
    launch, the assignments equal to the cluster kernel's and the counts
    to the plain version's; (d) ``time_sharded_scatters`` on (b)'s
    largest batch's planes."""
    kernel = solve_mod.solve_kernel
    timed = time_sharded(largest, repeats)
    kept, handles = {}, []

    def factory():
        be = ShardedBackend(make_mesh(shards))
        real = be.solve_lazy

        def solve_lazy(params, ss, sstate, pod_ints, pod_floats):
            valid = int((pod_ints[:, ss.r + 3] > 0).sum())
            largest = valid > kept.get("valid", -1)
            if largest:
                kept.update(valid=valid, ss=ss, state=SState(
                    sstate.planes.clone(), sstate.totals.clone()),
                    ints=pod_ints.copy(), floats=pod_floats.copy())
            handle = real(params, ss, sstate, pod_ints, pod_floats)
            handles.append(handle)
            if largest:
                kept["assign"] = handle.assign
            return handle

        be.solve_lazy = solve_lazy
        kept["backend"] = be
        return be

    name = "SchedulingBasic (sharded)"
    kernel.reset_counts()
    t0 = time.monotonic()
    res = perf.run_workload("SchedulingBasic", workloads.make_workload(
        "SchedulingBasic", nodes, 0, pods), max_batch=max_batch,
        backend_factory=factory)
    wall = time.monotonic() - t0
    counts = dict(kernel.counts)
    for k in counts:
        LAUNCHES[k] += counts[k]
    torch.cuda.synchronize()
    be = kept["backend"]
    launch_ms = [be.device_seconds(h) * 1000 for h in handles]
    check(res.device.startswith("cuda"), f"{name} ran on the card")
    check(len(res.placements) == pods, f"{name} created {pods} pods")
    unbound = sum(1 for v in res.placements.values() if not v)
    check(unbound == 0, f"{name}: {unbound} pods left unbound")
    check(counts["sharded"] == res.solves == len(handles),
          f"{name}: sharded launches {counts['sharded']} == solves "
          f"{res.solves}")
    others = {k: v for k, v in counts.items() if k != "sharded" and v}
    check(not others, f"{name}: other kernels launched: {others}")
    per_node = {}
    for node in res.placements.values():
        per_node[node] = per_node.get(node, 0) + 1
    fullest = max(per_node.values())
    # node_template: 32 cpu, 64Gi, 110 pods; basic_pod: 500m, 500Mi
    check(fullest * 500 <= 32000 and fullest * 500 <= 64 * 1024
          and fullest <= 110, f"{name}: a node over capacity ({fullest} "
          "pods)")
    # the largest batch again: the kernel and the plain version on the
    # row's own inputs must give the row's assignments
    ss, st = kept["ss"], kept["state"]
    ints = torch.from_numpy(kept["ints"]).cuda()
    floats = torch.from_numpy(kept["floats"]).cuda()
    again = SState(st.planes.clone(), st.totals.clone())
    got = sharded_mod.solve_sharded(PARAMS, ss, again, ints, floats)
    plain_st = SState(st.planes.clone(), st.totals.clone())
    want = sharded_mod.solve_sharded_plain(PARAMS, ss, plain_st, ints,
                                           floats)
    row_err = max(_err(got, want, again.planes, plain_st.planes),
                  int((again.totals - plain_st.totals).abs().max()),
                  int((kept["assign"] - want).abs().max()))
    check(row_err == 0, f"{name}: the largest batch's kernel, plain and "
          "row assignments agree")
    scatters = time_sharded_scatters(be, ss, st, repeats=repeats)
    log(f"  {name} {nodes} nodes / {pods} pods on {res.device}, "
        f"{shards} shards: {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); phase 4 "
        f"{basic.pods_per_second:.1f} pods/s")
    log(f"    enqueue->bind ms p50/p99: {res.latency['Perc50']:.1f} / "
        f"{res.latency['Perc99']:.1f} (phase 4: "
        f"{basic.latency['Perc50']:.1f} / {basic.latency['Perc99']:.1f}); "
        f"solves={res.solves} launches={counts['sharded']} ms a launch "
        f"mean {np.mean(launch_ms):.3f} max {np.max(launch_ms):.3f}; "
        f"largest batch ({kept['valid']} pods) kernel = plain = row; "
        f"fullest node {fullest} pods")
    # (c) the entry point of the reference's tests
    cluster, batch = encode([workloads.node_template(i)
                             for i in range(nodes)],
                            [workloads.basic_pod(i)
                             for i in range(max_batch)], max_batch)
    kernel.reset_counts()
    assign, feasible = solve_scan_sharded(cluster, batch, make_mesh(shards))
    scan_counts = dict(kernel.counts)
    for k in scan_counts:
        LAUNCHES[k] += scan_counts[k]
    check(scan_counts["sharded"] == 1 and scan_counts["counts"] == 1
          and sum(scan_counts.values()) == 2,
          f"solve_scan_sharded launches {scan_counts}")
    ps, state = prepare(cluster, batch, "cuda")
    pi, pf = (torch.from_numpy(a).cuda() for a in pack_podin(batch))
    single = solve_mod.solve_kernel(PARAMS, ps, state, pi, pf)
    ss, _ = sharded_mod.shard_planes(ps, state, shards)
    want_counts = sharded_mod.feasible_counts_plain(ss, pi, shards)
    scan_err = max(int(np.abs(assign - single.cpu().numpy()).max()),
                   int(np.abs(feasible - want_counts.cpu().numpy()).max()))
    check(scan_err == 0, "solve_scan_sharded equals the cluster kernel and "
          "the plain counts")
    log(f"  solve_scan_sharded on {max_batch} pods x {nodes} nodes, "
        f"{shards} shards: equal to the cluster kernel, counts to plain; "
        f"launches {scan_counts}")
    return {"timed": timed,
            "row": {"pods_per_s": res.pods_per_second,
                    "duration_s": res.duration_seconds,
                    "enqueue_to_bind_ms": res.latency,
                    "solve_to_bind_ms": res.metrics, "solves": res.solves,
                    "launches": counts, "launch_ms": launch_ms,
                    "host_seconds": res.seconds, "wall_s": wall,
                    "fullest_node": fullest, "err": row_err,
                    "phase4_pods_per_s": basic.pods_per_second,
                    "phase4_enqueue_to_bind_ms": basic.latency},
            "scan": {"launches": scan_counts, "err": scan_err},
            "scatters": scatters}


def time_sharded_scatters(be, ss, sstate, seed=29, repeats=10):
    """The ``_scatter_jit`` row (``kubernetes_tpu/parallel/sharded.py:
    487``): one batch of capacity deltas forced on ``ShardedBackend``'s
    scatters at phase 29's size (the row's largest batch's planes, four
    shards of 1,280 columns): a set of the cpu allocatable row on a
    seeded quarter of the real columns (the static planes), and adds of
    a deleted pod's requests on the same columns (requested cpu and
    memory, the two nonzero rows, the pod count: the state planes), each
    entry landing on the shard that owns its column. Each timed with
    CUDA events, upload included, ``repeats`` times on fresh copies;
    every result equal bit for bit to the plain version (the same
    ``index_put_`` on CPU copies, host clock); the bound is the bytes
    over the card's memory rate (``scatter_bound_ms``)."""
    rng = np.random.default_rng(seed)
    so, _ = static_planes(ss.r, ss.sc, ss.t, ss.u)
    do, _ = state_planes(ss.r, ss.sc, ss.t, ss.sv)
    ints_host = ss.ints.cpu()
    planes_host = sstate.planes.cpu()
    real = int(ints_host[so["node_valid"]].sum())
    cols = np.sort(rng.choice(real, size=real // 4, replace=False))
    set_rows = np.full(len(cols), so["alloc"], np.int64)
    set_vals = (ints_host[so["alloc"], cols].numpy() + 1000).astype(np.int32)
    add_rows, add_cols, add_vals = [], [], []
    for row, delta in ((do["requested"], 500), (do["requested"] + 1, 500),
                       (do["nonzero"], 500), (do["nonzero"] + 1, 500),
                       (do["pod_count"], 1)):
        cur = planes_host[row, cols].numpy()
        add_rows.append(np.full(len(cols), row, np.int64))
        add_cols.append(cols)
        add_vals.append(-np.minimum(cur, delta).astype(np.int32))
    add_rows, add_cols, add_vals = (np.concatenate(a) for a in (
        add_rows, add_cols, add_vals))
    shards = be.encode_shards
    per_shard = np.bincount(cols // (ss.n // shards), minlength=shards)

    def plain(host, rows, cs, vals, accumulate):
        out = host.clone()
        flat = torch.from_numpy(rows * out.shape[1] + cs)
        t0 = time.perf_counter()
        out.view(-1).index_put_((flat,), torch.from_numpy(vals),
                                accumulate=accumulate)
        return out, (time.perf_counter() - t0) * 1000

    want = {"set": plain(ints_host, set_rows, cols, set_vals, False),
            "add": plain(planes_host, add_rows, add_cols, add_vals, True)}
    ms = {"set": [], "add": []}
    err = 0
    for _ in range(repeats):
        for kind in ("set", "add"):
            if kind == "set":
                target = ss._replace(ints=ss.ints.clone())
                args = (target, set_rows, cols, set_vals)
                scatter = be.scatter_static_set
            else:
                target = SState(sstate.planes.clone(),
                                sstate.totals.clone())
                args = (target, add_rows, add_cols, add_vals)
                scatter = be.scatter_state_add
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            scatter(*args)
            end.record()
            torch.cuda.synchronize()
            ms[kind].append(start.elapsed_time(end))
            got = (target.ints if kind == "set" else target.planes).cpu()
            err = max(err, int((got - want[kind][0]).abs().max()))
    check(err == 0, "sharded scatters equal the plain index_put_ bit for bit")
    out = {}
    for kind, entries in (("set", len(cols)), ("add", len(add_cols))):
        out[kind] = {"entries": entries, "ms": float(np.mean(ms[kind])),
                     "ms_runs": ms[kind], "plain_ms": want[kind][1],
                     "bound_ms": scatter_bound_ms(kind, entries),
                     "bound_by": "bytes"}
        log(f"  sharded {kind}: {entries} entries over {shards} shards "
            f"(per shard {per_shard.tolist()}): {out[kind]['ms']:.4f} ms "
            f"mean of {repeats} (CUDA events, upload included), plain "
            f"{want[kind][1]:.4f} ms, bound {out[kind]['bound_ms']:.3g} ms "
            f"(bytes), max_abs_err {err}")
    out.update(per_shard=per_shard.tolist(), err=err)
    return out


def _launch_check(name, counts, solves):
    """A row's launches: the cluster kernel's at least once, the cluster
    and wide kernels' one a solve, no other solve kernel's."""
    check(counts["cluster"] > 0, f"{name}: the cluster kernel launched")
    others = {k: v for k, v in counts.items()
              if k not in ("cluster", "wide") and v}
    check(not others, f"{name}: other kernels launched: {others}")
    check(counts["cluster"] + counts["wide"] == solves,
          f"{name}: launches {counts} == solves {solves}")


def _ha_row_log(name, row, counts):
    lat = row["latency_ms"]
    log(f"  {name}: {row['pods']:,} pods over {row['nodes']:,} nodes on "
        f"{row['device']}: {row['pods_per_s']:.1f} pods/s over "
        f"{row['seconds']:.3f} s; enqueue->bind ms p50/p99 "
        f"{lat['Perc50']:.1f}/{lat['Perc99']:.1f}; launches cluster="
        f"{counts['cluster']} wide={counts['wide']}")


def phase_config_ha(nodes=5000, pods=30000, every=200, shared_nodes=1000,
                    shared_pods=6000, stop_after=10000, max_batch=4096):
    """Phase 30: the configuration and HA rows of ``harness.ha`` on the
    card, each with the kernels' counts reset just before and read just
    after (``run_path``): (a) the config row, SchedulingBasic ``nodes`` /
    ``pods`` through ``Scheduler.create`` from a v1beta1 dict (16
    workers, two profiles, an HTTP extender on loopback), every
    ``every``-th pod the extender's and every ``every``-th from
    ``every // 2`` the packing profile's; (b) the replica row, two
    node-sharded replicas on one store; (c) two replicas sharing
    ``shared_nodes`` nodes of six pod slots each, ``shared_pods`` pods,
    the capacity guard arbitrating, in the pipelined arm (where a held
    batch a sibling's binds made stale is discarded first) and the
    serialized one, and at five slots a node (serialized), where the two
    replicas' solves claim more than the nodes hold; (d) the failover
    row, the leader
    stopped once ``stop_after`` pods are bound."""
    out = {}
    row, counts, kernel_ms, _, _, wall = run_path(
        "phase 30a", lambda: ha.config_row(
            nodes, pods, every=every, device="cuda", max_batch=max_batch),
        kernel=None)
    res = row.pop("result")
    check(res.device.startswith("cuda"), "phase 30a ran on the card")
    _launch_check("phase 30a", counts, res.solves)
    check(not row["unbound"], f"phase 30a: {len(row['unbound'])} unbound")
    for key in ("extender_violations", "packing_violations",
                "packing_unscored", "rescore_mismatches", "not_serial"):
        check(not row[key], f"phase 30a: {key}: {row[key][:5]}")
    check(row["extender_calls"].get("filter", 0) >= row["extender_pods"],
          "phase 30a: the extender filtered every extender pod")
    log(f"  30a config row: {pods:,} pods over {nodes:,} nodes on "
        f"{res.device}: {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
        f"enqueue->bind ms p50/p99 {res.latency['Perc50']:.1f}/"
        f"{res.latency['Perc99']:.1f}; launches cluster={counts['cluster']} "
        f"wide={counts['wide']}; serial pods {row['serial_pods']} "
        f"({row['extender_pods']} extender, {row['packing_pods']} packing) "
        f"in {row['serial_seconds']:.3f} s; "
        f"extender calls {row['extender_calls']}; packing nodes re-scored "
        f"{row['packing_nodes_scored']}")
    out["a_config"] = dict(row, pods_per_s=res.pods_per_second,
                           duration_s=res.duration_seconds,
                           enqueue_to_bind_ms=res.latency,
                           solves=res.solves, launches=counts,
                           kernel_ms_mean=float(np.mean(kernel_ms)),
                           host_seconds=res.seconds)

    for key, title, kw in (
            ("b_replicas", "30b replica row (2 replicas, node pools)",
             dict(nodes=nodes, pods=pods, shard_nodes=True)),
            ("c_shared", "30c shared nodes, capacity guard, pipelined",
             dict(nodes=shared_nodes, pods=shared_pods, shard_nodes=False,
                  node_pods="6", pipeline=True)),
            ("c_shared_serialized",
             "30c shared nodes, capacity guard, serialized",
             dict(nodes=shared_nodes, pods=shared_pods, shard_nodes=False,
                  node_pods="6", pipeline=False)),
            ("c_oversubscribed",
             "30c shared nodes of five slots, capacity guard, serialized",
             dict(nodes=shared_nodes, pods=shared_pods, shard_nodes=False,
                  node_pods="5", pipeline=False))):
        name = f"phase {title}"
        row, counts, kernel_ms, _, _, wall = run_path(
            name, lambda kw=kw: ha.replica_row(
                device="cuda", max_batch=max_batch, **kw), kernel=None)
        check(row["device"].startswith("cuda"), f"{name} ran on the card")
        _launch_check(name, counts, sum(row["solves_by_replica"]))
        for k in ("lost", "double_binds", "pool_violations",
                  "over_allocatable"):
            check(not row[k], f"{name}: {k}: {row[k][:5]}")
        slots = shared_nodes * int(kw.get("node_pods", "110"))
        if kw["shard_nodes"] or slots >= kw["pods"]:
            check(row["unschedulable"] == 0, f"{name}: every pod bound")
        else:
            check(sum(row["bound_by_replica"]) == slots,
                  f"{name}: every slot filled")
        check(all(n > 0 for n in row["bound_by_replica"]),
              f"{name}: each replica bound pods")
        _ha_row_log(title, row, counts)
        log(f"    bound by replica {row['bound_by_replica']}, solves by "
            f"replica {row['solves_by_replica']}, held batches discarded "
            f"{row['discards_by_replica']}, guard rejects "
            f"{row['capacity_rejects']} (routed serial "
            f"{row['capacity_routed']}), unschedulable "
            f"{row['unschedulable']} (whole run {wall:.1f} s)")
        out[key] = dict(row, launches=counts,
                        kernel_ms_mean=float(np.mean(kernel_ms)))

    row, counts, kernel_ms, _, _, wall = run_path(
        "phase 30d", lambda: ha.failover_row(
            nodes, pods, stop_after=stop_after, device="cuda",
            max_batch=max_batch), kernel=None)
    check(row["device"].startswith("cuda"), "phase 30d ran on the card")
    _launch_check("phase 30d", counts,
                  row["leader_solves"] + row["standby_solves"])
    check(not row["lost"] and not row["double_binds"],
          f"phase 30d: lost {row['lost'][:5]}, bound twice "
          f"{row['double_binds'][:5]}")
    check(row["leader_bound_after_stop"] == 0,
          "phase 30d: the stopped leader bound nothing after its stop")
    check(row["standby_bound_before_stop"] == 0,
          "phase 30d: the standby bound nothing while it stood by")
    check(row["leader_bound"] + row["standby_bound"] == pods,
          "phase 30d: the leader's binds and the standby's are every pod")
    check(row["binds_after_stop"] == row["standby_bound"],
          "phase 30d: every bind after the stop was the standby's")
    check(row["standby_solves"] > 0 and row["standby_leads"],
          "phase 30d: the standby leads and solved on its own session")
    _ha_row_log("30d failover row", row, counts)
    log(f"    leader bound {row['leader_bound']:,} (stop after "
        f"{stop_after:,}; its stop took {row['stop_seconds']:.3f} s), "
        f"standby bound {row['standby_bound']:,}; stop -> standby's first "
        f"bind {row['failover_gap_s']:.3f} s; solves leader "
        f"{row['leader_solves']} standby {row['standby_solves']} (whole "
        f"run {wall:.1f} s)")
    out["d_failover"] = dict(row, launches=counts,
                             kernel_ms_mean=float(np.mean(kernel_ms)))
    return out


def phase_rest(basic, pipeline_runs, nodes=5000, pods=30000, max_batch=4096,
               qps=5000.0, creators=2):
    """Phase 31: ``bench.py``'s rest row once, through
    ``run_workload_rest`` on the card: the apiserver (WAL, RBAC,
    admission, watch cache, APF) and the creators as spawned processes,
    the scheduler here, fed by watch streams and binding through
    BindingList on the binding pool. The kernels' counts reset just
    before and read just after (``run_path``, cold): every launch the
    cluster kernel's, one a solve, and the kernel equal to the plain
    version on the row's largest drained batch. The apiserver's own
    bound count equals the scheduler's and the pods created; the WAL
    holds at least a line per node and two per pod; at least two
    federation instances; watch delivery observed; a
    ``rest_availability`` verdict; no torch in the children; no node's
    bound pods over its allocatable in the apiserver's store; a
    create-to-bind time for every pod. The fabric
    overhead is this row's measured window over phase 4's and phase 8's
    pipelined runs, same size, same process."""
    from kubernetes_tpu_torch.harness.rest_perf import run_workload_rest

    name = "SchedulingBasic/rest"
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_workload_rest(
            "SchedulingBasic", nodes=nodes, measure_pods=pods,
            max_batch=max_batch, qps=qps, n_creator_clients=creators,
            wal=True, device="cuda"),
        keep=True, cold=True)
    row_report(name, res.device, res)
    m = res.metrics
    check(res.device.startswith("cuda"), f"{name} ran on the card")
    check(m["server_pods_bound"] == m["scheduler_bound"] == pods,
          f"{name}: the apiserver bound {m['server_pods_bound']}, the "
          f"scheduler {m['scheduler_bound']}, of {pods}")
    check(m["wal_entries"] >= nodes + 2 * pods,
          f"{name}: {m['wal_entries']} WAL lines < {nodes + 2 * pods}")
    check(counts["cluster"] == res.solves,
          f"{name}: cluster launches {counts['cluster']} == solves "
          f"{res.solves}")
    check(len(m["federation_instances"]) >= 2,
          f"{name}: federation instances {m['federation_instances']}")
    check(m["watch_delivery_p99_ms"] > 0, f"{name}: no watch delivery "
          "observed")
    verdicts = (res.freshness or {}).get("slo") or {}
    check("rest_availability" in verdicts,
          f"{name}: no rest_availability verdict ({verdicts})")
    check(not m["children_import_torch"],
          f"{name}: a spawned child imported torch")
    check(m["rv_regressions"] == 0, f"{name}: list resourceVersions went "
          "backwards")
    check(not m["overcommitted_nodes"], f"{name}: nodes over their "
          f"allocatable in the apiserver's store: "
          f"{m['overcommitted_nodes'][:5]}")
    c2b = m["create_to_bind"]
    check(c2b["n"] == pods, f"{name}: create-to-bind over {c2b['n']} of "
          f"{pods} pods")
    ps, state, ints, floats = recorder.largest()
    st = state.clone()
    assign = solve_mod.solve_kernel(PARAMS, ps, st, ints, floats)
    plain_ms, err = plain_against(name, (ps, state, ints, floats),
                                  (assign, st))
    piped = [r for r in pipeline_runs if r["arm"] == "pipelined"]
    overhead = {
        "phase4": res.duration_seconds / basic.duration_seconds,
        "phase8_pipelined": [res.duration_seconds / r["duration_s"]
                             for r in piped]}
    cp = res.critical_path or {}
    log(f"  {name} {nodes} nodes / {pods} pods on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s); create->bind ms p50/p90/p99 (the "
        f"apiserver's clock, watch delivery included): "
        f"{c2b['Perc50']:.1f} / {c2b['Perc90']:.1f} / {c2b['Perc99']:.1f}; "
        f"the e2e histogram's (from the scheduler's solve start) "
        f"{m['Perc50']:.1f} / {m['Perc90']:.1f} / {m['Perc99']:.1f}; "
        f"enqueue->bind p99 {res.latency['Perc99']:.1f} ms")
    log(f"    fabric overhead (this row's window over the store-direct "
        f"row's, SchedulingBasic {nodes} / {pods} pipelined, same process): "
        f"{overhead['phase4']:.3f}x phase 4 ({basic.pods_per_second:.1f} "
        f"pods/s), "
        + ", ".join(f"{x:.3f}x" for x in overhead["phase8_pipelined"])
        + " phase 8's pipelined runs")
    log(f"    apiserver: bound {m['server_pods_bound']} of "
        f"{m['server_pods_total']}, WAL {m['wal_entries']} lines; scheduler "
        f"bound {m['scheduler_bound']}; federation "
        f"{m['federation_instances']}; watch delivery p50 / p99 "
        f"{m['watch_delivery_p50_ms']:.2f} / {m['watch_delivery_p99_ms']:.2f}"
        f" ms over {m['watch_delivery_events']} pod events; SLOs {verdicts}")
    log(f"    solves={res.solves} launches {counts}; kernel ms a launch "
        f"mean {np.mean(kernel_ms):.3f} max {np.max(kernel_ms):.3f}; "
        f"largest batch kernel = plain (max_abs_err {err})")
    log(f"    critical path over {cp.get('pods', 0)} sampled pods, the "
        f"apiserver's spans stitched in (skew bound "
        f"{cp.get('max_skew_ms')} ms): "
        + ", ".join(f"{k}={v}" for k, v in
                    (cp.get("phase_shares") or {}).items())
        + f"; unattributed {cp.get('unattributed_share')}")
    log("    host seconds: " + ", ".join(
        f"{k}={v:.3f}" for k, v in res.seconds.items()))
    apf = m["apf"] or {}
    return {"pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "create_to_bind_ms": c2b,
            "e2e_ms": {k: m[k] for k in ("Perc50", "Perc90", "Perc99")},
            "enqueue_to_bind_ms": res.latency,
            "server_pods_bound": m["server_pods_bound"],
            "scheduler_bound": m["scheduler_bound"],
            "wal_entries": m["wal_entries"],
            "federation_instances": m["federation_instances"],
            "watch_delivery_ms": {"p50": m["watch_delivery_p50_ms"],
                                  "p99": m["watch_delivery_p99_ms"],
                                  "events": m["watch_delivery_events"]},
            "slo": verdicts, "fabric_overhead": overhead,
            "solves": res.solves, "launches": counts,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "err": err,
            "critical_path": cp, "host_seconds": res.seconds,
            "apf_levels": {k: {"dispatched": v.get("dispatched_total"),
                               "rejected": v.get("rejected")}
                           for k, v in (apf.get("levels") or {}).items()}}

QOS_TENANTS = 3
QOS_THREADS = 6


def phase_qos(rest, nodes=5000, pods=30000, tenants=QOS_TENANTS,
              threads=QOS_THREADS, qps=5000.0, max_batch=4096,
              wait_timeout=600.0):
    """Phase 32: ``bench.py``'s qos row (``harness/qos.py``): the REST
    row's burst while ``tenants`` aggressor processes of ``threads``
    threads each (list storms, watch herds, 200-item ConfigMapList
    POSTs) hammer the apiserver from the measurement's start; the solo
    arm is phase 31's row of this call (``solo_baseline``), as in
    ``bench.py``'s default matrix. The kernels' counts reset just before
    and read just after (``run_path``, cold). Every pod bound in the
    apiserver's store and by the scheduler, the aggressors' requests
    sent (their processes without torch), APF's workload level
    dispatching, every launch the cluster kernel's and one a solve, the
    kernel equal to the plain version on the largest batch. ``qos_ok``
    (contended e2e p99 within twice the solo arm's) is reported, not
    gated."""
    from kubernetes_tpu_torch.harness.qos import run_noisy_tenant_qos

    name = "SchedulingBasic/qos"
    solo = {"pods_per_sec": rest["pods_per_s"],
            "p99_latency_ms": rest["e2e_ms"]["Perc99"]}
    row, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_noisy_tenant_qos(
            nodes, pods, tenants=tenants, qps=qps, max_batch=max_batch,
            aggressor_threads=threads, wait_timeout=wait_timeout,
            progress=log, solo_baseline=solo, device="cuda"),
        keep=True, cold=True)
    res = row.pop("contended")
    row_report(name, res.device, res)
    m = res.metrics
    agg = row["aggressors"]
    apf = row["apf"]
    workload = apf["levels"]["workload"]
    check(res.device.startswith("cuda"), f"{name} ran on the card")
    check(m["server_pods_bound"] == m["scheduler_bound"] == pods,
          f"{name}: the apiserver bound {m['server_pods_bound']}, the "
          f"scheduler {m['scheduler_bound']}, of {pods}")
    check(agg["reported"] == tenants and agg["requests"] > 0,
          f"{name}: aggressors {agg}")
    check(not agg["import_torch"] and not m["children_import_torch"],
          f"{name}: a spawned child imported torch")
    check(workload["dispatched"] > 0,
          f"{name}: APF's workload level dispatched nothing ({apf})")
    check(counts["cluster"] == res.solves,
          f"{name}: cluster launches {counts['cluster']} == solves "
          f"{res.solves}")
    check(not m["overcommitted_nodes"], f"{name}: nodes over their "
          f"allocatable: {m['overcommitted_nodes'][:5]}")
    check(m["rv_regressions"] == 0, f"{name}: list resourceVersions went "
          "backwards")
    ps, state, ints, floats = recorder.largest()
    st = state.clone()
    assign = solve_mod.solve_kernel(PARAMS, ps, st, ints, floats)
    plain_ms, err = plain_against(name, (ps, state, ints, floats),
                                  (assign, st))
    c2b = m["create_to_bind"]
    log(f"  {name} {nodes} nodes / {pods} pods on {res.device}, "
        f"{tenants} aggressor tenants x {threads} threads: contended "
        f"{row['value']} pods/s (solo, phase 31: {row['solo_pods_per_sec']}"
        f"); e2e p99 (Perc99) contended {m['Perc99']:.1f} ms, solo "
        f"{solo['p99_latency_ms']:.1f} ms, p99_ratio_vs_solo "
        f"{row['p99_ratio_vs_solo']}, qos_ok {row['qos_ok']}; create->bind "
        f"p50 / p99 {c2b['Perc50']:.1f} / {c2b['Perc99']:.1f} ms (whole "
        f"run {wall:.1f} s)")
    log(f"    aggressors: {agg['requests']} requests, {agg['throttled']} "
        f"answered 429; APF rejections {apf['rejections']}; by level "
        + ", ".join(f"{k}: dispatched {v['dispatched']} rejected "
                    f"{v['rejected']} peak seats {v['peak_executing_seats']}"
                    f"/{v['capacity']}" for k, v in apf["levels"].items()))
    log(f"    solves={res.solves} launches {counts}; kernel ms a launch "
        f"mean {np.mean(kernel_ms):.3f}; largest batch kernel = plain "
        f"(max_abs_err {err})")
    if not row["qos_ok"]:
        log("    qos_ok is false: the contended p99 is over twice the "
            "solo arm's (reported, not gated)")
    return {"row": row, "e2e_ms": {k: m[k] for k in
                                   ("Perc50", "Perc90", "Perc99")},
            "create_to_bind_ms": c2b, "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "solves": res.solves, "launches": counts,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "err": err,
            "host_seconds": res.seconds}


REPLAY_ROWS = ("storm", "gangs", "tenancy")


class _ScanKeeper:
    """Stands in for the scan wrapper during a row: CUDA events around
    each launch (on the what-if's stream) and copies of each launch's
    inputs and outputs, taken on that stream without waiting for it.
    The launch, and its count, stay the wrapper's."""

    def __init__(self, scan):
        self.scan = scan
        self.events = []
        self.kept = []

    def __getattr__(self, name):
        return getattr(self.scan, name)

    def __call__(self, params, static, state, ints, floats, **kw):
        before = (params, solver_mod.ScanStatic(*(t.clone() for t in static)),
                  solver_mod.ScanState(*(t.clone() for t in state)),
                  ints.clone(), floats.clone())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.scan(params, static, state, ints, floats, **kw)
        end.record()
        self.events.append((start, end))
        self.kept.append((before, out.clone(), [t.clone() for t in state]))
        return out


def plain_every_launch(name, recorder):
    """Each launch of a row (``run_path(..., keep="all")``) against the
    plain version on the card, on copies of its inputs: assignments and
    final state. Returns (launches held, valid pods, plain ms summed,
    largest absolute difference), which must be 0."""
    err, pods, ms = 0, 0, 0.0
    for params, (ps, state, ints, floats), (assign, final), slots in zip(
            recorder.params, recorder.inputs, recorder.outputs,
            recorder.slots):
        check(not slots, f"{name}: a slot-stream launch")
        st = state.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = solve_mod.solve_plain(params, ps, st, ints, floats)
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t0) * 1000
        if want.numel():
            err = max(err, int((assign - want).abs().max()))
        err = max(err, int((final - st).abs().max()))
        pods += int((ints[:, ps.r + 3] > 0).sum())
    check(err == 0, f"{name}: every launch equals the plain version")
    return len(recorder.outputs), pods, ms, err


def scans_against_plain(name, keeper):
    """Each what-if launch of a row against the plain scan on CPU copies
    of its inputs: the assignments and every final table. Returns
    (launches held, largest absolute difference), which must be 0."""
    err = 0
    for (params, static, state, ints, floats), out, final in keeper.kept:
        cpu_state = solver_mod.ScanState(*(t.cpu() for t in state))
        want = solver_mod.solve_scan_plain(
            params, solver_mod.ScanStatic(*(t.cpu() for t in static)),
            cpu_state, ints.cpu(), floats.cpu())
        err = max(err, _max_err([out.cpu(), *(t.cpu() for t in final)],
                                [want, *cpu_state]))
    check(err == 0, f"{name}: every what-if launch equals the plain scan")
    return len(keeper.kept), err


def replay_row(family, seed=11, scale=1.0, time_scale=1.0, max_batch=1024,
               wait_timeout=600.0):
    """One replay row of phase 33 through ``run_replay_row`` on the card,
    the kernels' counts reset just before and read just after
    (``run_path``, cold) and every launch kept; the scan kernel's
    what-if launches kept and counted the same way."""
    from kubernetes_tpu_torch.workloads import run_replay_row

    name = f"replay:{family}"
    scan = solver_mod.scan_kernel
    real_plain_scan = solver_mod.solve_scan_plain
    keeper, plain_scans = _ScanKeeper(scan), []

    def trapped_plain_scan(*args):
        plain_scans.append(1)
        return real_plain_scan(*args)

    solver_mod.scan_kernel = keeper
    solver_mod.solve_scan_plain = trapped_plain_scan
    scan.reset_counts()
    try:
        row, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: run_replay_row(
                family, seed=seed, scale=scale, time_scale=time_scale,
                rest=True, max_batch=max_batch, wait_timeout=wait_timeout,
                progress=log, device="cuda"),
            keep="all", cold=True)
    finally:
        solver_mod.scan_kernel = scan
        solver_mod.solve_scan_plain = real_plain_scan
    scan_launches = scan.launches
    LAUNCHES["scan"] += scan_launches
    row_report(name, row["device"], row)
    check(row["device"].startswith("cuda"), f"{name} ran on the card")
    failed = [k for k, v in row["invariants"].items() if not v]
    check(row["invariants_ok"], f"{name}: invariants failed: {failed}")
    check(row.get("slo_verdicts_ok") is not False,
          f"{name}: SLO verdicts {row.get('freshness', {}).get('slo')} "
          f"(gated {row.get('slo_gated')})")
    check(row["lost_pods"] == 0, f"{name}: lost {row['lost_pods']}")
    check(len(row.get("federation_instances") or ()) >= 2
          and "server" in row, f"{name}: not over the REST fabric")
    check(not row["server"]["import_torch"],
          f"{name}: the apiserver child imported torch")
    solves = row["solves"] + row.get("blind", {}).get("solves", 0)
    check(counts["cluster"] == solves,
          f"{name}: cluster launches {counts['cluster']} == solves {solves}")
    held, pods, plain_ms, err = plain_every_launch(name, recorder)
    check(held == counts["cluster"], f"{name}: {held} launches held of "
          f"{counts['cluster']}")
    check(not plain_scans, f"{name}: the plain scan ran on the card path")
    scan_held, scan_err = scans_against_plain(name, keeper)
    check(scan_held == scan_launches == len(keeper.events),
          f"{name}: scan launches {scan_launches}, kept {scan_held}")
    if family == "storm":
        check(row["preempted"] > 0, f"{name}: the storm preempted nothing")
    if family == "tenancy":
        auto = row["autoscaler"]
        check(auto["scaleup_decisions"] >= 1 and scan_launches >= 1,
              f"{name}: the autoscaler bought nothing ({auto})")
        check(scan_launches == auto["whatif_solves"],
              f"{name}: scan launches {scan_launches} == what-ifs "
              f"{auto['whatif_solves']}")
    else:
        check(scan_launches == 0, f"{name}: {scan_launches} scan launches")
    torch.cuda.synchronize()
    whatif_ms = [a.elapsed_time(b) for a, b in keeper.events]
    telemetry = row.get("telemetry") or {}
    lat = row["latency_by_class_ms"]
    log(f"  {name} on {row['device']}: {row['value']} pods/s against "
        f"{row['offered_rate_pods_per_sec']} offered ({row['injected']} "
        f"pods); arrival->bind p50 / p99 {row['p50_arrival_to_bind_ms']} / "
        f"{row['p99_arrival_to_bind_ms']} ms; by class "
        + ", ".join(f"{k} {v['p50']}/{v['p99']}" for k, v in lat.items())
        + f"; preempted {row['preempted']}, expired {row['expired']}, "
        f"lost {row['lost_pods']}; gangs {row['gangs']}; invariants "
        f"{row['invariants']}; SLO {row.get('freshness', {}).get('slo')} "
        f"(gated {row.get('slo_gated')}) (whole run {wall:.1f} s)")
    log(f"    launches: cluster {counts['cluster']} (solves {solves}), "
        f"scan {scan_launches}; every launch held against the plain version"
        f" ({held} launches, {pods} pods, plain {plain_ms:.1f} ms summed; "
        f"max_abs_err {err}; what-ifs {scan_held}, max_abs_err {scan_err});"
        f" device seconds: devprof {telemetry.get('device_s', 0.0):.4f} "
        f"(scored arm), CUDA events {sum(kernel_ms) / 1000:.4f} over every "
        f"launch; unexpected compiles {telemetry.get('unexpected_compiles')}")
    if family == "gangs":
        log(f"    adjacency: {row['adjacency_ab']}; blind arm {row['blind']}")
    if family == "tenancy":
        log(f"    autoscaler {row['autoscaler']}; APF {row.get('apf')}; "
            f"what-if ms {[round(x, 3) for x in whatif_ms]}")
    return {"row": row, "launches": dict(counts, scan=scan_launches),
            "kernel_ms": kernel_ms, "whatif_ms": whatif_ms,
            "plain_ms": plain_ms, "held": held, "pods_held": pods,
            "err": err, "scan_err": scan_err, "wall_s": wall}


def phase_replays(seed=11, scale=1.0, time_scale=1.0, max_batch=1024):
    """Phase 33: ``bench.py``'s three replay rows (``replay:storm``,
    ``replay:gangs``, ``replay:tenancy``) at its size (``scale`` 1.0,
    ``time_scale`` 1.0, seed 11, batches of at most 1,024) over the REST
    fabric (``workloads/replay_bench.py``): pods arriving open loop on
    the trace's clock and expiring into deletions. Each row must pass
    its own verdicts (the family's invariants and the SLO gate): zero
    lost, gangs whole, no priority inversion (storm), scored beating
    adjacency-blind (gangs, both arms), the serve class's p99 within
    budget with the autoscaler buying nodes (tenancy, its what-ifs on
    the scan kernel); every cluster-kernel and scan-kernel launch held
    against its plain version."""
    rows = {family: replay_row(family, seed=seed, scale=scale,
                               time_scale=time_scale, max_batch=max_batch)
            for family in REPLAY_ROWS}
    return {"rows": rows,
            "err": max(r["err"] for r in rows.values()),
            "scan_err": max(r["scan_err"] for r in rows.values())}



# phase 34's size: cut from bench.py's scale10x row (50,000 nodes /
# 500,000 pods) to fit this script's time (30,000 pods until phases
# 40-42 came)
SCALE_NODES, SCALE_PODS, SCALE_PARTITIONS = 5000, 15000, 4
# the depth cut that keeps the whole script under 1,100 s with phases
# 34 and 40-42: the replay rows' scale and time scale together (the same
# rate a node, 30% of the pods and of the trace's length; 0.5 with phase
# 34 alone; at 0.2 the tenancy row's autoscaler buys no node)
REPLAY_SCALE = 0.3


def scale_launches(name, recorder, lo, hi):
    """Launches ``lo:hi`` of a recorded run (one arm's, the arms running
    one after the other): the kernel each one's plan gives, and each
    held against the plain version. Returns (launches by kernel, the
    pools' plans by shape, held, valid pods, plain ms, max_abs_err)."""
    part = _Recorder(recorder.kernel, keep="all")
    for attr in ("inputs", "slots", "params", "outputs", "events"):
        setattr(part, attr, getattr(recorder, attr)[lo:hi])
    by_kernel = dict.fromkeys(LAUNCHES, 0)
    for (ps, _, ints, floats), slots in zip(part.inputs, part.slots):
        by_kernel[planned_kernel(ps, ints, floats, slots)] += 1
    plans = check_plans(name, by_kernel, part)
    held, pods, plain_ms, err = plain_every_launch(name, part)
    check(held == hi - lo, f"{name}: {held} launches held of {hi - lo}")
    return ({k: v for k, v in by_kernel.items() if v}, plans, held, pods,
            plain_ms, err)


def scale_arm_report(name, arm, launches, kernel_ms, extra=None):
    """Check one arm's invariants and print its ``row {...}`` line."""
    by_kernel, plans, held, pods, plain_ms, err = launches
    check(arm["device"].startswith("cuda"), f"{name} ran on the card")
    check(arm["lost_pods"] == 0, f"{name}: lost {arm['lost_pods']}")
    check(arm["double_binds"] == 0 and arm["oversubscribed_nodes"] == 0,
          f"{name}: double binds {arm['double_binds']}, nodes over "
          f"{arm['oversubscribed_nodes']}")
    check(sum(arm["solves"]) == sum(by_kernel.values()),
          f"{name}: launches {by_kernel} == solves {arm['solves']}")
    check(len(arm["federation_instances"]) >= arm["partitions"]
          + arm["replicas"], f"{name}: federation "
          f"{arm['federation_instances']}")
    busy_events = sum(kernel_ms) / 1000 / arm["time_to_all_bound_s"]
    row = {"row": name, "device": arm["device"],
           "nodes": arm["nodes"], "pods": arm["pods"],
           "cut": "from bench.py's 50,000 nodes / 500,000 pods",
           "partitions": arm["partitions"], "replicas": arm["replicas"],
           "pods_per_s": arm["pods_per_sec"],
           "seconds": arm["time_to_all_bound_s"],
           "e2e_ms": arm["e2e_ms"],
           "partition_pods": arm["partition_pods"],
           "partition_balance": arm["partition_balance"],
           "watch_streams": arm.get("watch_streams"),
           "stale_binds_rejected": arm["stale_binds_rejected"],
           "replica_pools": arm["replica_pools"],
           "launches": by_kernel, "plans": plans,
           "launches_held": held, "pods_held": pods,
           "plain_ms": plain_ms, "max_abs_err": err,
           "kernel_ms_sum": sum(kernel_ms),
           "device_busy_share": arm["device_busy_share"],
           "device_busy_share_events": busy_events,
           **(extra or {})}
    ROW_REPORTS.append(row)
    print("row " + json.dumps(row, default=str), flush=True)
    log(f"  {name} {arm['nodes']:,} nodes / {arm['pods']:,} pods (cut "
        f"from 50,000 / 500,000), {arm['partitions']} partitions x "
        f"{arm['replicas']} replicas on {arm['device']}: "
        f"{arm['pods_per_sec']:.1f} pods/s over "
        f"{arm['time_to_all_bound_s']:.3f} s; e2e ms p50 / p99 "
        f"{arm['e2e_ms']['p50']:.1f} / {arm['e2e_ms']['p99']:.1f}; "
        f"partition pods {arm['partition_pods']}; pools "
        f"{arm['replica_pools']}; launches {by_kernel} (held against "
        f"plain, max_abs_err {err}); stale binds "
        f"{arm['stale_binds_rejected']}; card busy "
        f"{arm['device_busy_share']} (devprof), {busy_events:.4f} (CUDA "
        f"events over every launch)")
    return row


def phase_scale(nodes=SCALE_NODES, pods=SCALE_PODS,
                partitions=SCALE_PARTITIONS, replicas=2, max_batch=1024,
                wait_timeout=600.0):
    """Phase 34 (see the module's docstring): the in-process arm, then
    ``run_scale10x_row`` over REST, each under ``run_path`` with every
    launch kept and held against the plain version."""
    from kubernetes_tpu_torch.harness.scale import (
        run_scale10x_row,
        run_scale_arm_inproc,
    )

    name = "scale:inproc"
    arm, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_scale_arm_inproc(
            nodes=nodes, pods=pods, partitions=partitions,
            replicas=replicas, use_batch=True, max_batch=max_batch,
            device="cuda", wait_timeout=wait_timeout, progress=log),
        keep="all", kernel=None)
    launches = scale_launches(name, recorder, 0, len(recorder.inputs))
    check(launches[0] == {k: v for k, v in counts.items() if v},
          f"{name}: counted {counts}, planned {launches[0]}")
    inproc = scale_arm_report(name, arm, launches, kernel_ms,
                              {"wall_s": wall})

    name = "scale10x"
    row, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_scale10x_row(
            nodes=nodes, pods=pods, partitions=partitions,
            replicas=replicas, max_batch=max_batch, device="cuda",
            wait_timeout=wait_timeout, progress=log),
        keep="all", kernel=None)
    arms = row["arms"]
    cut = sum(arms["partitioned"]["solves"])
    total = len(recorder.inputs)
    check(sum(counts.values()) == total == cut
          + sum(arms["single"]["solves"]),
          f"{name}: launches {counts}, kept {total}, solves "
          f"{arms['partitioned']['solves']} + {arms['single']['solves']}")
    ab = row["ab"]
    reports, planned = {}, dict.fromkeys(counts, 0)
    for arm_name, lo, hi in (("partitioned", 0, cut),
                             ("single", cut, total)):
        arm = arms[arm_name]
        check(arm["server_pods_bound"] == arm["server_pods_total"] == pods,
              f"{name}/{arm_name}: the partition servers hold "
              f"{arm['server_pods_total']} pods, {arm['server_pods_bound']} "
              f"bound, of {pods}")
        check(arm["rv_regressions"] == 0,
              f"{name}/{arm_name}: list versions went backwards")
        reports[arm_name] = scale_arm_report(
            f"{name}/{arm_name}", arm, scale_launches(
                f"{name}/{arm_name}", recorder, lo, hi),
            kernel_ms[lo:hi],
            {"speedup": ab["speedup"], "sharding_pays": ab["sharding_pays"],
             "created": arm["created"]})
        for k, v in reports[arm_name]["launches"].items():
            planned[k] += v
    check(planned == counts, f"{name}: counted {counts}, planned {planned}")
    cell = row["conflict_cell"]
    check(cell["ok"] and cell["conflicts_total"] > 0,
          f"{name}: the conflict cell {cell}")
    check(row["invariants"] == {"lost_pods": 0, "double_binds": 0},
          f"{name}: invariants {row['invariants']}")
    check(not row["children_import_torch"],
          f"{name}: a spawned child imported torch")
    log(f"  {name}: A/B {ab['partitioned_pods_per_sec']:.1f} against "
        f"{ab['single_partition_pods_per_sec']:.1f} pods/s, speedup "
        f"{ab['speedup']:.3f} (sharding_pays {ab['sharding_pays']}); "
        f"conflict cell {cell}; whole row {wall:.1f} s")
    return {"inproc": inproc, "partitioned": reports["partitioned"],
            "single": reports["single"], "ab": ab, "conflict_cell": cell,
            "wall_s": wall,
            "err": max(r["max_abs_err"] for r in
                       (inproc, reports["partitioned"],
                        reports["single"]))}


# ----------------------------------------------------------------------
# phases 35-37: the elastic control plane's write side. The JAX package's
# sizes: the reshard cells' own defaults, ``bench.py``'s hotspot row
# (24,000 pods, 3 partitions, hot share 0.8, 3 creators) and its upgrade
# row (``run_upgrade_row()``'s defaults)
RESHARD_SEED = 11
HOTSPOT_PODS, HOTSPOT_PARTITIONS, HOTSPOT_SHARE = 24_000, 3, 0.8
RECOVERY_BAR = 0.8


def phase_reshard(seed=RESHARD_SEED):
    """Phase 35: the reshard chaos cells (``harness/chaos_reshard.py``),
    one seed each: migrations under a write storm, the rebalancer under
    a hot tenant, and a spawned WAL-backed partition server SIGKILLed
    mid migration and restored. No scheduler runs: no kernel launches.
    Each cell's verdict and its zero-loss count gate; relists and the
    freeze are reported."""
    from kubernetes_tpu_torch.harness.chaos_reshard import (
        run_reshard_midstorm,
        run_reshard_rebalance,
        run_reshard_sigkill,
    )

    out = {}
    for cell, run in (
            ("midstorm", lambda: run_reshard_midstorm(seed, nodes=20,
                                                      pods=120)),
            ("rebalance", lambda: run_reshard_rebalance(seed, nodes=20,
                                                        pods=300)),
            ("sigkill", lambda: run_reshard_sigkill(seed, nodes=20,
                                                    pods=80,
                                                    progress=log))):
        name = f"reshard:{cell}"
        t0 = time.monotonic()
        r = run()
        wall = time.monotonic() - t0
        st = r["stats"]
        check(r["ok"], f"{name}: {r['failure']}")
        check(st["lost"] == 0, f"{name}: lost {st['lost']}")
        row = {"row": name, "seed": seed, "profile": r["profile"],
               "ok": r["ok"], **st, "wall_s": wall}
        ROW_REPORTS.append(row)
        print("row " + json.dumps(row, default=str), flush=True)
        log(f"  {name} seed {seed}: ok {r['ok']}; lost {st['lost']}, "
            f"relists beyond the moved slices "
            f"{st.get('unmoved_relists', 'no watch')}, epoch "
            f"{st['epoch']}, frozen {st['frozen_ms']} ms; {st} "
            f"({wall:.1f} s)")
        out[cell] = row
    return out


def phase_hotspot(pods=HOTSPOT_PODS, partitions=HOTSPOT_PARTITIONS,
                  hot_share=HOTSPOT_SHARE):
    """Phase 36: ``bench.py``'s hotspot row (``harness/hotspot.py``): the
    balanced, hotspot and rebalanced arms over spawned partition
    apiservers and creator children, no scheduler. Zero lost pods and
    watch events, no duplicate, no relist of an unmoved slice, no
    resourceVersion regression and the rebalancer's action gate; the
    recovery ratio is reported against its bar of 0.8."""
    from kubernetes_tpu_torch.harness.hotspot import run_hotspot_row

    name = "hotspot"
    t0 = time.monotonic()
    row = run_hotspot_row(pods=pods, partitions=partitions,
                          hot_share=hot_share, creator_clients=3,
                          wait_timeout=900.0, progress=log)
    wall = time.monotonic() - t0
    inv = row["invariants"]
    for k in ("lost_pods", "duplicated_pods", "lost_watches",
              "unmoved_relists", "rv_regressions"):
        check(inv[k] == 0, f"{name}: {k} {inv[k]}")
    check(inv["rebalancer_acted"], f"{name}: the rebalancer never acted")
    ops = [m.get("reason") for m in row["migrations"]]
    splits, moves = ops.count("split"), ops.count("move")
    report = {"row": name, "pods": pods, "partitions": partitions,
              "hot_share": hot_share, "creators": 3,
              "recovery_bar": RECOVERY_BAR,
              "recovery_ok": row["recovery_ratio"] >= RECOVERY_BAR,
              "splits": splits, "moves": moves, "wall_s": wall,
              **{k: v for k, v in row.items() if k != "metric"}}
    ROW_REPORTS.append(report)
    print("row " + json.dumps(report, default=str), flush=True)
    log(f"  {name} {pods:,} pods, {partitions} partitions, hot share "
        f"{hot_share}: pods/s balanced {row['balanced_pods_per_sec']}, "
        f"hotspot {row['hotspot_pods_per_sec']}, rebalanced "
        f"{row['rebalanced_pods_per_sec']} (recovered "
        f"{row['recovered_rate']}); recovery ratio "
        f"{row['recovery_ratio']} against the bar {RECOVERY_BAR} "
        f"({'met' if report['recovery_ok'] else 'NOT met'}, reported, not "
        f"gated); splits {splits}, moves {moves} committed, frozen "
        f"{row['frozen_ms_total']} ms, epoch {row['epoch']}; lost pods "
        f"{inv['lost_pods']}, lost watch events {inv['lost_watches']} "
        f"({wall:.1f} s)")
    return report


def kernel_alone_ms(recorder):
    """Each launch of a row (``run_path(..., keep="all")``) run again on
    its kernel alone, on copies of its inputs, timed with CUDA events:
    the card's own time for the row's launches. The run's own events
    bracket the wrapper's call, so they also hold the host's waits
    inside it and the launches other threads queued meanwhile."""
    ms = 0.0
    for params, (ps, state, ints, floats) in zip(recorder.params,
                                                 recorder.inputs):
        st = state.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solve_mod.solve_kernel(params, ps, st, ints, floats,
                               profiles_checked=True)
        end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
    return ms


def phase_upgrade(pods=2400, qps=100.0, max_batch=256):
    """Phase 37: ``bench.py``'s upgrade row (``run_upgrade_row()``'s
    defaults: 2,400 pods at 100 a second, 3 spawned partition
    apiservers with prespawned standbys, 2 scheduler replicas with batch
    paths of at most 256 pods on the card), every partition and replica
    rolled once under the open-loop arrivals, under ``run_path`` with
    every launch kept: each launch on the kernel its plan gives and held
    against the plain version, bit for bit. The row line is printed,
    then the zero-loss invariants, exactly-once restarts, one epoch and
    the v1 witness are checked; the p99 arrival-to-bind against its
    500 ms budget, the freeze against its 2 s budget and the SLO
    verdicts are reported. The card's busy share: the launches' kernel
    times alone (``kernel_alone_ms``) over the row's wall time; beside
    it the share of the run's own launch events, which bound it from
    above. ``run_upgrade_roll``'s own
    defaults, as a call of their own (the kernel builds at its first
    launch)::

        python3 -c 'import chip_smoke as c; c.phase_upgrade(30000, 5000, 4096)'
    """
    from kubernetes_tpu_torch.harness.upgrade import (
        P99_ARRIVAL_TO_BIND_BUDGET_MS,
        run_upgrade_row,
    )

    name = "upgrade"
    row, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_upgrade_row(pods=pods, qps=qps,
                                      max_batch=max_batch, progress=log,
                                      device="cuda"),
        keep="all", kernel=None)
    by_kernel, plans, held, pods_held, plain_ms, err = scale_launches(
        name, recorder, 0, len(recorder.inputs))
    check(by_kernel == {k: v for k, v in counts.items() if v},
          f"{name}: counted {counts}, planned {by_kernel}")
    check(sum(counts.values()) > 0, f"{name}: no kernel launched")
    check(row["device"].startswith("cuda"), f"{name} ran on the card")
    check(not row["children_import_torch"],
          f"{name}: a spawned child imported torch")
    alone_ms = kernel_alone_ms(recorder)
    busy_row = alone_ms / 1000 / wall
    events_row = sum(kernel_ms) / 1000 / wall
    report = {"row": name, "max_batch": max_batch,
              **{k: v for k, v in row.items()
                 if k not in ("metric", "freshness")},
              "slo_verdicts_ok": row.get("slo_verdicts_ok"),
              "p99_budget_ms": P99_ARRIVAL_TO_BIND_BUDGET_MS,
              "p99_within_budget": row["p99_arrival_to_bind_ms"]
              <= P99_ARRIVAL_TO_BIND_BUDGET_MS,
              "launches": by_kernel, "plans": plans,
              "launches_held": held, "pods_held": pods_held,
              "plain_ms": plain_ms, "max_abs_err": err,
              "kernel_ms_sum": sum(kernel_ms),
              "kernel_alone_ms_sum": alone_ms,
              "device_busy_share_row": busy_row,
              "launch_events_share_row": events_row, "wall_s": wall}
    ROW_REPORTS.append(report)
    print("row " + json.dumps(report, default=str), flush=True)
    log(f"  {name} on {row['device']}: {row['value']} pods/s over the "
        f"roll's {row['roll_wall_s']} s; arrival-to-bind p50 / p99 "
        f"{row['p50_arrival_to_bind_ms']} / {row['p99_arrival_to_bind_ms']}"
        f" ms against the {P99_ARRIVAL_TO_BIND_BUDGET_MS:.0f} ms budget; "
        f"rolled {row['rolled_partitions']} partitions and "
        f"{row['rolled_replicas']} replicas, exactly once "
        f"{row['rolled_exactly_once']}; frozen max {row['frozen_ms_max']} "
        f"ms against {row['freeze_budget_ms']:.0f}; codec "
        f"renegotiations {row['codec_renegotiations']}, failures "
        f"{row['codec_failures']}; handoff fetches "
        f"{row['handoff_fetches']}; epoch {row['epoch']}; invariants "
        f"{'ok' if row['invariants_ok'] else row['invariants']}; "
        f"launches {by_kernel}, every one held against plain "
        f"(max_abs_err {err}); card busy {busy_row:.4f} of the row's "
        f"{wall:.1f} s (the kernels alone; the run's launch events "
        f"{events_row:.4f})")
    failed = set((row["invariants"] or {}).get("failed", "").split())
    gated = failed - {"slo", "freeze_budget"}
    check(not gated, f"{name}: invariants failed: {sorted(gated)}")
    check(row["ever_bound"] == row["injected"] == pods,
          f"{name}: bound {row['ever_bound']} of {row['injected']}")
    return report


WATCHHERD_QUICK = dict(informers=64, creates=120, qps=20.0,
                       herd_children=2, nodes=20, replica_arms=(0, 4))


def phase_readtier(wait_timeout=300.0, **sizes):
    """Phase 38 (see the module's docstring): the watch-herd row at
    ``bench.py``'s ``--quick`` sizes (``sizes`` overrides them; with
    ``WATCHHERD_FULL`` it is ``run_watchherd_row()``'s defaults), then
    the owner_restart and lag_fence cells. Returns the rows and cells."""
    from kubernetes_tpu_torch.harness.watchherd import (
        READ_SCALING_FLOOR_X,
        WRITE_FLAT_TOLERANCE,
        run_chaos_readtier,
        run_watchherd_row,
    )

    kw = {**WATCHHERD_QUICK, **sizes}
    t0 = time.monotonic()
    rows = run_watchherd_row(wait_timeout=wait_timeout, progress=log, **kw)
    row_s = time.monotonic() - t0
    arms = [r for r in rows if r["metric"].startswith("watchherd[")]
    (scaling,) = [r for r in rows
                  if r["metric"].startswith("watchherd_scaling")]
    (kill,) = [r for r in rows if r["metric"].startswith("watchherd_cell")]
    for arm in arms:
        name = f"readtier:R={arm['replicas']}"
        check(arm["lost_events"] == 0 and arm["unconverged_informers"] == 0,
              f"{name}: lost {arm['lost_events']}, unconverged "
              f"{arm['unconverged_informers']}")
        check(arm["dup_suppressed"] == 0,
              f"{name}: {arm['dup_suppressed']} duplicate frames on steady "
              "streams")
        check(arm["relists"] == 0, f"{name}: {arm['relists']} relists with "
              "no process killed")
        report = {"row": name, **{k: v for k, v in arm.items()
                                  if k not in ("metric", "freshness")}}
        ROW_REPORTS.append(report)
        print("row " + json.dumps(report, default=str), flush=True)
        log(f"  {name}: {arm['informers']} informers, "
            f"{arm['events_committed']} events, {arm['value']} events/s "
            f"delivered ({arm['fanout_per_owner_cpu_s']} per owner "
            f"CPU-second, owner {arm['owner_cpu_s']} s), writes "
            f"{arm['write_qps_achieved']}/s of {arm['write_qps_offered']}; "
            f"replication lag p99 {arm['replication_lag_p99_ms']} ms "
            f"against {arm['lag_budget_ms']}; fences {arm['fences']}, "
            f"reroutes {arm['reroutes']}, replica reads "
            f"{arm['replica_reads']}; lost {arm['lost_events']}; arm "
            f"invariants {'ok' if arm['invariants_ok'] else arm['invariants']}")
    check(scaling["differential_match"],
          f"readtier: truth hashes differ {scaling['state_hashes']}")
    log(f"  readtier scaling: {scaling['read_scaling_x']}x per owner "
        f"CPU-second (JAX bar {READ_SCALING_FLOOR_X}x, reported), wall "
        f"{scaling['wall_clock_scaling_x']}x; write ratio "
        f"{scaling['write_ratio']} (bar {1 - WRITE_FLAT_TOLERANCE:.2f}, "
        f"reported); hashes {scaling['state_hashes']} ({row_s:.1f} s)")
    out = {"arms": arms, "scaling": scaling, "cells": {}, "row_s": row_s}
    cells = [("replica_kill", kill)]
    for scenario in ("owner_restart", "lag_fence"):
        t0 = time.monotonic()
        cell = run_chaos_readtier(16, scenario=scenario, progress=log)
        cell.pop("replica_stats", None)
        cell["wall_s"] = time.monotonic() - t0
        cells.append((scenario, cell))
    for scenario, cell in cells:
        name = f"readtier:{scenario}"
        check(cell["lost_events"] == 0, f"{name}: lost "
              f"{cell['lost_events']}")
        check(cell["relists_beyond_faulted"] == 0,
              f"{name}: {cell['relists_beyond_faulted']} relists beyond the "
              "faulted replica")
        if scenario == "replica_kill":
            check(cell["relists_on_faulted"] >= 1,
                  f"{name}: the killed replica's informers never relisted")
        elif scenario == "owner_restart":
            check(cell["resumes"] >= 1 and cell["reseeds"] == 0
                  and cell["relists"] == 0,
                  f"{name}: resumes {cell['resumes']}, reseeds "
                  f"{cell['reseeds']}, relists {cell['relists']}")
        else:
            check(cell["fences"] >= 1, f"{name}: the lagging replica "
                  "never fenced")
        check(cell["ok"], f"{name}: {cell['failure']}")
        report = {"row": name, **{k: v for k, v in cell.items()
                                  if k not in ("metric", "invariants")}}
        ROW_REPORTS.append(report)
        print("row " + json.dumps(report, default=str), flush=True)
        log(f"  {name}: ok; {cell['informers']} informers, "
            f"{cell['events_committed']} events, lost "
            f"{cell['lost_events']}, relists {cell['relists']} (on the "
            f"faulted {cell['relists_on_faulted']}), reroutes "
            f"{cell['reroutes']}, fences {cell['fences']}, resumes "
            f"{cell['resumes']}, reseeds {cell['reseeds']}")
        out["cells"][scenario] = report
    return out


WATCHHERD_FULL = dict(informers=320, creates=240, qps=12.0,
                      herd_children=4, nodes=100, replica_arms=(0, 1, 4))


def phase_federation_rest(pods=900, qps=300.0, max_batch=256):
    """Phase 39 (see the module's docstring): ``run_federation_row`` for
    spill and loss under ``run_path`` with every launch kept, each launch on
    the kernel its plan gives and held against the plain version."""
    from kubernetes_tpu_torch.harness.federation import (
        P99_PER_CLUSTER_BUDGET_MS,
        RECOVERY_RATIO_FLOOR,
        run_federation_row,
    )

    out = {}
    for mode in ("spill", "loss"):
        name = f"federation-rest:{mode}"
        row, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: run_federation_row(
                pods=pods, qps=qps, mode=mode, max_batch=max_batch,
                progress=log, device="cuda"),
            keep="all", kernel=None)
        by_kernel, plans, held, pods_held, plain_ms, err = scale_launches(
            name, recorder, 0, len(recorder.inputs))
        check(by_kernel == {k: v for k, v in counts.items() if v},
              f"{name}: counted {counts}, planned {by_kernel}")
        check(counts["cluster"] > 0, f"{name}: the cluster kernel never "
              "launched")
        check(row["device"].startswith("cuda"), f"{name} ran on the card")
        check(not row["children_import_torch"],
              f"{name}: a spawned cell imported torch")
        report = {"row": name, "max_batch": max_batch,
                  **{k: v for k, v in row.items()
                     if k not in ("metric", "freshness")},
                  "p99_per_cluster_budget_ms": P99_PER_CLUSTER_BUDGET_MS,
                  "launches": by_kernel, "plans": plans,
                  "launches_held": held, "pods_held": pods_held,
                  "plain_ms": plain_ms, "max_abs_err": err,
                  "kernel_ms_sum": sum(kernel_ms),
                  "launch_events_share_row": sum(kernel_ms) / 1000 / wall,
                  "wall_s": wall}
        ROW_REPORTS.append(report)
        print("row " + json.dumps(report, default=str), flush=True)
        p99s = {c: v["p99_ms"] for c, v in row["per_cluster"].items()}
        log(f"  {name} on {row['device']}: {row['ever_bound']}/"
            f"{row['injected']} bound, {row['value']} pods/s (offered "
            f"{row['offered_rate_pods_per_sec']}); p50 / p99 arrival-to-"
            f"bind {row['p50_arrival_to_bind_ms']} / "
            f"{row['p99_arrival_to_bind_ms']} ms; per cluster p99 {p99s} "
            f"against {P99_PER_CLUSTER_BUDGET_MS:.0f} ms (reported); "
            f"spilled {row['spilled']}, failovers {row['failovers']}, "
            f"recovery {row['recovery_ratio']} (bar "
            f"{RECOVERY_RATIO_FLOOR}), gang splits {row['gang_splits']}, "
            f"survivor relists {row['survivor_relists']}, lost "
            f"{row['lost_pods']}; launches {by_kernel}, every one held "
            f"against plain (max_abs_err {err}); {wall:.1f} s")
        failed = set((row["invariants"] or {}).get("failed", "").split())
        gated = failed - {"slo", "per_cluster_slo"}
        check(not gated, f"{name}: invariants failed: {sorted(gated)}")
        check(row["lost_pods"] == 0
              and row["ever_bound"] == row["injected"] == pods,
              f"{name}: bound {row['ever_bound']} of {row['injected']}, "
              f"lost {row['lost_pods']}")
        if mode == "loss":
            check(row["recovery_ratio"] >= RECOVERY_RATIO_FLOOR,
                  f"{name}: recovery ratio {row['recovery_ratio']}")
        out[mode] = report
    return out


# ----------------------------------------------------------------------
# the chaos ring (phases 40-42 and ``phase_chaos_matrix``)
def chaos_rest_cell(seed=11, profile="mixed"):
    """One ``run_chaos_rest`` cell at the JAX package's defaults (20
    nodes, 120 pods in 6 waves, the apiserver child SIGKILLed and
    restored from its WAL after a seeded wave), the kernels' counts reset
    just before and read just after: the cell's scheduler is serial, so
    none may launch. Returns (the cell, launches, errors, problems), as
    the other cells do: no launch, no error."""
    from kubernetes_tpu_torch.harness.chaos_rest import run_chaos_rest

    kernel, scan = solve_mod.solve_kernel, solver_mod.scan_kernel
    kernel.reset_counts()
    scan.reset_counts()
    cell = run_chaos_rest(seed, fault_profile=profile, progress=log)
    launched = kernel.launches + scan.launches
    st = cell["stats"]
    problems = [] if cell["ok"] else [cell["failure"] or
                                      str(cell["invariants"])]
    if st["kills"] != 1 or st["server_starts"] != 2:
        problems.append(f"kills {st['kills']}, starts {st['server_starts']}")
    if st["faults_injected"] <= 0:
        problems.append("no fault injected")
    if st["child_imports_torch"]:
        problems.append("the apiserver child imported torch")
    if launched:
        problems.append(f"{launched} kernel launches on the serial path")
    log(f"  chaos_rest[{seed}/{profile}]: {'ok' if not problems else problems}"
        f"; invariants {cell['invariants']}; faults injected "
        f"{st['faults_injected']}, client retries {st['client_retries']}, "
        f"degraded {st['degraded_seconds']} s, killed after wave "
        f"{st['kill_wave']}; {st['wall_s']:.1f} s")
    return cell, {}, {}, problems


def phase_chaos_rest(seed=11):
    """Phase 40 (see the module's docstring)."""
    cell, _, _, problems = chaos_rest_cell(seed)
    check(not problems, f"chaos_rest[{seed}/mixed]: {problems}")
    report = {"row": f"chaos_rest:{seed}/mixed", **cell}
    ROW_REPORTS.append(report)
    print("row " + json.dumps(report, default=str), flush=True)
    return cell


class _ShardedKeeper:
    """Stands in for the kernel wrapper's ``launch_sharded`` while
    entered: copies of each launch's inputs and outputs, taken on the
    stream without waiting for it. The launch, and its count, stay the
    wrapper's."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.kept = []

    def __enter__(self):
        real = self.kernel.launch_sharded

        def launch_sharded(params, ss, planes, totals, ints, floats):
            before = (params, ss._replace(
                ints=ss.ints.clone(), f32s=ss.f32s.clone(),
                sc_meta=ss.sc_meta.clone(), has_dom=ss.has_dom.clone()),
                planes.clone(), totals.clone(), ints.clone(),
                floats.clone())
            assign, err = real(params, ss, planes, totals, ints, floats)
            self.kept.append((before, assign.clone(), planes.clone(),
                              totals.clone()))
            return assign, err

        self.kernel.launch_sharded = launch_sharded
        return self

    def __exit__(self, *exc):
        del self.kernel.launch_sharded

    def against_plain(self, name):
        """Each kept launch against ``solve_sharded_plain`` on copies of
        its inputs: assignments, planes and totals. Returns (launches
        held, largest absolute difference), which must be 0."""
        err = 0
        for (params, ss, planes, totals, ints, floats), assign, p_out, \
                t_out in self.kept:
            st = SState(planes.clone(), totals.clone())
            want = sharded_mod.solve_sharded_plain(params, ss, st, ints,
                                                   floats)
            err = max(err, _err(assign, want, p_out, st.planes),
                      int((t_out - st.totals).abs().max()))
        check(err == 0, f"{name}: every sharded launch equals the plain "
              "version")
        return len(self.kept), err


def held_run(name, run):
    """``run()`` under ``run_path`` with every launch kept (the cluster
    kernel's through the recorder, the sharded kernel's and the scan
    kernel's through their keepers), the plain versions trapped, and
    afterwards each launch held against its plain version; the counts
    kernel must not launch. Returns
    (run's result, launches by kernel, the largest error by kernel,
    the launch events' ms summed, wall seconds)."""
    kernel = solve_mod.solve_kernel
    scan = solver_mod.scan_kernel
    real_plain_scan = solver_mod.solve_scan_plain
    real_plain_sharded = sharded_mod.solve_sharded_plain
    keeper, plain_calls = _ScanKeeper(scan), []

    def trapped(real):
        def plain(*args):
            plain_calls.append(real.__name__)
            return real(*args)
        return plain

    solver_mod.scan_kernel = keeper
    solver_mod.solve_scan_plain = trapped(real_plain_scan)
    sharded_mod.solve_sharded_plain = trapped(real_plain_sharded)
    scan.reset_counts()
    try:
        with _ShardedKeeper(kernel) as shards:
            out, counts, kernel_ms, _, recorder, wall = run_path(
                name, run, keep="all", kernel=None, sharded_kept=True)
    finally:
        solver_mod.scan_kernel = scan
        solver_mod.solve_scan_plain = real_plain_scan
        sharded_mod.solve_sharded_plain = real_plain_sharded
    check(not plain_calls, f"{name}: plain versions ran on the card path: "
          f"{sorted(set(plain_calls))}")
    # the session's sharded backend counts no feasibility: a launch of
    # the counts kernel here would go unheld
    check(not counts["counts"], f"{name}: {counts['counts']} counts-kernel "
          "launches, none held against plain")
    counts = dict(counts, scan=scan.launches)
    LAUNCHES["scan"] += scan.launches
    errs = {}
    if recorder.outputs:
        by_kernel, _, held, _, _, errs["cluster"] = scale_launches(
            name, recorder, 0, len(recorder.inputs))
        check(by_kernel == {k: v for k, v in counts.items()
                            if v and k not in ("sharded", "counts", "scan")},
              f"{name}: counted {counts}, planned {by_kernel}")
    if shards.kept:
        held, errs["sharded"] = shards.against_plain(name)
        check(held == counts["sharded"], f"{name}: sharded launches "
              f"{counts['sharded']}, kept {held}")
    if keeper.kept:
        held, errs["scan"] = scans_against_plain(name, keeper)
        check(held == counts["scan"], f"{name}: scan launches "
              f"{counts['scan']}, kept {held}")
    return out, {k: v for k, v in counts.items() if v}, errs, \
        sum(kernel_ms), wall


MIRROR_SEED = 11


def mirror_cell(scenario, seed=MIRROR_SEED):
    """One ``run_chaos_mirror`` cell at its defaults (20 nodes, 120
    pods) on the card, both arms, every launch held against its plain
    version (``held_run``). Returns (the cell, launches, errors,
    problems)."""
    from kubernetes_tpu_torch.harness.chaos_mirror import run_chaos_mirror

    name = f"chaos_mirror[{seed}/{scenario}]"
    cell, counts, errs, kernel_ms, wall = held_run(
        name, lambda: run_chaos_mirror(seed, scenario=scenario,
                                       device="cuda", progress=log))
    st = cell["stats"]
    problems = [] if cell["ok"] else [cell["failure"]]
    if not cell["device"].startswith("cuda"):
        problems.append(f"ran on {cell['device']}")
    want = "sharded" if scenario == "mesh_resize" else "cluster"
    if not counts.get(want):
        problems.append(f"the {want} kernel never launched")
    if any(errs.values()):
        problems.append(f"launches differ from plain: {errs}")
    log(f"  {name}: {'ok' if not problems else problems}; differential "
        f"match {cell['differential_match']}, lost {cell['lost_pods']}, "
        f"bound {st['bound']} of {st['created']} created ({st['deleted']} "
        f"deleted); scattered events {st['events']}, catch-ups "
        f"{st['catch_ups']}, reseeds {st['reseeds']}, widths "
        f"{st['widths']}; launches {counts}, every one held against plain "
        f"(max_abs_err {errs}); {wall:.1f} s")
    return cell, counts, errs, problems


def phase_mirror_ring(seed=MIRROR_SEED):
    """Phase 41 (see the module's docstring): the three mirror cells,
    every launch held against its plain version. Returns the cells and
    the largest error by kernel."""
    from kubernetes_tpu_torch.harness.chaos_mirror import MIRROR_SCENARIOS

    out = {"cells": {}, "errs": {}}
    for scenario in MIRROR_SCENARIOS:
        cell, counts, errs, problems = mirror_cell(scenario, seed)
        check(not problems, f"chaos_mirror[{seed}/{scenario}]: {problems}")
        if scenario == "event_storm":
            check(cell["stats"]["reseeds"] >= 1, "event_storm: no reseed")
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"].get(k, 0), v)
        report = {"row": f"chaos_mirror:{seed}/{scenario}", **cell,
                  "launches": counts, "max_abs_err": errs}
        ROW_REPORTS.append(report)
        print("row " + json.dumps(report, default=str), flush=True)
        out["cells"][scenario] = report
    return out


def phase_mirror_ab():
    """``bench.py``'s mirror A/B, as a call of its own (see the module's
    docstring)::

        python3 -c 'import chip_smoke as c; c.phase_mirror_ab()'

    Both arms and the node_kill cell run in one ``held_run``: every
    launch kept and held against its plain version afterwards. Prints
    the row and raises (a non-zero exit) on a failed gate or a launch
    that differs from plain. Returns the row."""
    from kubernetes_tpu_torch.harness.chaos_mirror import run_mirror_ab

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    log(f"[mirror-ab] card: {gpu_name_and_power()}")
    name = "mirror_ab"
    rows, counts, errs, kernel_ms, wall = held_run(
        name, lambda: run_mirror_ab(device="cuda", progress=log))
    on, off, summary = rows
    cell = summary.pop("cell")
    report = {"row": name, **summary, "launches": counts,
              "max_abs_err": errs, "launch_events_ms": kernel_ms,
              "wall_s": wall, "node_kill_cell": cell["stats"],
              "on_telemetry": on.get("telemetry"),
              "off_telemetry": off.get("telemetry"),
              "on_mirror": on.get("mirror"), "off_session": off["session"]}
    print("row " + json.dumps(report, default=str), flush=True)
    log(f"  {name}: on {summary['mirror_on_pods_per_sec']:.1f} / off "
        f"{summary['mirror_off_pods_per_sec']:.1f} pods/s (overhead "
        f"{summary['value']} %); cycles on / off "
        f"{on['cycles']} / {off['cycles']}; h2d a cycle on / off "
        f"{summary['h2d_per_cycle_on_bytes']} / "
        f"{summary['h2d_per_cycle_off_bytes']} B (strictly below: "
        f"{summary['h2d_below_off']}); encode share on / off "
        f"{summary['encode_share_on']} / {summary['encode_share_off']}; "
        f"reseeds on {summary['reseeds_on']}; p99 on / off "
        f"{summary['p99_on_ms']:.1f} / {summary['p99_off_ms']:.1f} ms; "
        f"node_kill differential {summary['differential_match']}, lost "
        f"{summary['differential_lost_pods']}; on arm's mirror events "
        f"{(on.get('mirror') or {}).get('events')}; gates "
        f"{summary['gates']}; launches {counts}, every one held "
        f"against plain (max_abs_err {errs}); {wall:.1f} s")
    check(not any(errs.values()), f"{name}: launches differ from plain")
    check(summary["ok"], f"{name}: gates failed: "
          f"{[k for k, v in summary['gates'].items() if not v]}")
    return report


NODES_SEED = 3


# the autoscale cell: the JAX package's own churn-with-autoscaler case
# (tests/test_autoscaler.py, TestChurnIntegration): the workload needs
# about 9 of 10 nodes and the killer profile buries up to 3, so binding
# it all takes autoscaled replacements
AUTOSCALE_CELL = dict(seed=29, profile="killer", nodes=10, pods=70,
                      node_cpu=4, waves=4, wait_timeout=180.0)


def nodes_cell(seed=NODES_SEED, profile="mixed", autoscale=False, **sizes):
    """One ``run_chaos_nodes`` cell, at the JAX package's defaults unless
    ``sizes`` says otherwise (16 nodes, 96 pods in 6 waves over REST,
    batches of 64 on the card); with ``autoscale`` the cluster
    autoscaler's what-ifs on the scan kernel, which must buy a node.
    Every launch held against its plain version. Returns (the cell,
    launches, errors, problems)."""
    from kubernetes_tpu_torch.harness.chaos_nodes import run_chaos_nodes

    name = f"chaos_nodes[{seed}/{profile}{'+autoscale' if autoscale else ''}]"
    cell, counts, errs, kernel_ms, wall = held_run(
        name, lambda: run_chaos_nodes(seed, churn_profile=profile,
                                      autoscale=autoscale, device="cuda",
                                      **sizes))
    st = cell["stats"]
    actions = st["churn_actions"]
    problems = [] if cell["ok"] else [cell["failure"]
                                      or str(cell["invariants"])]
    if not str(st["device"]).startswith("cuda"):
        problems.append(f"ran on {st['device']}")
    if actions.get("kill", 0) + actions.get("flap", 0) == 0:
        problems.append("no kill or flap happened")
    if counts.get("cluster", 0) != st["batch_solves"]:
        problems.append(f"cluster launches {counts.get('cluster', 0)} != "
                        f"solves {st['batch_solves']}")
    if counts.get("scan", 0) != st["whatif_solves"]:
        problems.append(f"scan launches {counts.get('scan', 0)} != "
                        f"what-ifs {st['whatif_solves']}")
    if autoscale and not (st["autoscaler_nodes_added"] >= 1
                          and counts.get("scan", 0) >= 1):
        problems.append("the autoscaler bought nothing")
    if any(errs.values()):
        problems.append(f"launches differ from plain: {errs}")
    log(f"  {name}: {'ok' if not problems else problems}; invariants "
        f"{cell['invariants']}; actions {actions}; evictions "
        f"{st['evictions']}, rescues {st['rescues']} (p50 / p99 "
        f"{st['rescue_p50_s']} / {st['rescue_p99_s']} s), stale commits "
        f"refused {st['stale_binds_rejected']}, rebuilds "
        f"{st['session_rebuilds']}, scale-ups {st['autoscaler_scaleups']} "
        f"(+{st['autoscaler_nodes_added']} nodes, what-ifs "
        f"{st['whatif_solves']}); launches {counts}, every one held "
        f"against plain (max_abs_err {errs}); {wall:.1f} s")
    return cell, counts, errs, problems


def phase_node_churn(seed=NODES_SEED):
    """Phase 42 (see the module's docstring). Returns the two cells and
    the largest error by kernel."""
    out = {"cells": {}, "errs": {}}
    auto = dict(AUTOSCALE_CELL)
    for key, (cell_seed, kw) in (
            ("mixed", (seed, {})),
            ("autoscale", (auto.pop("seed"), dict(auto, autoscale=True)))):
        cell, counts, errs, problems = nodes_cell(cell_seed, **kw)
        check(not problems, f"chaos_nodes[{cell_seed}/{key}]: {problems}")
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"].get(k, 0), v)
        report = {"row": f"chaos_nodes:{cell_seed}/{key}", **cell,
                  "launches": counts, "max_abs_err": errs}
        ROW_REPORTS.append(report)
        print("row " + json.dumps(report, default=str), flush=True)
        out["cells"][key] = report
    return out


CHAOS_MATRIX = {
    "rest": [(s, "mixed") for s in (11, 23, 37, 41, 53)]
    + [(11, p) for p in ("resets", "pushback", "watchstorm")],
    "nodes": [(s, "mixed") for s in (3, 17, 29, 47, 61)]
    + [(3, p) for p in ("killer", "flappy", "gentle")],
    "mirror": [(s, sc) for sc in ("node_kill", "mesh_resize", "event_storm")
               for s in (11, 23)],
}


def phase_chaos_matrix():
    """The chaos ring's seeded matrix, as a call of its own (the seeds of
    the JAX package's slow chaos tests, and seed 11 / 3 on each other
    profile; the mirror cells at seeds 11 and 23)::

        python3 -c 'import chip_smoke as c; c.phase_chaos_matrix()'

    Every cell runs, on the card where it has a batch path, with every
    launch held against its plain version; a ``cell {...}`` line each
    and a summary line; raises (a non-zero exit) if any cell failed."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    log(f"[matrix] card: {gpu_name_and_power()}")
    runs = {"rest": chaos_rest_cell, "nodes": nodes_cell,
            "mirror": lambda seed, scenario: mirror_cell(scenario, seed)}
    verdicts = []
    for suite, cells in CHAOS_MATRIX.items():
        for seed, profile in cells:
            t0 = time.monotonic()
            try:
                cell, counts, _, problems = runs[suite](seed, profile)
            except Exception as e:  # noqa: BLE001 — record, go on
                cell, counts, problems = {}, {}, [f"raised {e!r}"]
            verdict = {"suite": suite, "seed": seed, "profile": profile,
                       "ok": not problems, "problems": problems,
                       "launches": counts,
                       "stats": cell.get("stats"),
                       "invariants": cell.get("invariants"),
                       "wall_s": time.monotonic() - t0}
            verdicts.append(verdict)
            print("cell " + json.dumps(verdict, default=str), flush=True)
    failed = [f"{v['suite']}:{v['seed']}/{v['profile']}"
              for v in verdicts if not v["ok"]]
    print(json.dumps({"matrix": len(verdicts), "failed": failed,
                      "launches": LAUNCHES}), flush=True)
    check(not failed, f"chaos matrix: failed cells {failed}")
    return verdicts


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    t_start = time.monotonic()
    card = gpu_name_and_power()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    t0 = time.monotonic()
    libs = build.build_kernels([solve_mod.KERNEL_SOURCE,
                                solver_mod.SCAN_SOURCE])
    log(f"[2] built {', '.join(lib.name for lib in libs)} from "
        f"{KERNEL_SOURCE} and {SCAN_SOURCE} in "
        f"{time.monotonic() - t0:.1f} s (one nvcc each, together)")
    for lib in libs:
        print_ptxas(lib)

    log("[3] kernels against plain on seeded problems")
    errs = phase_compare()

    observe_rows()
    log("[4] main path: SchedulingBasic (pipelined, mirror on)")
    res, counts, kernel_ms, largest = run_main_path(
        "SchedulingBasic", 5000, 30000)
    check_attribution("SchedulingBasic", res)

    log("[5] TopologySpreading")
    spread, spread_counts, spread_ms, spread_largest = run_main_path(
        "TopologySpreading", 5000, 5000)
    skew = zone_skew(spread)
    check(skew <= 1, f"TopologySpreading zone skew {skew} <= 1")
    log(f"  zone skew {skew}")

    log("[6] small slices: card against CPU")
    phase_small_slices()

    log("[7] kernel timing: both kernels in turns")
    batches = {"SchedulingBasic": largest,
               "TopologySpreading": spread_largest,
               "SchedulingBasic@1024": cut_columns(largest, 1024)}
    timings, finals = {}, {}
    for name, batch in batches.items():
        timings[name], finals[name] = time_batch(name + " largest batch",
                                                 batch)
    sb = timings["SchedulingBasic"]
    split = split_per_pod(sb, timings["SchedulingBasic@1024"])
    sweep = {"SchedulingBasic": cluster_sweep("SchedulingBasic", largest),
             "TopologySpreading": cluster_sweep("TopologySpreading",
                                                spread_largest)}
    plain_ms, err = plain_against("SchedulingBasic", largest,
                                  finals["SchedulingBasic"])
    errs["cluster"] = max(errs["cluster"], err)
    _, err = plain_against("TopologySpreading", spread_largest,
                           finals["TopologySpreading"])
    errs["cluster"] = max(errs["cluster"], err)
    b_ms, b_by = bound_ms(*largest)
    log(f"  bound on the SchedulingBasic batch {b_ms:.6f} ms ({b_by})")
    for t in timings.values():
        for k in errs:
            errs[k] = max(errs[k], t["err"])

    log("[8] pipelined against serialized: SchedulingBasic, in turns")
    pipeline_runs = phase_pipeline()

    log("[9] the churn path, mirror on and off")
    churn = phase_churn()

    log("[10] the sustained-arrival row, pipelined and serialized")
    sustained_rows = phase_sustained()

    log("[11] the Preemption row, pipelined and serialized")
    preemption = phase_preemption()

    log("[12] the Unschedulable row")
    unschedulable = phase_unschedulable()

    log("[13] small Preemption and mixed serial rows: card against CPU")
    phase_small_rows()

    log("[14] the GangScheduling row, pipelined and serialized")
    gang = phase_gang()

    log("[15] the SchedulingPodAntiAffinity row")
    anti, slots = phase_anti_affinity()
    for k in ("slots", "wide"):
        errs[k] = max(errs[k], slots["err"])

    log("[16] the wide-term families: SchedulingPodAffinity, "
        "SchedulingPreferredPodAffinity, SchedulingPreferredPodAntiAffinity")
    wide, wide_err = phase_wide_terms()
    errs["slots"] = max(errs["slots"], wide_err)

    log("[17] the PV rows: SchedulingInTreePVs, SchedulingMigratedInTreePVs, "
        "SchedulingCSIPVs, SchedulingSharedPVs")
    pv_rows = phase_pv_rows()

    log("[18] PreemptionPVs, pipelined and serialized")
    preemption_pvs = phase_preemption_pvs()

    log("[19] the shared-volume attach planes at size")
    shared = phase_shared_volumes()
    for k in ("cluster", "wide"):
        errs[k] = max(errs[k], shared["err"])

    log("[20] BASELINE configs 1-3: SchedulingBasic 100/1,000 and "
        "1,000/10,000, TopologySpreading 5,000/30,000")
    configs = phase_configs()

    log("[21] SchedulingSecrets, SchedulingNodeAffinity, "
        "PreferredTopologySpreading, MixedSchedulingBasePod")
    families = phase_families()

    log("[22] the tracer's cost: SchedulingBasic with tracing on, off, off, "
        "on")
    tracing = phase_tracing_cost()

    log("[23] the latency-budget tuner forced to shrink")
    tuner = phase_tuner()

    log("[24] the scan kernel against the plain scan on seeded what-ifs")
    errs["scan"] = phase_scan_compare()

    log(f"[25] the autoscale row: {AUTOSCALE_BURST:,} pods (cut from "
        f"{AUTOSCALE_ROW_BURST:,}) from a fifth of the nodes, boot 1 s")
    autoscale = phase_autoscale()
    scan_fixed = scan_batch(*autoscale_whatif(), "cuda")
    scan_ms, scan_plain_ms, err, scan_pods = time_scan(
        "autoscale what-if shape", scan_fixed)
    errs["scan"] = max(errs["scan"], err)
    scan_b_ms, scan_b_by = scan_bound_ms(*scan_fixed)
    yard = whatif_problem(**SCAN_YARDSTICK)
    yard_batch = scan_batch(*yard, "cuda")
    yard_ms, yard_plain_ms, err, yard_pods = time_scan(
        "fixed yardstick", yard_batch)
    errs["scan"] = max(errs["scan"], err)
    yard_b_ms, _ = scan_bound_ms(*yard_batch)

    log("[26] mesh-block gangs on the batch path")
    mesh = phase_mesh()

    log("[27] federation cells: spill and loss-mid, oracle and scan-kernel "
        "decisions; the degradation differential")
    federation = phase_federation(card)
    check(STATE_ONLY["checked"] >= 1,
          "no state-only rebuild on phases 4, 5, 11 or 14")
    log(f"  state-only rebuilds checked against a fresh prepare: "
        f"{STATE_ONLY['checked']}, equal {STATE_ONLY['equal']}")

    log(f"[28] the anti-affinity row with every {WIDE_PODS_EVERY}th measured "
        f"pod carrying {WIDE_POD_TERMS} weighted pod-affinity terms: the "
        "wide kernel unforced")
    wide_pods, wide_timed = phase_wide_pods(anti)
    errs["wide"] = max(errs["wide"], wide_timed["err"])

    log("[29] the sharded tier: bare timings at 1, 2 and 4 shards, "
        "SchedulingBasic 5,000 / 30,000 on ShardedBackend(make_mesh(4)), "
        "solve_scan_sharded")
    sharded = phase_sharded(res, largest)
    st_timed = sharded["timed"]
    errs["sharded"] = max(errs["sharded"], st_timed["err"],
                          sharded["row"]["err"], sharded["scan"]["err"])
    errs["counts"] = max(errs["counts"], st_timed["counts_err"],
                         sharded["scan"]["err"])
    for k in ("sharded", "counts"):
        check(LAUNCHES[k] > 0, f"the {k} kernel launched on the main path")

    log("[30] the configuration and HA rows: SchedulingBasic 5,000 / "
        "30,000 from a v1beta1 dict (two profiles, an HTTP extender on "
        "loopback, 16 workers), on a two-replica set, 1,000 shared nodes "
        "with the capacity guard, and an elected pair failing over")
    config_ha = phase_config_ha()

    log("[31] the REST row: SchedulingBasic 5,000 / 30,000 through the "
        "apiserver process (WAL, RBAC, admission, watch cache, APF), two "
        "creator clients at 5,000 QPS each, the scheduler on watch streams "
        "binding through BindingList")
    rest = phase_rest(res, pipeline_runs)
    errs["cluster"] = max(errs["cluster"], rest["err"])

    log(f"[32] the noisy-tenant QoS row: phase 31's row again while "
        f"{QOS_TENANTS} aggressor tenants of {QOS_THREADS} threads each "
        "(list storms, watch herds, bulk ConfigMap abuse) hammer the "
        "apiserver; phase 31 is the solo arm")
    qos = phase_qos(rest)
    errs["cluster"] = max(errs["cluster"], qos["err"])

    log(f"[33] the replay rows over the REST fabric at scale and time scale "
        f"{REPLAY_SCALE} (cut from 1.0): storm, gangs (scored and "
        f"adjacency-blind), tenancy (the autoscaler buying nodes)")
    replays = phase_replays(scale=REPLAY_SCALE, time_scale=REPLAY_SCALE)
    errs["cluster"] = max(errs["cluster"], replays["err"])
    errs["scan"] = max(errs["scan"], replays["scan_err"])

    log(f"[34] the partitioned control plane at {SCALE_NODES:,} nodes / "
        f"{SCALE_PODS:,} pods (cut from bench.py's 50,000 / 500,000): the "
        f"in-process arm ({SCALE_PARTITIONS} partitions, 2 node-sharded "
        f"replicas, batches of 1,024), then the scale10x row over REST "
        f"({SCALE_PARTITIONS} partition apiservers and 1, a hollow fleet, "
        f"the conflict cell)")
    scale_phase = phase_scale()
    for k in {k for arm in ("inproc", "partitioned", "single")
              for k in scale_phase[arm]["launches"]}:
        errs[k] = max(errs[k], scale_phase["err"])

    log("[35] the reshard chaos cells: midstorm (20 nodes / 120 pods), "
        "rebalance (20 / 300), sigkill (20 / 80), seed "
        f"{RESHARD_SEED}")
    reshard = phase_reshard()

    log(f"[36] the hotspot row: {HOTSPOT_PODS:,} pods, "
        f"{HOTSPOT_PARTITIONS} partition apiservers, hot share "
        f"{HOTSPOT_SHARE}, 3 creator children; balanced, hotspot and "
        "rebalanced arms")
    hotspot = phase_hotspot()

    log("[37] the rolling-upgrade row: 2,400 pods at 100/s, 3 partition "
        "apiservers and 2 scheduler replicas (batches of 256) each "
        "restarted once under open-loop arrivals")
    upgrade = phase_upgrade()
    for k in upgrade["launches"]:
        errs[k] = max(errs[k], upgrade["max_abs_err"])

    log("[38] the read tier: the watch-herd row at bench.py's --quick "
        "sizes (64 informers, 120 creates at 20/s, arms R = 0 and 4, the "
        "replica-kill cell), then the owner_restart and lag_fence cells")
    readtier = phase_readtier()

    log("[39] federation over REST: 3 spawned cells, 900 pods at 300/s, "
        "the spill and loss rows, each cell's batch path on the card")
    federation_rest = phase_federation_rest()
    for row in federation_rest.values():
        for k in row["launches"]:
            errs[k] = max(errs[k], row["max_abs_err"])

    log("[40] chaos over REST: run_chaos_rest seed 11, mixed faults, 20 "
        "nodes / 120 pods in 6 waves, the apiserver child SIGKILLed and "
        "restored from its WAL mid-workload; the serial scheduler, no "
        "kernel")
    chaos_rest = phase_chaos_rest()

    log("[41] the mirror ring: node_kill, mesh_resize (2 then 4 shards), "
        "event_storm at seed 11, both arms on the card (the mirror A/B "
        "is a call of its own, phase_mirror_ab)")
    mirror_ring = phase_mirror_ring()
    for k, v in mirror_ring["errs"].items():
        errs[k] = max(errs[k], v)

    log("[42] node churn over REST: run_chaos_nodes seed 3, mixed churn, "
        "16 nodes / 96 pods, batches of 64 on the card; then seed 29, "
        "killer churn, 10 nodes of 4 cpu / 70 pods, with the "
        "autoscaler's what-ifs on the scan kernel")
    node_churn = phase_node_churn()
    for k, v in node_churn["errs"].items():
        errs[k] = max(errs[k], v)
    log(f"  main-path launches over phases 4, 5, 8 to 34, 37, 39, 41 and "
        f"42: {LAUNCHES}")

    scatters = {"scatters": {
        arm: {"counts": r["scatters"], "host_s": r["host_seconds"]["scatter"],
              "device_ms": {k: sum(v) for k, v in
                            r["scatter_device_ms"].items()},
              "bound_ms": {k: sum(v) for k, v in
                           r["scatter_bound_ms"].items()}}
        for arm, r in churn.items()}}
    scatters["scatters"]["sharded"] = {
        kind: {k: v for k, v in sharded["scatters"][kind].items()
               if k != "ms_runs"} for kind in ("add", "set")}
    # each kernel on the largest batch of a main path it runs on
    sv_timed = shared["timed"]
    timed = {
        "cluster": {"ms": sb["ms"]["cluster"], "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "batch": "SchedulingBasic largest batch",
                    "carries": "the sv attach planes",
                    "sv_ms": sv_timed["ms"]["cluster"],
                    "sv_plain_ms": shared["plain_ms"],
                    "sv_bound_ms": shared["bound_ms"],
                    "sv_bound_by": shared["bound_by"],
                    "sv_batch": f"shared-volume phase largest batch "
                                f"(SV=512, {sv_timed['valid_pods']} pods)"},
        "slots": {"ms": slots["ms"]["slots"],
                  "plain_ms": slots["plain_ms"]["slots"],
                  "bound_ms": slots["bound_ms"], "bound_by": slots["bound_by"],
                  "batch": f"SchedulingPodAntiAffinity largest batch "
                           f"(T={slots['t']}), slot stream"},
        "wide": {"ms": wide_timed["ms"], "plain_ms": wide_timed["plain_ms"],
                 "bound_ms": wide_timed["bound_ms"],
                 "bound_by": wide_timed["bound_by"],
                 "batch": f"phase 28 largest batch (T={wide_timed['t']}, "
                          f"{wide_timed['valid_pods']} pods, "
                          f"{wide_timed['wide_pods']} of more than "
                          f"{SPARSE_K} term references)",
                 "t100_forced_ms": slots["ms"]["wide"],
                 "t100_forced_plain_ms": slots["plain_ms"]["wide"],
                 "t100_forced_bound_ms": slots["wide_bound_ms"],
                 "t100_forced_batch": f"SchedulingPodAntiAffinity largest "
                                      f"batch (T={slots['t']}), dense "
                                      f"stream, forced",
                 "carries": "the sv attach planes",
                 "sv_ms": sv_timed["ms"]["wide"],
                 "sv_batch": "shared-volume phase largest batch, forced"},
        "sharded": {"ms": st_timed["ms"][str(SHARDED_WIDTHS[-1])],
                    "plain_ms": st_timed["plain_ms"],
                    "bound_ms": st_timed["bound_ms"],
                    "bound_by": st_timed["bound_by"],
                    "batch": f"SchedulingBasic largest batch "
                             f"({st_timed['valid_pods']} pods), "
                             f"{SHARDED_WIDTHS[-1]} shards",
                    "ms_by_shards": st_timed["ms"],
                    "us_per_pod_by_shards": st_timed["us_per_pod"],
                    "row_launch_ms_mean": float(np.mean(
                        sharded["row"]["launch_ms"]))},
        "counts": {"ms": st_timed["counts_ms"],
                   "plain_ms": st_timed["counts_plain_ms"],
                   "bound_ms": st_timed["counts_bound_ms"],
                   "bound_by": st_timed["counts_bound_by"],
                   "batch": f"SchedulingBasic largest batch, "
                            f"{SHARDED_WIDTHS[-1]} shards"},
        "scan": {"ms": scan_ms, "plain_ms": scan_plain_ms,
                 "bound_ms": scan_b_ms, "bound_by": scan_b_by,
                 "batch": f"autoscale_whatif() ({scan_pods} pods, N="
                          f"{scan_fixed[0].allocatable.shape[0]})",
                 "yardstick_ms": yard_ms, "yardstick_plain_ms": yard_plain_ms,
                 "yardstick_bound_ms": yard_b_ms,
                 "yardstick": f"whatif_problem({SCAN_YARDSTICK}) "
                              f"({yard_pods} pods, N="
                              f"{yard_batch[0].allocatable.shape[0]})"}}
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": LAUNCHES[k],
        "max_abs_err": float(errs[k]), **timed[k], "library_ms": None,
        "library_ms_reason": reason,
    } for k, name, source, replaces, reason in (
        ("cluster", "solve_cluster_kernel", KERNEL_SOURCE, REPLACES,
         SOLVE_REASON),
        ("slots", "solve_slots_kernel", KERNEL_SOURCE, REPLACES_SPARSE,
         SOLVE_REASON),
        ("wide", "solve_wide_kernel", KERNEL_SOURCE, REPLACES,
         SOLVE_REASON),
        ("sharded", "solve_sharded_kernel", KERNEL_SOURCE, REPLACES_SHARDED,
         SOLVE_REASON),
        ("counts", "feasible_counts_kernel", KERNEL_SOURCE, REPLACES_COUNTS,
         "no single PyTorch call computes the masked fit counts (a "
         "comparison, a gather of profile masks, two ands and a sum)"),
        ("scan", "solve_scan_kernel", SCAN_SOURCE, REPLACES_SCAN,
         SOLVE_REASON))]}
    report = {
        "card": card, "kernels": kernels["kernels"],
        "scheduling_basic": {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds,
            "enqueue_to_bind_ms": res.latency, "solve_to_bind_ms": res.metrics,
            "solves": res.solves, "rebuilds": res.rebuild_kinds,
            "kernel_ms": kernel_ms, "host_seconds": res.seconds},
        "timings": timings, "per_pod_split_us_ns": split,
        "cluster_sweep_ms": sweep,
        "topology_spreading": {
            "pods_per_s": spread.pods_per_second,
            "duration_s": spread.duration_seconds,
            "enqueue_to_bind_ms": spread.latency, "zone_skew": skew,
            "solves": spread.solves, "launches": spread_counts,
            "kernel_ms": spread_ms, "host_seconds": spread.seconds},
        "launches_by_path": LAUNCHES, "pipeline_runs": pipeline_runs,
        "churn": churn, "sustained": sustained_rows,
        "preemption": preemption, "unschedulable": unschedulable,
        "gang": gang, "anti_affinity": anti, "slot_kernel": slots,
        "wide_terms": wide, "pv_rows": pv_rows,
        "preemption_pvs": preemption_pvs, "shared_volumes": shared,
        "scatters": scatters["scatters"], "configs": configs,
        "families": families, "tracing_cost": tracing, "tuner": tuner,
        "autoscale": autoscale, "mesh": mesh, "federation": federation,
        "wide_pods": wide_pods, "wide_kernel": wide_timed,
        "sharded": sharded, "config_ha": config_ha, "rest": rest,
        "qos": qos, "replays": replays, "scale": scale_phase,
        "reshard": reshard, "hotspot": hotspot, "upgrade": upgrade,
        "readtier": readtier, "federation_rest": federation_rest,
        "chaos_rest": chaos_rest, "mirror_ring": mirror_ring,
        "node_churn": node_churn,
        "state_only_checks": STATE_ONLY, "rows": ROW_REPORTS,
        "wall_s": time.monotonic() - t_start,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"chip_smoke wall time {time.monotonic() - t_start:.1f} s")
    print(json.dumps(scatters), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
