#!/usr/bin/env python3
"""Drives the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Prints the card (``nvidia-smi`` name and power limit) and builds every
   kernel under ``ray_tpu_torch/csrc`` from source, timing the build; prints
   each ring kernel's, each splash kernel's and the fused CE kernels'
   registers, spill bytes, shared memory and resident blocks per SM
   (``resources ring ...``, ``resources splash <fwd|dkv|dq> hd=...``,
   ``resources ce <fwd|dx|dw> D=...``; the CE forward's also its cluster
   size and the clusters the card holds at once), and fails if a CE kernel
   spills at D=768 or ptxas serialised their wgmma (a C751x note).
2. Kernels against their plain versions, each at the main path's shape and
   a few edge shapes, with its device time beside the plain version's, a
   PyTorch yardstick (the port never calls it) and the card's bound:
   - the splash attention forward against ``attention_reference`` (output
     and lse; yardstick ``F.scaled_dot_product_attention``);
   - the splash attention backward against ``attention_bwd_reference``
     (dq, dk, dv; yardstick the backward of SDPA, its device time from
     ``torch.profiler`` beside a host-clock loop), timed at the training
     shape and at head_dim 128; it runs after phase 5, so that the
     profiler's tracing cannot slow what the other phases time;
   - the fused LM-head cross-entropy forward, dx and dW against
     ``ce_fwd_reference``, ``ce_dx_reference`` and ``ce_dw_reference``
     (yardstick the dense head: bf16 logits, logsumexp and gather, and
     their backward, the backward also timed on the device by kernel with
     ``torch.profiler``, after every other phase, beside dx + dW; the
     forward's also cuBLAS's bf16 ``x @ W^T`` alone, ``matmul_ms``: the
     forward's tensor-core work without the logsumexp).
3. Serving: GPT-2 124M (``GPTConfig()``, bf16, random weights from a seed)
   answers unary requests through ``GPT2Next`` and streams greedy tokens
   through ``GPT2Stream``. The splash launch counter must rise by exactly
   ``n_layer`` per forward, and every answer is held against the same model
   with ``attn_impl="xla"`` (the plain attention) on the card.
4. Training: GPT-2 124M, ``GPTConfig(remat_policy="attn_outside",
   scan_layers=False)``, ``make_optimizer(3e-4)``, B=16, S=1024, one batch
   from a numpy seed: five steps with the dense loss, then five with
   ``loss_impl="fused"`` from the same start. Every loss is finite and the
   last is below the first; each step launches exactly 12 splash forwards
   and 12 splash backwards, and in the fused run one of each CE kernel. At
   B=2 the loss and every gradient of one step are held against the same
   step with plain attention, the dense loss and ``remat_policy="full"``;
   and ``remat_policy="full"`` on the kernel path launches 24 splash
   forwards (each block's reruns in the backward) for the same gradients.
5. Ring attention (``attn_impl="ring"``, the ``seq`` axis of W=4 ranks
   folded onto the card): the ring step forward and backward kernels
   against their plain versions at the training path's per-step shapes
   (B=16, S_local=256, 12 heads, hd=64), a ragged shard, head_dim 128 and
   the full mask, with per-launch and whole-ring times beside the bound
   (step 0's blocks write-only; ``bound_ms_accumulate`` with every block
   reading) and SDPA, step 0 timed from NaN-filled accumulators, which it
   must not read; whole ``ring_attention`` against ``splash_attention`` at
   (16, 1024, 12, 64), forward and gradient; the process ring's launches
   (one per rank per ring step on the rank's own shard, every rank on this
   card: ``ring_by_rank``) at train_mesh (c)'s rank shape (8, 512, 12, 64),
   W=2, and with the full mask, against the plain blocks and, bit for
   bit, against the folded launches over the same pairs, with one rank's
   launch of each kind timed beside its bound and SDPA on the same blocks
   (causal for the first, diagonal step, full for a later one). Then GPT-2
   124M trains five steps through the ring from the splash run's start
   (exactly 48 ring forward and 48 ring backward launches per step, no
   splash or CE), and
   one B=2 step of ``attn_impl="ring"`` and of ``"ulysses"`` is held
   against the splash path.
6. Serving through the control plane (``serve_http`` line): after the
   in-process phases, ``ray_tpu_torch.init()`` and ``serve.start`` bring up
   the controller and the HTTP proxy, ``serve.run`` deploys ``GPT2Next``
   and then ``GPT2Stream`` at GPT-2 124M with the serving phase's weights,
   each replica holding the card (``ray_actor_options={"num_gpus": 1}``; the
   node registers one GPU, so the two apps take it in turn), and the phase's
   requests go over HTTP: four unary JSON POSTs and one SSE stream. Every
   answer and every token must equal the in-process one, the SSE answer's
   Content-Type must be ``text/event-stream``, and the splash launches over
   the HTTP requests must be exactly ``n_layer`` per forward. It prints each
   request's HTTP latency beside the in-process one, the SSE gaps and the
   decode rate beside the in-process rate.
7. Batched serving through the control plane (``serve_batch`` line): the
   same weights behind ``GPT2BatchNext`` (``@serve.batch``) beside
   ``GPT2Next``, 64 requests of random lengths from 1, 8 and 32 concurrent
   HTTP clients in turns; ``GPT2ContinuousStream``
   (``@serve.continuous_batch``) streaming 8 SSE answers, half of them
   admitted mid-flight, beside 8 concurrent ``GPT2Stream`` streams; and
   ``GPT2MultiplexNext`` (``@serve.multiplexed``) on two replicas with
   seeds 1 and 2 alternating, then seed 3. Each replica holds half the card.
   It fails if an answer or token breaks the tie rule (its reference logit
   within ``LOGIT_ATOL`` of the reference maximum), if the splash launches
   are not ``n_layer`` per vectorized call, per continuous step or per
   request as each path forms them, if no batch larger than 1 forms at 32
   clients, if the continuous steps are not shared, if the second half of
   the multiplexed traffic loads a model, or if the card does not get the
   evicted model's memory back. It prints queries per second, batch sizes,
   aggregate tokens per second and gaps, loads and memory.
8. SLO objectives and autoscaling through the control plane (``serve_slo``
   line): ``GPT2Next`` under the target-qps policy takes 12 s of HTTP
   traffic from 8 clients and must scale 1 -> 2 with reason
   ``"target_qps"``, the second replica on ``cuda:0`` answering too; then
   ``GPT2Next`` under one availability objective and the SLO-burn policy
   (upscale delay 60 s) takes 6 s in which every third request is too long
   (a real error), then 8 s of valid requests, while a dashboard reads
   ``/api/serve/slo`` from a ``MetricsAgent``. The watchdog must alert on
   the share of errors sent, the controller scale 1 -> 2 with reason
   ``"slo_burn"``, the alert clear within one fast window with one
   ``serve.slo_burn`` span and one ``slo_breach`` postmortem, and the route
   agree with ``serve.status()``. Every answer keeps the tie rule and the
   splash launches are ``n_layer`` per answered request. It prints the
   decision latencies, the cold start of the second replica, requests/s
   with one and two replicas, and the burn rates at the alert.
9. The process tier (``serve_process`` line): GPT-2 124M in worker
   processes of the runtime, each seeing only the card its lease names and
   building the weights from seed 0 there. (a) A ``num_gpus=1,
   isolation="process"`` task answers the serving phase's four requests, a
   CUDA tensor sent to a process task arrives as a host copy, a process
   generator task streams its 16 tokens, and a process actor
   (``num_gpus=0.5, max_restarts=1``) answers, has its worker killed,
   restarts in a new process and answers again. (b) ``GPT2Next`` on
   process replicas (``ray_actor_options={"isolation": "process",
   "num_gpus": 0.5}``, a subclass defined here and pickled by value, which
   reports its process's launch counts) and on thread replicas, one and
   then two of each, take 8 HTTP clients for 6 s each, in turns, and so do
   process replicas that take one request at a time; then ``GPT2Stream``
   on a process replica answers one SSE stream. (c) After
   ``serve.shutdown()`` and ``ray_tpu_torch.shutdown()`` no worker process
   is alive and nvidia-smi lists what it listed before the phase. It fails
   if an answer breaks the tie rule or a streamed token differs from the
   in-process one, if a worker runs in this process, sees another card or
   compiles a kernel, if the splash launches are not ``n_layer`` per
   forward in the workers or any are made in this process, if two replicas
   share a process, or if the actor does not restart. It prints requests/s
   of each tier at one and two replicas and each process replica's cold
   start (spawn to worker loop, to the replica's constructor, the
   constructor, the first answer, the kernel library's load).
9b. GPT-2 124M as two compiled stages (``dag_compiled`` line): thread
    actors ``StageA`` (embeddings, blocks 0-5) and ``StageB`` (blocks 6-11,
    ln_f, the head), both ``GPT2Stage`` on the serving weights, compiled as
    ``b.tail.bind(a.head.bind(inp).with_tensor_transport())``. 32
    executions at (1, 1024) and 8 at (8, 1024) keep the tie rule against
    one whole ``gpt2.forward`` at every position (max |dlogit| printed), 12
    splash launches an execution and no other kernel, the tensor StageB
    reads has the data_ptr and device StageA wrote, no host bytes ledgered
    for the edge; ``allreduce.bind`` over two actors holding halves of
    block 0's MLP gives both equal reduced tensors within 2e-2 of the
    unsplit MLP; after teardown both stages answer plain calls, and after
    shutdown no thread of the phase is left, the ``dag_channel`` pool reads
    0 and the card's memory is back within 8 MiB. It prints executions/s
    and ms per execution, compiled against interpreted ``execute()`` and a
    direct forward, at both shapes.
9c. The compiled serve route (``serve_compiled`` line): (a)
    ``GPT2BatchNext`` on one thread replica compiles after the stability
    window (``route_mode`` "compiled", one recompile with reason
    "deploy"), and answers 64 requests from 1, 8 and 32 handle clients, in
    turns with the same deployment at ``compiled_route=False``, and from 8
    HTTP clients, by the tie rule with 12 splash launches per vectorized
    call; (b) redeployed at two replicas under 8 clients: no caller error,
    the route torn down and compiled again (two recompiles, reasons
    printed); (c) ``serve.pipeline`` over two ``GPT2Stage`` deployments
    (``devices=["cuda"]``): mode "compiled", 32 answers equal to
    ``GPT2Next``'s, 32 pipeline forwards, no host bytes for the hidden
    state, 12 splash launches a request; no thread left after shutdown. It
    prints requests/s and p50 latency by clients, compiled over dynamic.
10. Ray Data on the card (``data_batch`` line). (a) Batch scoring: 2048
    windows of 1025 token ids (numpy ``default_rng(0)`` over 50257) in 16
    blocks of 128 rows go through ``Dataset.map_batches(GPT2Scorer,
    batch_size=32, num_gpus=1, concurrency=1)`` (GPT-2 124M from seed 0,
    one pool actor on the card its lease names), each row's greedy next
    token and mean next-token loss from the splash and fused CE forward
    kernels; in turns with the same scorer called in this process on the
    same 64 batches ("direct"), twice each. It fails unless every row comes
    back once, Data's answers equal direct's bit for bit, the first batch
    keeps the tie rule and its losses lie within ``LOGIT_ATOL`` of plain
    attention with the plain CE forward, the CE forward kernel at the path's
    N = 32768 holds each token's lse and target logit within ``CE_ATOL`` of
    ``ce_fwd_reference`` on the same splash hidden states (its rows giving
    back the path's nll bit for bit), each pass launches exactly 12 × 64
    splash and 64 CE forwards (the plain versions run only on CPU tensors,
    so none ran in a kernel's place), the actor's lease names
    card 0 and its weights are on ``cuda:0``, the actor is gone and the
    card free after the pass, and neither pyarrow nor pandas was imported.
    (b) Streaming ingest to the card: ``StreamingIngest`` feeds 512 of
    those rows at B=16 through ``IngestShard.iter_batches(device=cuda:0)``
    (pinned buffers, a side stream) into the fused-loss eval step; every
    row once, each device batch equal byte for byte to the host batch of a
    second ingest with the same seed, finite losses, 12 splash and 1 CE
    forward a batch. It prints rows/s and tokens/s of Data and direct,
    their ratio, the actor's constructor seconds, one scoring batch's
    device ms, and ms per ingest batch beside the same loop copying each
    host batch synchronously.
11. GPT-2 124M trained through the Train API (``train_fit`` lines):
    ``CudaTrainer.fit()`` runs ``examples/train_gpt2.py``'s loop (fused
    loss, ``attn_outside``, AdamW 3e-4, weights from seed 0; the gradients
    all-reduced through ``ray_tpu_torch.collective``) on windows of (10)'s
    token ids. (a) Two thread ranks share the card (``gpus_per_worker=0.5``),
    each taking 8 rows of one B=16 batch for 5 steps, in turns with the
    same steps at B=16 without a trainer ("direct") and through the
    trainer on one rank, twice each: both ranks
    on card 0 with the oversubscription warning, step 1's mean gradient
    within ``GRAD_RTOL`` of direct's per leaf while rank 0's own gradient
    before the all-reduce (the control: a sync that returned one rank's
    gradient) is farther than that in some leaf, the ranks' mean losses
    within ``FIT_LOSS_ATOL`` of direct's, exactly 2 x (12 + 12) splash and
    2 of each CE launch a step, and the placement group gone with the card
    free after. (b) The same two ranks read the 512 rows in 64 blocks
    through ``datasets=`` (streaming ingest to the card), one epoch at 8
    rows a rank: every block trained once on one rank (the ingest's
    audit), each rank at least one block (rows counted from the batches),
    finite losses, a non-zero ``data_wait`` bucket. (c) One rank, a
    checkpoint every 2 steps (two kept), fails before step 5 of its first
    attempt and resumes: one restart, the restored weights and moments
    equal the checkpointed ones bit for bit, steps 5-8 within
    ``FIT_LOSS_ATOL`` of an uninterrupted run. (e) Async checkpoints
    (``CheckpointConfig(async_save=True)``), its fits in turns with (c)'s:
    the same rank fails before step 5 and restores the coordinator's
    newest committed step from the memory replicas
    (``ray_tpu_ckpt_restores_total{source="memory"}`` up by one), params,
    bf16 mu and nu equal the snapshot bit for bit, steps 5-8 within
    ``FIT_LOSS_ATOL`` of an uninterrupted async run that waits for its
    persists before each save, two committed steps kept, the last one
    restored on the CPU and on the card equal to the card's state; two
    thread ranks save one step in two shards, restored at world size 1
    bit for bit; exact launches; the median block of the uninterrupted
    run at most ``ASYNC_BLOCK_RATIO`` of (c)'s median sync save. A third
    async run saves at the same cadence without waiting: each save's wait
    for a free pinned buffer, its snapshot, and the step ms beside a
    persist and clear of one. It prints each save's block (the first
    apart), persist and commit times, bytes per shard and restore times by
    source. (d) One process rank
    (``worker_mode="processes"``) on NCCL for 5 steps: its own pid, backend
    ``nccl`` on ``cuda:0``, 5 all-reduces, losses within ``FIT_LOSS_ATOL``
    of (c)'s uninterrupted rank, exact launches in the worker and none in
    this process, its checkpoint loaded here by value, and its process
    gone after. It prints tokens/s of the fit and of direct, the step
    profiler's buckets per step, the checkpoint's save ms and bytes, the
    failure-to-resumed seconds and the process rank's cold start.
12. GPT-2 124M elastic training on virtual nodes (``train_elastic``
    lines), after (11): a head without a GPU (the controller and the
    checkpoint coordinator) and two worker nodes of one CPU and half of
    card 0 each; ``CudaTrainer`` runs (11)'s loop at B=8 a rank over 200
    windows of 1025 ids (``default_rng(0)``) handed out by the exactly-once
    sample ledger (``ElasticDatasetShard``), two thread ranks at half the
    card (``ElasticConfig(min_workers=1)``), an async save every 3 steps
    (memory replicas of two steps). Rank 0 waits after the second save
    until rank 1's node is preempted (``simulate_preemption``) once two
    steps have committed; after two steps at world 1 a node is added back.
    It fails unless the events are exactly one shrink 2 -> 1 and one grow
    1 -> 2 with the last world 2 and no error, the shrink restored the
    newest step committed at the failure, the restored params, bf16 mu,
    nu, step and AdamW count equal that step read from disk bit for bit,
    the first step after the restore has the loss of a direct forward of
    the restored parameters on its rows within ``ELASTIC_LOSS_RTOL``, no
    row is trained twice or dropped, every forward a rank started (the
    failed attempt's included) made exactly 12 + 12 splash launches and
    one of each CE kernel, a ``train.elastic`` span was recorded, and the
    card's allocated memory after the fit is within ``ELASTIC_MEM_SLACK``
    of its value before; and unless each rank batch it ran is a shape at
    which phase 2 held the kernels to their plain versions. It prints the
    recovery and grow seconds, lost steps and requeued rows, tokens/s at
    world 2, at world 1 and at world 2 again, and the phase's wall time,
    each with the card's name and power limit.
12b. GPT-2 124M on a device mesh of process ranks (``train_mesh`` lines),
    after (12): ``CudaTrainer`` with ``worker_mode="processes"`` and
    ``ScalingConfig(backend="gloo")`` (the ranks share card 0, which NCCL
    refuses), each rank building ``make_mesh`` over the group,
    ``create_sharded_state`` and its (B/data, S/seq) block of the batch
    (``local_batch_to_global``), at the full width and the fused loss,
    AdamW 3e-4, MESH_STEPS steps of ``make_train_step`` on DTensors:
    (a) ``MeshSpec(data=2)``, B=8 a rank, ``attn_outside``; (c)
    ``MeshSpec(data=2, seq=2)``, four ranks of B=8 x 512 tokens,
    ``attn_impl="ring"`` (the ring's K/V shifts between the ranks, one
    launch of each ring kernel per rank per ring step); (d)
    ``MeshSpec(pipe=2)``, two stages of six layers, B=16 in four
    microbatches, ``save_attn``. An fsdp x tensor mesh does not run on one
    card: DTensor's all-gathers kill a gloo rank there (MESH_CELLS); it
    runs with ``--mesh-cards``, one rank a card over NCCL (below).
    Against a direct B=16 step in this process on the same weights and
    tokens (the ring folded onto the card for (c), the model unpipelined
    for (d)): the sharded state equal to ``init_params`` bit for bit, the
    first loss within ``LOSS_ATOL``, every synced gradient within
    ``GRAD_RTOL`` of its leaf's largest entry while rank 0's own before the
    sync is not where its shard makes them a part of the sum (the control,
    over the leaves it holds whole), the replicas of every shard equal bit
    for bit after each step, each rank's local shapes those of
    ``logical_to_spec``, and every rank's launches in every step those of
    its place on the mesh (12 + 12 splash, or 12(i + 1) of each ring
    kernel at seq index i, or 24 + 24 splash a stage, and one of each CE
    kernel; each rank's counts ride to rank 0's report), none in this
    process; and each rank's shapes ones at which phases 2 and 5 held the
    kernels (they also cover the fsdp x tensor mesh's rank shape, (8,
    1024, 6, 64)). It prints tokens/s of each mesh over direct's, the step
    profiler's ``collective`` ms per step (the gradient sync, staged
    through the host by gloo, timed after the rank's backward and a
    barrier), the host time each rank waits in point-to-point shifts, (d)'s
    bubble by its schedule, (c)'s ring steps' shift against their kernel
    (the share the kernel hides) and each rank's cold start.
13.GPT-2 124M tuned through ``Tuner.fit()`` (``tune_fit`` lines), the
    model of (11) at B=8 on its token windows, each trial building it on
    the card its lease names (``granted_cuda_device()`` in the trial's
    thread). (a) ASHA (``max_t=8, grace_period=2, reduction_factor=2``)
    over four function trials (``lr`` by grid, one report a step,
    ``trial_resources={"GPU": 0.5}``, a ``TBXLoggerCallback``), in turns
    with the same steps at B=8 and B=16 without Tune: every trial's lease
    and device card 0, two trials' steps overlapping, each step-1 loss
    within ``FIT_LOSS_ATOL`` of direct's, at least one trial stopped before
    ``max_t``, exactly 12 + 12 splash and one of each CE launch per step
    the functions ran (they run past a stop until their next report), one
    logged scalar row per consumed result, and afterwards no trial actor
    or thread alive and the card's allocated memory at most
    ``TUNE_MEM_SLACK`` above its value before the phase. (b) A ``CudaTrainer`` of one rank at half the card
    inside each of two ``{"CPU": 1}`` trials, 4 steps: losses within
    ``FIT_LOSS_ATOL`` of the same steps at each trial's ``lr`` without
    Tune, both placement groups alive at once, none left after. (c) PBT
    (``perturbation_interval=2``, seed 0) over two class trials saving
    params and moments with ``save_pytree``: at least one exploit, the
    clone's restored state equal to the donor's saved one bit for bit on
    the clone's card, finite losses. It prints each trial's tokens/s,
    cold start (thread start to first report), steps past its stop and the
    controller's ms from a consumed result to the next ``train()`` call;
    two trials' tokens/s at once beside direct's; the saves' and
    restores' ms.
14. The small libraries with GPT-2 124M (``workflow_fit`` lines), the
    model of (11) at B=8, in a runtime with one card. (a) ``ActorPool``
    over two ``GPT2Scorer`` actors at ``num_gpus=0.5`` scores 8 batches of
    (8, 1025) ids through ``map`` and ``map_unordered``: results in order
    and equal to the scorer called here bit for bit, the same multiset
    unordered, exactly 12 x 8 splash and 8 CE forwards each, the actors
    ``ALIVE`` in ``util.state.list_actors`` and ``DEAD`` after ``kill``.
    (b) A durable workflow ``init -> chunk -> chunk -> chunk``, each a
    ``num_gpus=1`` function step that loads ``{params, opt_state, step}``
    with ``load_pytree`` onto its card, trains 2 steps and saves with
    ``save_pytree``: the second chunk raises on its first attempt, so
    ``workflow.run`` raises and the status is ``FAILED``; ``resume`` is
    ``SUCCESSFUL`` with exactly 2 chunks x 2 steps of launches (the first
    chunk not rerun), and the six losses within ``WF_LOSS_ATOL`` of the
    same steps in one loop; after a restart of the runtime ``get_output``
    gives the same value. (c) ``examples/train_gpt2.py`` as a job
    (``--workers 1 --steps 3``) reaches ``SUCCEEDED`` with its logged
    losses within ``WF_LOSS_ATOL`` of direct's on its own tokens; a second
    job of 100000 steps is stopped after its first logged step and is
    ``STOPPED`` within ``JOB_GRACE_S`` + 5 s, the card's free memory back
    within ``JOB_MEM_SLACK``. (d) ``summarize_tasks`` counts each chunk's
    attempts, ``/api/tasks``, ``/api/actors`` and ``/api/jobs`` over HTTP
    equal the library's rows, and no actor, placement group or thread of
    the phase is left. It prints the pool's batches/s beside direct's, a
    chunk's load, steps and save, each step checkpoint's write, and the
    jobs' cold start (submit to first logged step).
15. The other model families at full width (``models`` lines), weights from
    seed 0 and data from numpy seed 0. (a) Llama, ``LlamaConfig()`` (8
    layers, D=512, 8 query heads over 4 kv heads of 64, RoPE, SwiGLU,
    V=32000, S=1024): a B=16 forward launches exactly 8 splash forwards and
    its logits keep the tie rule against the same model with plain
    attention; five steps at B=16 (``make_optimizer(3e-4)``) launch
    exactly 16 splash forwards (the whole-layer checkpoint reruns each) and
    8 backwards each, and no CE or ring kernel; at B=2 the loss within
    ``LOSS_ATOL`` and every gradient leaf within ``GRAD_RTOL`` of plain
    attention, and ``attn_impl="pallas"`` (16 + 8 splash),
    ``"ring"`` under ``MeshSpec(seq=4)`` (64 ring forwards, 32 backwards)
    and ``"ulysses"`` (no kernel, as in JAX) held to the splash path. (b)
    MoE, ``MoEConfig()``: five steps at B=8 with 16 + 8 splash launches
    each, losses finite and falling; at B=2 the loss within ``LOSS_ATOL``
    of plain attention, the aux loss finite, and the count of token-layers
    whose top-2 experts differ between the two paths printed (a near-tie may
    flip; the gradients are held on the CPU). (c) ViT-B/16 at B=64, five
    steps of its own AdamW (no clip, fp32 moment), no kernel launched. (d)
    The MLP trained on tests/test_torch_train.py's data to that test's
    accuracy bar, beside the same loop on the CPU. (e) Rows 1 and 2 at
    Llama's attention inputs (16, 1024, 8, 64) and MoE's (8, 1024, 8, 64)
    against their plain versions; at Llama's, timed alone beside SDPA and
    the bound. It prints tokens/s and MFU for Llama and MoE, images/s for
    ViT, and the phase's seconds, with the card's name and power limit.
16. RL on the card (``rl_ppo`` lines; ``ray_tpu_torch.rl``, no gymnasium:
    the port's own CartPole-v1). (a) PPO at ``examples/cartpole_ppo.py``'s
    configuration (``train_batch_size=2048, minibatch_size=128,
    num_epochs=8, lr=3e-4, entropy_coeff=0.001``, one local runner of 8
    envs with fragments of 64, seed 0, ``(64, 64)`` torsos), the learner
    and the runner's forward on the card, until the mean return reaches
    ``RL_STOP_REWARD`` (450) within ``RL_MAX_ITERS`` (150) iterations, else
    it fails; it prints the iteration and env steps where it got there,
    env steps/s, minibatch updates/s, the seconds sampling and learning per
    iteration, and the returns at iterations 0, 10 and 25 beside the
    reference's (``RL_NORTHSTAR.json``). (d) The trained algorithm saved
    and restored into a new one: weights and Adam's state equal bit for
    bit. (b) One ``PPOLearner.update_from_batch`` (2 epochs, minibatch 64,
    ``grad_clip=0.5``, 512 numpy rows) on the card and on the CPU from the
    same weights: every weight within ``RL_ATOL``; and a runner of 8 envs
    on each, seed 0, with those weights: the same 2048 steps (its sampling
    noise comes from a host generator), log-probs within ``RL_ATOL``. (c)
    Two thread learners
    on the card, their gradients all-reduced through the collective,
    against one learner on the same batch (two whole-batch steps): within
    ``RL_ATOL``; then two
    iterations with two remote runners and two learners. (e) No kernel of
    the port launched over the phase.
17. The rest of the RL stack on the card (``rl_extras`` lines), each
    algorithm at its reference test's configuration and seed 0, its learner
    and runners' forwards on the card, gated by that test's own gates:
    (a) DQN, plain and prioritized (``tests/test_rl.py``): the replay past
    64, priorities refreshed away from 1.0; one ``DQNLearner`` update and
    its TD errors on the card and the CPU within ``RL_ATOL``. (b) IMPALA
    through two aggregator actors, best mean return > 35 within 300
    iterations; APPO > 60 within 200, ``mean_ratio`` reported, a finite
    loss; one IMPALA and one APPO update (its KL loss on) on the card and
    the CPU within ``RL_ATOL``. (c) IMPALA with ``CNNActorCritic`` on the
    pixel gridworld, best >= 0.5 within 45 iterations. (d) SAC on the
    port's Pendulum-v1 at (256, 256), six iterations, every learner metric
    finite and alpha > 0; one SAC update on the card and the CPU with the
    same injected noise within ``SAC_ATOL``; CQL offline on the reference
    test's Pendulum transitions held in memory: finite, its critic loss
    not 0. (e) BC on expert CartPole transitions held in memory: bc_logp >
    -0.35, greedy agreement with the expert > 0.9, a greedy evaluation
    return > 100; MARWIL on half-random data: agreement > 0.75 (BC's on the
    same data printed beside it). (f) Multi-agent PPO with two policies on
    ``MultiAgentCartPole``: best > 60 within 12 iterations, the policies'
    weights different, a checkpoint round trip bit for bit. (g) No kernel
    of the port launched over the phase. Each line prints the gates'
    iterations and env steps, env steps/s and learner updates/s per
    algorithm; the summary line the phase's seconds.
18. DreamerV3 on the card (``rl_dreamer`` lines; tests/test_dreamerv3.py's
    LineWalk, the world model's and the actor-critic's updates and the
    policy step on the card). (a) LineWalk at the reference's defaults,
    seed 0: the best mean return must pass ``DREAMER_BEST`` (0.8) within
    ``DREAMER_ITERS`` (60) iterations; it prints the iteration, env steps
    and seconds (beside the reference test's 240 s deadline on one CPU),
    policy steps/s and updates/s. (e) That algorithm saved and restored
    into a new one: weights, target critic, both Adams' state, the return
    normaliser and the step count bit for bit. (b) The world-model losses
    of ``test_world_model_losses_decrease`` (300 random-policy steps, then
    30 single updates: reconstruction below 0.75x its start, reward loss
    0.25 nats lower). (c) The pixel configuration of
    ``test_dreamerv3_pixel_conv_encoder`` on the gridworld: the
    ConvTranspose decoder in use, finite losses, reconstruction down more
    than 10% over 10 iterations. (d) One world-model and one actor-critic
    update at the defaults on the card and on the CPU, from the same
    weights, batch and Gumbel noise: every weight and the target critic
    within ``RL_ATOL``. (f) No kernel of the port launched.
19. The device-telemetry plane on the card (``telemetry`` line). (a) The
    kernel builds this process ran are recorded, one ``kernel:<name>``
    compile per source (none when it compiled nothing); GPT-2 124M dense
    steps (``attn_outside``) through ``instrumented_step``, three at B=8
    and one at B=4: exactly one ``first_compile`` and then one
    ``shape_change``, 12 + 12 splash launches a step. (b)
    ``device_memory_snapshot()`` has one row for the card, its
    ``bytes_in_use`` equal to ``torch.cuda.memory_allocated()`` and its
    ``bytes_limit`` to the card's total. (c) ``DeviceBatchIterator`` over 16
    batches of a 64 MiB float32 column and token ids: the h2d ledger holds
    exactly their bytes, the batches in order on the card. (d) Two async
    checkpoint saves of the GPT-2 state, each persisted before the next:
    one d2h transfer of exactly its bytes each, ``ckpt_staging`` back at 0
    after the persists. (e) A multiplexed
    GPT-2 charged to ``mux_weights`` at exactly its bytes, 0 after its
    eviction. (f) A forensics bundle and ``serve.status()`` carry the
    telemetry. It prints the h2d GB/s (past the prefetcher's ring setup)
    and the d2h GB/s of the second save (the first's apart: it page-locks
    the writer's buffers), and each first call's seconds, with the card's
    name and power limit.
20. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. It imports nothing of JAX or of ``ray_tpu``.

``python3 chip_smoke.py --mesh-cards`` runs only ``train_mesh`` on four
cards, four process ranks over NCCL, after building the kernels, with the
gates of (12b): (b) ``MeshSpec(fsdp=2, tensor=2)``, (c4)
``MeshSpec(data=2, seq=2)`` and (d4) ``MeshSpec(pipe=2, data=2)``; its
last line gives ``count`` 4.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

# Published dense peaks, one table for the port (ray_tpu_torch._private.peaks):
# device-memory bytes/s and bf16 tensor-core flop/s by card name.
from ray_tpu_torch._private.peaks import PEAKS, peaks_for  # noqa: E402,F401
# Loaded before the kernels are built, so that each nvcc run is recorded as a
# compile (phase 19).
from ray_tpu_torch.util import device_telemetry  # noqa: E402,F401

# Kernel against plain version, bf16 in and out: the kernel rounds the
# unnormalised probabilities to bf16 before p @ v and normalises in fp32;
# the plain version rounds the normalised ones. Both round o to bf16 (an ulp
# is 2**-8 relative). lse is fp32 on both sides from the same fp32 scores.
O_ATOL = 2e-2
LSE_ATOL = 1e-3
# Served logits (fp32, from a 12-layer bf16 model) against the plain-attention
# model: the two attention paths round differently in bf16, and the
# difference passes through the remaining layers.
LOGIT_ATOL = 5e-2

# (B, S, H, hd, causal): the training shape (B=16), the serving shapes (B=1,
# and batches of 8 and 32 as serve.batch forms them, at S=1024 and at a
# ragged longest request), ragged S, head_dim 128, and train_mesh (b)'s rank
# shape (B=8 of B=16 over fsdp, half the heads over tensor); second, the
# microbatch of train_mesh (d)'s pipeline stages (4 rows).
KERNEL_SHAPES = [
    (16, 1024, 12, 64, True), (4, 1024, 12, 64, True),
    (8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
    (32, 1024, 12, 64, True), (8, 517, 12, 64, True),
    (1, 1024, 12, 64, True), (1, 1024, 12, 64, False),
    (1, 1000, 12, 64, True), (2, 1000, 12, 64, False),
    (1, 7, 12, 64, True), (3, 7, 12, 64, False),
    (2, 512, 8, 128, True), (2, 512, 8, 128, False),
    (8, 1024, 6, 64, True),
]
# The main path's shape (GPT2Stream pads every step to seq_len).
MAIN_SHAPE = (1, 1024, 12, 64, True)

# Splash backward against attention_bwd_reference, per gradient: max|delta|
# over max|reference| (bf16 out). The kernel rounds p and ds to bf16 before
# its products and accumulates in another order; the plain version keeps
# them fp32; both round the result to bf16 (2**-8 relative).
BWD_RTOL = 2e-2
# (B, S, H, hd, causal): the training shape first, q, k, v split from a
# fused qkv as the model makes them, then train_fit's rank shape (B=8 of
# the B=16 batch), train_mesh (b)'s (B=8, half the heads), and last the
# microbatch of train_mesh (d)'s pipeline stages (4 rows). Timed:
# the training shape and head_dim 128.
BWD_SHAPES = [(16, 1024, 12, 64, True), (8, 1024, 12, 64, True),
              (1, 1000, 12, 64, False), (1, 7, 12, 64, True),
              (2, 512, 8, 128, True), (8, 1024, 6, 64, True),
              (4, 1024, 12, 64, True)]
BWD_TIMED = [(16, 1024, 12, 64, True), (2, 512, 8, 128, True)]

# Fused CE against its plain versions. lse and tgt are fp32 on both sides
# from exact bf16 products summed in another order (over D and over V).
# dx and dW: both sides round (softmax - onehot) to bf16, and a p that lies
# on a rounding boundary may round one ulp apart (2**-8 relative).
CE_ATOL = 2e-3
CE_GRAD_RTOL = 2e-2
# (N, D, V): GPT-2 124M's training shape (16 x 1024 tokens), train_fit's
# rank shape (8 x 1024), the reference test's ragged 24 x 96 case, an N
# and V (GPT-2's unpadded vocab) that are multiples of no tile, and
# train_mesh (c)'s rank shape (8 x 512 tokens of a seq shard).
CE_SHAPES = [(16384, 768, 50304), (8192, 768, 50304), (24, 64, 96),
             (1000, 768, 50257), (4096, 768, 50304)]

# Ring kernels (rows 8, 9) against their plain versions: (B, S_local, H, hd,
# causal) over W=4 ranks. The training path's per-step shape first, then a
# ragged shard, head_dim 128 and the full mask. Tolerances are the splash
# kernels' (O_ATOL and LSE_ATOL on the merged fp32 o and lse after W steps,
# BWD_RTOL per gradient): the plain forward rounds each block's o to bf16
# before the merge, as JAX does, where the kernel merges it in fp32.
RING_WORLD = 4
RING_SHAPES = [(16, 256, 12, 64, True), (2, 250, 12, 64, True),
               (2, 256, 8, 128, True), (4, 256, 12, 64, False)]
# Whole ring attention against splash attention on the same q, k, v.
RING_WHOLE_SHAPE = (16, 1024, 12, 64)
# The process ring's launches (one per rank per step on the rank's own
# shard, ring_by_rank) as (B, S_local, H, hd, causal, W): train_mesh (c)'s
# rank shape first, then the full mask. Held to the plain blocks with the
# tolerances above and to the folded launches over the same pairs bit for
# bit: the same tiles, merged and summed in the same order.
RING_RANK_SHAPES = [(8, 512, 12, 64, True, 2), (2, 256, 12, 64, False, 4)]

TRAIN_BATCH = 16
TRAIN_STEPS = 5
# One B=2 step of the kernel path against the plain-attention, dense-loss,
# full-remat step on the card: loss within LOSS_ATOL; every gradient leaf
# within GRAD_RTOL of its largest entry. The two attention paths round to
# bf16 at different points, and the difference passes through 12 layers.
LOSS_ATOL = 1e-3
GRAD_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def attention_bound(B: int, S: int, H: int, hd: int, causal: bool,
                    bytes_per_s: float, flops_per_s: float
                    ) -> Tuple[float, str]:
    """Least time (ms) for one attention forward, and what bounds it: q, k,
    v read once, o (bf16) and lse (fp32) written once; 4*hd flops for each
    (query, key) pair the mask keeps (q k^T and p v)."""
    nbytes = 4 * B * S * H * hd * 2 + B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * hd * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(B: int, S: int, H: int, hd: int, causal: bool,
                        bytes_per_s: float, flops_per_s: float
                        ) -> Tuple[float, str]:
    """Least time (ms) for one attention backward: q, k, v, o, do read once,
    dq, dk, dv written once (bf16), lse and delta (fp32); 10*hd flops for
    each kept (query, key) pair (the score recompute and the dv, dp, dq, dk
    products)."""
    nbytes = 8 * B * S * H * hd * 2 + 2 * B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10.0 * hd * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ring_bound(which: str, B: int, shard: int, H: int, hd: int, n_diag: int,
               n_full: int, bytes_per_s: float, flops_per_s: float,
               n_first: int = 0) -> Tuple[float, str]:
    """Least time (ms) of ring steps that cover n_diag diagonal (causal) and
    n_full full (rank, chunk) blocks of S_local = ``shard`` rows, n_first of
    them at the ring's first step. Per block the forward reads q, k, v
    (bf16) and reads and writes the fp32 o_acc and lse_acc, with 4*hd flops
    per kept (query, key) pair; the backward reads q, k, v, do (bf16), lse
    and delta (fp32) and reads and writes the fp32 dq, dk, dv, with 10*hd
    flops per kept pair. A first-step block writes its accumulators and
    reads none; n_first=0 gives the form in which every block reads them."""
    x, rows = B * shard * H * hd, B * H * shard
    if which == "fwd":
        inputs, acc, flops_per_pair = 3 * x * 2, x * 4 + rows * 4, 4 * hd
    else:
        inputs, acc, flops_per_pair = 4 * x * 2 + 2 * rows * 4, 3 * x * 4, 10 * hd
    pairs = n_diag * shard * (shard + 1) // 2 + n_full * shard * shard
    nbytes = (n_diag + n_full) * (inputs + 2 * acc) - n_first * acc
    flops = float(flops_per_pair) * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ce_bound(which: str, N: int, D: int, V: int, bytes_per_s: float,
             flops_per_s: float) -> Tuple[float, str]:
    """Least time (ms) of one fused-CE kernel: x (N, D) and W (V, D) bf16 and
    t (N,) int32 read once; fwd writes lse and tgt (N,) fp32 and does
    2*N*V*D flops; dx and dW also read lse, write (N, D) or (V, D) fp32 and
    recompute the logits, 4*N*V*D flops."""
    nbytes = (N + V) * D * 2 + N * 4
    if which == "fwd":
        nbytes += 2 * N * 4
        flops = 2.0 * N * V * D
    else:
        nbytes += N * 4 + (N if which == "dx" else V) * D * 4
        flops = 4.0 * N * V * D
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(x, ref) -> float:
    """max|x - ref| / max|ref|, in fp32."""
    return ((x.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3
            ) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], iters: int = 20, reps: int = 5
              ) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, the median of ``reps`` replays over
    ``iters``. Unlike events around each Python call, this leaves out the
    host's time to launch, which exceeds a small kernel's own time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps + 1):  # the first replay warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times[1:])


class _Request:
    """The two request surfaces the replicas read (JSON body, query params)."""

    def __init__(self, body=None, query_params=None):
        self._body = body
        self.query_params = query_params or {}

    async def json(self):
        return self._body


def loop_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2
            ) -> float:
    """Device time of one call: two events around ``iters`` calls issued back
    to back, over ``iters``. For calls that cannot be captured in a CUDA
    graph (an autograd backward); at the sizes it is used for, the host
    issues the next call long before the device finishes this one."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2
                ) -> Tuple[Optional[float], Dict[str, float]]:
    """Device time of one call: the own times of the CUDA kernels that
    ``torch.profiler`` records over ``iters`` calls, summed, over ``iters``
    (as ``scripts/torch_profile_serve.py:device_kernel_times`` reads them),
    and each kernel's share by name (cut to 80 characters). For calls that
    cannot be captured in a CUDA graph; unlike ``loop_ms`` it leaves out the
    host's gaps between kernels. None when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key[:80]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.self_device_time_total / 1e3 / iters)
    total = sum(by_kernel.values())
    return (total if total > 0 else None), by_kernel


def card_lines() -> List[str]:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def phase_kernel(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, main = [], 0.0, None
    for B, S, H, hd, causal in KERNEL_SHAPES:
        # q, k, v as the model makes them: views split from one fused qkv.
        qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.attention_reference(q, k, v, causal=causal)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            fail(f"non-finite kernel output at {(B, S, H, hd, causal)}")
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        worst = max(worst, err_o)
        shape = dict(B=B, S=S, H=H, hd=hd, causal=causal)
        if err_o > O_ATOL or err_lse > LSE_ATOL:
            fail(f"kernel disagrees with attention_reference at {shape}: "
                 f"max|do| {err_o} (tol {O_ATOL}), max|dlse| {err_lse} "
                 f"(tol {LSE_ATOL})")
        def kernel():
            return attention.splash_attention(q, k, v, causal=causal)

        def plain():
            return attention.attention_reference(q, k, v, causal=causal)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        bound_ms, bound_by = attention_bound(B, S, H, hd, causal, *peaks)
        row = dict(shape, max_abs_err=err_o, lse_max_abs_err=err_lse,
                   ms=device_ms(kernel), plain_ms=device_ms(plain, iters=5),
                   library_ms=device_ms(library), bound_ms=bound_ms,
                   bound_by=bound_by, call_ms=time_ms(kernel),
                   library_call_ms=time_ms(library))
        rows.append(row)
        print("kernel splash_attention_fwd " + json.dumps(row), flush=True)
        if (B, S, H, hd, causal) == MAIN_SHAPE:
            main = row
        del qkv, q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return dict(main=main, worst=worst, rows=rows)


def _qkv(gen, B: int, S: int, H: int, hd: int):
    """q, k, v as the model makes them: views split from one fused qkv."""
    import torch

    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return tuple(t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))


def phase_attn_bwd(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst_abs, worst_rel, main = [], 0.0, 0.0, None
    for n, (B, S, H, hd, causal) in enumerate(BWD_SHAPES):
        q, k, v = _qkv(gen, B, S, H, hd)
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        grads = attention.splash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
        refs = attention.attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal=causal)
        shape = dict(B=B, S=S, H=H, hd=hd, causal=causal)
        row = dict(shape)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            if not torch.isfinite(g).all():
                fail(f"non-finite splash backward {name} at {shape}")
            row[f"{name}_rel_err"] = rel_err(g, r)
            row[f"{name}_abs_err"] = (g.float() - r.float()).abs().max().item()
            worst_abs = max(worst_abs, row[f"{name}_abs_err"])
            worst_rel = max(worst_rel, row[f"{name}_rel_err"])
            if row[f"{name}_rel_err"] > BWD_RTOL:
                fail(f"splash backward {name} disagrees with "
                     f"attention_bwd_reference at {shape}: "
                     f"{row[f'{name}_rel_err']} (tol {BWD_RTOL})")
        # An external delta (the ring backward's entry) gives the same result.
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
        ext = attention.splash_attention_bwd(q, k, v, o, lse, do,
                                             causal=causal, delta=delta)
        row["external_delta_rel_err"] = max(
            rel_err(a, b) for a, b in zip(ext, grads))
        if row["external_delta_rel_err"] > BWD_RTOL:
            fail(f"splash backward with an external delta differs at {shape}")
        if (B, S, H, hd, causal) in BWD_TIMED:
            qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2).contiguous()

            def kernel():
                return attention.splash_attention_bwd(q, k, v, o, lse, do,
                                                      causal=causal)

            def plain():
                return attention.attention_bwd_reference(q, k, v, o, lse, do,
                                                         causal=causal)

            def library():
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

            bound_ms, bound_by = attention_bwd_bound(B, S, H, hd, causal,
                                                     *peaks)
            # SDPA's backward is an autograd call, which a CUDA graph does
            # not capture: its device time comes from the profiler (the
            # kernel's own beside it, read the same way), the host-clock
            # loop beside it.
            (library_dev, library_kernels), library_loop = (
                profiled_ms(library), loop_ms(library))
            kernel_dev, kernel_kernels = profiled_ms(kernel)
            row.update(ms=device_ms(kernel), profiled_ms=kernel_dev,
                       profiled_by_kernel=kernel_kernels,
                       library_by_kernel=library_kernels,
                       plain_ms=device_ms(plain, iters=3),
                       library_ms=(library_dev if library_dev is not None
                                   else library_loop),
                       library_ms_by=("profiler" if library_dev is not None
                                      else "events_loop"),
                       library_loop_ms=library_loop, bound_ms=bound_ms,
                       bound_by=bound_by, call_ms=time_ms(kernel))
            if n == 0:
                main = row
            del qt, kt, vt, out, dot
        rows.append(row)
        print("kernel splash_attention_bwd " + json.dumps(row), flush=True)
        del q, k, v, o, lse, do, grads, refs, ext
    torch.cuda.empty_cache()
    return dict(main=main, worst_abs=worst_abs, worst_rel=worst_rel, rows=rows)


def _ce_inputs(gen, N: int, D: int, V: int):
    """x2 (N, D), W (V, D) bf16 and t (N,): layernormed hidden states, GPT-2's
    init scale for the head, uniform targets."""
    import torch

    x2 = torch.randn((N, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    return x2, w, t


def _dense_head(x2, w, t):
    """The dense head on the same inputs: bf16 logits, fp32 logsumexp and
    gather, and the backward of that loss to x2 and W."""
    import torch

    x2d = x2.detach().clone().requires_grad_()
    wd = w.detach().clone().requires_grad_()

    def fwd():
        logits = x2d @ wd.t()
        return (torch.logsumexp(logits.float(), -1)
                - logits.gather(1, t[:, None])[:, 0].float()).mean()

    loss = fwd()

    def bwd():
        return torch.autograd.grad(loss, (x2d, wd), retain_graph=True)

    return fwd, bwd


def phase_ce(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.ops import fused_ce

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {name: {"rows": [], "worst_abs": 0.0}
           for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")}
    for n, (N, D, V) in enumerate(CE_SHAPES):
        x2, w, t = _ce_inputs(gen, N, D, V)
        lse, tgt = fused_ce.ce_fwd(x2, w, t)
        dx = fused_ce.ce_dx(x2, w, t, lse)
        dw = fused_ce.ce_dw(x2, w, t, lse)
        torch.cuda.synchronize()
        lse_r, tgt_r = fused_ce.ce_fwd_reference(x2, w, t)
        dx_r = fused_ce.ce_dx_reference(x2, w, t, lse)
        dw_r = fused_ce.ce_dw_reference(x2, w, t, lse)
        shape = dict(N=N, D=D, V=V)
        for name, got in (("lse", lse), ("tgt", tgt), ("dx", dx), ("dW", dw)):
            if not torch.isfinite(got).all():
                fail(f"non-finite fused CE {name} at {shape}")
        fwd = dict(shape, lse_abs_err=(lse - lse_r).abs().max().item(),
                   tgt_abs_err=(tgt - tgt_r).abs().max().item())
        fwd["max_abs_err"] = max(fwd["lse_abs_err"], fwd["tgt_abs_err"])
        if fwd["max_abs_err"] > CE_ATOL:
            fail(f"fused_ce_fwd disagrees with ce_fwd_reference at {shape}: "
                 f"{fwd} (tol {CE_ATOL})")
        dxr = dict(shape, rel_err=rel_err(dx, dx_r),
                   max_abs_err=(dx - dx_r).abs().max().item())
        dwr = dict(shape, rel_err=rel_err(dw, dw_r),
                   max_abs_err=(dw - dw_r).abs().max().item())
        for name, r in (("fused_ce_dx", dxr), ("fused_ce_dw", dwr)):
            if r["rel_err"] > CE_GRAD_RTOL:
                fail(f"{name} disagrees with its plain version at {shape}: "
                     f"{r['rel_err']} (tol {CE_GRAD_RTOL})")
        del lse_r, tgt_r, dx_r, dw_r
        if n == 0:  # the training shape: time it
            dense_fwd, dense_bwd = _dense_head(x2, w, t)
            with torch.no_grad():
                dense_fwd_ms = device_ms(dense_fwd, iters=3)
                fwd["matmul_ms"] = device_ms(lambda: x2 @ w.t(), iters=3)
            dense_bwd_ms = loop_ms(dense_bwd, iters=3)
            for r, which, kern, plain in (
                    (fwd, "fwd", lambda: fused_ce.ce_fwd(x2, w, t),
                     lambda: fused_ce.ce_fwd_reference(x2, w, t)),
                    (dxr, "dx", lambda: fused_ce.ce_dx(x2, w, t, lse),
                     lambda: fused_ce.ce_dx_reference(x2, w, t, lse)),
                    (dwr, "dw", lambda: fused_ce.ce_dw(x2, w, t, lse),
                     lambda: fused_ce.ce_dw_reference(x2, w, t, lse))):
                bound_ms, bound_by = ce_bound(which, N, D, V, *peaks)
                r.update(ms=device_ms(kern, iters=3),
                         plain_ms=device_ms(plain, iters=2),
                         dense_ms=dense_fwd_ms if which == "fwd"
                         else dense_bwd_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
            dxr["dx_plus_dw_ms"] = dwr["dx_plus_dw_ms"] = dxr["ms"] + dwr["ms"]
            del dense_fwd, dense_bwd
        for name, r in (("fused_ce_fwd", fwd), ("fused_ce_dx", dxr),
                        ("fused_ce_dw", dwr)):
            out[name]["rows"].append(r)
            out[name]["worst_abs"] = max(out[name]["worst_abs"],
                                         r["max_abs_err"])
            if n == 0:
                out[name]["main"] = r
            print(f"kernel {name} " + json.dumps(r), flush=True)
        del x2, w, t, lse, tgt, dx, dw
        torch.cuda.empty_cache()
    return out


def phase_ce_yardstick(ce: Dict[str, object]) -> Dict[str, object]:
    """The dense head's backward at the CE training shape (phase_ce's
    inputs, from the same seed), timed on the device: the own time of each
    CUDA kernel ``torch.profiler`` records, by name, with cuBLAS's products
    (``matmul_ms``) apart from the softmax and other passes
    (``other_ms``); the host-clock loop beside it, and the fused backward's
    dx + dW from phase_ce. It runs after every other phase, as the splash
    backward's profiled yardstick does."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    x2, w, t = _ce_inputs(gen, *CE_SHAPES[0])
    _, dense_bwd = _dense_head(x2, w, t)
    dev, by_kernel = profiled_ms(dense_bwd, iters=3)
    matmul = sum(ms for name, ms in by_kernel.items()
                 if any(k in name.lower() for k in
                        ("gemm", "xmma", "nvjet", "cutlass")))
    row = dict(N=CE_SHAPES[0][0], D=CE_SHAPES[0][1], V=CE_SHAPES[0][2],
               profiled_ms=dev, matmul_ms=matmul,
               other_ms=(dev - matmul) if dev is not None else None,
               by_kernel=by_kernel, loop_ms=loop_ms(dense_bwd, iters=3),
               dx_plus_dw_ms=ce["fused_ce_dx"]["main"]["dx_plus_dw_ms"])
    print("yardstick ce_dense_bwd " + json.dumps(row), flush=True)
    del x2, w, t, dense_bwd
    torch.cuda.empty_cache()
    return row


# The serving paths' requests: four unary ones of these lengths and one
# 64-token prompt streamed for 16 greedy tokens, from a numpy seed.
SERVE_LENGTHS = (4, 100, 517, 1024)
SERVE_PROMPT_LEN = 64
SERVE_MAX_NEW = 16
# Rounds of HTTP against in-process, in turns, for the cost of the path.
HTTP_ROUNDS = 5


def _serve_requests():
    import numpy as np

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 50257, n).tolist() for n in SERVE_LENGTHS]
    return requests, rng.integers(0, 50257, SERVE_PROMPT_LEN).tolist()


def serve_weights():
    """GPT-2 124M's weights from seed 0, shared by both serving paths."""
    from ray_tpu_torch.models import gpt2

    return gpt2.init_params(gpt2.GPTConfig(), seed=0, device="cuda")


def phase_serve(params) -> Dict[str, object]:
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2Next, GPT2Stream

    config = gpt2.GPTConfig()  # GPT-2 124M, bf16, attn_impl="auto"
    nxt = GPT2Next(config, params=params)
    stream = GPT2Stream(config, params=params)
    lengths = SERVE_LENGTHS
    requests, prompt = _serve_requests()
    max_new = SERVE_MAX_NEW

    nxt.next_token(requests[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    # The main path: counts at 0 just before, read just after.
    _reset_counts()
    answers, latencies = [], []
    for toks in requests:
        t0 = time.perf_counter()
        out = asyncio.run(nxt(_Request(body={"tokens": toks})))
        latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append(out["next_token"])
    t0 = time.perf_counter()
    streamed, gaps = [], []
    last = t0
    for chunk in stream(_Request(query_params={
            "tokens": ",".join(map(str, prompt)), "max_new": str(max_new)})):
        now = time.perf_counter()
        gaps.append((now - last) * 1e3)
        last = now
        streamed.append(json.loads(chunk)["token"])
    decode_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts["splash_attention_fwd"]

    forwards = len(requests) + max_new
    if launches != config.n_layer * forwards:
        fail(f"splash launches {launches} != n_layer * forwards = "
             f"{config.n_layer} * {forwards}")
    if len(streamed) != max_new:
        fail(f"stream gave {len(streamed)} tokens, wanted {max_new}")

    # Hold every answer against the plain-attention model on the card.
    ref_config = dataclasses.replace(config, attn_impl="xla")
    ref_params = nxt.params
    worst = 0.0

    def check(label, logits, ref, chosen):
        nonlocal worst
        if logits.shape != (config.vocab_size,) or not torch.isfinite(logits).all():
            fail(f"{label}: logits of shape {tuple(logits.shape)} or non-finite")
        err = (logits - ref).abs().max().item()
        worst = max(worst, err)
        gap = (ref.max() - ref[chosen]).item()
        if err > LOGIT_ATOL or gap > LOGIT_ATOL:
            fail(f"{label}: max|dlogit| {err}, chosen token {chosen} is "
                 f"{gap} below the reference max (tol {LOGIT_ATOL})")

    with torch.inference_mode():
        for toks, ans in zip(requests, answers):
            logits = nxt.logits(toks)
            if int(torch.argmax(logits)) != ans:
                fail("GPT2Next answer differs from its own logits' argmax")
            t = torch.tensor([toks], device="cuda")
            ref = gpt2.forward(ref_params, t, ref_config)[0, -1]
            check(f"GPT2Next len {len(toks)}", logits, ref, ans)
        seq = list(prompt)
        for tok in streamed:
            arr = np.zeros((1, config.seq_len), np.int64)
            arr[0, :len(seq)] = seq
            logits = stream.logits_at(arr, len(seq) - 1)
            ref = gpt2.forward(ref_params, torch.as_tensor(arr, device="cuda"),
                               ref_config)[0, len(seq) - 1]
            check(f"GPT2Stream step {len(seq) - len(prompt)}", logits, ref, tok)
            seq.append(tok)

        # Forward time by attention path, and the LM head's two ways.
        full = torch.as_tensor(np.asarray([requests[-1]]), device="cuda")
        fwd_ms = time_ms(lambda: gpt2.forward_hidden(nxt.params, full, config),
                         iters=10)
        fwd_xla_ms = time_ms(lambda: gpt2.forward_hidden(
            nxt.params, full, ref_config), iters=10)
        # The same forward replayed as one CUDA graph: its device time alone.
        fwd_graph_ms = device_ms(lambda: gpt2.forward_hidden(
            nxt.params, full, config), iters=3)
        x = gpt2.forward_hidden(nxt.params, full, config)
        wte = nxt.params["wte"]
        head_fp32_ms = time_ms(lambda: gpt2.lm_head(x, wte, torch.float32),
                               iters=10)
        head_bf16_ms = time_ms(lambda: gpt2.lm_head(x, wte, torch.bfloat16),
                               iters=10)

    result = dict(
        unary_lengths=list(lengths), unary_answers=answers,
        unary_latency_ms=latencies, stream_prompt_len=len(prompt),
        stream_tokens=streamed, stream_gap_ms=gaps,
        decode_tokens_per_s=max_new / decode_s, forwards=forwards,
        splash_launches=launches, launches=counts, max_abs_logit_err=worst,
        forward_hidden_ms_splash=fwd_ms, forward_hidden_ms_xla=fwd_xla_ms,
        forward_hidden_graph_ms_splash=fwd_graph_ms,
        lm_head_ms_fp32_logits=head_fp32_ms,
        lm_head_ms_bf16_logits=head_bf16_ms)
    print("serve " + json.dumps(result), flush=True)
    return result


def _post_json(url: str, body: dict) -> Tuple[int, str, dict]:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], json.load(resp)


def _sse(url: str) -> Tuple[int, str, list, list]:
    """One SSE GET: status, Content-Type, the events' JSON, and each
    event's arrival on the host clock."""
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": "text/event-stream"})
    events, arrivals = [], []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            if raw.startswith(b"data: "):
                arrivals.append(time.perf_counter())
                events.append(json.loads(raw[len(b"data: "):]))
        return resp.status, resp.headers["Content-Type"], events, arrivals


def phase_serve_http(params, inproc: Dict[str, object]) -> Dict[str, object]:
    """The serving path through the control plane: ``serve.run`` deploys
    ``GPT2Next`` and ``GPT2Stream`` at GPT-2 124M, each replica holding the
    card (``num_gpus=1``), and the port's HTTP proxy answers the same
    requests as ``phase_serve``: four unary JSON POSTs and one SSE stream.
    The node registers one GPU, so the two apps take the card in turn: the
    unary app is deleted before the streaming app is deployed. Every answer
    and every token must equal the in-process ones (same weights, same
    deterministic kernel), and the splash launches counted over the HTTP
    requests must be ``n_layer`` per forward: the replicas are threads of
    this process, so the counters are the ones every other phase reads.

    Then the cost of the path: each request again over HTTP and in-process
    (a replica body called on this thread, as ``phase_serve`` calls it), in
    turns, HTTP_ROUNDS times, with every shape already seen; medians."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig()
    requests, prompt = _serve_requests()
    max_new = SERVE_MAX_NEW
    query = f"tokens={','.join(map(str, prompt))}&max_new={max_new}"
    gpu = {"num_gpus": 1}
    local_next = serve.GPT2Next(config, params=params)
    local_stream = serve.GPT2Stream(config, params=params)

    def inproc_unary(toks):
        t0 = time.perf_counter()
        out = asyncio.run(local_next(_Request(body={"tokens": toks})))
        return (time.perf_counter() - t0) * 1e3, out["next_token"]

    def inproc_stream():
        t0 = time.perf_counter()
        arrivals, tokens = [], []
        for chunk in local_stream(_Request(query_params={
                "tokens": ",".join(map(str, prompt)),
                "max_new": str(max_new)})):
            arrivals.append(time.perf_counter())
            tokens.append(json.loads(chunk)["token"])
        return t0, arrivals, tokens

    ray_tpu_torch.init()
    try:
        registered = ray_tpu_torch.cluster_resources().get("GPU")
        if registered != torch.cuda.device_count():
            fail(f"the runtime registers GPU {registered}, torch counts "
                 f"{torch.cuda.device_count()}")
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        t0 = time.perf_counter()
        serve.run(serve.deployment(ray_actor_options=gpu)(serve.GPT2Next)
                  .bind(config, params=params), name="gpt2",
                  route_prefix="/gpt2")
        deploy_next_s = time.perf_counter() - t0
        # Warm-up on the replica's threads (cuBLAS handles): not counted.
        _post_json(f"{addr}/gpt2", {"tokens": requests[0]})

        # The main path: counts at 0 just before, read just after.
        _reset_counts()
        answers, latencies, statuses = [], [], set()
        for toks in requests:
            t0 = time.perf_counter()
            status, ctype, out = _post_json(f"{addr}/gpt2", {"tokens": toks})
            latencies.append((time.perf_counter() - t0) * 1e3)
            statuses.add((status, ctype))
            answers.append(out.get("next_token"))
        unary_counts = _counts()

        # Cost of the path: HTTP and in-process in turns, shapes warm.
        http_ms = {n: [] for n in SERVE_LENGTHS}
        inproc_ms = {n: [] for n in SERVE_LENGTHS}
        for _ in range(HTTP_ROUNDS):
            for toks in requests:
                ms, ans = inproc_unary(toks)
                inproc_ms[len(toks)].append(ms)
                t0 = time.perf_counter()
                _, _, out = _post_json(f"{addr}/gpt2", {"tokens": toks})
                http_ms[len(toks)].append((time.perf_counter() - t0) * 1e3)
                if out.get("next_token") != ans:
                    fail(f"HTTP answer {out} != in-process {ans} at length "
                         f"{len(toks)}")

        t0 = time.perf_counter()
        serve.delete("gpt2")
        serve.run(serve.deployment(ray_actor_options=gpu)(serve.GPT2Stream)
                  .bind(config, params=params), name="gpt2stream",
                  route_prefix="/gpt2stream")
        redeploy_s = time.perf_counter() - t0
        _sse(f"{addr}/gpt2stream?tokens=1,2,3&max_new=1")  # warm-up

        _reset_counts()
        t_sse = time.perf_counter()
        sse_status, sse_ctype, events, arrivals = _sse(
            f"{addr}/gpt2stream?{query}")
        stream_counts = _counts()

        rates = {"http": [], "inproc": []}
        gap_runs = {"http": [], "inproc": []}
        for _ in range(HTTP_ROUNDS):
            t0, arr, toks = inproc_stream()
            rates["inproc"].append(max_new / (arr[-1] - t0))
            gap_runs["inproc"].append(_gaps_ms(t0, arr))
            if toks != inproc["stream_tokens"]:
                fail(f"in-process stream {toks} != {inproc['stream_tokens']}")
            t0 = time.perf_counter()
            _, _, evs, arr = _sse(f"{addr}/gpt2stream?{query}")
            rates["http"].append(max_new / (arr[-1] - t0))
            gap_runs["http"].append(_gaps_ms(t0, arr))
            if [e.get("token") for e in evs] != inproc["stream_tokens"]:
                fail(f"SSE tokens {evs} != in-process {inproc['stream_tokens']}")
        serve.delete("gpt2stream")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    counts = {k: unary_counts[k] + stream_counts[k] for k in unary_counts}
    streamed = [e.get("token") for e in events]
    forwards = len(requests) + max_new
    launches = counts["splash_attention_fwd"]
    if statuses != {(200, "application/json; charset=utf-8")}:
        fail(f"unary HTTP answers came back as {statuses}")
    if answers != inproc["unary_answers"]:
        fail(f"HTTP answers {answers} != in-process {inproc['unary_answers']}")
    if sse_status != 200 or not sse_ctype.startswith("text/event-stream"):
        fail(f"SSE answer {sse_status} with Content-Type {sse_ctype}")
    if streamed != inproc["stream_tokens"]:
        fail(f"SSE tokens {streamed} != in-process {inproc['stream_tokens']}")
    if launches != config.n_layer * forwards:
        fail(f"splash launches over HTTP {launches} != n_layer * forwards = "
             f"{config.n_layer} * {forwards}")
    others = {k: n for k, n in counts.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the HTTP serving path launched other kernels: {others}")
    med = statistics.median
    result = dict(
        unary_lengths=list(SERVE_LENGTHS), unary_answers=answers,
        unary_latency_ms=latencies,
        timed_rounds=HTTP_ROUNDS,
        unary_http_ms=[med(http_ms[n]) for n in SERVE_LENGTHS],
        unary_inproc_ms=[med(inproc_ms[n]) for n in SERVE_LENGTHS],
        unary_overhead_ms=[med(http_ms[n]) - med(inproc_ms[n])
                           for n in SERVE_LENGTHS],
        stream_prompt_len=len(prompt), stream_tokens=streamed,
        stream_gap_ms=_gaps_ms(t_sse, arrivals),
        decode_tokens_per_s_http=med(rates["http"]),
        decode_tokens_per_s_inproc=med(rates["inproc"]),
        gap_ms_median_http=med(g for run in gap_runs["http"] for g in run[1:]),
        gap_ms_median_inproc=med(g for run in gap_runs["inproc"]
                                 for g in run[1:]),
        sse_content_type=sse_ctype, forwards=forwards,
        splash_launches=launches, launches=counts,
        deploy_next_s=deploy_next_s, delete_and_deploy_stream_s=redeploy_s)
    print("serve_http " + json.dumps(result), flush=True)
    return result


# serve_batch: 64 unary requests of lengths uniform in [1, 1024] from a numpy
# seed, sent by 1, 8 and 32 concurrent HTTP clients, batched and unbatched
# in turns, BATCH_ROUNDS times; 8 SSE streams of their own 64-token prompts,
# 16 tokens each, half of them admitted once the first tokens have arrived;
# MUX_REQUESTS multiplexed requests alternating two seeds, then a third.
BATCH_REQUESTS = 64
BATCH_CLIENTS = (1, 8, 32)
BATCH_ROUNDS = 2
CONT_STREAMS = 8
MUX_REQUESTS = 16


def _batch_inputs():
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 1025, BATCH_REQUESTS)
    requests = [rng.integers(0, 50257, n).tolist() for n in lengths]
    prompts = [rng.integers(0, 50257, SERVE_PROMPT_LEN).tolist()
               for _ in range(CONT_STREAMS)]
    return requests, prompts


def _post_concurrently(url: str, bodies: list, clients: int
                       ) -> Tuple[list, float]:
    """Every body POSTed by ``clients`` threads at once; the answers in the
    bodies' order and the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        outs = list(pool.map(lambda b: _post_json(url, b), bodies))
    return outs, time.perf_counter() - t0


def _handle_concurrently(handle, bodies: list, clients: int) -> float:
    """Every body sent through the deployment handle (no HTTP) by
    ``clients`` threads at once; the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(lambda b: handle.remote(_Request(body=b)).result(
            timeout_s=120), bodies))
    return time.perf_counter() - t0


def _streams_concurrently(url: str, queries: list, late_after: int
                          ) -> Tuple[list, float]:
    """One SSE GET per query on its own thread. The first ``late_after``
    start at once; the others once each of those has its first token (all
    at once when ``late_after`` covers every query). Returns per stream
    (status, events, arrivals) and the start time."""
    import threading

    results = [None] * len(queries)
    first = [threading.Event() for _ in queries]

    def run(i):
        import urllib.request

        req = urllib.request.Request(f"{url}?{queries[i]}",
                                     headers={"Accept": "text/event-stream"})
        events, arrivals = [], []
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                for raw in resp:
                    if raw.startswith(b"data: "):
                        arrivals.append(time.perf_counter())
                        events.append(json.loads(raw[len(b"data: "):]))
                        first[i].set()
                results[i] = (resp.status, events, arrivals)
        finally:
            first[i].set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(queries))]
    for t in threads[:late_after]:
        t.start()
    for e in first[:late_after]:
        e.wait(120)
    for t in threads[late_after:]:
        t.start()
    for t in threads:
        t.join(300)
    return results, t0


def _stream_stats(results: list, t0: float) -> Dict[str, object]:
    tokens = sum(len(events) for _, events, _ in results)
    last = max(arrivals[-1] for _, _, arrivals in results)
    gaps = [b - a for _, _, arr in results for a, b in zip(arr, arr[1:])]
    gaps_ms = sorted(g * 1e3 for g in gaps)
    return dict(tokens_per_s=tokens / (last - t0),
                gap_ms_p50=statistics.median(gaps_ms),
                gap_ms_p99=gaps_ms[min(len(gaps_ms) - 1,
                                       int(0.99 * len(gaps_ms)))],
                ttft_ms=[(arr[0] - t0) * 1e3 for _, _, arr in results])


def phase_serve_batch(params) -> Dict[str, object]:
    """The batched serving paths through ``serve.run`` and HTTP, at GPT-2
    124M with the serving phases' weights, each replica on half the card
    (``num_gpus=0.5``) so that two live at once; the replicas are threads of
    this process, so the splash launch counters are the ones every phase
    reads.

    (a) ``GPT2BatchNext`` (``@serve.batch``, up to 32 per forward) and
    ``GPT2Next`` answer the same 64 requests from 1, 8 and 32 concurrent
    clients, in turns. Every answer keeps the tie rule against the
    in-process ``GPT2Next`` logits for its tokens; the splash launches of a
    batched run are ``n_layer`` per vectorized call, of an unbatched one
    ``n_layer`` per request; at 32 clients a batch larger than 1 forms. The
    64 requests' logits from in-process batched forwards (two of 32) are
    held to the same logits, as ``phase_serve`` holds its answers.
    (b) ``GPT2ContinuousStream`` (``@serve.continuous_batch``) streams 8 SSE
    answers, 4 admitted while the first 4 are in flight, beside 8
    concurrent streams of ``GPT2Stream``; every token keeps the tie rule
    against the plain-attention model at its stream's prefix, launches are
    ``n_layer`` per step (per token for ``GPT2Stream``), and steps are
    shared (fewer than 8 x 16) with more than 4 streams in some step.
    (c) ``GPT2MultiplexNext`` on two replicas, one model each: 16 requests
    alternate seeds 1 and 2 (the first two at once, so the models land on
    different replicas), then one asks for seed 3. Answers keep the tie
    rule against ``GPT2Next`` built from the seed; once the router knows
    where each model lives, the second half of the traffic loads nothing;
    after the seed-3 eviction the card holds no more than half a weight set
    above the level before it."""
    import gc

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import batching, multiplex
    from ray_tpu_torch.serve import metrics as serve_metrics

    config = gpt2.GPTConfig()
    ref_config = dataclasses.replace(config, attn_impl="xla")
    n_layer = config.n_layer
    requests, prompts = _batch_inputs()
    half = {"num_gpus": 0.5}
    local_next = serve.GPT2Next(config, params=params)
    weights = dict(local_next.params)
    weights.update(weights.pop("blocks"))
    weight_bytes = sum(t.numel() * t.element_size() for t in weights.values())
    worst = 0.0
    result: Dict[str, object] = dict(weight_set_bytes=weight_bytes)
    totals: Dict[str, int] = {}

    def take() -> int:
        """Reads the launch counts of the window that just ended (reset
        just before it) into the phase's totals; the splash launches."""
        counts = _counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        return counts["splash_attention_fwd"]

    def gap(ref, chosen):
        return (ref.max() - ref[chosen]).item()

    def ref_rows(arr, positions):
        """Plain-attention logits at ``positions`` of the (B, S) tokens."""
        dev = local_next.device
        with torch.inference_mode():
            t = torch.as_tensor(arr, device=dev)
            x = gpt2.forward_hidden(local_next.params, t, ref_config)
            x = x[torch.arange(len(positions), device=dev),
                  torch.as_tensor(positions, device=dev)]
            return gpt2.lm_head(x, local_next.params["wte"], torch.float32)

    with torch.inference_mode():
        ref_logits = torch.stack([local_next.logits(t) for t in requests])
    ref_answers = torch.argmax(ref_logits, dim=-1).tolist()

    # (a)'s in-process check: the 64 requests as two batched forwards.
    local_batch = serve.GPT2BatchNext(config, params=params)
    batched = []
    for i in range(0, BATCH_REQUESTS, 32):
        chunk = requests[i:i + 32]
        arr = np.zeros((len(chunk), max(map(len, chunk))), np.int64)
        for row, toks in enumerate(chunk):
            arr[row, :len(toks)] = toks
        batched.append(local_batch.logits_rows(arr, [len(t) - 1 for t in chunk]))
    batched = torch.cat(batched)
    if batched.shape != ref_logits.shape or not torch.isfinite(batched).all():
        fail(f"batched logits of shape {tuple(batched.shape)} or non-finite")
    dlogit = (batched - ref_logits).abs().max().item()
    batched_answers = torch.argmax(batched, dim=-1).tolist()
    worst_gap = max(gap(ref_logits[i], a) for i, a in enumerate(batched_answers))
    if dlogit > LOGIT_ATOL or worst_gap > LOGIT_ATOL:
        fail(f"in-process batched logits: max|dlogit| {dlogit}, a chosen "
             f"token {worst_gap} below the B=1 maximum (tol {LOGIT_ATOL})")
    # One vectorized call's host time at S=1024, by batch size.
    forward_ms = {}
    for B in (1, 8, 32):
        arr = np.zeros((B, config.seq_len), np.int64)
        forward_ms[B] = time_ms(lambda: local_batch.logits_rows(
            arr, [config.seq_len - 1] * B), iters=5)
    del local_batch, batched
    result["inproc_batched_max_abs_logit_err"] = dlogit

    ray_tpu_torch.init()
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address

        # ------------------------------------------ (a) batched unary
        h_batch = serve.run(
            serve.deployment(max_ongoing_requests=64, ray_actor_options=half)(
                serve.GPT2BatchNext).bind(config, params=params),
            name="gpt2batch", route_prefix="/gpt2batch")
        h_next = serve.run(
            serve.deployment(max_ongoing_requests=64, ray_actor_options=half)(
                serve.GPT2Next).bind(config, params=params),
            name="gpt2", route_prefix="/gpt2")
        bodies = [{"tokens": t} for t in requests]
        # Warm-up, not counted: the replicas' threads, a full batch.
        _post_concurrently(f"{addr}/gpt2", bodies[:2], 2)
        _post_concurrently(f"{addr}/gpt2batch", bodies[:32], 32)

        runs = {"batched": {c: [] for c in BATCH_CLIENTS},
                "unbatched": {c: [] for c in BATCH_CLIENTS}}
        batch_tags = {"deployment": "GPT2BatchNext", "method": "next_token"}
        sizes_by_clients = {c: [] for c in BATCH_CLIENTS}
        differ = {"batched": 0, "unbatched": 0}
        batched_launches = vectorized = unbatched_launches = 0
        for clients in BATCH_CLIENTS:
            for _ in range(BATCH_ROUNDS):
                for kind, route in (("batched", "gpt2batch"),
                                    ("unbatched", "gpt2")):
                    seen = batching.BATCH_SIZE_HISTOGRAM.get(tags=batch_tags)
                    _reset_counts()
                    outs, secs = _post_concurrently(f"{addr}/{route}", bodies,
                                                    clients)
                    launches = take()
                    runs[kind][clients].append(BATCH_REQUESTS / secs)
                    for i, (status, _, out) in enumerate(outs):
                        ans = out.get("next_token")
                        if status != 200 or not isinstance(ans, int):
                            fail(f"{kind} answer {status} {out}")
                        g = gap(ref_logits[i], ans)
                        worst = max(worst, g)
                        if g > LOGIT_ATOL:
                            fail(f"{kind} answer {ans} at {clients} clients "
                                 f"for request {i} (length "
                                 f"{len(requests[i])}) is {g} below the "
                                 f"in-process maximum (tol {LOGIT_ATOL})")
                        differ[kind] += ans != ref_answers[i]
                    if kind == "unbatched":
                        unbatched_launches += launches
                        if launches != n_layer * BATCH_REQUESTS:
                            fail(f"unbatched splash launches {launches} != "
                                 f"{n_layer} * {BATCH_REQUESTS}")
                        continue
                    # serve_batch_size over this run: one observation per
                    # vectorized call, its value the call's batch size.
                    sizes = _since(batching.BATCH_SIZE_HISTOGRAM, batch_tags,
                                   seen)
                    sizes_by_clients[clients].append(sizes)
                    batched_launches += launches
                    vectorized += sizes["count"]
                    if sizes["sum"] != BATCH_REQUESTS:
                        fail(f"batches {sizes} hold {sizes['sum']} "
                             f"requests, sent {BATCH_REQUESTS}")
                    if launches != n_layer * sizes["count"]:
                        fail(f"batched splash launches {launches} != "
                             f"n_layer * vectorized calls = {n_layer} * "
                             f"{sizes['count']}")
        if all(s["sum"] <= s["count"] for s in sizes_by_clients[32]):
            fail(f"no batch larger than 1 formed at 32 clients: "
                 f"{sizes_by_clients[32]}")
        # Where the batched qps stops: the same traffic at 32 clients
        # through the handle, without the proxy and the HTTP clients.
        handle_qps = {}
        for kind, h in (("batched", h_batch), ("unbatched", h_next)):
            _reset_counts()
            handle_qps[kind] = BATCH_REQUESTS / _handle_concurrently(
                h, bodies, 32)
            take()
        med = statistics.median
        result["unary"] = dict(
            requests=BATCH_REQUESTS, rounds=BATCH_ROUNDS,
            qps={kind: {f"c{c}": med(v) for c, v in by.items()}
                 for kind, by in runs.items()},
            qps_runs={kind: {f"c{c}": v for c, v in by.items()}
                      for kind, by in runs.items()},
            speedup={f"c{c}": med(runs["batched"][c])
                     / med(runs["unbatched"][c]) for c in BATCH_CLIENTS},
            batch_sizes={f"c{c}": v for c, v in sizes_by_clients.items()},
            handle_qps_c32=handle_qps,
            forward_ms_by_batch=forward_ms,
            vectorized_calls=vectorized, splash_launches=batched_launches,
            unbatched_splash_launches=unbatched_launches,
            answers_differing_exactly=differ,
            worst_gap_below_max=worst)
        serve.delete("gpt2batch")
        serve.delete("gpt2")

        # --------------------------------------- (b) continuous batching
        deploy = serve.deployment(max_ongoing_requests=64,
                                  ray_actor_options=half)
        serve.run(deploy(serve.GPT2ContinuousStream).bind(config, params=params),
                  name="gpt2cont", route_prefix="/gpt2cont")
        serve.run(deploy(serve.GPT2Stream).bind(config, params=params),
                  name="gpt2stream", route_prefix="/gpt2stream")
        for route in ("gpt2cont", "gpt2stream"):  # warm-up
            _sse(f"{addr}/{route}?tokens=1,2,3&max_new=2")
        queries = [f"tokens={','.join(map(str, p))}&max_new={SERVE_MAX_NEW}"
                   for p in prompts]
        # The engine observes serve_execution_seconds once per step. Only
        # streams reach this deployment, and a stream's request adds no
        # observation of its own under these tags.
        step_tags = {"deployment": "GPT2ContinuousStream",
                     "method": "__call__"}
        seen = serve_metrics.EXECUTION.get(tags=step_tags)
        _reset_counts()
        cont, t_cont = _streams_concurrently(f"{addr}/gpt2cont", queries,
                                             CONT_STREAMS // 2)
        cont_launches = take()
        steps = _since(serve_metrics.EXECUTION, step_tags, seen)["count"]
        _reset_counts()
        per_req, t_per = _streams_concurrently(f"{addr}/gpt2stream", queries,
                                               CONT_STREAMS)
        per_req_launches = take()
        serve.delete("gpt2cont")
        serve.delete("gpt2stream")
        for label, runs_ in (("continuous", cont), ("per-request", per_req)):
            for status, events, _ in runs_:
                if status != 200 or len(events) != SERVE_MAX_NEW:
                    fail(f"{label} stream {status} gave {len(events)} tokens")
        total = CONT_STREAMS * SERVE_MAX_NEW
        if cont_launches != n_layer * steps:
            fail(f"continuous splash launches {cont_launches} != n_layer * "
                 f"steps = {n_layer} * {steps}")
        if steps >= total:
            fail(f"{steps} continuous steps for {total} tokens shared "
                 f"nothing")
        # Each step emits one token per stream it holds: with at most
        # CONT_STREAMS // 2 per step, the tokens would need this many steps.
        if steps >= total // (CONT_STREAMS // 2):
            fail(f"{steps} continuous steps for {total} tokens: no step held "
                 f"a stream admitted mid-flight")
        if per_req_launches != n_layer * total:
            fail(f"per-request stream launches {per_req_launches} != "
                 f"{n_layer} * {total}")
        # Every token against the plain-attention model at its prefix.
        S = config.seq_len
        cont_gap = 0.0
        for label, runs_ in (("continuous", cont), ("per-request", per_req)):
            seqs = [list(p) for p in prompts]
            for step in range(SERVE_MAX_NEW):
                arr = np.zeros((CONT_STREAMS, S), np.int64)
                for row, seq in enumerate(seqs):
                    arr[row, :len(seq)] = seq
                ref = ref_rows(arr, [len(seq) - 1 for seq in seqs])
                for row, (_, events, _) in enumerate(runs_):
                    tok = events[step].get("token")
                    g = gap(ref[row], tok)
                    cont_gap = max(cont_gap, g)
                    if g > LOGIT_ATOL:
                        fail(f"{label} stream {row} step {step}: token {tok} "
                             f"is {g} below the plain model's maximum "
                             f"(tol {LOGIT_ATOL})")
                    seqs[row].append(tok)
        c_stats = _stream_stats(cont, t_cont)
        p_stats = _stream_stats(per_req, t_per)
        result["continuous"] = dict(
            streams=CONT_STREAMS, max_new=SERVE_MAX_NEW,
            prompt_len=SERVE_PROMPT_LEN, steps=steps,
            splash_launches=cont_launches,
            per_request_splash_launches=per_req_launches,
            continuous=c_stats, per_request=p_stats,
            tokens_per_s_ratio=c_stats["tokens_per_s"]
            / p_stats["tokens_per_s"],
            worst_gap_below_max=cont_gap)

        # ---------------------------------------------- (c) multiplexing
        def loads():
            return sum(v for _, _, v in multiplex.MODEL_LOADS.samples())

        def evictions():
            return sum(v for _, _, v in multiplex.MODEL_EVICTIONS.samples())

        h_mux = serve.run(
            serve.deployment(num_replicas=2, max_ongoing_requests=64,
                             ray_actor_options=half)(serve.GPT2MultiplexNext)
            .bind(config, max_num_models_per_replica=1),
            name="gpt2mux", route_prefix=None)
        hs = {s: h_mux.options(multiplexed_model_id=f"seed-{s}")
              for s in (1, 2, 3)}
        mux_reqs = requests[:MUX_REQUESTS + 1]
        seeds = [1 + i % 2 for i in range(MUX_REQUESTS)] + [3]
        loads0 = loads()
        _reset_counts()
        # The first two at once: the second sees the first in flight on
        # one replica and goes to the other.
        pair = [hs[s].remote({"tokens": t})
                for s, t in zip(seeds[:2], mux_reqs[:2])]
        mux_answers = [r.result(timeout_s=300)["next_token"] for r in pair]
        sched = h_mux._get_router()._scheduler
        deadline = time.time() + 30
        while True:
            with sched._lock:
                view = sorted(tuple(r.get("multiplexed_model_ids") or ())
                              for r in sched._replicas)
            if view == [("seed-1",), ("seed-2",)]:
                break
            if time.time() > deadline:
                fail(f"the router's view of the replicas' models: {view}")
            time.sleep(0.05)
        def ask(i):
            mux_answers.append(hs[seeds[i]].remote(
                {"tokens": mux_reqs[i]}).result(timeout_s=300)["next_token"])

        for i in range(2, MUX_REQUESTS // 2):
            ask(i)
        loads_first_half = loads()
        for i in range(MUX_REQUESTS // 2, MUX_REQUESTS):
            ask(i)
        loads_second_half = loads() - loads_first_half
        if loads_second_half:
            fail(f"{loads_second_half} loads in the second half of the "
                 f"alternating traffic: warm routing did not hold")
        torch.cuda.synchronize()
        gc.collect()
        mem_before = torch.cuda.memory_allocated()
        evict0 = evictions()
        ask(MUX_REQUESTS)
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        mux_launches = take()
        if evictions() - evict0 != 1:
            fail(f"seed-3 evicted {evictions() - evict0} models, wanted 1")
        if mem_after > mem_before + weight_bytes // 2:
            fail(f"after the eviction the card holds {mem_after} bytes, "
                 f"{mem_after - mem_before} more than before it (one weight "
                 f"set is {weight_bytes}): the evicted weights stayed")
        mux_loads = loads() - loads0
        serve.delete("gpt2mux")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    mux_gap = 0.0
    mux_differ = 0
    for seed in (1, 2, 3):
        model = serve.GPT2Next(config, seed=seed)
        with torch.inference_mode():
            for toks, s, ans in zip(mux_reqs, seeds, mux_answers):
                if s != seed:
                    continue
                logits = model.logits(toks)
                g = gap(logits, ans)
                mux_gap = max(mux_gap, g)
                mux_differ += ans != int(torch.argmax(logits))
                if g > LOGIT_ATOL:
                    fail(f"multiplexed answer {ans} for seed-{seed} is {g} "
                         f"below GPT2Next's maximum (tol {LOGIT_ATOL})")
        del model
    result["multiplex"] = dict(
        requests=len(mux_answers), seeds=seeds, loads=mux_loads,
        loads_second_half=loads_second_half, evictions=evictions() - evict0,
        memory_before_seed3=mem_before, memory_after_seed3=mem_after,
        splash_launches=mux_launches, answers_differing_exactly=mux_differ,
        worst_gap_below_max=mux_gap)
    others = {k: n for k, n in totals.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the batched serving paths launched other kernels: {others}")
    result["splash_launches"] = totals["splash_attention_fwd"]
    result["launches"] = totals
    print("serve_batch " + json.dumps(result), flush=True)
    return result


def _since(hist, tags: dict, before: dict) -> Dict[str, object]:
    """A histogram's observations since the snapshot ``before``: their
    number, their sum, and their number in each bucket by upper bound."""
    now = hist.get(tags=tags)
    labels = [str(b) for b in now["boundaries"]] + ["inf"]
    return {"count": now["count"] - before["count"],
            "sum": now["sum"] - before["sum"],
            "by_bucket": {le: a - b for le, a, b in zip(
                labels, now["counts"], before["counts"]) if a - b}}


def _gaps_ms(t0: float, arrivals: list) -> list:
    """Gaps between a request's start and each token's arrival, in ms: the
    first is the time to the first token."""
    return [(b - a) * 1e3 for a, b in zip([t0] + arrivals, arrivals)]


# The serve_slo phase: its clients, the seconds of each part of its traffic,
# and the period at which its dashboard reads /api/serve/slo.
SLO_CLIENTS = 8
SLO_QPS_SECONDS = 12.0
SLO_ERROR_SECONDS = 6.0
SLO_CLEAN_SECONDS = 8.0
SLO_SCRAPE_S = 0.25
# In-flight requests a replica is sized for: twice the clients, so that the
# queue-depth policy asks for one replica and each part's decision is the
# policy under test's (the policies compose by max, and the larger desire's
# reason decides whether the upscale delay is bypassed).
SLO_ONGOING = 2.0 * SLO_CLIENTS


def _post_status(url: str, body: dict) -> Tuple[int, Optional[dict]]:
    """One JSON POST: its status, and its JSON answer when it is 200."""
    import urllib.error

    try:
        status, _, out = _post_json(url, body)
        return status, out
    except urllib.error.HTTPError as e:
        e.read()
        e.close()
        return e.code, None


def _traffic(url: str, bodies: list, clients: int, seconds: float
             ) -> list:
    """``clients`` threads POST ``bodies`` round-robin (client k sends
    bodies k, k + clients, ...) for ``seconds``. Returns per request
    (body index, sent, done, status, answer), times on ``time.time()``."""
    import threading

    log = []
    lock = threading.Lock()
    end = time.time() + seconds

    def client(k):
        i = k
        while time.time() < end:
            sent = time.time()
            status, out = _post_status(url, bodies[i % len(bodies)])
            with lock:
                log.append((i % len(bodies), sent, time.time(), status, out))
            i += clients

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 150)
    if any(t.is_alive() for t in threads):
        fail(f"a client of {url} did not finish")
    return log


def phase_serve_slo(params) -> Dict[str, object]:
    """SLO objectives and the autoscaler's target-qps and SLO-burn policies
    through ``serve.run`` and HTTP, at GPT-2 124M with the serving phases'
    weights, each replica on half the card (``num_gpus=0.5``).

    Both apps size a replica for 16 requests in flight, so that the
    queue-depth policy, which the other two compose with by max, asks for
    one replica.
    (a) ``GPT2Next`` under ``target_qps_per_replica=15`` over a 5 s window
    (upscale delay 1 s, metrics every 0.5 s) takes 12 s of HTTP requests
    from 8 clients (``serve_batch``'s 64 prompts, cycled). The controller
    must apply target 2 with reason ``"target_qps"``, a second replica must reach RUNNING on a lease naming
    ``cuda:0``, and both replicas must answer (their processed counts).
    It prints the seconds from the first request to the decision and from
    the decision to the second replica's first answer, and requests/s
    before and after that answer.
    (b) ``GPT2Next`` with ``use_slo_burn=True`` and an upscale delay of 60 s,
    under one availability objective (target 0.9, windows 2 s and 6 s, burn
    threshold 2): 6 s in which every third request has 1025 tokens (the
    replica rejects it: an error in the router's RED counters), then 8 s of
    valid requests, while a dashboard reads ``/api/serve/slo`` from a
    ``MetricsAgent`` on port 0 every 0.25 s. The watchdog must alert, its
    fast window's bad fraction (read while the window lies in the error
    part) within 0.05 of the share of errors sent; the controller must
    apply target 2 with reason ``"slo_burn"`` while the errors last; the
    alert must clear within one fast window of the last error, with exactly
    one ``serve.slo_burn`` span (``ERROR: SLOBurn``) and one ``slo_breach``
    postmortem in a temporary ``RAY_TPU_POSTMORTEM_DIR``; and
    ``/api/serve/slo`` must agree with ``serve.status()`` on the objectives
    and the alert state, during the alert and after it. It prints the
    seconds from the first error to the alert and from the alert to the
    decision, and the burn rates at the alert.
    In both, every answer keeps the tie rule against the in-process
    ``GPT2Next`` logits for its tokens, and the splash launches are
    ``n_layer`` per answered request (a rejected one launches none)."""
    import glob
    import os
    import shutil
    import tempfile
    import threading
    import urllib.request

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.metrics_agent import MetricsAgent
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import autoscaling
    from ray_tpu_torch.serve.slo import SLOObjective
    from ray_tpu_torch.util import tracing

    config = gpt2.GPTConfig()
    n_layer = config.n_layer
    requests, _ = _batch_inputs()
    local = serve.GPT2Next(config, params=params)
    with torch.inference_mode():
        ref_logits = torch.stack([local.logits(t) for t in requests])
    del local
    half = {"num_gpus": 0.5}
    bodies = [{"tokens": t} for t in requests]
    result: Dict[str, object] = {}
    totals: Dict[str, int] = {}
    worst = [0.0]

    def take() -> int:
        counts = _counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        return counts["splash_attention_fwd"]

    def answered(label, log, request_of) -> int:
        """Checks each answer of ``log`` (``request_of(i)`` is body i's
        request, None for a body the replica must reject); the number of
        answered requests."""
        n = 0
        for i, _, _, status, out in log:
            r = request_of(i)
            if r is None:
                if status != 500:
                    fail(f"{label}: a 1025-token request got {status}")
                continue
            ans = (out or {}).get("next_token")
            if status != 200 or not isinstance(ans, int):
                fail(f"{label}: answer {status} {out}")
            g = (ref_logits[r].max() - ref_logits[r][ans]).item()
            worst[0] = max(worst[0], g)
            if g > LOGIT_ATOL:
                fail(f"{label}: answer {ans} for request {r} is {g} below "
                     f"the in-process maximum (tol {LOGIT_ATOL})")
            n += 1
        return n

    def decisions(dep):
        """The applied target changes of ``dep`` by reason (the
        autoscaler's decision counter), its target and the time of its last
        change (``serve.status()``). The flight recorder's rows say the
        same, but with tracing on the ring turns over in seconds."""
        by_reason = {tags["reason"]: int(v)
                     for _, tags, v in autoscaling.DECISIONS.samples()
                     if tags["deployment"] == dep}
        st = serve.status()[dep]
        return (by_reason, st["target_num_replicas"],
                st["autoscale"]["last_change_at"])

    def replicas(handle, n=1):
        """The deployment's running replicas as the handle's router knows
        them, once it knows at least ``n``."""
        sched = handle._get_router()._scheduler
        deadline = time.time() + 60
        while True:
            with sched._lock:
                out = [(r["replica_id"], r["actor"]) for r in sched._replicas]
            if len(out) >= n:
                return out
            if time.time() > deadline:
                fail(f"the router knows {len(out)} replicas, wanted {n}")
            time.sleep(0.05)

    def processed(actor) -> int:
        return ray_tpu_torch.get(actor.get_metadata.remote(),
                                 timeout=30)["num_processed_requests"]

    pm_dir = tempfile.mkdtemp(prefix="serve_slo_postmortems_")
    env_before = os.environ.get("RAY_TPU_POSTMORTEM_DIR")
    os.environ["RAY_TPU_POSTMORTEM_DIR"] = pm_dir
    serve.slo._reset_watchdog()
    burns = []
    ray_tpu_torch.init()
    agent = None
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address

        # ------------------------------------------- (a) target qps
        dep = "gpt2qps#GPT2Next"
        h = serve.run(serve.deployment(
            max_ongoing_requests=64, ray_actor_options=half,
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=1, max_replicas=2, target_qps_per_replica=15.0,
                target_ongoing_requests=SLO_ONGOING,
                qps_window_s=5.0, metrics_interval_s=0.5,
                upscale_delay_s=1.0, downscale_delay_s=600.0,
                use_slo_burn=False))(serve.GPT2Next).bind(
                    config, params=params),
            name="gpt2qps", route_prefix="/gpt2qps")
        _post_json(f"{addr}/gpt2qps", bodies[0])  # warm-up, not counted
        ((first_rid, _),) = replicas(h)
        marks: Dict[str, float] = {}
        stop = threading.Event()

        def watch():
            """The second replica's first answer, by its processed count."""
            while not stop.is_set() and "second_answer" not in marks:
                for rid, actor in replicas(h, 0):
                    if rid != first_rid and processed(actor) > 0:
                        marks["second_answer"] = time.time()
                stop.wait(0.05)

        watcher = threading.Thread(target=watch)
        watcher.start()
        _reset_counts()
        log = _traffic(f"{addr}/gpt2qps", bodies, SLO_CLIENTS,
                       SLO_QPS_SECONDS)
        stop.set()
        watcher.join(60)
        launches = take()
        n_ok = answered("target_qps", log, lambda i: i)
        if launches != n_layer * n_ok:
            fail(f"target_qps: {launches} splash launches for {n_ok} "
                 f"answers, want {n_layer} each")
        applied = decisions(dep)
        if applied[:2] != ({"target_qps": 1}, 2):
            fail(f"target_qps: the controller applied {applied}")
        st = serve.status()[dep]
        if st["running_replicas"] != 2:
            fail(f"target_qps: {st['running_replicas']} replicas running")
        reps = replicas(h, 2)
        rt = get_runtime()
        cards = []
        for _, actor in reps:
            lease = rt.get_actor_state(actor._actor_id).lease
            cards.append(f"cuda:{lease.gpu_ids[0]}" if lease.gpu_ids
                         else None)
        served = [processed(actor) for _, actor in reps]
        if len(reps) != 2 or cards != ["cuda:0", "cuda:0"] or min(served) < 1:
            fail(f"target_qps: replicas {[r for r, _ in reps]} on {cards} "
                 f"answered {served}")
        if "second_answer" not in marks:
            fail("target_qps: the second replica's first answer was missed")
        t_first = min(sent for _, sent, _, _, _ in log)
        t_last = max(done for _, _, done, _, _ in log)
        t_decision = applied[2]
        t_second = marks["second_answer"]
        result["target_qps"] = dict(
            requests=len(log), answered=n_ok, splash_launches=launches,
            decision_s=t_decision - t_first,
            cold_start_s=t_second - t_decision,
            qps_one_replica=sum(done < t_second for _, _, done, _, _ in log)
            / (t_second - t_first),
            qps_two_replicas=sum(done >= t_second
                                 for _, _, done, _, _ in log)
            / (t_last - t_second),
            replicas=[r for r, _ in reps], cards=cards,
            processed_by_replica=served)
        serve.delete("gpt2qps")

        # ---------------------------------------------- (b) SLO burn
        dep = "gpt2burn#GPT2Next"
        objective = SLOObjective("availability", target=0.9,
                                 fast_window_s=2.0, slow_window_s=6.0,
                                 burn_threshold=2.0)
        serve.run(serve.deployment(
            max_ongoing_requests=64, ray_actor_options=half,
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=1, max_replicas=2, use_slo_burn=True,
                target_ongoing_requests=SLO_ONGOING,
                upscale_delay_s=60.0))(serve.GPT2Next).bind(
                    config, params=params),
            name="gpt2burn", route_prefix="/gpt2burn")
        serve.slo.get_watchdog().set_objectives(dep, [objective])
        _post_json(f"{addr}/gpt2burn", bodies[0])  # warm-up, not counted
        tracing.enable_tracing(
            exporter=lambda s: burns.append(s)
            if s["name"] == "serve.slo_burn" else None)
        agent = MetricsAgent(get_runtime(), port=0)
        scrapes = []
        during = {}
        stop = threading.Event()

        def dashboard():
            url = f"http://127.0.0.1:{agent.port}/api/serve/slo"
            while not stop.is_set():
                with urllib.request.urlopen(url, timeout=30) as resp:
                    row = json.load(resp)["deployments"][dep]
                scrapes.append((time.time(), row))
                if row["alerting"] and not during:
                    during["route"] = row
                    during["status"] = serve.status()[dep]["slo"]
                stop.wait(SLO_SCRAPE_S)

        scraper = threading.Thread(target=dashboard)
        scraper.start()
        time.sleep(4 * SLO_SCRAPE_S)  # the counters' baseline samples
        too_long = {"tokens": [0] * (config.seq_len + 1)}
        mixed = [too_long if j % 3 == 2 else bodies[j % len(bodies)]
                 for j in range(3 * len(bodies))]
        _reset_counts()
        log_err = _traffic(f"{addr}/gpt2burn", mixed, SLO_CLIENTS,
                           SLO_ERROR_SECONDS)
        log_ok = _traffic(f"{addr}/gpt2burn", bodies, SLO_CLIENTS,
                          SLO_CLEAN_SECONDS)
        time.sleep(4 * SLO_SCRAPE_S)
        stop.set()
        scraper.join(60)
        tracing.disable_tracing()
        launches = take()
        n_ok = (answered("slo_burn", log_err,
                         lambda j: None if j % 3 == 2 else j % len(bodies))
                + answered("slo_burn", log_ok, lambda i: i))
        if launches != n_layer * n_ok:
            fail(f"slo_burn: {launches} splash launches for {n_ok} answers, "
                 f"want {n_layer} each")
        errors = [(sent, done) for j, sent, done, _, _ in log_err
                  if j % 3 == 2]
        share = len(errors) / len(log_err)
        t_err0 = min(sent for sent, _ in errors)
        t_err1 = max(done for _, done in errors)
        alerts = [(t, row) for t, row in scrapes
                  if row["objectives"]["availability"]["alerting"]]
        if not alerts:
            fail("slo_burn: the watchdog never alerted")
        at_alert = alerts[0][1]["objectives"]["availability"]
        t_alert = at_alert["since"]
        # The fast window's bad fraction at every read that has the window
        # wholly in the error part, the stretch whose share of errors is
        # known.
        reads = [(t, row["objectives"]["availability"]) for t, row in alerts
                 if t_err0 + objective.fast_window_s + SLO_SCRAPE_S
                 <= t <= t_err1]
        steady = [a["bad_fraction_fast"] for _, a in reads]
        if not steady:
            fail("slo_burn: no alerting read with the fast window in the "
                 "error part")
        off = [b for b in steady if abs(b - share) > 0.05]
        if off:
            # Each read's time from the first error, its fast window's bad
            # fraction and event count, and the requests the clients sent
            # and saw fail in that window: what the next look needs.
            windows = [dict(
                t=round(t - t_err0, 3), bad=a["bad_fraction_fast"],
                events=a["events_fast"],
                sent=sum(1 for _, sent_, _, _, _ in log_err
                         if t - objective.fast_window_s <= sent_ <= t),
                failed=sum(1 for j, sent_, _, _, _ in log_err
                           if j % 3 == 2
                           and t - objective.fast_window_s <= sent_ <= t))
                for t, a in reads]
            fail(f"slo_burn: bad_fraction_fast {off} of the {len(steady)} "
                 f"reads in the error part against {share} of the requests "
                 f"sent failing; reads {windows}")
        applied = decisions(dep)
        if applied[:2] != ({"slo_burn": 1}, 2) or not applied[2] < t_err1:
            fail(f"slo_burn: the controller applied {applied} (errors "
                 f"{t_err0} to {t_err1})")
        t_decision = applied[2]
        if len(burns) != 1 or burns[0]["status"] != "ERROR: SLOBurn":
            fail(f"slo_burn: serve.slo_burn spans {burns}")
        t_clear = burns[0]["end"]
        if burns[0]["start"] != t_alert \
                or not 0.0 < t_clear - t_err1 <= objective.fast_window_s:
            fail(f"slo_burn: the burn span {burns[0]['start']} to {t_clear}"
                 f", the alert at {t_alert}, the last error at {t_err1}")
        dumps = glob.glob(os.path.join(pm_dir, "*-slo_breach.json"))
        if len(dumps) != 1:
            fail(f"slo_burn: postmortems {dumps}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{agent.port}/api/serve/slo",
                timeout=30) as resp:
            after_route = json.load(resp)["deployments"][dep]
        after_status = serve.status()[dep]["slo"]
        keys = ("target", "threshold_ms", "fast_window_s", "slow_window_s",
                "burn_threshold", "alerting")

        def view(slo_row):
            return (slo_row["alerting"], {
                name: {k: o[k] for k in keys}
                for name, o in slo_row["objectives"].items()})

        agree = {"during": view(during["route"]) == view(during["status"]),
                 "after": view(after_route) == view(after_status)}
        if not all(agree.values()) or not view(during["route"])[0] \
                or view(after_route)[0]:
            fail(f"slo_burn: /api/serve/slo {during['route']} and "
                 f"{after_route} against serve.status() {during['status']} "
                 f"and {after_status}")
        result["slo_burn"] = dict(
            requests=len(log_err) + len(log_ok), errors=len(errors),
            error_share_sent=share, answered=n_ok, splash_launches=launches,
            first_error_to_alert_s=t_alert - t_err0,
            alert_to_decision_s=t_decision - t_alert,
            last_error_to_clear_s=t_clear - t_err1,
            at_alert={k: at_alert[k] for k in (
                "burn_fast", "burn_slow", "bad_fraction_fast",
                "bad_fraction_slow", "events_fast", "events_slow")},
            bad_fraction_fast_steady=dict(
                reads=len(steady), min=min(steady),
                median=statistics.median(steady), max=max(steady)),
            scrapes=len(scrapes),
            route_agrees_with_status=agree, postmortems=len(dumps))
        serve.delete("gpt2burn")
    finally:
        tracing.disable_tracing()
        if agent is not None:
            agent.stop()
        serve.shutdown()
        ray_tpu_torch.shutdown()
        serve.slo._reset_watchdog()
        if env_before is None:
            os.environ.pop("RAY_TPU_POSTMORTEM_DIR", None)
        else:
            os.environ["RAY_TPU_POSTMORTEM_DIR"] = env_before
        shutil.rmtree(pm_dir, ignore_errors=True)
    others = {k: n for k, n in totals.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the SLO serving paths launched other kernels: {others}")
    result["worst_gap_below_max"] = worst[0]
    result["splash_launches"] = totals["splash_attention_fwd"]
    result["launches"] = totals
    print("serve_slo " + json.dumps(result), flush=True)
    return result


# serve_process: the clients and seconds of each measured load, and the
# rounds of thread-tier against process-tier replicas in turns (one: the
# script's time limit holds train_mesh's (c) and (d) since the second
# round was cut; each gate still runs on every load).
PROC_CLIENTS = 8
PROC_SECONDS = 6.0
PROC_ROUNDS = 1


def _compute_apps() -> list:
    """The processes that hold a CUDA context, as nvidia-smi lists them.
    Its pids may be another pid namespace's, so lists are compared with
    each other, never with this process's pids."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return sorted(line.strip() for line in out.stdout.splitlines()
                  if line.strip())


def _card_uuid(index: int = 0) -> str:
    import torch

    props = torch.cuda.get_device_properties(index)
    return str(getattr(props, "uuid", f"{props.name}/{props.total_memory}"))


def _process_report(built=None) -> Dict[str, object]:
    """What a process worker says of itself: its pid, the cards it sees, the
    kernel libraries it loaded and the compiles it ran, when its worker
    loop started, and its kernels' launch counts."""
    import os

    import torch

    import ray_tpu_torch
    from ray_tpu_torch._private import kernel_build, process_pool

    return dict(pid=os.getpid(), gpu_ids=ray_tpu_torch.get_gpu_ids(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_count=torch.cuda.device_count(), uuid=_card_uuid(),
                nvcc_runs=kernel_build.NVCC_RUNS,
                load_s=dict(kernel_build.LOAD_SECONDS),
                main_at=process_pool.WORKER_MAIN_AT, built=built,
                launches=_counts())


def _reporting(base):
    """``base`` (a GPT-2 replica body) that also reports on its process.
    Defined in a function of this script, so that it is pickled by value
    into the worker that hosts it."""
    class Reporting(base):
        def __init__(self, *args, **kwargs):
            import torch

            t0 = time.time()
            super().__init__(*args, **kwargs)
            torch.cuda.synchronize(self.device)
            self.built = (t0, time.time())

        def report(self):
            return _process_report(self.built)

        def reset_launches(self):
            _reset_counts()

    Reporting.__name__ = Reporting.__qualname__ = f"Proc{base.__name__}"
    return Reporting


def _answer_in_worker(requests):
    """A process task: GPT-2 124M from seed 0 on the card its lease names
    answers the serving requests."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2Next

    t0 = time.time()
    model = GPT2Next(gpt2.GPTConfig(), seed=0)
    torch.cuda.synchronize(model.device)
    built = (t0, time.time())
    model.next_token(requests[0])  # warm-up: loads the kernel library
    torch.cuda.synchronize(model.device)
    _reset_counts()
    answers = [model.next_token(t) for t in requests]
    return answers, _process_report(built)


def _tensor_in_worker(t):
    """A process task given a CUDA tensor: the device it arrived on, and
    it doubled on the worker's own card (which travels back as a host
    copy too)."""
    from ray_tpu_torch._private.device import granted_cuda_device

    return t.device.type, t.to(granted_cuda_device()) * 2


def _stream_in_worker(prompt, max_new):
    """A process generator task: the greedy stream, then its report."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2Stream

    model = GPT2Stream(gpt2.GPTConfig(), seed=0)
    _reset_counts()
    yield from model.generate(prompt, max_new)
    yield _process_report()


def phase_serve_process(params, inproc: Dict[str, object]
                        ) -> Dict[str, object]:
    """GPT-2 124M in worker processes of the runtime's process tier, each
    on the card its lease names, at full width and depth from seed 0.

    (a) Tasks and actors: a ``num_gpus=1, isolation="process"`` task builds
    the model and answers ``phase_serve``'s four requests; a CUDA tensor
    sent to a process task arrives there, and comes back, as a host copy;
    a process generator task streams its 16 greedy tokens; a process actor
    (``num_gpus=0.5, max_restarts=1``) answers, has its worker killed
    (SIGKILL), restarts in a new process and answers again.
    (b) Serving: ``GPT2Next`` on process replicas
    (``ray_actor_options={"isolation": "process", "num_gpus": 0.5}``) and on
    thread replicas (``num_gpus=0.5``), one replica each and then two, take
    PROC_CLIENTS HTTP clients for PROC_SECONDS each, in turns
    (PROC_ROUNDS rounds), and process replicas that run one call at a time
    (``max_concurrency=1``: a thread replica's event loop runs
    ``GPT2Next``'s forwards one at a time) at one and two replicas; then
    ``GPT2Stream`` on a process replica answers one SSE stream. The process replicas' class is a subclass defined in
    this script, sent by value, that reports its process's launch counts.
    (c) After ``serve.shutdown()`` and ``ray_tpu_torch.shutdown()`` no
    worker process is alive and nvidia-smi lists the processes it listed
    before the phase.

    Every answer keeps the tie rule against the in-process ``GPT2Next``
    logits (the stream against ``GPT2Stream``'s along its tokens); every
    worker is another process than this one, sees one card, this one, and
    loads the kernel libraries this process built without compiling; the
    splash launches are ``n_layer`` per forward in the workers and none in
    this process. It prints requests/s of each tier at one and two
    replicas, and each process replica's cold start."""
    import multiprocessing
    import os
    import signal

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig()
    n_layer = config.n_layer
    me = os.getpid()
    uuid = _card_uuid()
    serve_requests, prompt = _serve_requests()
    bodies_requests, _ = _batch_inputs()
    bodies = [{"tokens": t} for t in bodies_requests]
    local = serve.GPT2Next(config, params=params)
    local_stream = serve.GPT2Stream(config, params=params)
    with torch.inference_mode():
        ref_serve = torch.stack([local.logits(t) for t in serve_requests])
        ref_bodies = torch.stack([local.logits(t) for t in bodies_requests])
    worst = [0.0]
    totals: Dict[str, int] = {}
    pids_seen: set = set()
    result: Dict[str, object] = {}

    def tie(label, ref, chosen):
        gap = (ref.max() - ref[chosen]).item()
        worst[0] = max(worst[0], gap)
        if gap > LOGIT_ATOL:
            fail(f"{label}: token {chosen} is {gap} below the in-process "
                 f"maximum (tol {LOGIT_ATOL})")

    def stream_ties(label, tokens):
        seq = list(prompt)
        with torch.inference_mode():
            for tok in tokens:
                arr = np.zeros((1, config.seq_len), np.int64)
                arr[0, :len(seq)] = seq
                tie(f"{label} step {len(seq) - len(prompt)}",
                    local_stream.logits_at(arr, len(seq) - 1), tok)
                seq.append(tok)

    def check_worker(label, rep):
        pids_seen.add(rep["pid"])
        if rep["pid"] == me:
            fail(f"{label}: ran in this process")
        if rep["device_count"] != 1 or rep["uuid"] != uuid:
            fail(f"{label}: the worker sees {rep['device_count']} cards "
                 f"({rep['uuid']}), not this one ({uuid})")
        if rep["nvcc_runs"]:
            fail(f"{label}: the worker compiled {rep['nvcc_runs']} kernels")
        if "splash_attention_fwd" not in rep["load_s"]:
            fail(f"{label}: the worker never loaded the splash kernel")

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    def driver_quiet(label):
        mine = {k: n for k, n in _counts().items() if n}
        if mine:
            fail(f"{label}: this process launched {mine}")

    def reap_check(label, baseline):
        live = [p.pid for p in multiprocessing.active_children()]
        alive = []
        for pid in sorted(pids_seen):
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        apps = _compute_apps()
        if live or alive or apps != baseline:
            fail(f"{label}: after shutdown children {live}, workers alive "
                 f"{alive}, compute apps {apps} (before: {baseline})")
        return apps

    baseline = _compute_apps()
    result["compute_apps_before"] = baseline

    # ------------------------------------------- (a) tasks and actors
    _reset_counts()
    ray_tpu_torch.init()
    try:
        t0 = time.time()
        answers, rep = ray_tpu_torch.get(
            ray_tpu_torch.remote(_answer_in_worker).options(
                num_gpus=1, isolation="process").remote(serve_requests),
            timeout=600)
        task_s = time.time() - t0
        check_worker("task", rep)
        for i, ans in enumerate(answers):
            tie(f"task request {i}", ref_serve[i], ans)
        if rep["launches"]["splash_attention_fwd"] != n_layer * len(answers):
            fail(f"task: {rep['launches']} for {len(answers)} forwards")
        add(rep["launches"])
        x = torch.arange(8.0, device="cuda")
        arrived, back = ray_tpu_torch.get(
            ray_tpu_torch.remote(_tensor_in_worker).options(
                num_gpus=1, isolation="process").remote(x), timeout=600)
        if arrived != "cpu" or back.device.type != "cpu" \
                or not torch.equal(back, (x * 2).cpu()):
            fail(f"a CUDA tensor crossed as a {arrived} tensor and came back "
                 f"as {back.device} {back.tolist()}")
        streamed = list(ray_tpu_torch.get(list(
            ray_tpu_torch.remote(_stream_in_worker).options(
                num_gpus=1, isolation="process").remote(
                    prompt, SERVE_MAX_NEW)), timeout=600))
        srep, streamed = streamed[-1], streamed[:-1]
        check_worker("stream", srep)
        if srep["launches"]["splash_attention_fwd"] != n_layer * len(streamed):
            fail(f"stream: {srep['launches']} for {len(streamed)} tokens")
        add(srep["launches"])

        # A process actor's methods are sync (GPT2Next's __call__ is not):
        # GPT2Stream's body answers next-token requests with next_tokens.
        actor = ray_tpu_torch.remote(_reporting(serve.GPT2Stream)).options(
            isolation="process", num_gpus=0.5, max_restarts=1).remote(
                config, seed=0)

        def next_of(toks):
            return ray_tpu_torch.get(actor.next_tokens.remote([toks]),
                                     timeout=600)[0]

        first = next_of(serve_requests[0])
        arep = ray_tpu_torch.get(actor.report.remote(), timeout=60)
        check_worker("actor", arep)
        t_kill = time.time()
        os.kill(arep["pid"], signal.SIGKILL)
        try:
            next_of(serve_requests[0])
            fail("actor: a call after its worker was killed was answered")
        except ray_tpu_torch.exceptions.ActorDiedError:
            pass
        deadline = time.time() + 600
        while True:
            try:
                again = next_of(serve_requests[0])
                break
            except ray_tpu_torch.exceptions.ActorDiedError:
                if time.time() > deadline:
                    fail("actor: no restart within 600 s")
                time.sleep(0.1)
        t_back = time.time()
        ray_tpu_torch.get(actor.reset_launches.remote(), timeout=60)
        next_of(serve_requests[1])
        brep = ray_tpu_torch.get(actor.report.remote(), timeout=60)
        check_worker("restarted actor", brep)
        restarts = get_runtime().get_actor_state(
            actor._ray_actor_id).num_restarts
        if brep["pid"] == arep["pid"] or restarts != 1:
            fail(f"actor: pid {arep['pid']} -> {brep['pid']} after "
                 f"{restarts} restarts")
        if brep["launches"]["splash_attention_fwd"] != n_layer:
            fail(f"restarted actor: {brep['launches']} for one forward")
        add(brep["launches"])
        for label, ans in (("actor", first), ("restarted actor", again)):
            tie(label, ref_serve[0], ans)
        ray_tpu_torch.kill(actor)
        driver_quiet("tasks and actors")
        stream_ties("process stream", streamed)  # forwards in this process
        result["tasks"] = dict(
            answers=answers, equal_to_inprocess=answers == inproc[
                "unary_answers"], task_s=task_s, worker=rep,
            cuda_tensor_arrived_as=arrived,
            stream_tokens=streamed,
            stream_equal_to_inprocess=streamed == inproc["stream_tokens"],
            actor_answers=[first, again], actor_pids=[arep["pid"],
                                                      brep["pid"]],
            kill_to_answer_s=t_back - t_kill,
            restarted_actor_built_s=brep["built"][1] - brep["built"][0])
    finally:
        ray_tpu_torch.shutdown()
    reap_check("tasks and actors", baseline)

    # ------------------------------------------------------ (b) serving
    ray_tpu_torch.init()
    runs = []
    cold = []
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        rt = get_runtime()
        Proc = _reporting(serve.GPT2Next)
        gpu = {"num_gpus": 0.5}
        proc_gpu = {"isolation": "process", "num_gpus": 0.5}

        def deploy(tier, n):
            """``tier`` "thread" or "process" (64 requests in flight a
            replica), or "serial": process replicas whose actor runs one
            call at a time, as a thread replica's event loop runs
            ``GPT2Next``'s forwards (its ``__call__`` computes without
            awaiting)."""
            in_process = tier != "thread"
            opts = dict(proc_gpu if in_process else gpu)
            if tier == "serial":
                opts["max_concurrency"] = 1
            handle = serve.run(serve.deployment(
                num_replicas=n,
                max_ongoing_requests=1 if tier == "serial" else 64,
                ray_actor_options=opts)(
                    Proc if in_process else serve.GPT2Next).bind(
                        config, **(dict(seed=0) if in_process
                                   else dict(params=params))),
                name=tier, route_prefix=f"/{tier}")
            reps = replicas(handle, n)
            for rid, a in reps:  # warm-up on each replica, not counted
                t1 = time.time()
                ray_tpu_torch.get(a.handle_request.remote(
                    "next_token", bodies_requests[0]), timeout=600)
                if in_process and rid not in {c["replica"] for c in cold}:
                    r = ray_tpu_torch.get(a.handle_request.remote("report"),
                                          timeout=60)
                    w = rt.get_actor_state(a._actor_id).proc_worker
                    check_worker(f"replica {rid}", r)
                    cold.append(dict(
                        replica=rid, pid=r["pid"],
                        spawn_to_worker_main_s=r["main_at"] - w.spawned_at,
                        worker_main_to_init_s=r["built"][0] - r["main_at"],
                        init_s=r["built"][1] - r["built"][0],
                        spawn_to_ready_s=r["built"][1] - w.spawned_at,
                        first_answer_s=time.time() - t1,
                        kernel_load_s=r["load_s"]["splash_attention_fwd"]))
            return handle

        def replicas(handle, n):
            sched = handle._get_router()._scheduler
            deadline = time.time() + 120
            while True:
                with sched._lock:
                    out = [(r["replica_id"], r["actor"])
                           for r in sched._replicas]
                if len(out) >= n:
                    return out
                if time.time() > deadline:
                    fail(f"the router knows {len(out)} replicas, wanted {n}")
                time.sleep(0.05)

        def measure(tier, handle, n):
            reps = replicas(handle, n)
            if tier != "thread":
                for _, a in reps:
                    ray_tpu_torch.get(a.handle_request.remote(
                        "reset_launches"), timeout=60)
            _reset_counts()
            log = _traffic(f"{addr}/{tier}", bodies, PROC_CLIENTS,
                           PROC_SECONDS)
            n_ok = 0
            for i, _, _, status, out in log:
                ans = (out or {}).get("next_token")
                if status != 200 or not isinstance(ans, int):
                    fail(f"{tier} x{n}: answer {status} {out}")
                tie(f"{tier} x{n} request {i}", ref_bodies[i], ans)
                n_ok += 1
            t_first = min(sent for _, sent, _, _, _ in log)
            t_last = max(done for _, _, done, _, _ in log)
            if tier != "thread":
                driver_quiet(f"process x{n}")
                reports = [ray_tpu_torch.get(a.handle_request.remote(
                    "report"), timeout=60) for _, a in reps]
                for r in reports:
                    check_worker(f"process x{n}", r)
                    add(r["launches"])
                pids = {r["pid"] for r in reports}
                if len(pids) != n:
                    fail(f"process x{n}: replicas in processes {pids}")
                launches = sum(r["launches"]["splash_attention_fwd"]
                               for r in reports)
                by_replica = [r["launches"]["splash_attention_fwd"] // n_layer
                              for r in reports]
            else:
                launches = _counts()["splash_attention_fwd"]
                by_replica = None
            if launches != n_layer * n_ok:
                fail(f"{tier} x{n}: {launches} splash launches for {n_ok} "
                     f"answers, want {n_layer} each")
            run = dict(tier=tier, replicas=n, answered=n_ok,
                       qps=n_ok / (t_last - t_first),
                       answered_by_replica=by_replica)
            runs.append(run)
            print(f"serve_process load {json.dumps(run)}", flush=True)

        handles = {"thread": deploy("thread", 1),
                   "process": deploy("process", 1)}
        result["compute_apps_serving"] = _compute_apps()
        for _ in range(PROC_ROUNDS):
            for tier in ("thread", "process"):
                measure(tier, handles[tier], 1)
        for _ in range(PROC_ROUNDS):
            for tier, other in (("process", "thread"), ("thread", "process")):
                serve.delete(other)
                measure(tier, deploy(tier, 2), 2)
        serve.delete("thread")
        # Process replicas that run one forward at a time: what the
        # concurrent forwards of one process cost.
        for n in (1, 2):
            measure("serial", deploy("serial", n), n)
        serve.delete("serial")

        PStream = _reporting(serve.GPT2Stream)
        h = serve.run(serve.deployment(ray_actor_options=proc_gpu)(
            PStream).bind(config, seed=0), name="pstream",
            route_prefix="/pstream")
        ((_, sactor),) = replicas(h, 1)
        _sse(f"{addr}/pstream?tokens=1,2,3&max_new=1")  # warm-up
        ray_tpu_torch.get(sactor.handle_request.remote("reset_launches"),
                          timeout=60)
        _reset_counts()
        query = f"tokens={','.join(map(str, prompt))}&max_new={SERVE_MAX_NEW}"
        status, ctype, events, _ = _sse(f"{addr}/pstream?{query}")
        srep = ray_tpu_torch.get(sactor.handle_request.remote("report"),
                                 timeout=60)
        check_worker("stream replica", srep)
        sse_tokens = [e.get("token") for e in events]
        if status != 200 or not ctype.startswith("text/event-stream"):
            fail(f"process SSE answer {status} with Content-Type {ctype}")
        if sse_tokens != inproc["stream_tokens"]:
            fail(f"process SSE tokens {sse_tokens} != in-process "
                 f"{inproc['stream_tokens']}")
        if srep["launches"]["splash_attention_fwd"] != n_layer * SERVE_MAX_NEW:
            fail(f"process SSE: {srep['launches']} for {SERVE_MAX_NEW} "
                 "tokens")
        add(srep["launches"])
        driver_quiet("process SSE")
        stream_ties("process SSE", sse_tokens)
        serve.delete("pstream")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    result["compute_apps_after"] = reap_check("serving", baseline)

    others = {k: n for k, n in totals.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the process serving paths launched other kernels: {others}")

    def qps(tier, n):
        return [r["qps"] for r in runs
                if r["tier"] == tier and r["replicas"] == n]

    result.update(
        card=card_line(), clients=PROC_CLIENTS, seconds_per_run=PROC_SECONDS,
        runs=runs,
        qps_thread_x1=qps("thread", 1), qps_thread_x2=qps("thread", 2),
        qps_process_x1=qps("process", 1), qps_process_x2=qps("process", 2),
        qps_serial_x1=qps("serial", 1), qps_serial_x2=qps("serial", 2),
        process_x2_over_x1=statistics.median(qps("process", 2))
        / statistics.median(qps("process", 1)),
        thread_x2_over_x1=statistics.median(qps("thread", 2))
        / statistics.median(qps("thread", 1)),
        cold_start=cold, sse_tokens=sse_tokens,
        worker_pids=sorted(pids_seen), worst_gap_below_max=worst[0],
        splash_launches=totals.get("splash_attention_fwd", 0),
        launches=totals)
    print("serve_process " + json.dumps(result), flush=True)
    return result


DATA_ROWS = 2048
DATA_BLOCKS = 16
DATA_BATCH = 32
INGEST_ROWS = 512
INGEST_BATCH = 16
DATA_ROUNDS = 2


# GPT-2 124M as two compiled stages: (B, S, executions gated) per shape.
DAG_SHAPES = ((1, 1024, 32), (8, 1024, 8))
# Executions per timed run, by B, for each of the three paths.
DAG_TIMED = {1: 48, 8: 16}
DAG_MAX_BUFFERED = 8
DAG_MEM_SLACK = 8 << 20  # bytes
# allreduce of block 0's MLP halves against the unsplit MLP, over its
# largest entry: each half rounds its bf16 product before the sum.
MLP_RTOL = 2e-2


def _phase_threads(before) -> List[str]:
    """Names of threads started since ``before`` still alive a few seconds
    on, but for two process-wide ones that are started once and kept: the
    hang watchdog and serve's executor for sync user code."""
    import threading

    deadline = time.monotonic() + 5.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t not in before and t.name != "ray_tpu_hang_watchdog"
                and not t.name.startswith("serve-sync")]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def _transfer_bytes(src: str) -> Dict[str, float]:
    """Bytes the transfer ledger holds for ``src``, by direction."""
    from ray_tpu_torch.util import device_telemetry as dt

    return {d: dt.TRANSFER_BYTES.get(tags={"direction": d, "src": src})
            for d in ("h2d", "d2h")}


def _pool_bytes(pool: str) -> float:
    from ray_tpu_torch.util import device_telemetry as dt

    return dt.pool_bytes().get(pool, {}).get("bytes", 0.0)


def _in_flight(submit: Callable[[], object], get: Callable[[object], object],
               n: int, window: int) -> float:
    """Seconds for ``n`` submissions with at most ``window`` in flight, each
    result fetched in order, until the card is done."""
    import collections

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = collections.deque()
    for _ in range(n):
        if len(pending) == window:
            get(pending.popleft())
        pending.append(submit())
    while pending:
        get(pending.popleft())
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _settled_memory() -> int:
    """The card's allocated bytes with the collector run and cuBLAS's
    per-thread workspaces dropped (a thread's handle keeps one after the
    thread ends)."""
    import gc

    import torch

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def phase_dag_compiled(params) -> Dict[str, object]:
    """GPT-2 124M as two compiled stages (``dag_compiled`` line). Thread
    actor ``StageA`` holds the embeddings and blocks 0-5, ``StageB`` blocks
    6-11, ln_f and the head (``GPT2Stage`` on the serving phases' weights,
    cast as ``GPT2Next`` casts them), compiled as
    ``b.tail.bind(a.head.bind(inp).with_tensor_transport())``.
    (a) 32 executions at (1, 1024) and 8 at (8, 1024), tokens from numpy
    seed 0: each answer's logits keep the tie rule against one whole
    ``gpt2.forward`` here at every position (the max |dlogit| printed: the
    kernels and shapes are the same, so 0 is expected), exactly 12 splash
    forward launches per execution and none of the other kernels, the
    tensor StageB reads has the data_ptr and device StageA wrote, and the
    transfer ledger holds 0 host bytes for ``dag_channel``.
    (b) Two thread actors hold halves of block 0's MLP (``mlp_in`` by
    columns, ``mlp_out`` by rows) on the card, and ``allreduce.bind`` sums
    their partial outputs: both reduced tensors equal bit for bit, each
    within ``MLP_RTOL`` of the unsplit MLP's largest entry.
    (c) After teardown both stages answer plain calls; after shutdown no
    thread of the phase is left, the ``dag_channel`` pool reads 0 and the
    card's allocated memory is back within ``DAG_MEM_SLACK``.
    It prints executions/s and ms per execution at both shapes for the
    compiled DAG (up to ``DAG_MAX_BUFFERED`` in flight), interpreted
    ``execute()`` (as many in flight) and one direct forward here, with
    their ratios, beside the card's name and power limit."""
    import threading

    import numpy as np
    import torch
    import torch.nn.functional as F

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.gpt2 import GPT2Stage

    config = gpt2.GPTConfig()
    L = config.n_layer
    mem0 = _settled_memory()
    threads0 = set(threading.enumerate())
    xfer0 = _transfer_bytes("dag_channel")
    rng = np.random.default_rng(0)
    inputs = {B: [rng.integers(0, config.vocab_size, (B, S))
                  for _ in range(n)] for B, S, n in DAG_SHAPES}
    whole_params = gpt2.inference_params(params, config)

    def whole(tokens):
        with torch.inference_mode():
            return gpt2.forward(whole_params,
                                torch.as_tensor(tokens, device="cuda"),
                                config)

    class StageA(GPT2Stage):
        """Records where each hidden state it hands on lives."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []

        def head(self, tokens):
            out = super().head(tokens)
            self.records.append((out.data_ptr(), str(out.device)))
            return out

        def take(self):
            out, self.records = self.records, []
            return out

    class StageB(GPT2Stage):
        """Records where each hidden state it reads lives."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []

        def tail(self, hidden):
            self.records.append((hidden.data_ptr(), str(hidden.device)))
            return super().tail(hidden)

        take = StageA.take

    class MLPHalf:
        """Half ``part`` of block 0's MLP: mlp_in's columns and mlp_out's
        rows of that half; the first half adds mlp_out's bias."""

        def __init__(self, blk, part: int):
            D4 = blk["mlp_in_w"].shape[1]
            cols = slice(part * D4 // 2, (part + 1) * D4 // 2)
            dt = config.dtype
            self.w_in = blk["mlp_in_w"][:, cols].to(dt)
            self.b_in = blk["mlp_in_b"][cols].to(dt)
            self.w_out = blk["mlp_out_w"][cols].to(dt)
            self.b_out = blk["mlp_out_b"].to(dt) if part == 0 else None

        def mlp(self, x):
            with torch.inference_mode():
                y = F.gelu(x @ self.w_in + self.b_in,
                           approximate="tanh") @ self.w_out
                return y if self.b_out is None else y + self.b_out

        def take(self, y):
            return y

    worst = 0.0
    driver_launches = 0

    def check(B, S, tokens, out):
        """The tie rule at every position against one whole forward, whose
        own splash launches are kept out of the DAG's count (no execution
        is in flight while it runs)."""
        nonlocal worst, driver_launches
        if out.shape != (B, S, config.vocab_size) or not out.is_cuda \
                or not torch.isfinite(out).all():
            fail(f"dag_compiled: logits {tuple(out.shape)} on {out.device}, "
                 f"or non-finite")
        before = _counts()["splash_attention_fwd"]
        ref = whole(tokens)
        driver_launches += _counts()["splash_attention_fwd"] - before
        worst = max(worst, (out - ref).abs().max().item())
        chosen = out.argmax(-1, keepdim=True)
        gap = (ref.max(-1).values - ref.gather(-1, chosen)[..., 0]).max()
        if gap.item() > LOGIT_ATOL:
            fail(f"dag_compiled at B={B}: a chosen token is {gap.item()} "
                 f"below the whole forward's maximum (tol {LOGIT_ATOL})")

    result: Dict[str, object] = {}
    card = card_line()
    ray_tpu_torch.init()
    try:
        a = ray_tpu_torch.remote(StageA).remote((0, L // 2), config,
                                                params=params)
        b = ray_tpu_torch.remote(StageB).remote((L // 2, L), config,
                                                params=params)
        with InputNode() as inp:
            dag = b.tail.bind(a.head.bind(inp).with_tensor_transport())
        compiled = dag.experimental_compile(max_buffered=DAG_MAX_BUFFERED)
        try:
            for B in inputs:  # warm-up: cuBLAS handles, the allocator
                compiled.execute(inputs[B][0]).get(timeout=300)
            # ----------------------------------------- (a) the main path
            _reset_counts()
            for B, S, n in DAG_SHAPES:
                refs = []
                for i, tokens in enumerate(inputs[B]):
                    refs.append((tokens, compiled.execute(tokens)))
                    if len(refs) < DAG_MAX_BUFFERED and i < n - 1:
                        continue
                    outs = [(tokens, ref.get(timeout=300))
                            for tokens, ref in refs]
                    for tokens, out in outs:
                        check(B, S, tokens, out)
                    refs, outs, out = [], [], None
            torch.cuda.synchronize()
            launches = _counts()
            launches["splash_attention_fwd"] -= driver_launches
            executions = sum(n for _, _, n in DAG_SHAPES)
            if launches["splash_attention_fwd"] != L * executions:
                fail(f"dag_compiled: {launches['splash_attention_fwd']} "
                     f"splash launches for {executions} executions, "
                     f"want {L} each")
            others = {k: v for k, v in launches.items()
                      if k != "splash_attention_fwd" and v}
            if others:
                fail(f"dag_compiled launched other kernels: {others}")
            timed = {}
            for B, n in DAG_TIMED.items():
                x = inputs[B][0]
                timed[B] = {"compiled": _in_flight(
                    lambda: compiled.execute(x),
                    lambda r: r.get(timeout=300), n, DAG_MAX_BUFFERED)}
        finally:
            compiled.teardown()
        # The loops are gone: each stage's mailbox answers plain calls.
        wrote = ray_tpu_torch.get(a.take.remote(), timeout=60)
        read = ray_tpu_torch.get(b.take.remote(), timeout=60)
        if not wrote or wrote != read or any(
                dev != "cuda:0" for _, dev in wrote):
            fail(f"dag_compiled: StageB read other tensors than StageA "
                 f"wrote ({len(wrote)} written, {len(read)} read, first "
                 f"{wrote[:1]} / {read[:1]})")
        xfer = {d: v - xfer0[d]
                for d, v in _transfer_bytes("dag_channel").items()}
        if any(xfer.values()):
            fail(f"dag_compiled: the edge moved host bytes {xfer}")
        for B, n in DAG_TIMED.items():
            x = inputs[B][0]
            timed[B]["interpreted"] = _in_flight(
                lambda: dag.execute(x),
                lambda r: ray_tpu_torch.get(r, timeout=300), n,
                DAG_MAX_BUFFERED)
            timed[B]["direct"] = _in_flight(lambda: whole(x), lambda r: r,
                                            n, n)
        hidden = ray_tpu_torch.get(a.head.remote([1, 2, 3]), timeout=60)
        answer = ray_tpu_torch.get(b.next_token.remote(hidden), timeout=60)
        del hidden

        # ------------------------------------------- (b) the allreduce
        blk = {k: v[0] for k, v in params["blocks"].items()}
        x = torch.randn((1, 1024, config.d_model),
                        generator=torch.Generator(device="cuda").manual_seed(
                            0), device="cuda").to(config.dtype)
        halves = [ray_tpu_torch.remote(MLPHalf).remote(blk, p)
                  for p in (0, 1)]
        with InputNode() as inp:
            parts = [h.mlp.bind(inp) for h in halves]
            reduced = allreduce.bind(parts)
            ar_dag = MultiOutputNode([h.take.bind(r)
                                      for h, r in zip(halves, reduced)])
        ar = ar_dag.experimental_compile()
        try:
            outs = ar.execute(x).get(timeout=120)
        finally:
            ar.teardown()
        with torch.inference_mode():
            dt = config.dtype
            full = F.gelu(x @ blk["mlp_in_w"].to(dt) + blk["mlp_in_b"].to(dt),
                          approximate="tanh") @ blk["mlp_out_w"].to(dt) \
                + blk["mlp_out_b"].to(dt)
        scale = full.float().abs().max().item()
        mlp_err = [(o.float() - full.float()).abs().max().item() / scale
                   for o in outs]
        if not (outs[0].is_cuda and torch.equal(outs[0], outs[1])):
            fail("allreduce: the two participants' reduced tensors differ")
        if max(mlp_err) > MLP_RTOL:
            fail(f"allreduce: the summed halves are {mlp_err} of the "
                 f"unsplit MLP's largest entry from it (tol {MLP_RTOL})")
        del outs, full, x, blk
        alive = [ray_tpu_torch.get(h.take.remote(7), timeout=60) == 7
                 for h in halves]
        if not all(alive):
            fail("allreduce: a participant does not answer after teardown")
        # Killed, not only shut down: a runtime keeps its actors'
        # instances, and with them the stages' weights, until the next one.
        for actor in (a, b, *halves, reduced[0]._target):
            ray_tpu_torch.kill(actor)
        del a, b, halves, compiled, ar, dag, ar_dag, reduced
    finally:
        ray_tpu_torch.shutdown()
    # ------------------------------------------------- (c) what is left
    left = _phase_threads(threads0)
    if left:
        fail(f"dag_compiled: threads left after shutdown: {left}")
    pool = _pool_bytes("dag_channel")
    if pool:
        fail(f"dag_compiled: the dag_channel pool holds {pool} bytes")
    del whole_params
    mem = _settled_memory()
    if mem > mem0 + DAG_MEM_SLACK:
        fail(f"dag_compiled: the card holds {mem - mem0} bytes more than "
             f"before the phase (slack {DAG_MEM_SLACK})")
    rates = {}
    for B, by in timed.items():
        n = DAG_TIMED[B]
        rates[f"B{B}"] = dict(
            executions=n,
            per_s={k: n / s for k, s in by.items()},
            ms={k: s / n * 1e3 for k, s in by.items()},
            compiled_over_interpreted=by["interpreted"] / by["compiled"],
            compiled_over_direct=by["direct"] / by["compiled"])
    result.update(
        card=card, stages=[[0, L // 2], [L // 2, L]],
        executions={f"B{B}": n for B, _, n in DAG_SHAPES},
        max_abs_logit_err=worst, launches=launches,
        splash_per_execution=launches["splash_attention_fwd"] / executions,
        edge_records=len(wrote), edge_host_bytes=xfer,
        plain_call_after_teardown=answer, allreduce_rel_err=mlp_err,
        dag_channel_pool_bytes=pool, memory_delta_bytes=mem - mem0,
        max_buffered=DAG_MAX_BUFFERED, rates=rates)
    print("dag_compiled " + json.dumps(result), flush=True)
    return result


# The compiled serve route: handle clients per run, requests through the
# pipeline, the clients and seconds of the membership change.
SC_CLIENTS = (1, 8, 32)
SC_PIPE_REQUESTS = 32
SC_CHANGE_CLIENTS = 8
SC_CHANGE_AFTER_S = 1.0
SC_REASONS = ("deploy", "replica_death", "drain", "rolling_update",
              "autoscale")


def _wait_compiled(handle, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while handle._get_router()._compiled.mode != "compiled":
        if time.monotonic() > deadline:
            fail(f"{handle.deployment_id}: the route never compiled")
        time.sleep(0.02)


def _recompiles(dep_id: str) -> Dict[str, float]:
    from ray_tpu_torch.serve.compiled_router import RECOMPILES_TOTAL

    out = {r: RECOMPILES_TOTAL.get(tags={"deployment": dep_id, "reason": r})
           for r in SC_REASONS}
    return {r: n for r, n in out.items() if n}


def _handle_answers(handle, bodies: list, clients: int
                    ) -> Tuple[list, list, float]:
    """Every body through the handle by ``clients`` threads at once: the
    answers in the bodies' order, each request's latency (ms) and the wall
    time."""
    from concurrent.futures import ThreadPoolExecutor

    def one(body):
        t0 = time.perf_counter()
        out = handle.remote(_Request(body=body)).result(timeout_s=120)
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        outs = list(pool.map(one, bodies))
    return ([o["next_token"] for o, _ in outs], [ms for _, ms in outs],
            time.perf_counter() - t0)


def phase_serve_compiled(params) -> Dict[str, object]:
    """The compiled serve route on the card (``serve_compiled`` line), GPT-2
    124M with the serving phases' weights, each replica a thread of this
    process on a quarter of the card.
    (a) ``GPT2BatchNext`` on one replica through ``serve.run``, and the same
    deployment with ``compiled_route=False`` beside it: after the stability
    window ``serve.status()`` reads ``route_mode`` "compiled" for the first
    and "dynamic" for the second, and the first's recompile counter reads 1
    with reason "deploy"; 64 requests of (7)'s lengths from 1, 8 and 32
    handle clients to each in turns, and (after (b)) from 8 HTTP clients
    to the compiled one, keep the tie rule against ``GPT2Next`` here, with
    exactly 12 splash launches per vectorized call (``serve_batch_size``'s
    count).
    (b) The compiled deployment redeployed at two replicas under 8 handle
    clients: no caller sees an error, every answer keeps the tie rule, the
    route tears down and compiles again over both replicas (the counter at
    2), and the reasons are printed.
    (c) ``serve.pipeline`` over two deployments of ``GPT2Stage`` (the
    ``dag_compiled`` stages: blocks 0-5 with the embeddings, 6-11 with ln_f
    and the head; ``methods=["head", "next_token"]``, ``devices=["cuda"]``):
    ``mode`` "compiled", 32 requests each answered as ``GPT2Next`` answers
    it, the pipeline-forwards counter up by 32, 0 host bytes ledgered for
    the hidden state, 12 splash launches per request. After shutdown no
    thread of the phase is left and the ``dag_channel`` pool reads 0.
    It prints requests/s and p50 latency by clients for the compiled and
    the dynamic route and their ratio, beside the card's name and power
    limit."""
    import threading

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import batching
    from ray_tpu_torch.serve.compiled_router import PIPELINE_FORWARDS

    config = gpt2.GPTConfig()
    L = config.n_layer
    requests, _ = _batch_inputs()
    bodies = [{"tokens": t} for t in requests]
    local_next = serve.GPT2Next(config, params=params)
    with torch.inference_mode():
        ref_logits = torch.stack([local_next.logits(t) for t in requests])
    ref_answers = torch.argmax(ref_logits, dim=-1).tolist()
    worst = 0.0

    def held(label, answers, indices):
        nonlocal worst
        for i, ans in zip(indices, answers):
            g = (ref_logits[i].max() - ref_logits[i][ans]).item()
            worst = max(worst, g)
            if g > LOGIT_ATOL:
                fail(f"serve_compiled {label}: answer {ans} to request {i} "
                     f"is {g} below the in-process maximum (tol "
                     f"{LOGIT_ATOL})")

    threads0 = set(threading.enumerate())
    card = card_line()
    quarter = {"num_gpus": 0.25}
    batch_tags = {"deployment": "GPT2BatchNext", "method": "next_token"}
    result: Dict[str, object] = dict(card=card)
    ray_tpu_torch.init()
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        dep = serve.deployment(max_ongoing_requests=64,
                               ray_actor_options=quarter)(serve.GPT2BatchNext)
        comp_id = "compiled#GPT2BatchNext"
        base = _recompiles(comp_id)
        h_c = serve.run(dep.bind(config, params=params), name="compiled",
                        route_prefix="/compiled")
        h_d = serve.run(dep.options(compiled_route=False).bind(
            config, params=params), name="dynamic", route_prefix="/dynamic")
        _wait_compiled(h_c)
        deadline = time.monotonic() + 10
        while True:
            status = serve.status()
            modes = {k: status[f"{k}#GPT2BatchNext"]["route_mode"]
                     for k in ("compiled", "dynamic")}
            if modes["compiled"] == "compiled" or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
        if modes != {"compiled": "compiled", "dynamic": "dynamic"}:
            fail(f"serve_compiled: serve.status() route modes {modes}")
        if h_d._get_router()._compiled.mode != "dynamic":
            fail("serve_compiled: compiled_route=False compiled")
        made = {r: n - base.get(r, 0) for r, n in _recompiles(comp_id).items()
                if n - base.get(r, 0)}
        if made != {"deploy": 1}:
            fail(f"serve_compiled: recompiles after deploy {made}, want "
                 f"one with reason 'deploy'")
        # ----------------------------------------------- (a) one replica
        for h in (h_c, h_d):  # warm-up, not counted: a full batch
            _handle_answers(h, bodies[:32], 32)
        runs: Dict[str, Dict[str, object]] = {"compiled": {}, "dynamic": {}}
        launches_by_run, calls_by_run = {}, {}
        _reset_counts()
        totals: Dict[str, int] = {}
        for clients in SC_CLIENTS:
            for kind, h in (("compiled", h_c), ("dynamic", h_d)):
                seen = batching.BATCH_SIZE_HISTOGRAM.get(tags=batch_tags)
                _reset_counts()
                answers, lat, secs = _handle_answers(h, bodies, clients)
                counts = _counts()
                sizes = _since(batching.BATCH_SIZE_HISTOGRAM, batch_tags,
                               seen)
                held(f"{kind} c{clients}", answers, range(len(bodies)))
                launches = counts["splash_attention_fwd"]
                if launches != L * sizes["count"] or \
                        sizes["sum"] != len(bodies):
                    fail(f"serve_compiled {kind} c{clients}: {launches} "
                         f"splash launches over {sizes}, want {L} per "
                         f"vectorized call holding {len(bodies)} requests")
                if kind == "compiled":
                    for k, v in counts.items():
                        totals[k] = totals.get(k, 0) + v
                runs[kind][f"c{clients}"] = dict(
                    qps=len(bodies) / secs, p50_ms=statistics.median(lat),
                    vectorized_calls=sizes["count"])
                launches_by_run[f"{kind}_c{clients}"] = launches
        serve.delete("dynamic")

        # ------------------------------- (b) a membership change, loaded
        graph0 = h_c._get_router()._compiled.graph
        stop = threading.Event()
        errors, answered = [], []

        def client(k):
            i = k
            while not stop.is_set():
                j = i % len(bodies)
                try:
                    out = h_c.remote(_Request(body=bodies[j])).result(
                        timeout_s=120)
                    answered.append((j, out["next_token"]))
                except Exception as e:  # noqa: BLE001 — the gate below
                    errors.append(repr(e))
                    return
                i += SC_CHANGE_CLIENTS

        clients_ = [threading.Thread(target=client, args=(k,))
                    for k in range(SC_CHANGE_CLIENTS)]
        for t in clients_:
            t.start()
        time.sleep(SC_CHANGE_AFTER_S)
        t_change = time.perf_counter()
        serve.run(dep.options(num_replicas=2).bind(config, params=params),
                  name="compiled", route_prefix="/compiled")
        mgr = h_c._get_router()._compiled
        deadline = time.monotonic() + 60
        while not (mgr.graph is not None and mgr.graph is not graph0
                   and len(mgr.graph._lanes) == 2):
            if time.monotonic() > deadline or errors:
                break
            time.sleep(0.02)
        recompiled_s = time.perf_counter() - t_change
        time.sleep(SC_CHANGE_AFTER_S)
        stop.set()
        for t in clients_:
            t.join(timeout=120)
        if errors or any(t.is_alive() for t in clients_):
            fail(f"serve_compiled: callers saw errors through the "
                 f"membership change: {errors[:3]}")
        if mgr.graph is None or len(mgr.graph._lanes) != 2:
            fail("serve_compiled: the route did not compile again over "
                 "two replicas")
        held("membership change", [a for _, a in answered],
             [j for j, _ in answered])
        change_reasons = {r: n - base.get(r, 0)
                          for r, n in _recompiles(comp_id).items()
                          if n - base.get(r, 0)}
        if sum(change_reasons.values()) != 2:
            fail(f"serve_compiled: recompiles {change_reasons}, want 2")
        # (a) over HTTP, after (b): the proxy's own router would add its
        # compiles to the counter (b) reads.
        seen = batching.BATCH_SIZE_HISTOGRAM.get(tags=batch_tags)
        _reset_counts()
        outs, secs = _post_concurrently(f"{addr}/compiled", bodies, 8)
        counts = _counts()
        sizes = _since(batching.BATCH_SIZE_HISTOGRAM, batch_tags, seen)
        for status_, _, out in outs:
            if status_ != 200 or not isinstance(out.get("next_token"), int):
                fail(f"serve_compiled HTTP answer {status_} {out}")
        held("HTTP c8", [o["next_token"] for _, _, o in outs],
             range(len(bodies)))
        if counts["splash_attention_fwd"] != L * sizes["count"]:
            fail(f"serve_compiled HTTP: {counts['splash_attention_fwd']} "
                 f"splash launches over {sizes['count']} vectorized calls")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        http_qps = len(bodies) / secs
        serve.delete("compiled")

        # ------------------------------------------------ (c) the pipeline
        stage = serve.deployment(max_ongoing_requests=32,
                                 ray_actor_options=quarter)(serve.GPT2Stage)
        h_head = serve.run(stage.options(name="Head").bind(
            (0, L // 2), config, params=params), name="head",
            route_prefix=None)
        h_tail = serve.run(stage.options(name="Tail").bind(
            (L // 2, L), config, params=params), name="tail",
            route_prefix=None)
        pipe = serve.pipeline(h_head, h_tail, methods=["head", "next_token"],
                              devices=["cuda"], name="gpt2")
        try:
            _wait_compiled(h_head)
            _wait_compiled(h_tail)
            pipe.remote(requests[0]).result(timeout_s=120)  # warm-up
            mode = pipe.mode
            if mode != "compiled":
                fail(f"serve_compiled: the pipeline's mode is {mode}")
            tags = {"pipeline": "gpt2"}
            fwd0 = PIPELINE_FORWARDS.get(tags=tags)
            xfer0 = _transfer_bytes("dag_channel")
            chosen = requests[:SC_PIPE_REQUESTS]
            _reset_counts()
            t0 = time.perf_counter()
            resps = [pipe.remote(t) for t in chosen]
            pipe_answers = [r.result(timeout_s=120) for r in resps]
            pipe_s = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            forwards = PIPELINE_FORWARDS.get(tags=tags) - fwd0
            xfer = {d: v - xfer0[d]
                    for d, v in _transfer_bytes("dag_channel").items()}
            kinds = sorted({type(r).__name__ for r in resps})
            mode_after = pipe.mode
        finally:
            pipe.stop()
        want = [ref_answers[i] for i in range(SC_PIPE_REQUESTS)]
        if pipe_answers != want:
            bad = [i for i, (a, w) in enumerate(zip(pipe_answers, want))
                   if a != w]
            fail(f"serve_compiled: the pipeline answered {len(bad)} "
                 f"requests unlike GPT2Next (first {bad[:3]})")
        if forwards != SC_PIPE_REQUESTS or mode_after != "compiled":
            fail(f"serve_compiled: {forwards} pipeline forwards for "
                 f"{SC_PIPE_REQUESTS} requests, mode {mode_after}")
        if any(xfer.values()):
            fail(f"serve_compiled: the hidden state crossed the host {xfer}")
        if counts["splash_attention_fwd"] != L * SC_PIPE_REQUESTS or any(
                v for k, v in counts.items() if k != "splash_attention_fwd"):
            fail(f"serve_compiled: pipeline launches {counts}, want {L} "
                 f"splash forwards per request")
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    left = _phase_threads(threads0)
    if left:
        fail(f"serve_compiled: threads left after shutdown: {left}")
    pool = _pool_bytes("dag_channel")
    if pool:
        fail(f"serve_compiled: the dag_channel pool holds {pool} bytes")
    result.update(
        requests=len(bodies), runs=runs,
        compiled_over_dynamic={
            c: dict(qps=runs["compiled"][c]["qps"] / runs["dynamic"][c]["qps"],
                    p50=runs["compiled"][c]["p50_ms"]
                    / runs["dynamic"][c]["p50_ms"])
            for c in runs["compiled"]},
        http_qps_c8=http_qps, splash_by_run=launches_by_run,
        route_modes=modes, recompiles_after_deploy=made,
        change=dict(answered=len(answered), errors=len(errors),
                    recompiled_s=recompiled_s, reasons=change_reasons),
        pipeline=dict(requests=SC_PIPE_REQUESTS, mode=mode_after,
                      response_types=kinds, forwards=forwards,
                      host_bytes=xfer, requests_per_s=SC_PIPE_REQUESTS
                      / pipe_s, splash=counts["splash_attention_fwd"]),
        worst_gap_below_max=worst, launches=totals,
        dag_channel_pool_bytes=pool)
    print("serve_compiled " + json.dumps(result), flush=True)
    return result


def _released(label: str) -> None:
    """After a pass: the pool's actor is gone and the card is free again."""
    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import get_runtime

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        alive = [a for a in get_runtime().list_actor_states()
                 if a["class_name"] == "MapWorker" and a["state"] != "DEAD"]
        if not alive and ray_tpu_torch.available_resources().get(
                "GPU") == 1.0:
            return
        time.sleep(0.05)
    fail(f"{label}: pool actor {alive} still up or the card not back "
         f"({ray_tpu_torch.available_resources()})")


def phase_data_batch() -> Dict[str, object]:
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.data.ingest import IngestShard, StreamingIngest
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import fused_ce

    optional = ("pyarrow", "pandas")
    loaded_before = {m for m in sys.modules if m.split(".")[0] in optional}
    config = gpt2.GPTConfig()  # GPT-2 124M, bf16, splash attention
    S, n_layer, B = config.seq_len, config.n_layer, DATA_BATCH
    n_batches = DATA_ROWS // B
    tokens = bi.token_windows(DATA_ROWS, S, 50257)  # default_rng(0)
    direct = bi.GPT2Scorer(config, seed=0, device="cuda:0")
    direct.score(tokens[:B])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    result: Dict[str, object] = {"card": card_line(), "rows": DATA_ROWS,
                                 "blocks": DATA_BLOCKS, "batch": B,
                                 "seq_len": S}

    def run_direct():
        t0 = time.perf_counter()
        outs = [direct.score(tokens[i * B:(i + 1) * B])
                for i in range(n_batches)]
        dt = time.perf_counter() - t0
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}, dt

    ray_tpu_torch.init()
    try:
        if ray_tpu_torch.available_resources().get("GPU") != 1.0:
            fail(f"the runtime registers {ray_tpu_torch.available_resources()}"
                 " (one card expected)")
        ds = bi.token_dataset(tokens, DATA_BLOCKS)
        sizes = [ray_tpu_torch.get(r).num_rows for r in ds.iter_block_refs()]
        if sizes != [DATA_ROWS // DATA_BLOCKS] * DATA_BLOCKS:
            fail(f"token dataset blocks {sizes}")

        def run_data(label):
            before = len(bi.CONSTRUCTED)
            _reset_counts()
            t0 = time.perf_counter()
            got = list(ds.map_batches(
                bi.GPT2Scorer, batch_size=B, num_gpus=1,
                concurrency=1).iter_batches(batch_size=B))
            dt = time.perf_counter() - t0
            counts = _counts()
            built = bi.CONSTRUCTED[before:]
            out = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
            if not np.array_equal(np.sort(out["row"]), np.arange(DATA_ROWS)):
                fail(f"{label}: rows {len(out['row'])} came back, not each "
                     f"of {DATA_ROWS} once")
            want = {k: 0 for k in counts}
            want.update(splash_attention_fwd=n_layer * n_batches,
                        fused_ce_fwd=n_batches)
            # The plain versions run only on CPU tensors, so exact launch
            # counts also show that none of them took a kernel's place.
            if counts != want:
                fail(f"{label}: launches {counts} (want {want})")
            if len(built) != 1 or built[0]["gpu_ids"] != [0] or \
                    built[0]["device"] != "cuda:0":
                fail(f"{label}: pool actors {built} (one on card 0 wanted)")
            _released(label)
            order = np.argsort(out["row"])
            return ({k: v[order] for k, v in out.items()}, dt, counts,
                    built[0]["seconds"])

        turns = []
        for r in range(DATA_ROUNDS):
            d_out, d_s = run_direct()
            m_out, m_s, counts, ctor_s = run_data(f"data pass {r}")
            for key in ("next_token", "nll"):
                a, b = d_out[key], m_out[key]
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    fail(f"data pass {r}: {key} differs from the direct "
                         f"scorer's in {int((a != b).sum())} rows")
            turns.append(dict(direct_s=d_s, data_s=m_s, actor_ctor_s=ctor_s,
                              launches=counts))
        launches = {k: sum(t["launches"][k] for t in turns) for k in counts}

        # The first batch's CE forward at the path's shape (N = B·S), the
        # kernel and its plain version on the same splash hidden states,
        # each token's lse and target logit within CE_ATOL; the kernel's
        # rows give back the path's nll bit for bit.
        wte = direct.params["wte"]
        with torch.inference_mode():
            t = torch.as_tensor(tokens[:B], device="cuda")
            x2 = gpt2.forward_hidden(direct.params, t[:, :S],
                                     config).reshape(B * S, -1)
            t2 = t[:, 1:].reshape(-1)
            lse, tgt = fused_ce.ce_fwd(x2, wte, t2)
            lse_r, tgt_r = fused_ce.ce_fwd_reference(x2, wte, t2)
            ce_check = dict(
                N=B * S, D=x2.shape[1], V=wte.shape[0],
                lse_abs_err=(lse - lse_r).abs().max().item(),
                tgt_abs_err=(tgt - tgt_r).abs().max().item())
            ce_check["max_abs_err"] = max(ce_check["lse_abs_err"],
                                          ce_check["tgt_abs_err"])
            path_nll = (lse - tgt).view(B, S).mean(dim=1).float().cpu()
            finite = bool(torch.isfinite(lse).all() and
                          torch.isfinite(tgt).all())
            del x2, lse, tgt, lse_r, tgt_r
        if not finite or ce_check["max_abs_err"] > CE_ATOL:
            fail(f"fused_ce_fwd disagrees with ce_fwd_reference on the first "
                 f"batch's hidden states: {ce_check} (tol {CE_ATOL})")
        if path_nll.numpy().tobytes() != d_out["nll"][:B].tobytes():
            fail("the first batch's nll differs from the checked CE forward's")

        # The first batch against plain attention and the plain CE forward.
        ref_config = dataclasses.replace(config, attn_impl="xla")
        with torch.inference_mode():
            x = gpt2.forward_hidden(direct.params, t[:, :S], ref_config)
            ref_last = gpt2.lm_head(x[:, -1], wte, torch.float32)
            lse, tgt = fused_ce.ce_fwd_reference(
                x.reshape(B * S, -1), wte, t2)
            ref_nll = (lse - tgt).view(B, S).mean(dim=1).cpu().numpy()
            chosen = torch.as_tensor(d_out["next_token"][:B], device="cuda")
            gaps = (ref_last.max(dim=1).values - ref_last.gather(
                1, chosen[:, None])[:, 0]).cpu().numpy()
            del x, lse, tgt
        nll_err = float(np.abs(d_out["nll"][:B] - ref_nll).max())
        if not np.isfinite(d_out["nll"]).all() or \
                gaps.max() > LOGIT_ATOL or nll_err > LOGIT_ATOL:
            fail(f"first batch against the plain path: worst gap below the "
                 f"max {gaps.max()}, nll error {nll_err} (tol {LOGIT_ATOL})")

        # Device time of one scoring batch (graph replay) and one call.
        t_dev = torch.as_tensor(tokens[:B], device="cuda")

        def score_on_device():
            xh = gpt2.forward_hidden(direct.params, t_dev[:, :S], config)
            fused_ce.ce_fwd(xh.reshape(B * S, -1), wte,
                            t_dev[:, 1:].reshape(-1))
            return torch.argmax(gpt2.lm_head(xh[:, -1], wte, torch.float32),
                                dim=-1)

        with torch.inference_mode():
            score_device_ms = device_ms(score_on_device, iters=3)
        score_call_ms = time_ms(lambda: direct.score(tokens[:B]), iters=10)

        # (b) Streaming ingest to the card: the eval step on each batch.
        ids = bi.token_dataset(tokens[:INGEST_ROWS],
                               INGEST_ROWS // (DATA_ROWS // DATA_BLOCKS))
        step = gpt2.make_eval_step(dataclasses.replace(config,
                                                       loss_impl="fused"))
        dev = torch.device("cuda", 0)
        n_ingest = INGEST_ROWS // INGEST_BATCH

        def ingest_loop(prefetch):
            shard = IngestShard(StreamingIngest(ids, seed=0))
            batches, losses = [], []
            _reset_counts()
            t0 = time.perf_counter()
            if prefetch:
                for b in shard.iter_batches(batch_size=INGEST_BATCH,
                                            device=dev):
                    tok = b["tokens"]
                    losses.append(step(direct.params, tok[:, :S], tok[:, 1:]))
                    batches.append(b)
            else:
                for b in shard.iter_batches(batch_size=INGEST_BATCH):
                    tok = torch.from_numpy(np.array(b["tokens"])).to(dev)
                    losses.append(step(direct.params, tok[:, :S], tok[:, 1:]))
                    batches.append(b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / max(1, len(batches))
            return batches, losses, ms, _counts()

        ingest_loop(False)  # warm-up
        host_ref = [b for b in IngestShard(StreamingIngest(
            ids, seed=0)).iter_batches(batch_size=INGEST_BATCH)]
        ms = {"prefetch": [], "sync_copy": []}
        ingest_launches = {k: 0 for k in launches}
        for r in range(DATA_ROUNDS):
            for mode in (("prefetch", "sync_copy") if r % 2 == 0
                         else ("sync_copy", "prefetch")):
                batches, losses, per, counts = ingest_loop(mode == "prefetch")
                ms[mode].append(per)
                want = {k: 0 for k in counts}
                want.update(splash_attention_fwd=n_layer * n_ingest,
                            fused_ce_fwd=n_ingest)
                if counts != want:
                    fail(f"ingest {mode}: launches {counts} (want {want})")
                vals = torch.stack(losses).float().cpu()
                if len(batches) != n_ingest or not torch.isfinite(vals).all():
                    fail(f"ingest {mode}: {len(batches)} batches, losses "
                         f"{vals.tolist()}")
                if mode != "prefetch":
                    continue
                for k in launches:
                    ingest_launches[k] += counts[k]
                rows = np.concatenate([b["row"].cpu().numpy()
                                       for b in batches])
                if not np.array_equal(np.sort(rows), np.arange(INGEST_ROWS)):
                    fail("ingest: rows not each once")
                for i, (got, ref) in enumerate(zip(batches, host_ref)):
                    for key in ("row", "tokens"):
                        if not got[key].is_cuda or got[key].device != dev:
                            fail(f"ingest batch {i} {key} on "
                                 f"{got[key].device}")
                        if got[key].cpu().numpy().tobytes() != \
                                np.asarray(ref[key]).tobytes():
                            fail(f"ingest batch {i}: {key} differs from the "
                                 "host batch")
        first_loss, last_loss = float(vals[0]), float(vals[-1])
    finally:
        ray_tpu_torch.shutdown()
    loaded = {m for m in sys.modules if m.split(".")[0] in optional}
    if loaded - loaded_before:
        fail(f"the data path imported {sorted(loaded - loaded_before)}")

    for k in launches:
        launches[k] += ingest_launches[k]
    tokens_per_row = S
    result.update(
        direct_rows_per_s=[DATA_ROWS / t["direct_s"] for t in turns],
        data_rows_per_s=[DATA_ROWS / t["data_s"] for t in turns],
        direct_tokens_per_s=[DATA_ROWS * tokens_per_row / t["direct_s"]
                             for t in turns],
        data_tokens_per_s=[DATA_ROWS * tokens_per_row / t["data_s"]
                           for t in turns],
        data_over_direct=[t["data_s"] / t["direct_s"] for t in turns],
        actor_ctor_s=[t["actor_ctor_s"] for t in turns],
        score_device_ms=score_device_ms, score_call_ms=score_call_ms,
        ce_fwd_at_path=ce_check,
        first_batch_worst_gap=float(gaps.max()), first_batch_nll_err=nll_err,
        ingest_rows=INGEST_ROWS, ingest_batch=INGEST_BATCH,
        ingest_ms_per_batch_prefetch=ms["prefetch"],
        ingest_ms_per_batch_sync_copy=ms["sync_copy"],
        ingest_first_loss=first_loss, ingest_last_loss=last_loss,
        launches_per_pass=turns[0]["launches"], launches=launches)
    print("data_batch " + json.dumps(result), flush=True)
    return result


FIT_ROWS = 512
# (b) streams the rows in blocks of one rank's batch: a rank claims up to
# its task cap (8) and shuffle window (16) of blocks before it learns their
# size, so 8 blocks all went to the first rank to ask.
FIT_INGEST_BLOCKS = 64
FIT_BATCH = 16  # the global batch of (a) and of direct; 8 per rank
FIT_STEPS = 5
# (a)'s fit against direct, in one round (a second repeated it for its
# spread; cut so that the script's time limit holds train_mesh's (c), (d)).
FIT_ROUNDS = 1
RESTORE_STEPS = 8
RESTORE_FAIL_AT = 4  # raise before step 5 of the first attempt
RESTORE_CKPT_EVERY = 2
# Two ranks at B=8 against one loop at B=16 (and a resumed run against an
# uninterrupted one): the same arithmetic in bf16, the batch's rows summed
# in other groupings and the mean gradient formed after the all-reduce.
FIT_LOSS_ATOL = 1e-2
# (e): the median async save may block the step for at most this share of
# (c)'s median sync save (the reference's acceptance bound,
# tests/test_checkpoint_subsystem.py:537-550).
ASYNC_BLOCK_RATIO = 0.25


def _fit_config(**kw):
    """The Train-API loop's config on the card (``examples/train_gpt2``):
    GPT-2 124M from seed 0, ``loss_impl="fused"``,
    ``remat_policy="attn_outside"``, AdamW 3e-4, diagnostics on."""
    return dict(seed=0, lr=3e-4, diagnostics=True, **kw)


def _fit_buckets(trainer) -> Dict[str, object]:
    """Each rank's StepProfiler attribution in ms per step, over steps 2 on
    (the first holds the loop's start-up), and the first step's apart."""
    out = {}
    for s in trainer.sessions:
        hist = list(s.profiler.history)
        row = {"steps": len(hist)}
        for label, rows in (("per_step", hist[1:]), ("first", hist[:1])):
            n = max(1, len(rows))
            row[label] = {b: 1e3 * sum(r[b] for r in rows) / n
                          for b in ("wall", "compute", "data_wait", "h2d",
                                    "collective", "ckpt_block")}
        out[f"rank{s.context.world_rank}"] = row
    return out


def _gone(label: str, pg_table) -> None:
    """After a fit: no placement group left and the card free again."""
    import ray_tpu_torch

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if not pg_table() and ray_tpu_torch.available_resources().get(
                "GPU") == 1.0:
            return
        time.sleep(0.05)
    fail(f"{label}: placement groups {pg_table()} or the card not back "
         f"({ray_tpu_torch.available_resources()})")


def _overlap_ms(marks, windows):
    """Step ms from a probe's marks, split by whether a persist window
    overlaps the step. ``marks``: (step, start, end) ``time.time()``."""
    over, clear = [], []
    for _, t0, t1 in marks:
        hit = any(a < t1 and t0 < b for a, b in windows)
        (over if hit else clear).append(1e3 * (t1 - t0))
    return over, clear


def _flat_state(state):
    """params, mu and nu of a training state, each part's leaves by sorted
    name (a restored dict's keys come back sorted, as JAX orders them)."""
    from ray_tpu_torch.optim import tree_leaves

    out = []
    for part in (state["params"], state["opt_state"]["mu"],
                 state["opt_state"]["nu"]):
        names = list(_leaf_names(part))
        out += [t for _, t in sorted(zip(names, tree_leaves(part)),
                                     key=lambda x: x[0])]
    return out


def _ckpt_restores(source):
    from ray_tpu_torch.checkpoint import metrics as ckpt_metrics

    return sum(v for _, tags, v in ckpt_metrics.RESTORES.samples()
               if tags.get("source") == source)


def _commit_stats():
    """(commits, their seconds) so far."""
    from ray_tpu_torch.checkpoint import metrics as ckpt_metrics

    got = {name: v for name, _, v in ckpt_metrics.COMMIT_SECONDS.samples()}
    return got.get("_count", 0), got.get("_sum", 0.0)


def _async_fit(label, storage, batch, want_counts, add_launches, fail_at,
               workers=1, steps=RESTORE_STEPS, keep=(), batch_size=FIT_BATCH,
               drain=False):
    """One ``CudaTrainer.fit()`` of (e) with ``async_save=True`` and a save
    every ``RESTORE_CKPT_EVERY`` steps; exact launches. ``drain``: rank 0
    waits for its writer's earlier persists before each save, so that the
    save's block is the snapshot alone (the reference's envelope saves
    with no step between, into memory without bound). Returns what the
    probe saw: losses, states at the steps in ``keep``, save handles, step
    marks, the restore."""
    import os
    import warnings

    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )
    from ray_tpu_torch.train.session import get_session
    from ray_tpu_torch.util.placement_group import placement_group_table

    seen = {"loss": {}, "states": {}, "handles": [], "marks": [],
            "restore": None, "last": None}

    def probe(event, rank, step, **info):
        now = time.time()
        if event == "step" and rank == 0:
            seen["loss"][step] = info["loss"]
            if seen["last"] is not None:
                seen["marks"].append((step, seen["last"], now))
        if event == "checkpoint" and rank == 0:
            if step in keep:
                seen["states"][step] = [t.detach().to("cpu", copy=True)
                                        for t in _flat_state(info["state"])]
            if drain:
                get_session().shard_writer.drain(timeout=600)
        if event == "saved" and rank == 0:
            seen["handles"].append((step, get_session().last_save_handle))
        if event == "restore" and rank == 0:
            seen["restore"] = (step, info["seconds"],
                               [t.detach().to("cpu", copy=True)
                                for t in _flat_state(info["state"])])
        if rank == 0 and event in ("step", "saved", "restore"):
            seen["last"] = time.time()

    trainer = CudaTrainer(
        train_gpt2.train_loop_per_worker,
        train_loop_config=_fit_config(
            steps=steps, batch_size=batch_size, tokens=batch,
            ckpt_every=RESTORE_CKPT_EVERY, fail_at_step=fail_at,
            async_save=True, probe=probe),
        scaling_config=ScalingConfig(
            num_workers=workers, gpus_per_worker=1.0 / workers),
        run_config=RunConfig(
            name=label, storage_path=storage,
            checkpoint_config=CheckpointConfig(num_to_keep=2,
                                               async_save=True),
            failure_config=FailureConfig(max_failures=1)))
    _reset_counts()
    memory0, commits0 = _ckpt_restores("memory"), _commit_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # ranks share
        res = trainer.fit()
    counts = _counts()
    commits1 = _commit_stats()
    if res.error is not None:
        fail(f"{label}: fit failed: {res.error!r}")
    _gone(label, placement_group_table)
    forwards = workers * len(res.metrics_history)  # rank 0's reports
    if counts != want_counts(forwards):
        fail(f"{label}: launches {counts}, want {want_counts(forwards)}")
    add_launches(counts)
    seen["res"] = res
    seen["memory_restores"] = _ckpt_restores("memory") - memory0
    seen["commits"] = commits1[0] - commits0[0]
    seen["commit_ms"] = (1e3 * (commits1[1] - commits0[1])
                         / max(1, seen["commits"]))
    seen["root"] = os.path.join(storage, label, "checkpoints", "sharded")
    return seen


def _saves(seen):
    """Each save's block, its wait for a free buffer, persist and bytes; a
    save queued when its attempt failed is aborted (``abort``: the error's
    name)."""
    out = []
    for step, h in seen["handles"]:
        exc = h.exception(timeout=600)
        a, b = h.persist_window
        out.append(dict(step=step, block_ms=1e3 * h.block_seconds,
                        wait_ms=1e3 * h.wait_seconds, persist_s=b - a,
                        bytes=None if exc else h.result()["bytes"],
                        abort=type(exc).__name__ if exc else None))
    return out


def _fit_async(storage, batch, want_counts, add_launches, broken, drained,
               cadence, sync_save_ms, want_late) -> Dict[str, object]:
    """(e) Async sharded checkpoints from the card, from three fits run in
    turns with (c)'s: ``broken`` fails before step 5 and restores from the
    memory replicas; ``drained`` runs uninterrupted, its yardstick, and
    waits for the persists before each save; ``cadence`` runs
    uninterrupted at the same cadence without waiting, and measures the
    saves' waits for a free buffer and the steps beside persists. Then
    two thread ranks write one step in two shards, restored at world size
    1. The gate holds ``drained``'s median block to ``ASYNC_BLOCK_RATIO``
    of (c)'s median sync save, in the same call."""
    import os

    import torch

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.train import Checkpoint

    flat = _flat_state
    res = broken["res"]
    committed = ckpt.list_committed_steps(broken["root"])
    rst = res.restarts[0].get("restore") if res.restarts else None
    r_step, r_seconds, r_state = broken["restore"] or (None, None, None)
    saved = broken["states"].get(r_step)
    restored_equal = saved is not None and r_state is not None and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(r_state, saved))
    got = {m["step"]: m["loss"] for m in res.metrics_history}
    ref = {m["step"]: m["loss"] for m in drained["res"].metrics_history}
    late = sorted(want_late)
    late_err = max(abs(got[s] - ref[s]) for s in late)
    # The final committed dir, restored on the CPU, against the card's
    # state at the last save (captured by the probe).
    final = Checkpoint(os.path.join(broken["root"],
                                    ckpt.layout.step_dirname(committed[-1])))
    t0 = time.perf_counter()
    on_cpu = final.to_pytree()
    disk_cpu_ms = 1e3 * (time.perf_counter() - t0)
    final_equal = int(on_cpu["step"]) == RESTORE_STEPS and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(flat(on_cpu), broken["states"][RESTORE_STEPS]))
    del on_cpu
    # The same dir restored onto the card.
    t0 = time.perf_counter()
    onto = ckpt.restore_pytree(final.path, device="cuda")
    torch.cuda.synchronize()
    disk_card_ms = 1e3 * (time.perf_counter() - t0)
    card_equal = all(a.is_cuda and a.dtype == b.dtype and torch.equal(
        a.cpu(), b) for a, b in zip(flat(onto),
                                    broken["states"][RESTORE_STEPS]))
    del onto
    if len(res.restarts) != 1 or rst is None or rst["source"] != "memory" \
            or broken["memory_restores"] != 1 or not restored_equal or \
            r_step not in (2, RESTORE_FAIL_AT) or \
            late_err > FIT_LOSS_ATOL or len(committed) != 2 or \
            not final_equal or not card_equal:
        fail(f"async restore: restarts {res.restarts}, memory restores "
             f"{broken['memory_restores']}, restored step {r_step} equal "
             f"{restored_equal}, late losses {[got[s] for s in late]} vs "
             f"{[ref[s] for s in late]}, committed {committed}, final dir "
             f"equal on the CPU {final_equal}, on the card {card_equal}")

    b_saves, d_saves, c_saves = _saves(broken), _saves(drained), \
        _saves(cadence)
    blocks = [x["block_ms"] for x in d_saves]
    ratio = statistics.median(blocks) / statistics.median(sync_save_ms)
    c_blocks = [x["block_ms"] for x in c_saves]
    windows = [h.persist_window for _, h in cadence["handles"]]
    over, clear = _overlap_ms(cadence["marks"], windows)

    # Two thread ranks, one save: two shards, restored at world size 1.
    two = _async_fit("fit_async_two", storage, batch, want_counts,
                     add_launches, None, workers=2, steps=RESTORE_CKPT_EVERY,
                     keep=(RESTORE_CKPT_EVERY,), batch_size=FIT_BATCH // 2)
    (two_step,) = ckpt.list_committed_steps(two["root"])
    two_dir = os.path.join(two["root"], ckpt.layout.step_dirname(two_step))
    with open(os.path.join(two_dir, ckpt.layout.GLOBAL_MANIFEST)) as f:
        two_manifest = json.load(f)
    doc, _, _ = ckpt.layout.read_skeleton(two_dir)
    sharded = sum(m["partition"]["kind"] == "sharded" for m in doc["leaves"])
    t0 = time.perf_counter()
    at_one = ckpt.restore_pytree(two_dir, device="cuda")
    torch.cuda.synchronize()
    two_restore_ms = 1e3 * (time.perf_counter() - t0)
    two_equal = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for a, b in zip(flat(at_one),
                                    two["states"][RESTORE_CKPT_EVERY]))
    del at_one
    if two_manifest["num_shards"] != 2 or not sharded or not two_equal:
        fail(f"two shards: manifest {two_manifest['num_shards']} shards, "
             f"{sharded} sharded leaves, restored at world 1 equal "
             f"{two_equal}")
    out = dict(
        card=card_line(),
        blocks_ms=blocks, first_block_ms=blocks[0],
        later_blocks_ms=blocks[1:],
        sync_save_ms=sync_save_ms,
        median_block_over_sync=ratio, gate=ASYNC_BLOCK_RATIO,
        cadence=dict(
            every_steps=RESTORE_CKPT_EVERY, blocks_ms=c_blocks,
            buffer_wait_ms=[x["wait_ms"] for x in c_saves],
            snapshot_ms=[x["block_ms"] - x["wait_ms"] for x in c_saves],
            median_block_over_sync=(statistics.median(c_blocks)
                                    / statistics.median(sync_save_ms)),
            persist_s=[x["persist_s"] for x in c_saves],
            commit_ms=cadence["commit_ms"]),
        broken_run_blocks_ms=[x["block_ms"] for x in b_saves],
        persist_s=[x["persist_s"] for x in b_saves + d_saves
                   if not x["abort"]],
        aborted_saves=[(x["step"], x["abort"]) for x in b_saves
                       if x["abort"]],
        commit_ms=broken["commit_ms"], drained_commit_ms=drained["commit_ms"],
        bytes_per_shard=d_saves[0]["bytes"],
        two_rank_bytes_per_shard=[m["bytes"] for _, m in sorted(
            two_manifest["shards"].items())],
        restore_ms=dict(
            memory_fetch=1e3 * rst["seconds"],
            memory_to_card=1e3 * r_seconds,
            disk_to_cpu=disk_cpu_ms, disk_to_card=disk_card_ms,
            two_shards_to_card_at_world_1=two_restore_ms),
        restored_step=r_step, restored_state_bit_equal=restored_equal,
        late_max_abs_err=late_err,
        late_losses=[got[s] for s in late],
        uninterrupted_late_losses=[ref[s] for s in late],
        sync_run_late_losses=[want_late[s] for s in late],
        committed_kept=committed, final_dir_bit_equal=final_equal,
        steps_ms_beside_persist=over, steps_ms_clear=clear,
        two_shards=dict(num_shards=two_manifest["num_shards"],
                        sharded_leaves=sharded, leaves=len(doc["leaves"]),
                        restored_at_world_1_bit_equal=two_equal),
        resumed_s=res.restarts[0]["resumed_s"])
    print("train_fit_e " + json.dumps(out), flush=True)
    if not ratio <= ASYNC_BLOCK_RATIO:
        fail(f"async saves block {blocks} ms (median) against sync saves "
             f"{sync_save_ms} ms: ratio {ratio:.3f} > {ASYNC_BLOCK_RATIO}")
    return out


def phase_train_fit() -> Dict[str, object]:
    """GPT-2 124M trained through ``CudaTrainer.fit()`` on the card: (a) two
    thread ranks sharing it against the same steps without a trainer, (b)
    streaming ingest, (c) a failure and the restore, (d) one process rank
    on NCCL. Each gate fails the script."""
    import multiprocessing
    import os
    import tempfile
    import warnings

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )
    from ray_tpu_torch.util.placement_group import placement_group_table

    cfg = train_gpt2.model_config()
    S, L = cfg.seq_len, cfg.n_layer
    tokens = bi.token_windows(FIT_ROWS, S, 50257)  # default_rng(0)
    batch = tokens[:FIT_BATCH]
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_fit_")
    result: Dict[str, object] = {"card": card_line(), "batch": FIT_BATCH,
                                 "steps": FIT_STEPS, "seq_len": S}
    path_launches = {k: 0 for k in _counts()}

    def add_launches(counts):
        for k, v in counts.items():
            path_launches[k] += v

    def want_counts(forwards):
        """Launches of ``forwards`` training steps of one rank's batch."""
        want = {k: 0 for k in _counts()}
        want.update(splash_attention_fwd=L * forwards,
                    splash_attention_bwd=L * forwards, fused_ce_fwd=forwards,
                    fused_ce_dx=forwards, fused_ce_dw=forwards)
        return want

    # ------------------------------- direct: the same steps, no trainer
    def run_direct():
        params = gpt2.init_params(cfg, seed=0, device="cuda")
        optimizer = gpt2.make_optimizer(3e-4)
        opt_state = optimizer.init(params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tok = torch.as_tensor(batch, device="cuda")
        losses, ends, first_grads = [], [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FIT_STEPS):
            loss = gpt2.loss_fn(params, tok[:, :S], tok[:, 1:], cfg)
            grads = torch.autograd.grad(loss, leaves)
            if i == 0:
                first_grads = [g.clone() for g in grads]
            it = iter(grads)
            opt_state = optimizer.update(tree_map(lambda _: next(it), params),
                                         opt_state, params)
            losses.append(float(loss))
            ends.append(time.perf_counter())
        return dict(losses=losses, wall_s=ends[-1] - t0,
                    steps_s=ends[-1] - ends[0],
                    names=list(_leaf_names(params))), first_grads

    ray_tpu_torch.init()
    try:
        if ray_tpu_torch.available_resources().get("GPU") != 1.0:
            fail(f"the runtime registers {ray_tpu_torch.available_resources()}"
                 " (one card expected)")

        # --------------------- (a) two thread ranks sharing the card
        def run_one_rank(label):
            """One thread rank at B=16 through the trainer: what the fit
            costs without a second rank (tokens/s over steps 2-5)."""
            trainer = CudaTrainer(
                train_gpt2.train_loop_per_worker,
                train_loop_config=_fit_config(
                    steps=FIT_STEPS, batch_size=FIT_BATCH, tokens=batch),
                scaling_config=ScalingConfig(num_workers=1),
                run_config=RunConfig(name=label, storage_path=storage))
            _reset_counts()
            res = trainer.fit()
            counts = _counts()
            times = [m["time"] for m in res.metrics_history]
            if res.error is not None or counts != want_counts(FIT_STEPS):
                fail(f"{label}: error {res.error!r}, launches {counts}")
            _gone(label, placement_group_table)
            return counts, (FIT_STEPS - 1) * FIT_BATCH * S / (
                times[-1] - times[0]), _fit_buckets(trainer)

        def run_fit(label):
            seen = {"loss": {}, "grads": None, "own": None}

            def probe(event, rank, step, **info):
                if event != "step":
                    return
                seen["loss"][(rank, step)] = info["loss"]
                if step == 1 and rank == 0:
                    seen["grads"] = [g.detach().clone()
                                     for g in tree_leaves(info["grads"])]
                    seen["own"] = [g.detach().clone() for g in
                                   tree_leaves(info["local_grads"])]

            trainer = CudaTrainer(
                train_gpt2.train_loop_per_worker,
                train_loop_config=_fit_config(
                    steps=FIT_STEPS, batch_size=FIT_BATCH // 2, tokens=batch,
                    probe=probe),
                scaling_config=ScalingConfig(num_workers=2,
                                             gpus_per_worker=0.5),
                run_config=RunConfig(name=label, storage_path=storage))
            _reset_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = trainer.fit()
                wall = time.perf_counter() - t0
            counts = _counts()
            if res.error is not None:
                fail(f"{label}: fit failed: {res.error!r}")
            hist = res.metrics_history
            if [m["step"] for m in hist] != list(range(1, FIT_STEPS + 1)):
                fail(f"{label}: rank 0 reported {hist}")
            warned = [str(w.message) for w in caught
                      if issubclass(w.category, RuntimeWarning)
                      and "ranks share devices" in str(w.message)]
            last = hist[-1]
            if last["gpu_ids"] != [0] or last["device"] != "cuda:0" or \
                    not last["oversubscribed"] or not warned:
                fail(f"{label}: ranks on {last['gpu_ids']} {last['device']}, "
                     f"oversubscribed {last['oversubscribed']}, warnings "
                     f"{warned}")
            if counts != {k: 2 * v for k, v in want_counts(FIT_STEPS).items()}:
                fail(f"{label}: launches {counts}, want 2 ranks x "
                     f"{want_counts(FIT_STEPS)}")
            _gone(label, placement_group_table)
            return trainer, res, seen, counts, wall, [m["time"] for m in hist]

        turns = []
        for r in range(FIT_ROUNDS):
            direct, direct_grads = run_direct()
            trainer, res, seen, counts, wall, times = run_fit(f"fit_{r}")
            add_launches(counts)
            one_counts, one_tokens_per_s, one_buckets = run_one_rank(
                f"fit_one_{r}")
            add_launches(one_counts)
            losses = [(seen["loss"][(0, s)] + seen["loss"][(1, s)]) / 2
                      for s in range(1, FIT_STEPS + 1)]
            loss_err = max(abs(a - b) for a, b in zip(losses, direct["losses"]))
            grad_err = {n: rel_err(g, d) for n, g, d in zip(
                direct["names"], seen["grads"], direct_grads)}
            worst = max(grad_err, key=grad_err.get)
            # The control: rank 0's own B=8 gradient, as an all-reduce that
            # returned one rank's gradient would leave it, against direct's
            # B=16. The gate must be able to fail it.
            own_err = {n: rel_err(g, d) for n, g, d in zip(
                direct["names"], seen["own"], direct_grads)}
            own_worst = max(own_err, key=own_err.get)
            if loss_err > FIT_LOSS_ATOL or grad_err[worst] > GRAD_RTOL or \
                    not np.isfinite(losses).all():
                fail(f"fit round {r}: losses {losses} vs direct "
                     f"{direct['losses']} (tol {FIT_LOSS_ATOL}); step-1 "
                     f"gradient {worst} off by {grad_err[worst]} (tol "
                     f"{GRAD_RTOL})")
            if not own_err[own_worst] > GRAD_RTOL:
                fail(f"fit round {r}: rank 0's unreduced gradient is within "
                     f"{own_err[own_worst]} of direct's ({own_worst}): the "
                     f"gate (tol {GRAD_RTOL}) cannot tell a missing "
                     f"all-reduce")
            tokens_per_step = FIT_BATCH * S
            turns.append(dict(
                direct_losses=direct["losses"], fit_losses=losses,
                rank_losses={f"rank{k}": [seen["loss"][(k, s)] for s in
                                          range(1, FIT_STEPS + 1)]
                             for k in range(2)},
                loss_max_abs_err=loss_err, grad_rel_err_worst=grad_err[worst],
                grad_worst_leaf=worst, grad_rel_tol=GRAD_RTOL,
                control_unreduced_rel_err_worst=own_err[own_worst],
                control_worst_leaf=own_worst,
                control_unreduced_rel_err_least=min(own_err.values()),
                control_leaves_over_tol=sum(
                    e > GRAD_RTOL for e in own_err.values()),
                leaves=len(own_err),
                direct_tokens_per_s=(FIT_STEPS - 1) * tokens_per_step
                / direct["steps_s"],
                fit_tokens_per_s=(FIT_STEPS - 1) * tokens_per_step
                / (times[-1] - times[0]),
                one_rank_tokens_per_s=one_tokens_per_s,
                one_rank_buckets_ms=one_buckets,
                direct_wall_s=direct["wall_s"], fit_wall_s=wall,
                buckets_ms=_fit_buckets(trainer)))
            turns[-1]["fit_over_direct"] = (
                turns[-1]["direct_tokens_per_s"] / turns[-1]["fit_tokens_per_s"])
            del direct_grads, seen
            torch.cuda.empty_cache()
        result["a"] = dict(turns=turns, launches_per_fit=counts)
        print("train_fit_a " + json.dumps(result["a"]), flush=True)

        # ---------------------------------------- (b) streaming ingest
        ds = bi.token_dataset(tokens, FIT_INGEST_BLOCKS)
        b_losses, b_rows, b_steps = [], {0: 0, 1: 0}, {0: 0, 1: 0}

        def probe_b(event, rank, step, **info):
            if event == "step":
                b_losses.append(info["loss"])
                b_rows[rank] += info["rows"]
                b_steps[rank] += 1

        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=_fit_config(batch_size=FIT_BATCH // 2,
                                          probe=probe_b),
            scaling_config=ScalingConfig(num_workers=2, gpus_per_worker=0.5),
            run_config=RunConfig(name="fit_ingest", storage_path=storage),
            datasets={"train": ds})
        _reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # 2 ranks, 1 card
            res = trainer.fit()
        wall = time.perf_counter() - t0
        counts = _counts()
        add_launches(counts)
        audit = trainer.streaming_ingests["train"].audit(0)
        buckets = _fit_buckets(trainer)
        data_wait = sum(r["data_wait"] for s in trainer.sessions
                        for r in s.profiler.history)
        forwards = sum(b_steps.values())
        block_rows = FIT_ROWS // FIT_INGEST_BLOCKS
        if res.error is not None or audit["double_trained"] or \
                audit["untrained"] or sum(b_rows.values()) != FIT_ROWS or \
                sorted(audit["trained_counts"].values()) != \
                [1] * FIT_INGEST_BLOCKS or \
                min(b_rows.values()) < block_rows:
            fail(f"ingest fit: error {res.error!r}, audit {audit}, rows "
                 f"{b_rows} (each rank must train a block of {block_rows})")
        if not np.isfinite(b_losses).all() or not data_wait > 0:
            fail(f"ingest fit: losses {b_losses}, data_wait {buckets}")
        if counts != want_counts(forwards):
            fail(f"ingest fit: launches {counts}, want {want_counts(forwards)}")
        _gone("ingest fit", placement_group_table)
        result["b"] = dict(rows=b_rows, steps=b_steps,
                           blocks=FIT_INGEST_BLOCKS, wall_s=wall,
                           tokens_per_s=FIT_ROWS * S / wall,
                           first_loss=b_losses[0], last_loss=b_losses[-1],
                           audit=audit, buckets_ms=buckets, launches=counts)
        print("train_fit_b " + json.dumps(result["b"]), flush=True)

        # --------------------------------- (c) a failure and the restore
        def run_restore(label, fail_at):
            seen = {}

            def probe_c(event, rank, step, **info):
                if event == "restore" or (event == "checkpoint"
                                          and step == fail_at):
                    st = info["state"]
                    seen[event] = [t.detach().to("cpu", copy=True) for t in
                                   tree_leaves(st["params"])
                                   + tree_leaves(st["opt_state"]["mu"])
                                   + tree_leaves(st["opt_state"]["nu"])]
                    seen[event + "_step"] = step

            trainer = CudaTrainer(
                train_gpt2.train_loop_per_worker,
                train_loop_config=_fit_config(
                    steps=RESTORE_STEPS, batch_size=FIT_BATCH, tokens=batch,
                    ckpt_every=RESTORE_CKPT_EVERY, fail_at_step=fail_at,
                    probe=probe_c),
                scaling_config=ScalingConfig(num_workers=1),
                run_config=RunConfig(
                    name=label, storage_path=storage,
                    checkpoint_config=CheckpointConfig(num_to_keep=2),
                    failure_config=FailureConfig(max_failures=1)))
            _reset_counts()
            res = trainer.fit()
            counts = _counts()
            if res.error is not None:
                fail(f"{label}: fit failed: {res.error!r}")
            _gone(label, placement_group_table)
            return res, seen, counts

        # (c) and (e) in turns: sync failing, async failing, sync whole,
        # async whole (drained before each save), async whole at cadence.
        def async_fit(label, fail_at, **kw):
            return _async_fit(label, storage, batch, want_counts,
                              add_launches, fail_at, **kw)

        broken, seen, counts_c = run_restore("fit_restore", RESTORE_FAIL_AT)
        add_launches(counts_c)
        e_broken = async_fit("fit_async", RESTORE_FAIL_AT,
                             keep=(2, RESTORE_FAIL_AT, RESTORE_STEPS))
        whole, _, counts_w = run_restore("fit_whole", None)
        add_launches(counts_w)
        e_drained = async_fit("fit_async_whole", None, drain=True)
        e_cadence = async_fit("fit_async_cadence", None)
        got = {m["step"]: m["loss"] for m in broken.metrics_history}
        want = {m["step"]: m["loss"] for m in whole.metrics_history}
        late = range(RESTORE_FAIL_AT + 1, RESTORE_STEPS + 1)
        kept = sorted(os.listdir(os.path.dirname(broken.checkpoint.path)))
        bit_equal_state = (
            seen.get("restore_step") == RESTORE_FAIL_AT and
            len(seen["restore"]) == len(seen["checkpoint"]) and
            all(a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(seen["restore"], seen["checkpoint"])))
        saves = [m for m in broken.metrics_history if "save_ms" in m]
        whole_saves = [m for m in whole.metrics_history if "save_ms" in m]
        if len(broken.restarts) != 1 or not bit_equal_state or \
                max(abs(got[s] - want[s]) for s in late) > FIT_LOSS_ATOL or \
                len(kept) != 2:
            fail(f"restore: restarts {broken.restarts}, restored state equal "
                 f"{bit_equal_state}, losses {got} vs {want}, kept {kept}")
        if counts_c != want_counts(RESTORE_STEPS) or \
                counts_w != want_counts(RESTORE_STEPS):
            fail(f"restore: launches {counts_c}, {counts_w}, want "
                 f"{want_counts(RESTORE_STEPS)} each")
        result["c"] = dict(
            restarts=len(broken.restarts),
            resumed_s=broken.restarts[0]["resumed_s"],
            restored_step=seen["restore_step"],
            restored_state_bit_equal=bit_equal_state,
            late_losses=[got[s] for s in late],
            uninterrupted_late_losses=[want[s] for s in late],
            late_losses_bit_equal=all(got[s] == want[s] for s in late),
            late_max_abs_err=max(abs(got[s] - want[s]) for s in late),
            kept=kept, save_ms=[m["save_ms"] for m in saves],
            whole_save_ms=[m["save_ms"] for m in whole_saves],
            ckpt_bytes=saves[0]["ckpt_bytes"])
        print("train_fit_c " + json.dumps(result["c"]), flush=True)
        del seen
        torch.cuda.empty_cache()

        # ------------------------- (e) async checkpoints from the card
        result["e"] = _fit_async(
            storage, batch, want_counts, add_launches, e_broken, e_drained,
            e_cadence, [m["save_ms"] for m in saves + whole_saves],
            {s: want[s] for s in late})
        del e_broken, e_drained, e_cadence
        torch.cuda.empty_cache()

        # -------------------------------- (d) one process rank on NCCL
        baseline = _compute_apps()
        _reset_counts()
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=_fit_config(steps=FIT_STEPS,
                                          batch_size=FIT_BATCH, tokens=batch,
                                          ckpt_every=FIT_STEPS),
            scaling_config=ScalingConfig(num_workers=1,
                                         worker_mode="processes"),
            run_config=RunConfig(name="fit_process", storage_path=storage))
        t0 = time.time()
        res = trainer.fit()
        wall = time.time() - t0
        driver_counts = _counts()
        if res.error is not None:
            fail(f"process fit: {res.error!r}")
        hist = res.metrics_history
        last = hist[-1]
        pid = last["pid"]
        worker_counts = {k: last["launches"].get(k, 0) for k in driver_counts}
        add_launches(worker_counts)
        ckpt = res.checkpoint.to_pytree()
        want_losses = [want[s] for s in range(1, FIT_STEPS + 1)]
        d_err = max(abs(m["loss"] - w) for m, w in zip(hist, want_losses))
        deadline = time.monotonic() + 15.0
        while True:
            # active_children() reaps the killed worker, which would else
            # linger as a zombie that os.kill(pid, 0) still finds.
            alive = pid in [p.pid for p in multiprocessing.active_children()]
            apps = _compute_apps()
            if (not alive and apps == baseline) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        if pid == os.getpid() or last["backend"] != "nccl" or \
                last["device"] != "cuda:0" or last["gpu_ids"] != [0] or \
                last["collective_ops"] != {"allreduce": FIT_STEPS} or \
                trainer.process_topology[0]["backend"] != "nccl":
            fail(f"process fit: rank {last}, topology "
                 f"{trainer.process_topology}")
        if d_err > FIT_LOSS_ATOL or [m["step"] for m in hist] != \
                list(range(1, FIT_STEPS + 1)):
            fail(f"process fit: losses {[m['loss'] for m in hist]} vs one "
                 f"thread rank's {want_losses}")
        if worker_counts != want_counts(FIT_STEPS) or \
                any(driver_counts.values()):
            fail(f"process fit: worker launches {worker_counts} (want "
                 f"{want_counts(FIT_STEPS)}), driver {driver_counts}")
        if ckpt["step"] != FIT_STEPS or not all(
                torch.isfinite(t).all() for t in tree_leaves(ckpt["params"])):
            fail(f"process fit: the checkpoint by value holds step "
                 f"{ckpt['step']}")
        if alive or apps != baseline:
            fail(f"process fit: worker {pid} alive {alive}, compute apps "
                 f"{apps} (before {baseline})")
        _gone("process fit", placement_group_table)
        topo = trainer.process_topology[0]
        result["d"] = dict(
            pid=pid, backend=last["backend"], device=last["device"],
            collective_ops=last["collective_ops"],
            losses=[m["loss"] for m in hist], loss_max_abs_err=d_err,
            cold_start_s=hist[0]["time"] - t0, wall_s=wall,
            cold_start_split_s=dict(
                to_worker_main=topo["worker_main_at"] - t0,
                to_setup=topo["setup_at"] - topo["worker_main_at"],
                nccl_join=topo["joined_at"] - topo["setup_at"],
                to_first_report=hist[0]["time"] - topo["joined_at"]),
            # Steps 2-4: step 5's time holds its checkpoint's save.
            steps_per_s=(FIT_STEPS - 2) / (hist[-2]["time"] - hist[0]["time"]),
            worker_launches=worker_counts, checkpoint_step=ckpt["step"])
        print("train_fit_d " + json.dumps(result["d"]), flush=True)
        del ckpt
    finally:
        ray_tpu_torch.shutdown()
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
    torch.cuda.empty_cache()
    result["launches"] = path_launches
    print("train_fit " + json.dumps({
        k: result[k] for k in ("card", "launches")} | {
        "fit_over_direct": [t["fit_over_direct"] for t in result["a"]["turns"]],
        "restore_resumed_s": result["c"]["resumed_s"],
        "async_block_over_sync": result["e"]["median_block_over_sync"],
        "process_cold_start_s": result["d"]["cold_start_s"]}), flush=True)
    return result


TUNE_BATCH = 8  # rows a trial trains per step (two trials share the card)
ASHA_LRS = (1e-4, 3e-4, 1e-3, 1e-2)
ASHA_MAX_T = 8
TRAINER_LRS = (3e-4, 1e-3)
TRAINER_STEPS = 4
PBT_LRS = (1e-4, 1e-2)
PBT_STOP = 6
# After Tuner.fit() every trial's weights and moments must be freed: the
# card's allocated memory, read after a collection with PyTorch's cuBLAS
# workspaces cleared (each thread's handle keeps one, 32 MiB, for the life
# of the process), may exceed its value before the phase by this much.
TUNE_MEM_SLACK = 64 << 20


def _tune_model(cfg, dev, lr):
    """GPT-2 from seed 0 on ``dev``, its leaves taking gradients, and
    AdamW at ``lr`` (``examples/train_gpt2.py``'s optimizer)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves

    params = gpt2.init_params(cfg, seed=0, device=dev)
    optimizer = gpt2.make_optimizer(lr)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return params, leaves, optimizer, optimizer.init(params)


def _tune_step(cfg, params, leaves, optimizer, opt_state, tok):
    """One training step on a (B, S + 1) batch: (new state, loss)."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_map

    S = cfg.seq_len
    loss = gpt2.loss_fn(params, tok[:, :S], tok[:, 1:], cfg)
    it = iter(torch.autograd.grad(loss, leaves))
    opt_state = optimizer.update(tree_map(lambda _: next(it), params),
                                 opt_state, params)
    return opt_state, float(loss.detach())


def _tune_direct(cfg, tokens, batch, steps, lr):
    """The same steps without Tune: losses, and tokens/s over steps 2 on."""
    import torch

    dev = torch.device("cuda", 0)
    params, leaves, optimizer, opt_state = _tune_model(cfg, dev, lr)
    losses, ends = [], []
    for i in range(steps):
        tok = torch.as_tensor(tokens[i * batch:(i + 1) * batch], device=dev)
        opt_state, loss = _tune_step(cfg, params, leaves, optimizer,
                                     opt_state, tok)
        losses.append(loss)
        ends.append(time.perf_counter())
    return dict(losses=losses, tokens_per_s=(steps - 1) * batch
                * cfg.seq_len / (ends[-1] - ends[0]))


def _trial_actors_alive():
    from ray_tpu_torch._private.runtime import _ActorState, get_runtime

    return [s for s in list(get_runtime()._actors.values())
            if s.spec.cls.__name__ == "_TrainableActor"
            and s.state != _ActorState.DEAD]


def _tensor_bytes():
    """Allocated device bytes after a collection (earlier phases leave
    garbage), with and without PyTorch's cuBLAS workspaces (one per
    thread's cuBLAS handle and stream, kept after the thread ends)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    with_workspaces = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return with_workspaces, torch.cuda.memory_allocated()


def _tune_after(label, threads, mem_before):
    """After a Tuner.fit(): every trial's thread ended, no trial actor
    alive, the card back to its lease-free state and its memory back."""
    import ray_tpu_torch

    for t in threads:
        t.join(timeout=30)
    deadline = time.monotonic() + 10.0
    while _trial_actors_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    with_workspaces, mem = _tensor_bytes()
    alive = [t.name for t in threads if t.is_alive()]
    actors = len(_trial_actors_alive())
    gpu = ray_tpu_torch.available_resources().get("GPU")
    if alive or actors or gpu != 1.0 or \
            mem - mem_before > TUNE_MEM_SLACK:
        fail(f"{label}: trial threads alive {alive}, trial actors alive "
             f"{actors}, free GPU {gpu}, memory {mem} vs {mem_before} "
             f"before (slack {TUNE_MEM_SLACK})")
    return dict(memory_before=mem_before, memory_after=mem,
                memory_after_with_workspaces=with_workspaces)


def _scalar_rows(result):
    """The TensorBoard logger's rows of one trial: (tag, step) per scalar
    from its JSONL fallback (tensorboardX is not installed on the card's
    machine), else None."""
    import os

    path = os.path.join(result.path, f"{result.metrics['trial_id']}.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["tag"], r["step"]) for r in rows if r["type"] == "scalar"]


def phase_tune_fit() -> Dict[str, object]:
    """GPT-2 124M tuned through ``Tuner.fit()`` on the card: (a) ASHA over
    four function trials at half the card each, (b) a ``CudaTrainer``
    inside each of two trials, (c) PBT over two class trials with
    checkpoints. Each gate fails the script."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch._private.device import granted_cuda_device
    from ray_tpu_torch.air.integrations import TBXLoggerCallback
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.optim import tree_leaves
    from ray_tpu_torch.train import (
        CudaTrainer,
        RunConfig,
        ScalingConfig,
        load_pytree,
        save_pytree,
    )
    from ray_tpu_torch.tune.schedulers import (
        ASHAScheduler,
        PopulationBasedTraining,
    )
    from ray_tpu_torch.tune.trainable import wrap_function
    from ray_tpu_torch.util.placement_group import placement_group_table

    cfg = train_gpt2.model_config()
    S, L, B = cfg.seq_len, cfg.n_layer, TUNE_BATCH
    tokens = bi.token_windows(FIT_ROWS, S, 50257)  # train_fit's windows
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_fit_")
    result: Dict[str, object] = {"card": card_line(), "batch": B,
                                 "seq_len": S}
    path_launches = {k: 0 for k in _counts()}

    def want_counts(steps):
        want = {k: 0 for k in _counts()}
        want.update(splash_attention_fwd=L * steps,
                    splash_attention_bwd=L * steps, fused_ce_fwd=steps,
                    fused_ce_dx=steps, fused_ce_dw=steps)
        return want

    def launches_of(label, steps):
        counts = _counts()
        if counts != want_counts(steps):
            fail(f"{label}: launches {counts}, want {want_counts(steps)} "
                 f"for the {steps} steps the trials ran")
        for k, v in counts.items():
            path_launches[k] += v
        return counts

    mem_before = _tensor_bytes()[1]
    ray_tpu_torch.init()
    try:
        if ray_tpu_torch.available_resources().get("GPU") != 1.0:
            fail(f"the runtime registers {ray_tpu_torch.available_resources()}"
                 " (one card expected)")

        # --------------------------- (a) ASHA over four function trials
        runs: Dict[float, Dict[str, object]] = {}
        train_calls: Dict[str, list] = {}
        consumed: Dict[str, list] = {}

        def asha_trial(config):
            lr = config["lr"]
            dev = granted_cuda_device()
            torch.cuda.set_device(dev)
            run = runs[lr] = dict(started=time.time(), windows=[],
                                  losses=[], gpu_ids=ray_tpu_torch
                                  .get_gpu_ids(), device=str(dev),
                                  thread=threading.current_thread())
            params, leaves, optimizer, opt_state = _tune_model(cfg, dev, lr)
            for step in range(1, ASHA_MAX_T + 1):
                tok = torch.as_tensor(tokens[(step - 1) * B:step * B],
                                      device=dev)
                t0 = time.time()
                opt_state, loss = _tune_step(cfg, params, leaves, optimizer,
                                             opt_state, tok)
                run["windows"].append((t0, time.time()))
                run["losses"].append(loss)
                tune.report({"loss": loss, "step": step,
                             "reported_at": time.time()})

        class TimedTrial(wrap_function(asha_trial)):
            """Notes when the controller calls train()."""

            def train(self):
                train_calls.setdefault(self.trial_id, []).append(time.time())
                return super().train()

        class Consumed:
            def on_trial_result(self, trial, result):
                consumed.setdefault(trial.trial_id, []).append(
                    (time.time(), result.get("reported_at")))

        def direct_turns():
            return {b: _tune_direct(cfg, tokens, b, ASHA_MAX_T, 3e-4)
                    for b in (B, 2 * B)}

        turns = [direct_turns()]
        _reset_counts()
        t0 = time.perf_counter()
        grid = tune.Tuner(
            TimedTrial, param_space={"lr": tune.grid_search(list(ASHA_LRS))},
            # The Tuner's metric and mode are the scheduler's: it hands
            # them down (TuneConfig's default mode, "max", would win).
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=ASHAScheduler(metric="loss", mode="min",
                                        max_t=ASHA_MAX_T, grace_period=2,
                                        reduction_factor=2),
                trial_resources={"GPU": 0.5}),
            run_config=RunConfig(name="tune_asha", storage_path=storage,
                                 callbacks=[TBXLoggerCallback(), Consumed()])
        ).fit()
        fit_s = time.perf_counter() - t0
        threads = [r["thread"] for r in runs.values()]
        for t in threads:
            t.join(timeout=30)
        steps_run = {lr: len(r["losses"]) for lr, r in runs.items()}
        counts_a = launches_of("tune_fit_a", sum(steps_run.values()))
        after_a = _tune_after("tune_fit_a", threads, mem_before)
        turns.append(direct_turns())
        if grid.num_errors or sorted(runs) != sorted(ASHA_LRS):
            fail(f"tune_fit_a: errors {grid.errors}, trials ran {sorted(runs)}")
        by_lr = {r.metrics["config"]["lr"]: r for r in grid}
        stopped = {lr: max(m["training_iteration"] for m in
                           by_lr[lr].metrics_history) for lr in ASHA_LRS}
        direct_step1 = turns[0][B]["losses"][0]
        step1_err = max(abs(r["losses"][0] - direct_step1)
                        for r in runs.values())
        spans = sorted((r["windows"][0][0], r["windows"][-1][1])
                       for r in runs.values())
        overlap = any(a[1] > b[0] for a, b in zip(spans, spans[1:]))
        logs = {}
        for lr, r in by_lr.items():
            rows = _scalar_rows(r)
            logs[lr] = None if rows is None else dict(
                results=len(r.metrics_history),
                rows=sum(tag == "training_iteration" for tag, _ in rows),
                loss_rows=sum(tag == "loss" for tag, _ in rows),
                loss_results=sum("loss" in m for m in r.metrics_history))
        if any(r["gpu_ids"] != [0] or r["device"] != "cuda:0"
               for r in runs.values()):
            fail("tune_fit_a: trials on " + str(
                {lr: (r["gpu_ids"], r["device"]) for lr, r in runs.items()}))
        if not overlap:
            fail(f"tune_fit_a: no two trials' steps overlap: {spans}")
        if step1_err > FIT_LOSS_ATOL:
            fail(f"tune_fit_a: step-1 losses "
                 f"{[r['losses'][0] for r in runs.values()]} vs direct "
                 f"{direct_step1} (tol {FIT_LOSS_ATOL})")
        if not min(stopped.values()) < ASHA_MAX_T:
            fail(f"tune_fit_a: ASHA stopped no trial early: {stopped}")
        if any(v is None or v["rows"] != v["results"]
               or v["loss_rows"] != v["loss_results"] for v in logs.values()):
            fail(f"tune_fit_a: TensorBoard log rows vs results {logs}")
        per_trial = {}
        for lr, r in runs.items():
            ends = [w[1] for w in r["windows"]]
            tid = by_lr[lr].metrics["trial_id"]
            gaps = [c - t for t, c in zip(
                [t for t, _ in consumed.get(tid, [])],
                train_calls.get(tid, [])[1:])]
            per_trial[str(lr)] = dict(
                steps_run=steps_run[lr], stopped_at=stopped[lr],
                past_stop=steps_run[lr] - stopped[lr],
                losses=r["losses"],
                cold_start_s=r["windows"][0][1] - r["started"],
                tokens_per_s=(len(ends) - 1) * B * S / (ends[-1] - ends[0])
                if len(ends) > 1 else None,
                consumed_to_train_ms=[1e3 * g for g in gaps],
                report_to_consumed_ms=[1e3 * (c - rep) for c, rep in
                                       consumed.get(tid, []) if rep])
        # Two trials at once: the tokens both trained in the window they
        # were both stepping in (each step's share by its time inside),
        # over that window.
        first, second = (runs[lr] for lr in ASHA_LRS[:2])
        lo = max(first["windows"][0][0], second["windows"][0][0])
        hi = min(first["windows"][-1][1], second["windows"][-1][1])
        inside = sum(max(0.0, min(b, hi) - max(a, lo)) / (b - a)
                     for r in (first, second) for a, b in r["windows"])
        gaps = [g for v in per_trial.values()
                for g in v["consumed_to_train_ms"]]
        result["a"] = dict(
            trials=per_trial, fit_s=fit_s, step1_max_abs_err=step1_err,
            direct_step1_loss=direct_step1, logs={str(k): v for k, v in
                                                  logs.items()},
            concurrent_tokens_per_s=inside * B * S / (hi - lo)
            if hi > lo else None,
            direct_tokens_per_s={f"B={b}": [t[b]["tokens_per_s"]
                                            for t in turns]
                                 for b in (B, 2 * B)},
            consumed_to_train_ms_median=statistics.median(gaps)
            if gaps else None, launches=counts_a, **after_a)
        print("tune_fit_a " + json.dumps(result["a"]), flush=True)
        del grid, by_lr, runs
        torch.cuda.empty_cache()

        # --------------------- (b) a CudaTrainer inside each of two trials
        b_rows = tokens[:TRAINER_STEPS * B]
        groups_seen: Dict[float, list] = {}
        b_threads = []

        def trainer_trial(config):
            lr = config["lr"]
            b_threads.append(threading.current_thread())
            seen = groups_seen[lr] = []

            def probe(event, rank, step, **info):
                if event == "step":
                    seen.append(len(placement_group_table()))

            res = CudaTrainer(
                train_gpt2.train_loop_per_worker,
                train_loop_config=dict(seed=0, lr=lr, diagnostics=True,
                                       steps=TRAINER_STEPS, batch_size=B,
                                       tokens=b_rows, probe=probe),
                scaling_config=ScalingConfig(num_workers=1,
                                             gpus_per_worker=0.5),
                run_config=RunConfig(name=f"tune_trainer_{lr}",
                                     storage_path=storage)).fit()
            if res.error is not None:
                raise res.error
            hist = res.metrics_history
            tune.report({"losses": [m["loss"] for m in hist],
                         "devices": sorted({m["device"] for m in hist}),
                         "gpu_ids": sorted({g for m in hist
                                            for g in m["gpu_ids"]})})

        direct_b = {lr: _tune_direct(cfg, b_rows, B, TRAINER_STEPS, lr)
                    for lr in TRAINER_LRS}
        _reset_counts()
        t0 = time.perf_counter()
        grid = tune.Tuner(
            trainer_trial,
            param_space={"lr": tune.grid_search(list(TRAINER_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        trial_resources={"CPU": 1}),
            run_config=RunConfig(name="tune_trainer", storage_path=storage)
        ).fit()
        fit_s = time.perf_counter() - t0
        counts_b = launches_of("tune_fit_b", len(TRAINER_LRS) * TRAINER_STEPS)
        _gone("tune_fit_b", placement_group_table)
        after_b = _tune_after("tune_fit_b", b_threads, mem_before)
        if grid.num_errors:
            fail(f"tune_fit_b: {grid.errors}")
        b_losses = {}
        for r in grid:
            got = [m for m in r.metrics_history if "losses" in m][0]
            lr = r.metrics["config"]["lr"]
            b_losses[lr] = got["losses"]
            if got["devices"] != ["cuda:0"] or got["gpu_ids"] != [0]:
                fail(f"tune_fit_b: the trainer of lr {lr} ran on {got}")
        b_err = max(abs(a - w) for lr in TRAINER_LRS for a, w in
                    zip(b_losses[lr], direct_b[lr]["losses"]))
        if sorted(b_losses) != sorted(TRAINER_LRS) or any(
                len(b_losses[lr]) != TRAINER_STEPS for lr in TRAINER_LRS) \
                or b_err > FIT_LOSS_ATOL:
            fail(f"tune_fit_b: losses {b_losses} vs direct "
                 f"{ {lr: d['losses'] for lr, d in direct_b.items()} } "
                 f"(tol {FIT_LOSS_ATOL})")
        if max(max(v) for v in groups_seen.values()) < 2:
            fail(f"tune_fit_b: the two trials' placement groups never "
                 f"existed at once: {groups_seen}")
        result["b"] = dict(
            losses={str(k): v for k, v in b_losses.items()},
            direct_losses={str(k): v["losses"] for k, v in direct_b.items()},
            loss_max_abs_err=b_err, fit_s=fit_s,
            groups_seen={str(k): v for k, v in groups_seen.items()},
            launches=counts_b, **after_b)
        print("tune_fit_b " + json.dumps(result["b"]), flush=True)
        del grid
        torch.cuda.empty_cache()

        # ------------------------- (c) PBT over two class trials
        saved: Dict[str, list] = {}
        c = dict(steps=0, saves_ms=[], restores=[], threads=[])

        class PBTTrial(tune.Trainable):
            """One GPT-2 step per train(); its params and moments saved
            with ``save_pytree`` and restored onto its own lease's card."""

            def setup(self, config):
                self.dev = granted_cuda_device()
                torch.cuda.set_device(self.dev)
                (self.params, self.leaves, self.optimizer,
                 self.opt_state) = _tune_model(cfg, self.dev, config["lr"])

            def step(self):
                i = self.iteration % (len(tokens) // B)
                tok = torch.as_tensor(tokens[i * B:(i + 1) * B],
                                      device=self.dev)
                self.opt_state, loss = _tune_step(
                    cfg, self.params, self.leaves, self.optimizer,
                    self.opt_state, tok)
                c["steps"] += 1
                return {"loss": loss, "lr": self.config["lr"],
                        "device": str(self.dev),
                        "gpu_ids": ray_tpu_torch.get_gpu_ids()}

            def _state(self):
                return {"params": self.params, "opt_state": self.opt_state}

            def save_checkpoint(self, checkpoint_dir):
                t0 = time.perf_counter()
                save_pytree(self._state(), os.path.join(checkpoint_dir,
                                                        "state"))
                c["saves_ms"].append(1e3 * (time.perf_counter() - t0))
                saved[checkpoint_dir] = [
                    t.detach().to("cpu", copy=True)
                    for t in _flat_state(self._state())]
                return None

            def load_checkpoint(self, data, checkpoint_dir):
                t0 = time.perf_counter()
                state = load_pytree(os.path.join(checkpoint_dir, "state"),
                                    self._state())
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                got = _flat_state(state)
                want = saved.get(checkpoint_dir, [])
                c["restores"].append(dict(ms=ms, bit_equal=len(got) == len(
                    want) and all(a.device == self.dev and a.dtype == b.dtype
                                  and torch.equal(a.cpu(), b)
                                  for a, b in zip(got, want)),
                    device=str(self.dev), leaves=len(got)))
                self.params, self.opt_state = state["params"], \
                    state["opt_state"]
                self.leaves = tree_leaves(self.params)
                for p in self.leaves:
                    p.requires_grad_(True)

            def cleanup(self):
                self.params = self.leaves = self.opt_state = None

        _reset_counts()
        t0 = time.perf_counter()
        grid = tune.Tuner(
            PBTTrial, param_space={"lr": tune.grid_search(list(PBT_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=PopulationBasedTraining(
                    metric="loss", mode="min", perturbation_interval=2,
                    hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3]},
                    seed=0),
                trial_resources={"GPU": 0.5}),
            run_config=RunConfig(name="tune_pbt", storage_path=storage,
                                 stop={"training_iteration": PBT_STOP})
        ).fit()
        fit_s = time.perf_counter() - t0
        counts_c = launches_of("tune_fit_c", c["steps"])
        after_c = _tune_after("tune_fit_c", [], mem_before)
        losses = {r.metrics["trial_id"]: [m["loss"] for m in
                                          r.metrics_history if "loss" in m]
                  for r in grid}
        if grid.num_errors or grid.num_terminated != len(PBT_LRS):
            fail(f"tune_fit_c: errors {grid.errors}, terminated "
                 f"{grid.num_terminated}")
        if not c["restores"] or not all(r["bit_equal"] and
                                        r["device"] == "cuda:0"
                                        for r in c["restores"]):
            fail(f"tune_fit_c: exploits restored {c['restores']} (one at "
                 "least, bit for bit on the clone's card)")
        if not all(np.isfinite(v).all() for v in losses.values()):
            fail(f"tune_fit_c: losses {losses}")
        result["c"] = dict(
            exploits=len(c["restores"]), steps=c["steps"], fit_s=fit_s,
            save_ms=c["saves_ms"], restore_ms=[r["ms"] for r in
                                               c["restores"]],
            restored_bit_equal=all(r["bit_equal"] for r in c["restores"]),
            final_configs=sorted(r.metrics["config"]["lr"] for r in grid),
            losses=list(losses.values()), launches=counts_c, **after_c)
        print("tune_fit_c " + json.dumps(result["c"]), flush=True)
        del grid, saved
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    torch.cuda.empty_cache()
    result["launches"] = path_launches
    print("tune_fit " + json.dumps({
        "card": result["card"], "launches": path_launches,
        "asha_stopped_early": sum(v["stopped_at"] < ASHA_MAX_T
                                  for v in result["a"]["trials"].values()),
        "steps_past_stop": {k: v["past_stop"] for k, v in
                            result["a"]["trials"].items()},
        "pbt_exploits": result["c"]["exploits"]}), flush=True)
    return result


WF_BATCH = 8  # rows a scoring batch, a chunk's step and the job's step take
WF_POOL_BATCHES = 8
WF_CHUNKS = 3
WF_CHUNK_STEPS = 2
WF_FAIL_CHUNK = 1  # the chunk that raises on its first attempt
WF_LR = 3e-4
WF_LOSS_ATOL = 1e-3
JOB_STEPS = 3
JOB_GRACE_S = 3.0
# A stopped job's process must give the card its memory back: the free
# memory nvidia's driver reports may differ from its value before the job
# by this much.
JOB_MEM_SLACK = 256 << 20


def _wf_device():
    import torch

    from ray_tpu_torch._private.device import granted_cuda_device

    dev = granted_cuda_device()
    torch.cuda.set_device(dev)
    return dev


def _wf_init(out):
    """The workflow's first step: GPT-2 from seed 0 and AdamW's state on the
    step's card, saved with ``save_pytree``; returns the path."""
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import save_pytree

    cfg = train_gpt2.model_config()
    params = gpt2.init_params(cfg, seed=0, device=_wf_device())
    save_pytree({"params": params,
                 "opt_state": gpt2.make_optimizer(WF_LR).init(params),
                 "step": 0}, out)
    return out


def _wf_chunk(prev, index, out, fail_marker):
    """One chunk of the workflow: load ``{params, opt_state, step}`` from
    the path its upstream returned onto the step's card, train
    ``WF_CHUNK_STEPS`` steps at B=``WF_BATCH`` on its rows of the token
    windows, save; returns ``(path, losses)``. Its load, steps and save
    times go to ``<out>.times.json``, beside the state it saved.
    Raises once, before touching the card, while ``fail_marker`` exists."""
    import os

    import torch

    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.train import load_pytree, save_pytree

    if os.path.exists(fail_marker):
        os.remove(fail_marker)
        raise RuntimeError(f"chunk {index}: failure injected")
    dev = _wf_device()
    cfg = train_gpt2.model_config()

    t0 = time.perf_counter()
    params, _, optimizer, opt_state = _tune_model(cfg, dev, WF_LR)
    state = load_pytree(prev if isinstance(prev, str) else prev[0],
                        {"params": params, "opt_state": opt_state,
                         "step": 0})
    params, opt_state = state["params"], state["opt_state"]
    leaves = _wf_leaves(params)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    tokens = bi.token_windows(WF_CHUNKS * WF_CHUNK_STEPS * WF_BATCH,
                              cfg.seq_len, min(cfg.vocab_size, 50257))
    losses = []
    for j in range(WF_CHUNK_STEPS):
        i = index * WF_CHUNK_STEPS + j
        tok = torch.as_tensor(tokens[i * WF_BATCH:(i + 1) * WF_BATCH],
                              device=dev)
        opt_state, loss = _tune_step(cfg, params, leaves, optimizer,
                                     opt_state, tok)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    save_pytree({"params": params, "opt_state": opt_state,
                 "step": int(state["step"]) + WF_CHUNK_STEPS}, out)
    t3 = time.perf_counter()
    with open(out + ".times.json", "w") as f:
        json.dump({"load_s": t1 - t0, "steps_s": t2 - t1,
                   "save_s": t3 - t2}, f)
    return out, losses


def _wf_leaves(params):
    from ray_tpu_torch.optim import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _wf_direct(cfg, dev, tokens_per_step):
    """The same steps in one loop on ``dev``, no workflow: the losses."""
    import torch

    params, leaves, optimizer, opt_state = _tune_model(cfg, dev, WF_LR)
    losses = []
    for rows in tokens_per_step:
        tok = torch.as_tensor(rows, device=dev)
        opt_state, loss = _tune_step(cfg, params, leaves, optimizer,
                                     opt_state, tok)
        losses.append(loss)
    return losses


def _wf_collect():
    """Frees what a part left (the card's cached blocks too)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _job_losses(logs):
    """The example's per-step log lines: {step: loss}."""
    import re

    return {int(s): float(x) for s, x in re.findall(
        r"^train_gpt2 step (\d+) loss ([0-9.eE+-]+)$", logs, re.M)}


def phase_workflow_fit() -> Dict[str, object]:
    """The small libraries on the card with GPT-2 124M (``workflow_fit``
    lines): (a) an ``ActorPool`` of two scorers at half the card each,
    (b) a durable workflow of training chunks that fails and is resumed
    without rerunning its finished chunk, (c) the training example as a
    job that succeeds and one that is stopped, (d) all of it through the
    state API, in the library and over HTTP. Each gate fails the script."""
    import os
    import re
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.metrics_agent import MetricsAgent
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.job import JobStatus, job_manager
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.placement_group import placement_group_table
    from ray_tpu_torch.workflow import api as wf_api

    dev = torch.device("cuda", 0)
    cfg = train_gpt2.model_config()
    S, L, B = cfg.seq_len, cfg.n_layer, WF_BATCH
    vocab = min(cfg.vocab_size, 50257)
    storage = tempfile.mkdtemp(prefix="chip_smoke_workflow_fit_")
    result: Dict[str, object] = {"card": card_line(), "batch": B,
                                 "seq_len": S}
    path_launches = {k: 0 for k in _counts()}

    def want_counts(fwd_layers, steps, ce_fwd):
        want = {k: 0 for k in _counts()}
        want.update(splash_attention_fwd=fwd_layers,
                    splash_attention_bwd=L * steps, fused_ce_fwd=ce_fwd,
                    fused_ce_dx=steps, fused_ce_dw=steps)
        return want

    def launches_of(label, want):
        counts = _counts()
        if counts != want:
            fail(f"{label}: launches {counts}, want {want}")
        for k, v in counts.items():
            path_launches[k] += v
        return counts

    threads_before = set(threading.enumerate())
    ray_tpu_torch.init()
    try:
        if ray_tpu_torch.available_resources().get("GPU") != 1.0:
            fail(f"the runtime registers {ray_tpu_torch.available_resources()}"
                 " (one card expected)")
        agent = MetricsAgent(get_runtime(), port=0)

        # --------------------------------------------- (a) an ActorPool
        tokens = bi.token_windows(WF_POOL_BATCHES * B, S, vocab)
        batches = [tokens[i * B:(i + 1) * B] for i in range(WF_POOL_BATCHES)]
        direct = bi.GPT2Scorer(cfg, seed=0, device=dev)
        direct.score(batches[0])  # warm-up: cuBLAS handles, allocator
        t0 = time.perf_counter()
        want = [direct.score(b) for b in batches]
        direct_s = time.perf_counter() - t0
        Scorer = ray_tpu_torch.remote(num_gpus=0.5)(bi.GPT2Scorer)
        scorers = [Scorer.remote(cfg, 0) for _ in range(2)]
        pool = ActorPool(scorers)
        _reset_counts()
        t0 = time.perf_counter()
        got = list(pool.map(lambda a, b: a.score.remote(b), batches))
        pool_s = time.perf_counter() - t0
        counts_map = launches_of("workflow_fit_a map", want_counts(
            L * WF_POOL_BATCHES, 0, WF_POOL_BATCHES))
        _reset_counts()
        unordered = list(pool.map_unordered(
            lambda a, b: a.score.remote(b), batches))
        launches_of("workflow_fit_a map_unordered", want_counts(
            L * WF_POOL_BATCHES, 0, WF_POOL_BATCHES))

        def same(x, y):
            return all(x[k].dtype == y[k].dtype and
                       x[k].tobytes() == y[k].tobytes() for k in x)

        in_order = len(got) == len(want) and all(
            same(g, w) for g, w in zip(got, want))
        key = [(w["next_token"].tobytes(), w["nll"].tobytes()) for w in want]
        multiset = sorted(key) == sorted(
            (u["next_token"].tobytes(), u["nll"].tobytes())
            for u in unordered)
        if not in_order or not multiset:
            fail(f"workflow_fit_a: pool results in order and bit for bit "
                 f"{in_order}, map_unordered's multiset {multiset}")
        rows = state.list_actors(
            filters=[("class_name", "=", "GPT2Scorer")])
        alive = sorted(r["state"] for r in rows)
        for a in scorers:
            ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            dead = sorted(r["state"] for r in state.list_actors(
                filters=[("class_name", "=", "GPT2Scorer")]))
            if dead == ["DEAD", "DEAD"]:
                break
            time.sleep(0.05)
        if alive != ["ALIVE", "ALIVE"] or dead != ["DEAD", "DEAD"]:
            fail(f"workflow_fit_a: scorer rows {alive} while the pool ran, "
                 f"{dead} after kill")
        result["a"] = dict(
            batches=WF_POOL_BATCHES, in_order_bit_equal=in_order,
            unordered_same_multiset=multiset,
            pool_batches_per_s=WF_POOL_BATCHES / pool_s,
            direct_batches_per_s=WF_POOL_BATCHES / direct_s,
            pool_over_direct=direct_s / pool_s, launches=counts_map,
            actor_states=[alive, dead])
        print("workflow_fit_a " + json.dumps(result["a"]), flush=True)
        del direct, scorers, pool, got, unordered
        _wf_collect()

        # ------------------------------------ (b) a durable workflow
        workflow.init_storage(os.path.join(storage, "workflows"))
        states = os.path.join(storage, "states")
        os.makedirs(states)
        marker = os.path.join(storage, f"fail-chunk-{WF_FAIL_CHUNK}")
        node = ray_tpu_torch.remote(num_gpus=1)(_wf_init).options(
            name="wf_init").bind(os.path.join(states, "state-0"))
        for index in range(WF_CHUNKS):
            node = ray_tpu_torch.remote(num_gpus=1)(_wf_chunk).options(
                name=f"wf_chunk_{index}").bind(
                    node, index, os.path.join(states, f"state-{index + 1}"),
                    marker if index == WF_FAIL_CHUNK else "")
        dag = node
        step_writes = []
        atomic_write = wf_api._atomic_write

        def timed_write(path, data):
            t = time.perf_counter()
            atomic_write(path, data)
            if os.sep + "steps" + os.sep in path:
                step_writes.append(dict(path=os.path.basename(path),
                                        bytes=len(data),
                                        s=time.perf_counter() - t))

        wf_api._atomic_write = timed_write
        try:
            with open(marker, "w") as f:
                f.write("fail once")
            _reset_counts()
            t0 = time.perf_counter()
            try:
                workflow.run(dag, workflow_id="gpt2-chunks")
            except Exception as e:  # noqa: BLE001 — the injected failure
                run_error = repr(e)
            else:
                run_error = None
            run_s = time.perf_counter() - t0
            status_failed = workflow.get_status("gpt2-chunks")
            counts_run = launches_of("workflow_fit_b run", want_counts(
                L * WF_CHUNK_STEPS, WF_CHUNK_STEPS, WF_CHUNK_STEPS))
            if run_error is None or "failure injected" not in run_error or \
                    status_failed != workflow.WorkflowStatus.FAILED:
                fail(f"workflow_fit_b: the run gave {run_error}, status "
                     f"{status_failed}")
            _reset_counts()
            t0 = time.perf_counter()
            path, last = workflow.resume("gpt2-chunks")
            resume_s = time.perf_counter() - t0
            resumed = 2 * WF_CHUNK_STEPS  # chunks 1 and 2, not chunk 0
            counts_resume = launches_of("workflow_fit_b resume", want_counts(
                L * resumed, resumed, resumed))
        finally:
            wf_api._atomic_write = atomic_write
        status_ok = workflow.get_status("gpt2-chunks")
        output = workflow.get_output("gpt2-chunks")
        ids = wf_api._step_ids(dag)
        losses = []
        for n in dag._topo():
            with open(os.path.join(storage, "workflows", "gpt2-chunks",
                                   "steps", f"{ids[id(n)]}.pkl"), "rb") as f:
                value = serialization.loads(f.read())
            if isinstance(value, tuple):
                losses.extend(value[1])
        all_tokens = bi.token_windows(WF_CHUNKS * WF_CHUNK_STEPS * B, S,
                                      vocab)
        direct_losses = _wf_direct(cfg, dev, [
            all_tokens[i * B:(i + 1) * B]
            for i in range(WF_CHUNKS * WF_CHUNK_STEPS)])
        loss_err = max(abs(a - b) for a, b in zip(losses, direct_losses)) \
            if len(losses) == len(direct_losses) else float("inf")
        if status_ok != workflow.WorkflowStatus.SUCCESSFUL or \
                loss_err > WF_LOSS_ATOL or last != losses[-WF_CHUNK_STEPS:] \
                or output != (path, last) or not np.isfinite(losses).all():
            fail(f"workflow_fit_b: status {status_ok}, losses {losses} vs "
                 f"direct {direct_losses} (tol {WF_LOSS_ATOL}), output "
                 f"{output} vs {(path, last)}")
        chunk_times = []
        for index in range(WF_CHUNKS):
            with open(os.path.join(states, f"state-{index + 1}.times.json")
                      ) as f:
                chunk_times.append(json.load(f))
        result["b"] = dict(
            losses=losses, direct_losses=direct_losses,
            loss_max_abs_err=loss_err,
            bit_equal=losses == direct_losses, run_s=run_s,
            resume_s=resume_s, chunk_times=chunk_times,
            step_checkpoint_writes=step_writes,
            launches_run=counts_run, launches_resume=counts_resume,
            statuses=[status_failed, status_ok])
        print("workflow_fit_b " + json.dumps(result["b"]), flush=True)
        _wf_collect()

        # ------------------------------------------------------- (c) jobs
        jm = job_manager()
        here = os.path.dirname(os.path.abspath(__file__))
        env = {"env_vars": {"PYTHONPATH": here}}
        # B=8 rows a step: the example's default batch for one rank.
        example = (f"{sys.executable} -m ray_tpu_torch.examples.train_gpt2 "
                   "--workers 1")

        def first_step(job_id, timeout):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < timeout:
                if 1 in _job_losses(jm.get_job_logs(job_id)):
                    return
                if jm.get_job_status(job_id) in JobStatus.TERMINAL:
                    break
                time.sleep(0.05)
            fail(f"workflow_fit_c: job {job_id} logged no step: "
                 f"{jm.get_job_logs(job_id)[-3000:]}")

        t0 = time.perf_counter()
        ok_job = jm.submit_job(f"{example} --steps {JOB_STEPS}",
                               runtime_env=env)
        first_step(ok_job, 300)
        cold_start_s = time.perf_counter() - t0
        ok_status = jm.wait_job(ok_job, timeout=300)
        ok_s = time.perf_counter() - t0
        ok_logs = jm.get_job_logs(ok_job)
        job_losses = _job_losses(ok_logs)
        # The example's own clock around CudaTrainer.fit(): the rest of the
        # job is the interpreter, imports and init.
        fit_s = re.search(r" elapsed=([0-9.]+)s ", ok_logs)
        job_tokens = np.random.default_rng(0).integers(
            0, vocab, (B, S + 1), dtype=np.int64)  # the example's own
        job_direct = _wf_direct(cfg, dev, [job_tokens] * JOB_STEPS)
        job_err = max(abs(job_losses.get(i + 1, float("inf")) - want)
                      for i, want in enumerate(job_direct))
        if ok_status != JobStatus.SUCCEEDED or \
                sorted(job_losses) != list(range(1, JOB_STEPS + 1)) or \
                job_err > WF_LOSS_ATOL:
            fail(f"workflow_fit_c: job {ok_status}, logged losses "
                 f"{job_losses} vs direct {job_direct} (tol {WF_LOSS_ATOL})"
                 f": {jm.get_job_logs(ok_job)[-3000:]}")
        _wf_collect()
        free_before = torch.cuda.mem_get_info(0)[0]
        t0 = time.perf_counter()
        long_job = jm.submit_job(f"{example} --steps 100000",
                                 runtime_env=env)
        first_step(long_job, 300)
        long_cold_s = time.perf_counter() - t0
        free_running = torch.cuda.mem_get_info(0)[0]
        t0 = time.perf_counter()
        jm.stop_job(long_job, grace_s=JOB_GRACE_S)
        stop_status = jm.wait_job(long_job, timeout=JOB_GRACE_S + 5)
        stop_s = time.perf_counter() - t0
        free_after, back_s = None, None
        while time.perf_counter() - t0 < JOB_GRACE_S + 5:
            free_after = torch.cuda.mem_get_info(0)[0]
            if abs(free_after - free_before) <= JOB_MEM_SLACK:
                back_s = time.perf_counter() - t0
                break
            time.sleep(0.05)
        if stop_status != JobStatus.STOPPED or \
                stop_s > JOB_GRACE_S + 5 or back_s is None:
            fail(f"workflow_fit_c: the stopped job is {stop_status} after "
                 f"{stop_s:.2f} s; free memory {free_after} vs "
                 f"{free_before} before (slack {JOB_MEM_SLACK})")
        result["c"] = dict(
            entrypoint=example, job_losses=[job_losses[i + 1] for i in
                                            range(JOB_STEPS)],
            direct_losses=job_direct, loss_max_abs_err=job_err,
            cold_start_s=cold_start_s, job_s=ok_s,
            job_fit_s=float(fit_s.group(1)) if fit_s else None,
            stopped_cold_start_s=long_cold_s,
            stop_s=stop_s, memory_back_s=back_s, free_before=free_before,
            free_running=free_running, free_after=free_after,
            statuses=[ok_status, stop_status])
        print("workflow_fit_c " + json.dumps(result["c"]), flush=True)

        # ---------------------------------------------------- (d) state
        summary = state.summarize_tasks()["by_func"]
        chunk_rows = {name: summary.get(name, {}) for name in
                      ["wf_init"] + [f"wf_chunk_{i}"
                                     for i in range(WF_CHUNKS)]}
        # The failed chunk's attempts, and the chunk after it, which failed
        # on its upstream's error in the run and finished in the resume.
        if chunk_rows != {"wf_init": {"FINISHED": 1},
                          "wf_chunk_0": {"FINISHED": 1},
                          "wf_chunk_1": {"FAILED": 1, "FINISHED": 1},
                          "wf_chunk_2": {"FAILED": 1, "FINISHED": 1}}:
            fail(f"workflow_fit_d: task summary {chunk_rows}")

        def fetch(route):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{agent.port}{route}",
                    timeout=30) as resp:
                return json.loads(resp.read())

        def plain(rows):
            return json.loads(json.dumps(rows, default=str))

        over_http = {route: fetch(route) for route in
                     ("/api/tasks", "/api/actors", "/api/jobs")}
        library = {
            "/api/tasks": plain(state.list_tasks()),
            "/api/actors": plain(state.list_actors()),
            "/api/jobs": plain([dict(job_id=j.job_id, status=j.status,
                                     entrypoint=j.entrypoint,
                                     log_path=j.log_path)
                                for j in jm.list_jobs()])}
        equal = {route: over_http[route] == library[route]
                 for route in over_http}
        if not all(equal.values()) or len(over_http["/api/jobs"]) != 2:
            fail(f"workflow_fit_d: HTTP rows equal to the library's: {equal}"
                 f"; jobs {over_http['/api/jobs']}")
        agent.stop()
        left = dict(actors=[r for r in state.list_actors()
                            if r["state"] != "DEAD"],
                    placement_groups=placement_group_table())
        if left["actors"] or left["placement_groups"]:
            fail(f"workflow_fit_d: left alive {left}")
        result["d"] = dict(task_summary=chunk_rows, http_equal=equal,
                           rows={k: len(v) for k, v in over_http.items()})
    finally:
        ray_tpu_torch.shutdown()

    # The workflow's output after a restart of the runtime.
    ray_tpu_torch.init()
    try:
        after_restart = workflow.get_output("gpt2-chunks")
    finally:
        ray_tpu_torch.shutdown()
    shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        new = [t.name for t in threading.enumerate()
               if t not in threads_before and t.is_alive()]
        if not new:
            break
        time.sleep(0.05)
    if new or after_restart != output:
        fail(f"workflow_fit: threads left {new}; output after a restart "
             f"{after_restart} vs {output}")
    result["d"]["threads_left"] = new
    print("workflow_fit_d " + json.dumps(result["d"]), flush=True)
    torch.cuda.empty_cache()
    result["launches"] = path_launches
    print("workflow_fit " + json.dumps({
        "card": result["card"], "launches": path_launches,
        "output_after_restart_equal": True,
        "chunk_s": [sum(t.values()) for t in result["b"]["chunk_times"]],
        "job_cold_start_s": result["c"]["cold_start_s"]}), flush=True)
    return result


ELASTIC_ROWS = 200  # windows of 1025 ids: 25 claims of 8 rows
ELASTIC_BATCH = 8  # rows a rank claims a step
ELASTIC_CKPT_EVERY = 3  # an async save every 3 steps
ELASTIC_WORLD1_STEPS = 2  # steps at world 1 before a node comes back
# After the fit the preempted rank's tensors must be freed: the card's
# allocated memory (after a collection, cuBLAS workspaces cleared) may
# exceed its value before the fit by this much.
ELASTIC_MEM_SLACK = 64 << 20
# The first loss after the restore against a direct forward of the
# restored parameters on the same rows: the same kernels on the same
# inputs, so only a restore that is not bit for bit can move it.
ELASTIC_LOSS_RTOL = 1e-6


def phase_train_elastic() -> Dict[str, object]:
    """GPT-2 124M elastic training on a virtual cluster: a head without a
    GPU and two worker nodes of one CPU and half of card 0. One node is
    preempted after the second committed save (world 2 -> 1), one added
    back after a few steps at world 1 (1 -> 2 at the next boundary), and
    the fit runs the sized dataset out. Each gate fails the script."""
    import os
    import tempfile
    import threading

    import torch

    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import current_task_context, get_runtime
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption
    from ray_tpu_torch.checkpoint import layout, restore_pytree
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_map
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        ElasticConfig,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )
    from ray_tpu_torch.util import tracing

    card = card_line()
    cfg = train_gpt2.model_config()
    S, L = cfg.seq_len, cfg.n_layer
    rows = bi.token_windows(ELASTIC_ROWS, S, 50257)  # default_rng(0)
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_elastic_")
    root = os.path.join(storage, "elastic", "checkpoints", "sharded")
    lock = threading.Lock()
    at_save, preempted = threading.Event(), threading.Event()
    seen = {"forwards": {0: 0, 1: 0}, "nodes": {}, "restores": [],
            "first": None, "marks": [], "shapes": set()}

    def to_cpu(tree):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

    def probe(event, rank, step, **info):
        with lock:
            attempt = len(seen["restores"])
            if event == "forward":
                seen["forwards"][rank] += 1
                if rank not in seen["nodes"]:
                    state = get_runtime().get_actor_state(
                        current_task_context().actor_id)
                    seen["nodes"][rank] = str(state.node_id)
            elif event == "restore" and rank == 0:
                st = info["state"]
                seen["restores"].append(dict(
                    step=step, seconds=info["seconds"],
                    params=to_cpu(st["params"]),
                    flat=[t.detach().to("cpu", copy=True)
                          for t in _flat_state(st)],
                    count=int(st["opt_state"]["count"]),
                    state_step=int(st["step"])))
            elif event == "step":
                seen["shapes"].add(tuple(info["tokens"].shape))
                if rank == 0:
                    seen["marks"].append((attempt, step, time.time()))
                if attempt == 1 and rank == 0 and seen["first"] is None:
                    seen["first"] = (step, info["loss"],
                                     info["tokens"].detach().clone())
        # Rank 0 holds after the second save of the first attempt until the
        # node of rank 1 is gone: the preemption lands after a known step.
        if event == "saved" and rank == 0 and attempt == 0 and \
                step == 2 * ELASTIC_CKPT_EVERY:
            at_save.set()
            preempted.wait(300)

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    result: Dict[str, object] = {"card": card, "rows": ELASTIC_ROWS,
                                 "batch_per_rank": ELASTIC_BATCH,
                                 "ckpt_every": ELASTIC_CKPT_EVERY}
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=1, num_gpus=0.5)
        if ray_tpu_torch.cluster_resources().get("GPU") != 1.0:
            fail(f"train_elastic: the cluster registers "
                 f"{ray_tpu_torch.cluster_resources()} (two halves of card 0 "
                 f"expected)")
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=_fit_config(
                batch_size=ELASTIC_BATCH, ckpt_every=ELASTIC_CKPT_EVERY,
                async_save=True, probe=probe),
            scaling_config=ScalingConfig(
                num_workers=2, gpus_per_worker=0.5, worker_mode="threads",
                elastic=ElasticConfig(min_workers=1,
                                      grow_check_period_s=0.5)),
            datasets={"train": rows},
            run_config=RunConfig(
                name="elastic", storage_path=storage,
                checkpoint_config=CheckpointConfig(async_save=True,
                                                   replica_memory_steps=2),
                failure_config=FailureConfig(max_failures=2)))
        tracing.clear_spans()
        tracing.enable_tracing()
        _tensor_bytes()
        mem_before = torch.cuda.memory_allocated()
        _reset_counts()
        box: Dict[str, object] = {}
        t0 = time.perf_counter()
        fit_thread = threading.Thread(
            target=lambda: box.update(res=trainer.fit()), daemon=True)
        fit_thread.start()
        # 1. After the second committed save: take out rank 1's node.
        if not at_save.wait(300):
            fail("train_elastic: rank 0 never reached its second save")
        deadline = time.monotonic() + 120
        while len(layout.list_committed_steps(root)) < 2:
            if time.monotonic() > deadline:
                fail(f"train_elastic: committed steps "
                     f"{layout.list_committed_steps(root)} after 120 s")
            time.sleep(0.05)
        committed_at_failure = layout.latest_committed_step(root)
        victim = seen["nodes"][1]
        failed_at = time.perf_counter()
        if simulate_preemption(victim) != victim:
            fail(f"train_elastic: node {victim} was not preempted")
        preempted.set()
        # 2. A few steps at world 1, then a node comes back.
        deadline = time.monotonic() + 300
        while sum(1 for a, _, _ in seen["marks"] if a == 1) < \
                ELASTIC_WORLD1_STEPS:
            if time.monotonic() > deadline or not fit_thread.is_alive():
                fail(f"train_elastic: {ELASTIC_WORLD1_STEPS} steps at world "
                     f"1 never came ({box})")
            time.sleep(0.05)
        added_at = time.perf_counter()
        cluster.add_node(num_cpus=1, num_gpus=0.5)
        fit_thread.join(600)
        wall = time.perf_counter() - t0
        counts = _counts()
        if fit_thread.is_alive():
            fail("train_elastic: fit() did not end within 600 s")
        res = box["res"]
        spans = [s for s in tracing.exported_spans()
                 if s["name"] == "train.elastic"]
        tracing.disable_tracing()
        tracing.clear_spans()
        events = res.elastic_events
        kinds = [(e["type"], e["from_world"], e["to_world"]) for e in events]
        world = (res.metrics or {}).get("world")
        if res.error is not None or world != 2 or \
                kinds != [("shrink", 2, 1), ("grow", 1, 2)]:
            fail(f"train_elastic: error {res.error!r}, events {events}, "
                 f"last metrics {res.metrics}")
        shrink, grow = events
        if shrink["restore_step"] != committed_at_failure:
            fail(f"train_elastic: the shrink restored step "
                 f"{shrink['restore_step']}, the coordinator's newest "
                 f"committed step at the failure was {committed_at_failure}")
        led = trainer.sample_ledgers["train"]
        if led.double_trained() or led.untrained():
            fail(f"train_elastic: double-trained {led.double_trained()}, "
                 f"untrained {led.untrained()}")
        # Exact launches: 12 + 12 splash and one of each CE kernel for every
        # forward a rank started, the failed attempt's included.
        forwards = sum(seen["forwards"].values())
        want = {k: 0 for k in counts}
        want.update(splash_attention_fwd=L * forwards,
                    splash_attention_bwd=L * forwards, fused_ce_fwd=forwards,
                    fused_ce_dx=forwards, fused_ce_dw=forwards)
        if counts != want:
            fail(f"train_elastic: launches {counts}, want {want} for "
                 f"{seen['forwards']} forwards")
        if not spans:
            fail("train_elastic: no train.elastic span was recorded")
        # The restored state against the committed step on disk.
        restore = seen["restores"][0]
        disk = restore_pytree(layout.final_dir(root, committed_at_failure))
        disk_flat = [t.to("cpu") for t in _flat_state(disk)]
        bad = [i for i, (a, b) in enumerate(zip(restore["flat"], disk_flat))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        n = len(disk_flat) // 3  # params, mu, nu
        mu_bf16 = all(t.dtype == torch.bfloat16 for t in disk_flat[n:2 * n])
        if bad or len(disk_flat) != len(restore["flat"]) or not mu_bf16 or \
                restore["state_step"] != int(disk["step"]) or \
                restore["count"] != int(disk["opt_state"]["count"]) or \
                restore["step"] != ELASTIC_CKPT_EVERY * (
                    committed_at_failure + 1):
            fail(f"train_elastic: the restored state differs from step "
                 f"{committed_at_failure} on disk (leaves {bad[:5]}, mu "
                 f"bf16 {mu_bf16}, step {restore['state_step']} vs "
                 f"{int(disk['step'])}, count {restore['count']} vs "
                 f"{int(disk['opt_state']['count'])})")
        del disk, disk_flat
        # The first step after the restore against a direct forward.
        first_step, first_loss, first_tok = seen["first"]
        params = tree_map(lambda t: t.to("cuda"), restore["params"])
        with torch.no_grad():
            direct = float(gpt2.loss_fn(params, first_tok[:, :S],
                                        first_tok[:, 1:], cfg))
        del params
        loss_rel = abs(first_loss - direct) / abs(direct)
        if first_step != restore["step"] + 1 or \
                loss_rel > ELASTIC_LOSS_RTOL:
            fail(f"train_elastic: step {first_step} after the restore to "
                 f"{restore['step']}: loss {first_loss} vs a direct forward "
                 f"{direct} (rel {loss_rel})")
        # Tokens/s of each attempt from rank 0's step marks (steps 2 on).
        rates = []
        for attempt, world in enumerate((2, 1, 2)):
            marks = [t for a, _, t in seen["marks"] if a == attempt]
            rates.append(ELASTIC_BATCH * world * S * (len(marks) - 1)
                         / (marks[-1] - marks[0]) if len(marks) > 1 else None)
        shapes = sorted(seen["shapes"])
        restore_seconds = restore["seconds"]
        del seen["restores"], seen["first"], restore, first_tok
        del res, trainer, box
        _, mem_after = _tensor_bytes()
        if mem_after - mem_before > ELASTIC_MEM_SLACK:
            fail(f"train_elastic: memory {mem_after} after the fit vs "
                 f"{mem_before} before (slack {ELASTIC_MEM_SLACK})")
        result.update(
            launches=counts, forwards=dict(seen["forwards"]),
            rank_shapes=shapes, wall_s=wall,
            recovery_s=shrink.get("recovery_seconds"),
            grow_s=grow.get("recovery_seconds"),
            preempt_to_node_added_s=added_at - failed_at,
            restore_step=shrink["restore_step"],
            restored_train_step=first_step - 1,
            lost_steps=shrink["lost_steps"],
            requeued_samples=shrink["requeued_samples"],
            grow_restore_step=grow["restore_step"],
            restore_seconds=restore_seconds,
            first_loss=first_loss, first_loss_direct=direct,
            first_loss_rel=loss_rel,
            tokens_per_s={"world2_before": rates[0], "world1": rates[1],
                          "world2_after": rates[2]},
            memory_before=mem_before, memory_after=mem_after,
            spans=len(spans))
    finally:
        tracing.disable_tracing()
        cluster.shutdown()
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
    for key in ("recovery_s", "grow_s", "lost_steps", "requeued_samples",
                "tokens_per_s", "wall_s"):
        print(f"train_elastic_{key} " + json.dumps(
            {"card": card, key: result[key]}), flush=True)
    print("train_elastic " + json.dumps(result), flush=True)
    return result


# ----------------------------------------------------------------- train_mesh
MESH_STEPS = 3
MESH_BATCH = 16  # the global batch of each mesh and of direct
MESH_LR = 3e-4
#: The model of every cell: GPT-2 124M at full width with the fused loss.
MESH_BASE = {"loss_impl": "fused", "remat_policy": "attn_outside"}
#: (c)'s and (d)'s settings. (c) rings the 1024-token sequence over seq=2:
#: 512 rows a rank, a splash block, so the fused ring's kernels run, one
#: launch per rank per ring step. (d) pipelines the 12 layers over pipe=2 in
#: 4 microbatches of 4 rows; the reference refuses attn_outside under a
#: pipe, so it keeps the attention outside the two halves' checkpoints by
#: save_attn, which the port runs alike.
MESH_RING = {"attn_impl": "ring"}
MESH_PIPE = {"pp_stages": 2, "pp_microbatches": 4,
             "remat_policy": "save_attn"}
# (label, MeshSpec axes, settings over MESH_BASE). On one card the ranks
# share card 0 over gloo. (a): a data mesh needs all-reduces alone. (c)
# the reference's mixed mesh: the ring's K/V shifts are staged through the
# host by gloo, and Ulysses' all_to_all_single takes CUDA tensors there
# (scripts/torch_gloo_cuda_probe.py). (d) the pipeline: its tick shifts
# and the output's sum ride the same transport. An fsdp x tensor mesh ("b")
# gathers shards, and DTensor's Shard -> Replicate calls the functional
# all-gather, which kills a gloo rank on CUDA tensors (SIGSEGV in
# wait_tensor, torch 2.11.0+cu128; the probe). The c10d all-gather works
# there, but only 13 of a step's 32 all-gathers are the port's own
# redistributions; DTensor's propagation through the model's operators and
# the backward issues the other 19 (scripts/torch_mesh_allgathers.py). It
# is held on the CPU by tests/test_torch_mesh.py and
# tests/test_torch_mesh_models.py.
MESH_CELLS = (("a", {"data": 2}, {}),
              ("c", {"data": 2, "seq": 2}, MESH_RING),
              ("d", {"pipe": 2}, MESH_PIPE))
# With ``--mesh-cards``: one process rank on each of four cards joined over
# NCCL (the default backend), as their users run them; the shifts send the
# CUDA tensors themselves. (d4) in 2 microbatches, so a microbatch is (d)'s
# 4 rows.
MESH_CARDS_CELLS = (("b", {"fsdp": 2, "tensor": 2}, {}),
                    ("c4", {"data": 2, "seq": 2}, MESH_RING),
                    ("d4", {"pipe": 2, "data": 2},
                     dict(MESH_PIPE, pp_microbatches=2)))
#: Ring steps timed in each rank of a seq mesh after its steps: a step's
#: K/V shift alone, its kernel alone, and both as the ring runs them.
RING_PROBE_REPS = 5


def _want_local(shape, spec, sizes) -> list:
    """The local shape a rank holds of a leaf placed by ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in () if entry is None else (
                (entry,) if isinstance(entry, str) else entry):
            out[d] //= sizes[name]
    return out


def _mesh_config(extra):
    from ray_tpu_torch.models import gpt2

    return gpt2.GPTConfig(**dict(MESH_BASE, **extra))


def _mesh_reference(spec, extra):
    """The direct B=16 step a cell is held to: the same model unpipelined,
    and a seq mesh's ring folded onto the card (``Mesh`` of a seq-only spec
    without a process group)."""
    from ray_tpu_torch.parallel import Mesh, MeshSpec

    ref = {k: v for k, v in extra.items()
           if k not in ("pp_stages", "pp_microbatches")}
    fold = Mesh(MeshSpec(seq=spec["seq"])) if spec.get("seq", 1) > 1 \
        else None
    return _mesh_config(ref), fold


def _mesh_want(spec, extra, coord, L: int = 12) -> Dict[str, int]:
    """Each kernel's launches in one step of the rank at mesh coordinate
    ``coord``: a rank at seq index i runs the ring kernels on i + 1 of each
    layer's W steps (the chunks after its shard are masked whole), a
    pipeline stage the splash kernels on each of its layers once for each
    microbatch, and every rank one of each CE kernel (every stage computes
    the loss of the output the pipeline replicates)."""
    want = {k: 0 for k in _counts()}
    want.update(fused_ce_fwd=1, fused_ce_dx=1, fused_ce_dw=1)
    if extra.get("attn_impl") == "ring":
        n = L * (coord.get("seq", 0) + 1)
        want.update(ring_attention_fwd=n, ring_attention_bwd=n)
    else:
        per = L // spec.get("pipe", 1) * extra.get("pp_microbatches", 1)
        want.update(splash_attention_fwd=per, splash_attention_bwd=per)
    return want


def _whole(t, mesh):
    """The whole of DTensor ``t`` on every rank, gathered with the c10d
    all-gather over each mesh dimension that shards it (DTensor's
    ``full_tensor`` calls the functional all-gather, which kills a gloo rank
    on CUDA tensors)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    x = t.to_local()
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            group = mesh.device_mesh.get_group(i)
            part = x.movedim(pl.dim, 0).contiguous()
            out = torch.empty((dist.get_world_size(group) * part.shape[0],)
                              + tuple(part.shape[1:]), dtype=part.dtype,
                              device=part.device)
            dist.all_gather_into_tensor(out, part, group=group)
            x = out.movedim(0, pl.dim)
    return x


def _ring_probe(mesh, shape, device: str = "cuda") -> list:
    """Each step of one ring layer on this rank's (B, S/W, H, hd) shard:
    ms of the step's K/V shift alone, of its forward kernel alone and of
    both as the ring runs them (the shift posted, the kernel launched, the
    shift waited on), the median of RING_PROBE_REPS, host clock around a
    synchronised card; then the share of the shift that the kernel hid,
    (shift + kernel - both) / shift. Every rank of the seq group issues the
    same shifts; a rank whose chunk at a step lies after its shard
    launches nothing there."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch._private import torch_compat
    from ray_tpu_torch.ops import ring_attention as ra

    group = mesh.device_mesh.get_group("seq")
    W, i = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator(device=device).manual_seed(11 + dist.get_rank())
    q, k, v = (torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    o = torch.empty(shape, dtype=torch.float32, device=device)
    lse = torch.empty(shape[0], shape[2], shape[1], dtype=torch.float32,
                      device=device)
    perm = [(r, (r + 1) % W) for r in range(W)]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(fn):
        times = []
        for _ in range(RING_PROBE_REPS):
            sync()
            dist.barrier(group)
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    rows = []
    for step in range(W - 1):  # the last step shifts nothing
        chunk = ra.ring_source(step, i, W)
        computes = chunk <= i

        def kernel():
            if computes:
                ra.ring_fwd_block(q, k, v, o, lse, diagonal=step == 0,
                                  first=step == 0)

        def shift():
            torch_compat.shift_start((k, v), group, perm).wait()

        def both():
            pending = torch_compat.shift_start((k, v), group, perm)
            kernel()
            pending.wait()

        row = dict(step=step, chunk=chunk, computes=computes,
                   shift_ms=timed(shift), kernel_ms=timed(kernel),
                   both_ms=timed(both))
        row["hidden_share"] = (max(0.0, min(1.0, (
            row["shift_ms"] + row["kernel_ms"] - row["both_ms"])
            / row["shift_ms"])) if computes else 0.0)
        rows.append(row)
    return rows


def _mesh_loop(config) -> None:
    """One process rank of ``train_mesh``: GPT-2 124M on a device mesh over
    the ranks' process group, as a user writes the loop. The rank builds the
    mesh, the sharded state (``create_sharded_state``) and its (B/data,
    S/seq) block of the batch; checks each leaf's local shape against
    ``logical_to_spec``; computes the first step's loss and gradients (rank
    0 holds the synced ones, and its own before the sync, against a direct
    B=16 step it runs alone); then takes MESH_STEPS steps of
    ``make_train_step``, reporting after each its time, the host time spent
    waiting in point-to-point shifts, and every rank's kernel launches and
    digest of every local shard; on a seq mesh it then times the ring's
    steps (``_ring_probe``). ``config["device"]`` "cpu" (and a tiny model in
    ``config["extra"]``) rehearses it on the CPU."""
    import hashlib
    import os
    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch._private import torch_compat
    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention, fused_ce, ring_attention
    from ray_tpu_torch.optim import _as_placed, tree_leaves
    from ray_tpu_torch.parallel import (MeshSpec, batch_sharding,
                                        create_sharded_state,
                                        logical_to_spec, make_mesh, use_mesh)
    from ray_tpu_torch.parallel.mesh import axis_index
    from ray_tpu_torch.train import profiler

    started = time.time()
    rank, world = dist.get_rank(), dist.get_world_size()
    spec, extra = config["spec"], config["extra"]
    dev = config.get("device", "cuda")
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if not cuda:
        # The CPU's index_put (the embedding's backward) and its BLAS sum
        # in an order that follows the threads; the stages' replicated
        # computation must be bit for bit.
        torch.set_num_threads(1)
    cfg = _mesh_config(extra)
    mesh = make_mesh(MeshSpec(**spec), device=dev)
    coord = {n: axis_index(mesh, n) for n in mesh.dim_names}
    opt = gpt2.make_optimizer(config["lr"])
    params, state = create_sharded_state(
        partial(gpt2.init_params, cfg), gpt2.logical_axes(cfg), mesh, 0, opt)
    tokens = np.array(config["tokens"], dtype=np.int64)
    # Each batch shard (data x fsdp, major to minor) feeds its own rows, and
    # each seq shard its own columns; ranks that differ only on the tensor
    # or pipe axis feed the same block.
    shard, shards = 0, 1
    for name in ("data", "fsdp"):
        if name in mesh.dim_names:
            shard = shard * mesh.shape[name] + coord[name]
            shards *= mesh.shape[name]
    b = tokens.shape[0] // shards
    s = (tokens.shape[1] - 1) // mesh.shape["seq"]
    j = coord.get("seq", 0)
    rows = tokens[shard * b:(shard + 1) * b]
    x, y = (distributed.local_batch_to_global(
        mesh, torch.as_tensor(t[:, j * s:(j + 1) * s].copy()),
        axis=batch_sharding(mesh).spec) for t in (rows[:, :-1], rows[:, 1:]))
    leaves = tree_leaves(params)
    names, axes = zip(*_named_leaves(gpt2.logical_axes(cfg)))
    local = {n: list(p.to_local().shape) for n, p in zip(names, leaves)}
    wrong = {n: (local[n], _want_local(p.shape, logical_to_spec(a),
                                       mesh.shape))
             for n, p, a in zip(names, leaves, axes)
             if local[n] != _want_local(p.shape, logical_to_spec(a),
                                        mesh.shape)}
    x_local = list(x.to_local().shape)
    ready = time.time()

    for p in leaves:
        p.requires_grad_(True)
    loss = gpt2.loss_fn(params, x, y, cfg)
    raw = torch.autograd.grad(loss, leaves)
    own = [g.to_local() for g in raw] if rank == 0 else None
    synced = [_whole(g, mesh) for g in _as_placed(raw, leaves)]
    full_init = [_whole(p.detach(), mesh) for p in leaves]
    loss0 = float(loss.detach().full_tensor())
    del raw
    for p in leaves:
        p.requires_grad_(False)
    check = None
    if rank == 0:
        ref_cfg, fold = _mesh_reference(spec, extra)
        ref_params = gpt2.init_params(ref_cfg, 0, device=dev)
        rl = tree_leaves(ref_params)
        init_equal = all(torch.equal(a, b) for a, b in zip(full_init, rl))
        for p in rl:
            p.requires_grad_(True)
        t = torch.as_tensor(tokens, device=dev)
        with use_mesh(fold) if fold is not None else contextlib.nullcontext():
            ref_loss = gpt2.loss_fn(ref_params, t[:, :-1], t[:, 1:], ref_cfg)
            ref = torch.autograd.grad(ref_loss, rl)

        def err(g, r):
            if g.shape != r.shape:
                return math.inf
            return float((g.float() - r.float()).abs().max()
                         / r.float().abs().max())

        # The control: rank 0's own gradients of the leaves it holds whole
        # (a sharded leaf's local gradient has another shape).
        check = dict(loss=loss0, ref_loss=float(ref_loss),
                     init_equal=init_equal,
                     grad_rel_err={n: err(g, r)
                                   for n, g, r in zip(names, synced, ref)},
                     own_rel_err={n: err(g, r)
                                  for n, g, r in zip(names, own, ref)
                                  if g.shape == r.shape})
        del ref, ref_params, rl, t, own
    del synced, full_init
    if cuda:
        torch.cuda.empty_cache()

    def counts():
        return {**attention.LAUNCHES, **fused_ce.LAUNCHES,
                **ring_attention.LAUNCHES}

    # The host time a step spends waiting in point-to-point shifts (the
    # ring's K/V and dK/dV, the pipeline's ticks): its own wait for a
    # peer, the bubble included, and the transfer.
    waited = [0.0]
    wait = torch_compat.Shift.wait

    def timed_wait(self):
        t0 = time.perf_counter()
        try:
            return wait(self)
        finally:
            waited[0] += time.perf_counter() - t0

    torch_compat.Shift.wait = timed_wait
    for mod in (attention, fused_ce, ring_attention):
        mod.reset_launches()
    step = gpt2.make_train_step(cfg, opt)
    # Process ranks run no session profiler; one per step times the step
    # and takes the gradient sync that make_step records as ``collective``.
    buckets = []
    for i in range(config["steps"]):
        before = counts()
        waited[0] = 0.0
        sync()
        t0 = time.time()
        prof = profiler.StepProfiler(run_name="train_mesh", rank=rank)
        profiler.activate(prof)
        params, state, loss = step(params, state, x, y)
        value = float(loss)
        step_s = time.time() - t0
        buckets.append(prof.step_boundary())
        profiler.activate(None)
        launched = {k: v - before[k] for k, v in counts().items()}
        digests = [hashlib.sha256(p.to_local().detach().cpu().numpy()
                                  .tobytes()).hexdigest()[:16]
                   for p in tree_leaves(params)]
        # Only rank 0's reports reach the driver: every rank's launches,
        # digests and start times ride to it here.
        ranks = [None] * world
        dist.all_gather_object(ranks, {
            "coord": mesh.device_mesh.get_coordinate(), "axes": coord,
            "digests": digests,
            "placements": [[repr(q) for q in p.placements]
                           for p in tree_leaves(params)],
            "launches": launched, "wrong_shapes": wrong,
            "shift_wait_s": waited[0], "step_s": step_s,
            "started": started, "ready": ready})
        metrics = {"step": i + 1, "loss": value, "step_s": step_s,
                   "time": time.time(), "ranks": ranks, "rank": rank,
                   "pid": os.getpid(), "backend": dist.get_backend(),
                   "x_local": x_local, "local_shapes": local,
                   "check": check if i == 0 else None,
                   "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                   if cuda else None)}
        if i == config["steps"] - 1:
            metrics["buckets"] = buckets
            if "seq" in mesh.dim_names:
                probes = [None] * world
                dist.all_gather_object(probes, _ring_probe(
                    mesh, (x_local[0], x_local[1], cfg.n_head,
                           cfg.head_dim), dev))
                metrics["ring_probe"] = probes
        train.report(metrics)
    torch_compat.Shift.wait = wait


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _replicas_equal(ranks) -> bool:
    """Whether ranks that hold the same shard of a leaf (the same
    coordinates on the mesh dimensions that shard it) hold the same
    bytes."""
    for leaf in range(len(ranks[0]["digests"])):
        seen = {}
        for r in ranks:
            key = tuple(c for c, p in zip(r["coord"], r["placements"][leaf])
                        if p.startswith("Shard"))
            if seen.setdefault(key, r["digests"][leaf]) != r["digests"][leaf]:
                return False
    return True


def _mesh_direct(spec, extra, tokens) -> Dict[str, object]:
    """Direct: one process, B=16, the same weights and tokens, the cell's
    reference model (``_mesh_reference``), MESH_STEPS steps: its losses and
    tokens/s over steps 2 on."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import use_mesh

    cfg, fold = _mesh_reference(spec, extra)
    params = gpt2.init_params(cfg, 0, device="cuda")
    opt = gpt2.make_optimizer(MESH_LR)
    state = opt.init(params)
    step = gpt2.make_train_step(cfg, opt)
    t = torch.as_tensor(np.asarray(tokens, np.int64), device="cuda")
    seconds, losses = [], []
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        with use_mesh(fold) if fold is not None else contextlib.nullcontext():
            params, state, loss = step(params, state, t[:, :-1], t[:, 1:])
        losses.append(float(loss))
        seconds.append(time.time() - t0)
    del params, state, step, t
    torch.cuda.empty_cache()
    return {"losses": losses, "tokens_per_s": (MESH_STEPS - 1) * MESH_BATCH
            * cfg.seq_len / sum(seconds[1:])}


def phase_train_mesh(card: str, cells=MESH_CELLS, cards: int = 1
                     ) -> Dict[str, object]:
    """GPT-2 124M at full width on a device mesh of process ranks, one run
    per entry of ``cells``. On one card (``cards=1``) the ranks share card 0
    over an explicitly chosen gloo: (a) ``MeshSpec(data=2)``, two ranks of
    B=8; (c) ``MeshSpec(data=2, seq=2)``, four ranks of B=8 x 512 tokens
    through the process ring; (d) ``MeshSpec(pipe=2)``, two stages of six
    layers, B=16 in four microbatches (MESH_CELLS says why an fsdp x tensor
    mesh does not run there). On ``cards`` cards each rank holds one and
    they join over NCCL: (b) ``MeshSpec(fsdp=2, tensor=2)``, four ranks of
    B=8 and six heads (the tensor ranks feed the same rows), and (c4), (d4)
    as (c), (d) with ``data=2`` beside ``pipe``. Each is held to a direct
    B=16 step on the same weights and tokens (a seq mesh's direct step runs
    the ring folded onto the card, a pipelined one's the same model
    unpipelined): the first loss within LOSS_ATOL, every synced gradient
    within GRAD_RTOL of its leaf's largest entry in direct's (rank 0's own
    gradients before the sync must fail that gate where its batch or
    sequence shard makes them a part of the sum), the parameters' replicas
    equal bit for bit after each step, each rank's local shapes those
    ``logical_to_spec`` names, and each rank's launches per step those its
    place on the mesh gives (``_mesh_want``), none in the driver. Prints
    tokens/s against direct, the step profiler's collective bucket, the
    time each rank waits in point-to-point shifts, the pipeline's bubble
    by its schedule, each ring step's shift against its kernel, and each
    rank's cold start."""
    import os
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    t_phase = time.perf_counter()
    S = _mesh_config({}).seq_len
    tokens = bi.token_windows(MESH_BATCH, S, 50257)  # default_rng(0)
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    result: Dict[str, object] = {"card": card}
    path_launches = {k: 0 for k in _counts()}
    directs: Dict[str, Dict[str, object]] = {}
    for label, spec, extra in cells:
        key = repr(_mesh_reference(spec, extra))
        if key not in directs:
            directs[key] = _mesh_direct(spec, extra, tokens)
    ray_tpu_torch.init()
    try:
        for label, spec, extra in cells:
            world = math.prod(spec.values())
            direct = directs[repr(_mesh_reference(spec, extra))]
            shared = cards == 1
            backend = "gloo" if shared else "nccl"
            if not shared and world != cards:
                fail(f"train_mesh ({label}): {world} ranks on {cards} cards")
            _reset_counts()
            trainer = CudaTrainer(
                _mesh_loop,
                train_loop_config={"spec": spec, "extra": extra,
                                   "tokens": tokens, "lr": MESH_LR,
                                   "steps": MESH_STEPS},
                scaling_config=ScalingConfig(
                    num_workers=world,
                    gpus_per_worker=1.0 / world if shared else 1.0,
                    worker_mode="processes",
                    backend="gloo" if shared else None),
                run_config=RunConfig(name=f"mesh_{label}",
                                     storage_path=storage))
            t0 = time.time()
            res = trainer.fit()
            wall = time.time() - t0
            driver = _counts()
            if res.error is not None:
                fail(f"train_mesh ({label}): {res.error!r}")
            hist = res.metrics_history
            first, last = hist[0], hist[-1]
            check = first["check"]
            worst = max(check["grad_rel_err"], key=check["grad_rel_err"].get)
            own_worst = max(check["own_rel_err"].values(), default=0.0)
            topo = trainer.process_topology
            pids = {r["pid"] for r in topo}
            # [step][rank] -> that rank's launches in that step
            per_rank = [[r["launches"] for r in m["ranks"]] for m in hist]
            want = [_mesh_want(spec, extra, r["axes"])
                    for r in first["ranks"]]
            if any(r["backend"] != backend for r in topo) or \
                    len(pids) != world or os.getpid() in pids:
                fail(f"train_mesh ({label}): topology {topo}")
            if abs(check["loss"] - check["ref_loss"]) > LOSS_ATOL or \
                    not check["init_equal"]:
                fail(f"train_mesh ({label}): first loss {check['loss']} vs "
                     f"direct {check['ref_loss']}, init equal "
                     f"{check['init_equal']}")
            if check["grad_rel_err"][worst] > GRAD_RTOL:
                fail(f"train_mesh ({label}): gradient {worst} off by "
                     f"{check['grad_rel_err'][worst]} (tol {GRAD_RTOL})")
            # The control, where a rank's gradients are a part of the sum
            # (its batch or sequence shard's). A pipe stage's own gradients
            # of what every stage holds are whole before any sync.
            control = any(spec.get(n, 1) > 1 for n in ("data", "fsdp",
                                                        "seq"))
            if control and own_worst <= GRAD_RTOL:
                fail(f"train_mesh ({label}): rank 0's gradients before the "
                     f"sync passed the gate ({own_worst}): the control")
            if not all(_replicas_equal(m["ranks"]) for m in hist):
                fail(f"train_mesh ({label}): replicas differ after a step")
            wrong = {i: r["wrong_shapes"] for i, r in enumerate(first["ranks"])
                     if r["wrong_shapes"]}
            if wrong:
                fail(f"train_mesh ({label}): local shapes by rank {wrong}")
            if any(len(step) != world or step != want
                   for step in per_rank) or any(driver.values()):
                fail(f"train_mesh ({label}): the ranks launched {per_rank} "
                     f"per step (want {want} in each), the driver {driver}")
            if not all(np.isfinite(m["loss"]) for m in hist):
                fail(f"train_mesh ({label}): losses "
                     f"{[m['loss'] for m in hist]}")
            for k in path_launches:
                path_launches[k] += sum(c[k] for step in per_rank
                                        for c in step)
            steps = [m["step_s"] for m in hist]
            tps = (MESH_STEPS - 1) * MESH_BATCH * S / sum(steps[1:])
            buckets = last["buckets"] or []
            stages = spec.get("pipe", 1)
            micro = extra.get("pp_microbatches", 1)
            row = dict(
                spec=spec, extra=extra, world=world, cards=cards,
                backend=backend, x_local=first["x_local"],
                qkv_w_local=first["local_shapes"]["blocks.qkv_w"],
                losses=[m["loss"] for m in hist],
                first_loss=check["loss"], direct_first_loss=check["ref_loss"],
                loss_abs_err=abs(check["loss"] - check["ref_loss"]),
                worst_grad=worst, worst_grad_rel_err=check["grad_rel_err"][
                    worst], own_worst_rel_err=own_worst,
                step_s=steps, tokens_per_s=tps,
                direct_tokens_per_s=direct["tokens_per_s"],
                direct_losses=direct["losses"],
                tokens_per_s_over_direct=tps / direct["tokens_per_s"],
                collective_ms_per_step=[1e3 * b["collective"]
                                        for b in buckets[1:]],
                wall_ms_per_step=[1e3 * b["wall"] for b in buckets[1:]],
                shift_wait_ms_by_rank=[
                    [1e3 * m["ranks"][r]["shift_wait_s"] for m in hist[1:]]
                    for r in range(world)],
                cold_start_s=dict(
                    to_loop=[r["started"] - t0 for r in first["ranks"]],
                    to_state=[r["ready"] - t0 for r in first["ranks"]],
                    to_first_report=hist[0]["time"] - t0),
                launches_per_step_by_rank=per_rank[0],
                launches_by_rank=[{k: sum(step[r][k] for step in per_rank)
                                   for k in want[r] if want[r][k]}
                                  for r in range(world)],
                wall_s=wall,
                peak_mem_gb=last["peak_mem_gb"])
            if stages > 1:
                # GPipe's bubble: S - 1 of the S + M - 1 ticks a stage idles.
                row["bubble_share_schedule"] = (stages - 1) / (stages + micro
                                                               - 1)
                row["shift_wait_share_of_step"] = [
                    [m["ranks"][r]["shift_wait_s"] / m["ranks"][r]["step_s"]
                     for m in hist[1:]] for r in range(world)]
            if last.get("ring_probe"):
                row["ring_probe_by_rank"] = last["ring_probe"]
                hidden = [p["hidden_share"] for probe in last["ring_probe"]
                          for p in probe if p["computes"]]
                row["ring_hidden_share"] = dict(
                    min=min(hidden), median=statistics.median(hidden),
                    max=max(hidden))
            print(f"train_mesh_{label} " + json.dumps(row), flush=True)
            result[label] = row
    finally:
        ray_tpu_torch.shutdown()
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
    torch.cuda.empty_cache()
    result["launches"] = path_launches
    result["seconds"] = time.perf_counter() - t_phase
    print("train_mesh " + json.dumps({
        "card": card, "launches": path_launches,
        "seconds": result["seconds"],
        "tokens_per_s_over_direct": {k: result[k]["tokens_per_s_over_direct"]
                                     for k, _, _ in cells}}), flush=True)
    return result


def phase_ring(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(3)
    W = RING_WORLD
    rows, main = [], None
    worst = {"fwd": 0.0, "bwd_abs": 0.0, "bwd_rel": 0.0}
    for n, (B, shard, H, hd, causal) in enumerate(RING_SHAPES):
        q, k, v = _qkv(gen, B, W * shard, H, hd)
        do = torch.randn(q.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
        grads = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = ra.ring_forward(q, k, v, world=W, causal=causal,
                                         plain=True)
        refs = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal,
                                plain=True)
        shape = dict(B=B, S_local=shard, H=H, hd=hd, W=W, causal=causal)
        if not all(torch.isfinite(x).all() for x in (o, lse, *grads)):
            fail(f"non-finite ring kernel output at {shape}")
        row = dict(shape, o_max_abs_err=(o - o_ref).abs().max().item(),
                   lse_max_abs_err=(lse - lse_ref).abs().max().item())
        if row["o_max_abs_err"] > O_ATOL or row["lse_max_abs_err"] > LSE_ATOL:
            fail(f"ring_attention_fwd disagrees with its plain version at "
                 f"{shape}: {row} (tol {O_ATOL}, {LSE_ATOL})")
        worst["fwd"] = max(worst["fwd"], row["o_max_abs_err"])
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            row[f"{name}_rel_err"] = rel_err(g, r)
            row[f"{name}_abs_err"] = (g - r).abs().max().item()
            worst["bwd_abs"] = max(worst["bwd_abs"], row[f"{name}_abs_err"])
            worst["bwd_rel"] = max(worst["bwd_rel"], row[f"{name}_rel_err"])
            if row[f"{name}_rel_err"] > BWD_RTOL:
                fail(f"ring_attention_bwd {name} disagrees with its plain "
                     f"version at {shape}: {row[f'{name}_rel_err']} "
                     f"(tol {BWD_RTOL})")
        if n == 0:  # the training path's shape: time it
            row.update(_ring_times(peaks, q, k, v, do, o, lse, causal))
            main = row
        rows.append(row)
        print("kernel ring_attention " + json.dumps(row), flush=True)
        del q, k, v, do, o, lse, grads, o_ref, lse_ref, refs
    torch.cuda.empty_cache()
    whole = _ring_against_splash(gen)
    torch.cuda.empty_cache()
    per_rank = _ring_per_rank(peaks, gen, worst)
    torch.cuda.empty_cache()
    return dict(rows=rows, main=main, worst=worst, whole=whole,
                per_rank=per_rank)


def _ring_per_rank(peaks, gen, worst) -> Dict[str, object]:
    """The process ring's per-rank launches (``ring_fwd_block`` and
    ``ring_bwd_block``: the pair (0, 0), W = 1, the diagonal and first
    flags of the rank's step) at RING_RANK_SHAPES, every rank on this card:
    against the plain blocks and against the folded launches bit for bit;
    then, at the first shape, the device ms of one rank's launch of each
    kind (its first, diagonal step and a later, full one) beside the
    bound."""
    import torch

    from ray_tpu_torch.ops import ring_attention as ra

    out = {"rows": []}
    for n, (B, shard, H, hd, causal, W) in enumerate(RING_RANK_SHAPES):
        q, k, v = _qkv(gen, B, W * shard, H, hd)
        do = torch.randn(q.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        got = ra.ring_by_rank(q, k, v, do, world=W, causal=causal)
        plain = ra.ring_by_rank(q, k, v, do, world=W, causal=causal,
                                plain=True)
        o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
        folded = (o, lse) + ra.ring_backward(q, k, v, o, lse, do, world=W,
                                             causal=causal)
        names = ("o", "lse", "dq", "dk", "dv")
        shape = dict(B=B, S_local=shard, H=H, hd=hd, W=W, causal=causal)
        row = dict(shape, equal_folded={m: bool(torch.equal(a, b)) for m, a, b
                                        in zip(names, got, folded)},
                   folded_max_abs_diff={
                       m: (a - b).abs().max().item()
                       for m, a, b in zip(names, got, folded)},
                   o_max_abs_err=(got[0] - plain[0]).abs().max().item(),
                   lse_max_abs_err=(got[1] - plain[1]).abs().max().item(),
                   **{f"{m}_rel_err": rel_err(a, b) for m, a, b in
                      zip(names[2:], got[2:], plain[2:])})
        print("kernel ring_per_rank " + json.dumps(row), flush=True)
        if not all(torch.isfinite(x).all() for x in got):
            fail(f"non-finite per-rank ring output at {shape}")
        if row["o_max_abs_err"] > O_ATOL or row["lse_max_abs_err"] > LSE_ATOL:
            fail(f"the per-rank ring forward disagrees with its plain "
                 f"version at {shape}: {row}")
        if max(row[f"{m}_rel_err"] for m in names[2:]) > BWD_RTOL:
            fail(f"the per-rank ring backward disagrees with its plain "
                 f"version at {shape}: {row}")
        if not all(row["equal_folded"].values()):
            fail(f"the per-rank ring launches differ from the folded ones "
                 f"at {shape}: {row['folded_max_abs_diff']}")
        worst["fwd"] = max(worst["fwd"], row["o_max_abs_err"])
        worst["bwd_rel"] = max(worst["bwd_rel"],
                               *(row[f"{m}_rel_err"] for m in names[2:]))
        worst["bwd_abs"] = max(worst["bwd_abs"], *(
            (a - b).abs().max().item() for a, b in zip(got[2:], plain[2:])))
        if n == 0:
            out["timed"] = _ring_block_times(peaks, q, k, v, do, shard,
                                             folded)
        out["rows"].append(row)
        del q, k, v, do, got, plain, o, lse, folded
    return out


def _ring_block_times(peaks, q, k, v, do, shard, folded) -> Dict[str, object]:
    """Device ms of one rank's per-rank launch at train_mesh (c)'s shape:
    the first (diagonal, writing) and a later (full, merging) step, forward
    and backward, with their bounds and plain versions, and the library
    yardstick on the same rank's blocks: SDPA causal for the diagonal step
    and non-causal for the full one, its forward replayed in a CUDA graph
    and its backward timed by events around a loop (no profiler this early
    in the script)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import ring_attention as ra

    B, _, H, hd = q.shape
    q0, do0 = (x[:, :shard].contiguous() for x in (q, do))
    own = [x[:, :shard].contiguous() for x in (k, v)]
    other = [x[:, shard:2 * shard].contiguous() for x in (k, v)]
    o = folded[0][:, :shard].contiguous()
    lse = folded[1][:, :, :shard].contiguous()
    delta = ra.ring_delta(o, do0)
    o_acc, dq, dk, dv = (torch.empty_like(o) for _ in range(4))
    lse_acc = torch.empty_like(lse)
    out = {}
    for label, kv, diagonal, first in (("first_diagonal", own, True, True),
                                       ("later_full", other, False, False)):
        flags = dict(diagonal=diagonal, first=first)
        calls = {
            "fwd": lambda fn, kv=kv, flags=flags: (
                lambda: fn(q0, *kv, o_acc, lse_acc, **flags)),
            "bwd": lambda fn, kv=kv, flags=flags: (
                lambda: fn(q0, *kv, do0, lse, delta, dq, dk, dv, **flags))}
        for which, kern, plain in (
                ("fwd", ra.ring_fwd_block, ra.ring_fwd_block_plain),
                ("bwd", ra.ring_bwd_block, ra.ring_bwd_block_plain)):
            bound_ms, bound_by = ring_bound(
                which, B, shard, H, hd, int(diagonal), int(not diagonal),
                *peaks, n_first=int(first))
            out[f"{which}_{label}"] = dict(
                ms=device_ms(calls[which](kern)),
                plain_ms=device_ms(calls[which](plain), iters=2),
                bound_ms=bound_ms, bound_by=bound_by)
        qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                      for x in (q0, *kv))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=diagonal)
        dot = do0.transpose(1, 2).contiguous()
        with torch.no_grad():
            out[f"fwd_{label}"]["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=diagonal))
        out[f"bwd_{label}"]["library_ms"] = loop_ms(
            lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                        retain_graph=True))
        out[f"bwd_{label}"]["library_ms_by"] = "events around a loop"
        del qt, kt, vt, sdpa, dot
    print("kernel ring_per_rank_ms " + json.dumps(
        dict(B=B, S_local=shard, H=H, hd=hd, **out)), flush=True)
    return out


def _ring_times(peaks, q, k, v, do, o, lse, causal) -> Dict[str, object]:
    """Device ms of each ring kernel per launch (steps 0 and 1) and over the
    W launches of one layer's attention, beside the plain versions and the
    bounds (``bound_ms`` with the first step's blocks write-only,
    ``bound_ms_accumulate`` with every block reading its accumulators);
    host ms per launch. The accumulators are scratch tensors that the timed
    launches keep merging into. They hold NaN when step 0 is timed: step 0
    reads none of them, so they must come out finite."""
    import torch

    from ray_tpu_torch.ops import ring_attention as ra

    W = RING_WORLD
    B, S, H, hd = q.shape
    shard = S // W
    o_t, lse_t = o.clone(), lse.clone()
    delta = ra.ring_delta(o, do)
    acc = [torch.empty_like(o) for _ in range(3)]
    fwd_args = (q, k, v, o_t, lse_t)
    bwd_args = (q, k, v, do, lse, delta, *acc)

    def steps(fn, args, which):
        return lambda: [fn(*args, step=s, world=W, causal=causal)
                        for s in which]

    def bounds(which, n_diag, n_full, n_first):
        bound_ms, bound_by = ring_bound(which, B, shard, H, hd, n_diag,
                                        n_full, *peaks, n_first=n_first)
        return dict(bound_ms=bound_ms, bound_by=bound_by,
                    bound_ms_accumulate=ring_bound(
                        which, B, shard, H, hd, n_diag, n_full, *peaks)[0])

    out = {"per_launch": []}
    for s in (0, 1):
        n = len(ra.ring_pairs(s, W, causal))
        blocks = (n, 0) if causal and s == 0 else (0, n)
        launch = dict(step=s, pairs=n)
        if s == 0:
            for x in (o_t, lse_t, *acc):
                x.fill_(float("nan"))
        for which, kern, plain, args, accs in (
                ("fwd", ra.ring_fwd_step, ra.ring_fwd_step_plain, fwd_args,
                 (o_t, lse_t)),
                ("bwd", ra.ring_bwd_step, ra.ring_bwd_step_plain, bwd_args,
                 acc)):
            launch[f"{which}_ms"] = device_ms(steps(kern, args, [s]))
            if s == 0 and not all(torch.isfinite(x).all() for x in accs):
                fail(f"ring step 0 ({which}) left a NaN of its accumulators: "
                     "it read them")
            launch.update({
                f"{which}_plain_ms": device_ms(steps(plain, args, [s]),
                                               iters=2),
                **{f"{which}_{key}": val for key, val in bounds(
                    which, *blocks, n if s == 0 else 0).items()},
                f"{which}_call_ms": time_ms(steps(kern, args, [s]))})
        out["per_launch"].append(launch)
    causal_blocks = (W, W * (W - 1) // 2) if causal else (0, W * W)
    for which, kern, plain, args in (
            ("fwd", ra.ring_fwd_step, ra.ring_fwd_step_plain, fwd_args),
            ("bwd", ra.ring_bwd_step, ra.ring_bwd_step_plain, bwd_args)):
        out[which] = dict(
            launches=W, ms=device_ms(steps(kern, args, range(W))),
            plain_ms=device_ms(steps(plain, args, range(W)), iters=2),
            **bounds(which, *causal_blocks, W),
            call_ms=time_ms(steps(kern, args, range(W))))
    return out


# What a kernel holds on an SM, as the sources' ``*_resources`` entries
# give it (kernel_resources in csrc/mma_sm90.cuh).
RESOURCE_FIELDS = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
                   "blocks_per_sm")


def ce_resources() -> Dict[str, object]:
    """What the fused CE kernels hold on an SM, by width: the forward's
    from ``fused_ce_fwd_resources`` (with its cluster size and the clusters
    the card holds at once), dx's and dW's from ``fused_ce_resources``."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    lib = kernel_build.load("fused_ce")
    for fn in (lib.fused_ce_fwd_resources, lib.fused_ce_resources):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = {}
    for D in (64, 128, 768):
        buf = (ctypes.c_int * 7)()
        err = lib.fused_ce_fwd_resources(D, ctypes.addressof(buf))
        if err != 0:
            fail(f"fused_ce_fwd_resources({D}): CUDA error {err}")
        out[f"fwd D={D}"] = dict(zip(
            RESOURCE_FIELDS + ("cluster_size", "active_clusters"), buf))
    for D in (64, 128, 768):
        buf = (ctypes.c_int * 10)()
        err = lib.fused_ce_resources(D, ctypes.addressof(buf))
        if err != 0:
            fail(f"fused_ce_resources({D}): CUDA error {err}")
        for i, kernel in enumerate(("dx", "dw")):
            out[f"{kernel} D={D}"] = dict(
                zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def ring_resources() -> Dict[str, object]:
    """What each ring kernel holds on an SM (registers, spill bytes, static
    and dynamic shared bytes, resident blocks per SM), by head_dim and step
    kind, from the ring sources' ``*_resources`` entries."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    out = {}
    for name, kernels in (("ring_attention_fwd", ("fwd",)),
                          ("ring_attention_bwd", ("dkv", "dq"))):
        fn = getattr(kernel_build.load(name), f"{name}_resources")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for hd in (64, 128):
            for first in (0, 1):
                buf = (ctypes.c_int * (5 * len(kernels)))()
                err = fn(hd, first, ctypes.addressof(buf))
                if err != 0:
                    fail(f"{name}_resources({hd}, {first}): CUDA error {err}")
                for i, kernel in enumerate(kernels):
                    out[f"{kernel} hd={hd} {'first' if first else 'later'}"] = \
                        dict(zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def splash_resources() -> Dict[str, object]:
    """What each splash kernel holds on an SM (the forward; the backward's
    dk/dv and dq kernels), by head_dim, from the sources' ``*_resources``
    entries."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    out = {}
    for name, kernels in (("splash_attention_fwd", ("fwd",)),
                          ("splash_attention_bwd", ("dkv", "dq"))):
        fn = getattr(kernel_build.load(name), f"{name}_resources")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for hd in (64, 128):
            buf = (ctypes.c_int * (5 * len(kernels)))()
            err = fn(hd, ctypes.addressof(buf))
            if err != 0:
                fail(f"{name}_resources({hd}): CUDA error {err}")
            for i, kernel in enumerate(kernels):
                out[f"{kernel} hd={hd}"] = dict(
                    zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def _ring_against_splash(gen) -> Dict[str, object]:
    """Whole ring attention (W=4, FusedRing, the kernels) against the splash
    kernels on the same q, k, v, forward and gradient, with the device time
    of each and of SDPA, forward by CUDA-graph replay and backward by events
    around back-to-back calls (an autograd backward does not capture)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.parallel import MeshSpec

    B, S, H, hd = RING_WHOLE_SHAPE
    mesh = MeshSpec(seq=RING_WORLD)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    out_r = ra.ring_attention(q, k, v, mesh=mesh)
    if type(out_r.grad_fn).__name__ != "FusedRingBackward":
        fail(f"ring_attention's gradient is {type(out_r.grad_fn).__name__}")
    out_s = attention.splash_attention(q, k, v)
    (g_r,) = torch.autograd.grad(out_r, qkv, do, retain_graph=True)
    (g_s,) = torch.autograd.grad(out_s, qkv, do, retain_graph=True)
    res = dict(B=B, S=S, H=H, hd=hd, W=RING_WORLD,
               o_max_abs_err=(out_r.float() - out_s.float()).abs().max().item())
    for name, a, b in zip(("dq", "dk", "dv"), g_r.split(H * hd, -1),
                          g_s.split(H * hd, -1)):
        res[f"{name}_rel_err"] = rel_err(a, b)
    print("ring_vs_splash " + json.dumps(res), flush=True)
    if res["o_max_abs_err"] > O_ATOL:
        fail(f"ring_attention differs from splash_attention: {res}")
    if max(res[f"{n}_rel_err"] for n in ("dq", "dk", "dv")) > BWD_RTOL:
        fail(f"ring_attention's gradient differs from splash's: {res}")

    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out_l = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        res["fwd_ms"] = dict(
            ring=device_ms(lambda: ra.ring_attention(q, k, v, mesh=mesh)),
            splash=device_ms(lambda: attention.splash_attention(q, k, v)),
            sdpa=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)))
    res["bwd_ms"] = dict(
        ring=loop_ms(lambda: torch.autograd.grad(out_r, qkv, do,
                                                 retain_graph=True)),
        splash=loop_ms(lambda: torch.autograd.grad(out_s, qkv, do,
                                                   retain_graph=True)),
        sdpa=loop_ms(lambda: torch.autograd.grad(out_l, (qt, kt, vt), dot,
                                                 retain_graph=True)))
    print("ring_whole_ms " + json.dumps(res), flush=True)
    return res


def _counts() -> Dict[str, int]:
    from ray_tpu_torch.ops import attention, fused_ce, ring_attention

    return {**attention.LAUNCHES, **fused_ce.LAUNCHES,
            **ring_attention.LAUNCHES}


def _reset_counts() -> None:
    from ray_tpu_torch.ops import attention, fused_ce, ring_attention

    for mod in (attention, fused_ce, ring_attention):
        mod.reset_launches()


def _train_start(config):
    """The training runs' common start: GPT-2 weights from seed 0 and one
    batch of B=16 tokens from a numpy seed."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2

    init = gpt2.init_params(config, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, 50257, (TRAIN_BATCH, config.seq_len + 1)),
        dtype=torch.long, device="cuda")
    return init, toks[:, :-1], toks[:, 1:]


def _train_steps(label, config, step, params, opt_state, tokens, targets,
                 want, peaks, card, flops_per_token=None, per_row=None
                 ) -> Dict[str, object]:
    """TRAIN_STEPS steps of ``step``, checking each step's launch counts
    against ``want`` (every kernel not named there: 0) and that the losses
    are finite and fall. Counts are set to 0 just before and read after.
    ``tokens_per_s`` counts ``per_row`` (default ``config.seq_len``) per
    row of ``tokens``; MFU uses ``flops_per_token`` (default GPT-2's), and
    is None when that is 0."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in _counts().items()}
        expected = {k: want.get(k, 0) for k in delta}
        if delta != expected:
            fail(f"{label} step {i}: launches {delta}, expected {expected}")
    launches = _counts()
    if not all(np.isfinite(losses)):
        fail(f"{label} training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} training loss did not fall: {losses}")
    # Steps after the first (which sets up cuBLAS and the allocator).
    steps_per_s = (TRAIN_STEPS - 1) / sum(step_s[1:])
    tokens_per_s = steps_per_s * tokens.shape[0] * (
        config.seq_len if per_row is None else per_row)
    if flops_per_token is None:
        flops_per_token = gpt2.flops_per_token(config)
    mfu = (100.0 * flops_per_token * tokens_per_s / peaks[1]
           if flops_per_token else None)
    return dict(losses=losses, step_s=step_s, steps_per_s=steps_per_s,
                tokens_per_s=tokens_per_s, mfu_pct=mfu, launches=launches,
                card=card,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _check_step_against(label, cfg, ref_cfg, init, small, mesh=None,
                        loss_fn=None, want=None) -> Dict[str, object]:
    """One B=2 loss and gradient of ``cfg`` against ``ref_cfg`` on the same
    weights: loss within LOSS_ATOL, every leaf within GRAD_RTOL of its
    largest entry. ``loss_fn`` defaults to GPT-2's. With ``want``, the
    launches of ``cfg``'s loss and gradient must be exactly those (every
    kernel not named: 0)."""
    import contextlib

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map
    from ray_tpu_torch.parallel import use_mesh

    loss_fn = gpt2.loss_fn if loss_fn is None else loss_fn

    def loss_and_grads(c):
        params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          init)
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            loss = loss_fn(params, *small, c)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        return float(loss.detach()), grads

    before = _counts()
    loss, grads = loss_and_grads(cfg)
    launches = {k: v - before[k] for k, v in _counts().items()}
    ref_loss, ref_grads = loss_and_grads(ref_cfg)
    errs = {n: rel_err(g, r)
            for n, g, r in zip(_leaf_names(init), grads, ref_grads)}
    worst = max(errs, key=errs.get)
    check = dict(loss=loss, ref_loss=ref_loss, loss_abs_err=abs(loss - ref_loss),
                 grad_rel_err=errs, worst_leaf=worst, launches=launches)
    print(f"train_check {label} " + json.dumps(check), flush=True)
    if want is not None and launches != {k: want.get(k, 0) for k in launches}:
        fail(f"B=2 {label} launched {launches}, expected {want}")
    if not np.isfinite(loss) or abs(loss - ref_loss) > LOSS_ATOL:
        fail(f"B=2 {label} loss {loss} vs {ref_loss} (tol {LOSS_ATOL})")
    if errs[worst] > GRAD_RTOL:
        fail(f"B=2 {label} gradient {worst} off by {errs[worst]} of its "
             f"largest entry (tol {GRAD_RTOL})")
    return check


def phase_train_ring(peaks: Tuple[float, float], card: str
                     ) -> Dict[str, object]:
    """GPT-2 124M through attn_impl="ring" on a seq axis of W=4 folded onto
    the card: five steps from the splash run's start, then B=2 steps of the
    ring and of Ulysses against the splash path."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_map
    from ray_tpu_torch.parallel import MeshSpec, jit_train_step

    W = RING_WORLD
    config = gpt2.GPTConfig(attn_impl="ring", remat_policy="attn_outside",
                            scan_layers=False)
    mesh = MeshSpec(seq=W)
    init, tokens, targets = _train_start(config)
    params = tree_map(lambda p: p.detach().clone(), init)
    optimizer = gpt2.make_optimizer(3e-4)
    step = jit_train_step(gpt2.make_train_step(config, optimizer), mesh=mesh)
    want = {"ring_attention_fwd": config.n_layer * W,
            "ring_attention_bwd": config.n_layer * W}
    run = _train_steps("ring", config, step, params, optimizer.init(params),
                       tokens, targets, want, peaks, card)
    run.update(attn_impl="ring", seq_axis=W)
    print("train " + json.dumps(run), flush=True)
    del params, step
    torch.cuda.empty_cache()

    small = (tokens[:2], targets[:2])
    splash = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    checks = {label: _check_step_against(
        label, dataclasses.replace(config, attn_impl=label), splash, init,
        small, mesh) for label in ("ring", "ulysses")}
    torch.cuda.empty_cache()
    return dict(run=run, checks=checks)


def phase_train(peaks: Tuple[float, float], card: str) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import fused_ce
    from ray_tpu_torch.optim import tree_leaves, tree_map

    config = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    init, tokens, targets = _train_start(config)
    result: Dict[str, object] = {"launches": {}}

    def fresh():
        return tree_map(lambda p: p.detach().clone(), init)

    # (i) Five steps with each loss from the same start: the main path.
    for impl in ("dense", "fused"):
        cfg = dataclasses.replace(config, loss_impl=impl)
        params = fresh()
        optimizer = gpt2.make_optimizer(3e-4)
        step = gpt2.make_train_step(cfg, optimizer)
        want = {"splash_attention_fwd": config.n_layer,
                "splash_attention_bwd": config.n_layer,
                **{k: int(impl == "fused") for k in fused_ce.LAUNCHES}}
        run = _train_steps(impl, config, step, params, optimizer.init(params),
                           tokens, targets, want, peaks, card)
        run = dict(loss_impl=impl, **run)
        result[impl] = run
        result["launches"][impl] = run["launches"]
        print("train " + json.dumps(run), flush=True)
        del params, step
        torch.cuda.empty_cache()

    # (ii) One B=2 step of the kernel paths against plain attention, the
    # dense loss and full remat, on the same weights.
    small = (tokens[:2], targets[:2])

    def loss_and_grads(cfg):
        params = tree_map(lambda p: p.requires_grad_(True), fresh())
        loss = gpt2.loss_fn(params, *small, cfg)
        return (float(loss.detach()),
                torch.autograd.grad(loss, tree_leaves(params)))

    plain = dataclasses.replace(config, attn_impl="xla", loss_impl="dense",
                                remat_policy="full")
    result["checks"] = {
        "dense": _check_step_against("dense", config, plain, init, small),
        # The fused loss keeps fp32 logits: hold it to fp32 dense logits.
        "fused": _check_step_against(
            "fused", dataclasses.replace(config, loss_impl="fused"),
            dataclasses.replace(plain, logits_dtype=torch.float32), init,
            small)}

    # (iii) remat_policy="full" checkpoints each block whole, so the backward
    # reruns its splash forward: twice attn_outside's forward launches, the
    # same backward launches and the same gradients.
    _, split_grads = loss_and_grads(config)
    before = _counts()
    _, full_grads = loss_and_grads(
        dataclasses.replace(config, remat_policy="full"))
    delta = {k: v - before[k] for k, v in _counts().items()}
    full = dict(launches=delta,
                grads_equal=all(torch.equal(a, b)
                                for a, b in zip(full_grads, split_grads)),
                grad_rel_err=max(rel_err(a, b)
                                 for a, b in zip(full_grads, split_grads)))
    print("train_full_remat " + json.dumps(full), flush=True)
    if (delta["splash_attention_fwd"] != 2 * config.n_layer
            or delta["splash_attention_bwd"] != config.n_layer):
        fail(f"remat_policy='full' launched {delta}; expected "
             f"{2 * config.n_layer} splash forwards, {config.n_layer} "
             "backwards")
    # The kernels and the matmuls are deterministic: remat reruns the same
    # forward, so the gradients must be equal bit for bit.
    if not full["grads_equal"]:
        fail(f"remat_policy='full' changed the gradients: {full}")
    result["full_remat"] = full
    torch.cuda.empty_cache()
    return result


# The other model families at full width (phase 15, ``models`` line).
LLAMA_BATCH = 16
MOE_BATCH = 8
VIT_BATCH = 64
MODEL_LR = 3e-4
# (B, S, H, hd): Llama's attention (8 query heads, k and v repeated from 4
# kv heads, q and k from RoPE) and MoE's (q, k, v split from a fused qkv),
# each kernel held to its plain version there; Llama's timed alone.
LLAMA_ATTN_SHAPE = (16, 1024, 8, 64)
MOE_ATTN_SHAPE = (8, 1024, 8, 64)
# The MLP on tests/test_torch_train.py's data: 3 epochs of Adam at 1e-3 in
# batches of 128, to that test's accuracy bar.
MLP_EPOCHS = 3
MLP_ACC_FLOOR = 0.5


def _model_tokens(config, rows: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, config.vocab_size, (rows, config.seq_len + 1)),
        dtype=torch.long, device="cuda")
    return toks[:, :-1], toks[:, 1:]


def _llama_attention_inputs(B: int, S: int, H: int, hd: int, kv: int):
    """q, k, v as ``models/llama.py:_block`` hands them to the kernel: q and
    k through ``_rope``, k and v ``repeat_interleave``d from ``kv`` heads;
    the pre-repeat leaves require grad."""
    import torch

    from ray_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(20)
    leaves = [torch.randn((B, S, n, hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16, requires_grad=True)
              for n in (H, kv, kv)]
    q, k = (llama._rope(t, 10000.0) for t in leaves[:2])
    k, v = (t.repeat_interleave(H // kv, dim=2) for t in (k, leaves[2]))
    return leaves, q, k, v


def _models_kernels(peaks: Tuple[float, float]) -> Dict[str, object]:
    """Rows 1 and 2 at the Llama and MoE shapes against their plain
    versions; at Llama's, each timed alone beside SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    out: Dict[str, object] = {}
    for label, (B, S, H, hd) in (("llama", LLAMA_ATTN_SHAPE),
                                 ("moe", MOE_ATTN_SHAPE)):
        if label == "llama":
            leaves, q, k, v = _llama_attention_inputs(B, S, H, hd, H // 2)
        else:
            q, k, v = (t.detach().requires_grad_(True)
                       for t in _qkv(torch.Generator(
                           device="cuda").manual_seed(21), B, S, H, hd))
            leaves = [q, k, v]
        do = torch.randn((B, S, H, hd), generator=torch.Generator(
            device="cuda").manual_seed(22), device="cuda",
            dtype=torch.bfloat16)
        o, lse = attention.splash_attention(q, k, v, return_lse=True)
        grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.attention_reference(q, k, v)
        refs = attention.attention_bwd_reference(q, k, v, o, lse, do)
        row = dict(B=B, S=S, H=H, hd=hd, causal=True,
                   max_abs_err=(o.float() - o_ref.float()).abs().max().item(),
                   lse_max_abs_err=(lse - lse_ref).abs().max().item(),
                   **{f"{n}_rel_err": rel_err(g, r)
                      for n, g, r in zip(("dq", "dk", "dv"), grads, refs)})
        if not (torch.isfinite(o).all()
                and all(torch.isfinite(g).all() for g in grads)):
            fail(f"non-finite splash output at the {label} shape")
        if row["max_abs_err"] > O_ATOL or row["lse_max_abs_err"] > LSE_ATOL:
            fail(f"splash forward disagrees at the {label} shape: {row}")
        if max(row[f"{n}_rel_err"] for n in ("dq", "dk", "dv")) > BWD_RTOL:
            fail(f"splash backward disagrees at the {label} shape: {row}")
        if label == "llama":
            qd, kd, vd, od = (t.detach() for t in (q, k, v, o))
            qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                          for t in (qd, kd, vd))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2).contiguous()
            fwd_bound = attention_bound(B, S, H, hd, True, *peaks)
            bwd_bound = attention_bwd_bound(B, S, H, hd, True, *peaks)
            sdpa_bwd, _ = profiled_ms(lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), dot, retain_graph=True))
            row.update(
                fwd_ms=device_ms(lambda: attention.splash_attention(
                    qd, kd, vd)),
                fwd_plain_ms=device_ms(lambda: attention.attention_reference(
                    qd, kd, vd), iters=5),
                fwd_library_ms=device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)),
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                bwd_ms=device_ms(lambda: attention.splash_attention_bwd(
                    qd, kd, vd, od, lse, do)),
                bwd_plain_ms=device_ms(
                    lambda: attention.attention_bwd_reference(
                        qd, kd, vd, od, lse, do), iters=3),
                bwd_library_ms=sdpa_bwd, bwd_library_ms_by="profiler",
                bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
            del qt, kt, vt, sdpa, dot
        out[label] = row
        print(f"models_kernel {label} " + json.dumps(row), flush=True)
        del leaves, q, k, v, o, lse, grads, o_ref, lse_ref, refs, do
    torch.cuda.empty_cache()
    return out


def _llama_forward_check(config, params, tokens) -> Dict[str, object]:
    """Llama's forward at B=16: exactly n_layer splash forwards, logits held
    to the same model with plain attention by the serving tie rule."""
    import torch

    from ray_tpu_torch.models import llama

    with torch.no_grad():
        _reset_counts()
        t0 = time.perf_counter()
        logits = llama.forward(params, tokens, config)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        launches = _counts()
        want = {k: 0 for k in launches}
        want["splash_attention_fwd"] = config.n_layer
        if launches != want:
            fail(f"llama forward launched {launches}, expected {want}")
        if logits.shape != (*tokens.shape, config.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"llama logits {tuple(logits.shape)} or non-finite")
        ref = llama.forward(params, tokens,
                            dataclasses.replace(config, attn_impl="xla"))
        err = (logits - ref).abs().max().item()
        chosen = logits.argmax(-1, keepdim=True)
        gap = (ref.max(-1).values - ref.gather(-1, chosen)[..., 0]).max().item()
    del logits, ref
    torch.cuda.empty_cache()
    res = dict(launches=launches, max_abs_err=err, worst_gap=gap,
               forward_s=forward_s)
    if err > LOGIT_ATOL or gap > LOGIT_ATOL:
        fail(f"llama forward against plain attention: max|dlogit| {err}, "
             f"worst chosen gap {gap} (tol {LOGIT_ATOL})")
    return res


def _moe_flops_per_token(config) -> float:
    """6 x the parameters a token's forward multiplies by (every expert's
    weights top_k / n_experts times) + attention's 12 L D S. The dispatch
    and combine products against the (N, E, C) one-hots are not counted."""
    from ray_tpu_torch.models import moe

    D, L, F_ = config.d_model, config.n_layer, config.expert_mlp
    E, K = config.n_experts, config.top_k
    expert = E * D * F_ + E * F_ + E * F_ * D + E * D
    active = moe.num_params(config) - L * expert + L * expert * K / E
    return 6.0 * active + 12.0 * L * D * config.seq_len


def _moe_choices(params, tokens, config):
    """Each layer's top-k experts per token (sorted), read at the router's
    input during a no-grad forward; and the aux loss."""
    import torch

    from ray_tpu_torch.models import moe

    seen, route = [], moe._route

    def recording(x32, router_w, cfg):
        probs = torch.softmax(x32 @ router_w, dim=-1)
        seen.append(probs.topk(cfg.top_k, dim=-1).indices.sort(-1).values)
        return route(x32, router_w, cfg)

    moe._route = recording
    try:
        with torch.no_grad():
            _, aux = moe.forward(params, tokens, config)
    finally:
        moe._route = route
    return torch.stack(seen), float(aux)


def phase_models(peaks: Tuple[float, float], card: str) -> Dict[str, object]:
    """Llama, MoE, ViT and the MLP at full width on the card (see the
    module docstring, phase 15)."""
    import numpy as np
    import torch

    from ray_tpu_torch import optim
    from ray_tpu_torch.models import llama, mlp, moe, vit
    from ray_tpu_torch.optim import tree_map
    from ray_tpu_torch.parallel import MeshSpec

    t_phase = time.perf_counter()
    result: Dict[str, object] = {"card": card}

    def fresh(init):
        return tree_map(lambda p: p.detach().clone(), init)

    # Llama: forward, five steps at B=16, then B=2 against each path.
    config = llama.LlamaConfig()
    init = llama.init_params(config, seed=0, device="cuda")
    tokens, targets = _model_tokens(config, LLAMA_BATCH)
    fwd = _llama_forward_check(config, init, tokens)
    optimizer = llama.make_optimizer(MODEL_LR)
    params = fresh(init)
    L = config.n_layer
    splash = {"splash_attention_fwd": 2 * L, "splash_attention_bwd": L}
    run = _train_steps("llama", config, llama.make_train_step(
        config, optimizer), params, optimizer.init(params), tokens, targets,
        splash, peaks, card, flops_per_token=llama.flops_per_token(config))
    del params
    torch.cuda.empty_cache()
    small = (tokens[:2], targets[:2])
    W = RING_WORLD
    checks = {"xla": _check_step_against(
        "llama", config, dataclasses.replace(config, attn_impl="xla"), init,
        small, loss_fn=llama.loss_fn, want=splash)}
    for impl, mesh, want in (
            ("pallas", None, splash),
            # The whole-layer checkpoint reruns each layer's ring forward.
            ("ring", MeshSpec(seq=W), {"ring_attention_fwd": 2 * L * W,
                                       "ring_attention_bwd": L * W}),
            # Ulysses runs plain attention on the head shards, as JAX does.
            ("ulysses", MeshSpec(seq=W), {})):
        checks[impl] = _check_step_against(
            f"llama_{impl}", dataclasses.replace(config, attn_impl=impl),
            config, init, small, mesh=mesh, loss_fn=llama.loss_fn, want=want)
    result["llama"] = dict(forward=fwd, run=run, checks=checks,
                           num_params=llama.num_params(config))
    print("models_llama " + json.dumps(result["llama"]), flush=True)
    del init
    torch.cuda.empty_cache()

    # MoE: five steps at B=8, then B=2 against plain attention.
    config = moe.MoEConfig()
    init = moe.init_params(config, seed=0, device="cuda")
    tokens, targets = _model_tokens(config, MOE_BATCH)
    optimizer = optim.make_optimizer(MODEL_LR)
    params = fresh(init)
    L = config.n_layer
    run = _train_steps("moe", config, moe.make_train_step(config, optimizer),
                       params, optimizer.init(params), tokens, targets,
                       {"splash_attention_fwd": 2 * L,
                        "splash_attention_bwd": L}, peaks, card,
                       flops_per_token=_moe_flops_per_token(config))
    del params
    torch.cuda.empty_cache()
    small = (tokens[:2], targets[:2])
    plain = dataclasses.replace(config, attn_impl="xla")
    with torch.no_grad():
        loss, ref_loss = (float(moe.loss_fn(init, *small, c))
                          for c in (config, plain))
    choices, aux = _moe_choices(init, small[0], config)
    ref_choices, ref_aux = _moe_choices(init, small[0], plain)
    flips = int((choices != ref_choices).any(-1).sum())
    check = dict(loss=loss, ref_loss=ref_loss, loss_abs_err=abs(loss - ref_loss),
                 aux=aux, ref_aux=ref_aux, topk_differs=flips,
                 token_layers=int(choices.shape[0] * choices.shape[1]),
                 capacity=config.capacity(MOE_BATCH * config.seq_len))
    if not np.isfinite(aux) or abs(loss - ref_loss) > LOSS_ATOL:
        fail(f"MoE B=2 against plain attention: {check} (tol {LOSS_ATOL})")
    result["moe"] = dict(run=run, check=check,
                         num_params=moe.num_params(config))
    print("models_moe " + json.dumps(result["moe"]), flush=True)
    del init
    torch.cuda.empty_cache()

    # ViT-B/16: five steps at B=64 under its own optimizer; no kernel.
    config = vit.ViTConfig.base()
    params = vit.init_params(config, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.normal(size=(
        VIT_BATCH, config.image_size, config.image_size, 3)).astype(
            np.float32), device="cuda")
    labels = torch.as_tensor(rng.integers(0, config.num_classes, VIT_BATCH),
                             device="cuda")
    optimizer = vit.make_optimizer(MODEL_LR)
    run = _train_steps("vit", config, vit.make_train_step(config, optimizer),
                       params, optimizer.init(params), images, labels, {},
                       peaks, card, flops_per_token=0, per_row=1)
    run["images_per_s"] = run.pop("tokens_per_s")
    result["vit"] = dict(run=run, num_params=vit.num_params(config))
    print("models_vit " + json.dumps(result["vit"]), flush=True)
    del params, images
    torch.cuda.empty_cache()

    # The MLP on tests/test_torch_train.py's data, on the card and (the
    # same loop, the same weights) on the CPU.
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 784)).astype(np.float32)
    w = rng.normal(size=(784, 10)).astype(np.float32)
    y = np.argmax(x @ w + rng.normal(size=(512, 10)) * 0.1, axis=-1)
    accs = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda p: p.to(dev), mlp.init_params(0, device="cuda"))
        xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        optimizer = optim.AdamW(learning_rate=1e-3, weight_decay=0.0,
                                b2=0.999, grad_clip=math.inf,
                                mu_dtype=torch.float32)
        step = optim.make_step(mlp.loss_fn, optimizer)
        state = optimizer.init(params)
        _reset_counts()
        for _ in range(MLP_EPOCHS):
            for i in range(0, len(x), 128):
                params, state, _ = step(params, state, xt[i:i + 128],
                                        yt[i:i + 128])
        with torch.no_grad():
            accs[dev] = float(mlp.accuracy(params, xt, yt))
        if any(_counts().values()):
            fail(f"the MLP launched a port kernel: {_counts()}")
    result["mlp"] = dict(accuracy=accs["cuda"], cpu_accuracy=accs["cpu"])
    if accs["cuda"] <= MLP_ACC_FLOOR:
        fail(f"the MLP reached {accs} on the card (floor {MLP_ACC_FLOOR})")
    # Last: the SDPA backward's yardstick runs under torch.profiler.
    result["kernels"] = _models_kernels(peaks)
    result["seconds"] = time.perf_counter() - t_phase
    summary = dict(
        card=card, seconds=result["seconds"],
        llama_tokens_per_s=result["llama"]["run"]["tokens_per_s"],
        llama_mfu_pct=result["llama"]["run"]["mfu_pct"],
        moe_tokens_per_s=result["moe"]["run"]["tokens_per_s"],
        moe_mfu_pct=result["moe"]["run"]["mfu_pct"],
        vit_images_per_s=result["vit"]["run"]["images_per_s"],
        mlp=result["mlp"], moe_topk_differs=check["topk_differs"],
        launches={k: result[k]["run"]["launches"]
                  for k in ("llama", "moe", "vit")})
    print("models " + json.dumps(summary), flush=True)
    return result



# PPO on CartPole-v1 at examples/cartpole_ppo.py's configuration, until the
# mean return (over the last 20 iterations' episodes) reaches 450, for at
# most 150 iterations (2.6x the reference's 58).
RL_STOP_REWARD = 450.0
RL_MAX_ITERS = 150
# RL_NORTHSTAR.json: the reference's curve (mean return by iteration) and
# where it reached 450, on its 1-core CPU host; the card's run is compared
# with it, not timed against it.
RL_REF_CURVE = {0: 20.93, 10: 137.37, 25: 288.93}
RL_REF_REACHED = {"iteration": 57, "env_steps": 118784}
# Every weight of the card's update against the CPU's, and of two learners
# against one (fp32, TF32 off): sums in other orders over <= 512 rows and
# 16 Adam steps at lr 3e-4.
RL_ATOL = 1e-5
RL_BATCH = 512


def _rl_batch(module, n: int):
    """A PPO batch from numpy seed 0 for a CartPole-shaped module: the
    module's own log-probs plus noise (ratios leave the clip range), wide
    value targets, ``kl_coeff`` 0.2."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import Columns
    from ray_tpu_torch.rl.core.rl_module import Categorical

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, n).astype(np.int32)
    with torch.no_grad():
        logits = module.forward_train(obs)[Columns.ACTION_DIST_INPUTS]
        logp = Categorical.logp(logits, torch.from_numpy(actions)).numpy()
    return {Columns.OBS: obs, Columns.ACTIONS: actions,
            Columns.ACTION_LOGP: (logp + rng.normal(0.1, 0.4, n)).astype(np.float32),
            Columns.ADVANTAGES: rng.normal(size=n).astype(np.float32),
            Columns.VALUE_TARGETS: (rng.normal(size=n) * 4).astype(np.float32),
            "kl_coeff": np.float32(0.2)}


def _rl_max_diff(a, b) -> float:
    return max(float((a[k].detach().cpu() - b[k].detach().cpu()).abs().max())
               for k in a)


def phase_rl_ppo(card: str, device: str = "cuda") -> Dict[str, object]:
    """The RL path on the card (see the module docstring, phase 16)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.rl import (DefaultActorCritic, LearnerGroup, RLModuleSpec,
                                  SingleAgentEnvRunner)
    from ray_tpu_torch.rl.algorithms import PPOConfig, PPOLearner

    t_phase = time.perf_counter()
    result: Dict[str, object] = {"card": card}
    _reset_counts()
    ray_tpu_torch.init()
    try:
        # (a) The north star: examples/cartpole_ppo.py to a mean of 450.
        config = (PPOConfig().environment("CartPole-v1")
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                               rollout_fragment_length=64)
                  .training(train_batch_size=2048, minibatch_size=128,
                            num_epochs=8, lr=3e-4, entropy_coeff=0.001,
                            vf_clip_param=10.0, lambda_=0.95, gamma=0.99)
                  .resources(device=device)
                  .debugging(seed=0))
        t0 = time.perf_counter()
        algo = config.build_algo()
        setup_s = time.perf_counter() - t0
        curve, reached, steps_before, updates = [], None, 0, 0
        timers = {"sample_s": [], "learn_s": [], "update_s": []}
        t_train = time.perf_counter()
        for it in range(RL_MAX_ITERS):
            res = algo.train()
            ret = res.get("episode_return_mean", float("nan"))
            steps = res["num_env_steps_sampled_lifetime"]
            n = steps - steps_before
            steps_before = steps
            updates += config.num_epochs * math.ceil(n / config.minibatch_size)
            for k in timers:
                timers[k].append(res["timers"][k])
            curve.append({"iteration": it, "env_steps": steps,
                          "return_mean": ret})
            if ret >= RL_STOP_REWARD:
                reached = it
                break
        train_s = time.perf_counter() - t_train
        iters = len(curve)
        a = dict(
            card=card, device=str(algo.device), reached=reached is not None,
            reached_at_iteration=reached, iterations=iters,
            env_steps=steps_before, train_s=train_s, setup_s=setup_s,
            env_steps_per_s=steps_before / train_s,
            sample_env_steps_per_s=steps_before / sum(timers["sample_s"]),
            updates=updates, updates_per_s=updates / sum(timers["update_s"]),
            sample_s_per_iter=statistics.median(timers["sample_s"]),
            learn_s_per_iter=statistics.median(timers["learn_s"]),
            update_s_per_iter=statistics.median(timers["update_s"]),
            first_iter_s={k: v[0] for k, v in timers.items()},
            sample_share=sum(timers["sample_s"]) / (
                sum(timers["sample_s"]) + sum(timers["learn_s"])),
            returns={str(i): (curve[i]["return_mean"] if i < iters else None)
                     for i in RL_REF_CURVE},
            reference_returns={str(i): v for i, v in RL_REF_CURVE.items()},
            reference_reached=RL_REF_REACHED,
            curve_every_5=[c for c in curve if c["iteration"] % 5 == 0])
        result["ppo"] = a
        print("rl_ppo_a " + json.dumps(a), flush=True)
        if reached is None:
            fail(f"PPO did not reach a mean return of {RL_STOP_REWARD} in "
                 f"{RL_MAX_ITERS} iterations: {curve[-1]}")

        # (d) Save and restore the trained algorithm: bit for bit.
        ckpt = algo.save()
        algo2 = config.copy().build_algo()
        algo2.restore(ckpt)
        saved, restored = algo.get_weights(), algo2.get_weights()
        opt_a = algo.learner_group.get_state()["opt_state"]["state"]
        opt_b = algo2.learner_group.get_state()["opt_state"]["state"]
        d = dict(card=card, weights_equal=all(
            torch.equal(saved[k], restored[k]) for k in saved) and list(saved)
            == list(restored), opt_state_equal=all(
            torch.equal(opt_a[p][k], opt_b[p][k]) for p in opt_a
            for k in opt_a[p]), restored_device=str(
            next(iter(restored.values())).device))
        result["restore"] = d
        print("rl_ppo_d " + json.dumps(d), flush=True)
        if not (d["weights_equal"] and d["opt_state_equal"]):
            fail(f"PPO's restored state differs from the saved one: {d}")
        algo.stop()
        algo2.stop()

        # (b) One update on the card against the same update on the CPU.
        spec = RLModuleSpec(module_class=DefaultActorCritic,
                            observation_dim=4, action_dim=2)
        batch = _rl_batch(spec.build(device="cpu"), RL_BATCH)
        cfg = PPOConfig().training(grad_clip=0.5)
        learners, metrics = {}, {}
        for dev in ("cpu", device):
            learners[dev] = PPOLearner(
                config=cfg.copy().resources(device=dev), module_spec=spec,
                seed=0)
        if _rl_max_diff(learners["cpu"].get_weights(),
                        learners[device].get_weights()) != 0.0:
            fail("PPO learners from one seed start from other weights on "
                 "the card and the CPU")
        for dev, learner in learners.items():
            t0 = time.perf_counter()
            metrics[dev] = learner.update_from_batch(
                dict(batch), num_epochs=2, minibatch_size=64)
            metrics[dev]["update_s"] = time.perf_counter() - t0
        b = dict(card=card, rows=RL_BATCH, epochs=2, minibatch=64,
                 max_abs_err=_rl_max_diff(learners["cpu"].get_weights(),
                                          learners[device].get_weights()),
                 atol=RL_ATOL, metrics=metrics, moved=_rl_max_diff(
                     learners["cpu"].get_weights(),
                     spec.build(device="cpu").state_dict()))
        # The runner's sampler: one seed draws the same uniforms on the
        # card and on the CPU (a host generator), so with the same weights
        # both take the same 2048 steps.
        episodes = {}
        for dev in ("cpu", device):
            runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=spec,
                                          num_envs=8, seed=0, device=dev)
            runner.set_state({"params": learners["cpu"].get_weights()})
            episodes[dev] = [ep.to_numpy() for ep in
                             runner.sample(num_timesteps=2048)]
        pairs = list(zip(episodes["cpu"], episodes[device]))
        b["runner"] = dict(
            episodes=len(pairs), steps=sum(len(x["actions"]) for x, _ in pairs),
            same_steps=len(episodes["cpu"]) == len(episodes[device]) and all(
                np.array_equal(x[k], y[k]) for x, y in pairs
                for k in ("obs", "actions", "rewards")),
            logp_max_abs_err=max(float(np.abs(
                x["action_logp"] - y["action_logp"]).max()) for x, y in pairs))
        result["card_vs_cpu"] = b
        print("rl_ppo_b " + json.dumps(b), flush=True)
        if not b["max_abs_err"] <= RL_ATOL or b["moved"] < 1e-4:
            fail(f"PPO's update on the card differs from the CPU's: {b}")
        if not b["runner"]["same_steps"] or \
                not b["runner"]["logp_max_abs_err"] <= RL_ATOL:
            fail(f"the runner's steps on the card differ from the CPU's: {b}")

        # (c) Two thread learners on the card, their gradients all-reduced
        # through the collective, against one learner on the same batch.
        # Whole-batch steps: each learner permutes its own shard, so only
        # a step over the whole shard sees the rows one learner's step sees.
        groups = {}
        for num_learners in (0, 2):
            groups[num_learners] = LearnerGroup(
                learner_class=PPOLearner,
                config=cfg.copy().resources(device=device), module_spec=spec,
                num_learners=num_learners, seed=0)
        for g in groups.values():
            g.update_from_batch(dict(batch), num_epochs=2, minibatch_size=None)
        c = dict(card=card, max_abs_err=_rl_max_diff(groups[0].get_weights(),
                                                     groups[2].get_weights()),
                 atol=RL_ATOL)
        groups[2].stop()
        # Then the whole loop with two remote runners and two learners.
        two = (config.copy().env_runners(num_env_runners=2,
                                         num_envs_per_env_runner=4)
               .learners(num_learners=2))
        algo = two.build_algo()
        runs = [algo.train() for _ in range(2)]
        algo.stop()
        c["two_runners_two_learners"] = [
            dict(env_steps=r["num_env_steps_sampled_lifetime"],
                 total_loss=r["learners"]["total_loss"],
                 return_mean=r.get("episode_return_mean")) for r in runs]
        result["two_learners"] = c
        print("rl_ppo_c " + json.dumps(c), flush=True)
        if not c["max_abs_err"] <= RL_ATOL:
            fail(f"two learners on the card differ from one: {c}")
        if [r["env_steps"] for r in c["two_runners_two_learners"]] != [2048, 4096] \
                or not all(math.isfinite(r["total_loss"])
                           for r in c["two_runners_two_learners"]):
            fail(f"PPO with two runners and two learners: {c}")
    finally:
        ray_tpu_torch.shutdown()

    # (e) The RL path launches none of the port's kernels.
    result["launches"] = _counts()
    if any(result["launches"].values()):
        fail(f"the RL path launched a port kernel: {result['launches']}")
    result["seconds"] = time.perf_counter() - t_phase
    summary = dict(
        card=card, seconds=result["seconds"], reached=a["reached"],
        reached_at_iteration=a["reached_at_iteration"],
        env_steps=a["env_steps"], train_s=a["train_s"],
        env_steps_per_s=a["env_steps_per_s"], updates_per_s=a["updates_per_s"],
        sample_s_per_iter=a["sample_s_per_iter"],
        learn_s_per_iter=a["learn_s_per_iter"],
        returns=a["returns"], reference_returns=a["reference_returns"],
        card_vs_cpu_max_abs_err=b["max_abs_err"],
        runner_same_steps=b["runner"]["same_steps"],
        two_learners_max_abs_err=c["max_abs_err"],
        restore_bit_for_bit=d["weights_equal"] and d["opt_state_equal"],
        launches=result["launches"])
    print("rl_ppo " + json.dumps(summary), flush=True)
    return result


# rl_extras: the reference tests' own gates (tests/test_rl.py,
# tests/test_rl_extras.py, tests/test_rl_pixel.py,
# tests/test_rl_multi_agent.py), at their configurations and seed 0.
RLX_IMPALA_BEST, RLX_IMPALA_ITERS = 35.0, 300
RLX_APPO_BEST, RLX_APPO_ITERS = 60.0, 200
RLX_PIXEL_BEST, RLX_PIXEL_ITERS = 0.5, 45
RLX_MA_BEST, RLX_MA_ITERS = 60.0, 12
RLX_BC_LOGP, RLX_BC_AGREE, RLX_BC_RETURN = -0.35, 0.9, 100.0
RLX_MARWIL_AGREE = 0.75
# One SAC update at (256, 256) on the card against the CPU, the same noise
# injected into both: Adam's first step moves each weight by lr * g /
# (|g| + eps), so an entry whose gradient is near its rounding noise can
# move by a share of lr (3e-4) on one device and not on the other.
SAC_ATOL = 1e-4


def _rlx_count(algo) -> Dict[str, float]:
    """Count the local learners' minibatch updates and time their
    ``update_from_batch`` calls (each ends in one copy of its metrics to
    the host, so the time covers the device's work)."""
    learners = ([g._local for g in algo.learner_groups.values()]
                if hasattr(algo, "learner_groups")
                else [algo.learner_group._local])
    stats = {"updates": 0, "update_s": 0.0}
    for learner in learners:
        def counted(mb, inner=learner._update):
            stats["updates"] += 1
            return inner(mb)

        def timed(*args, inner=learner.update_from_batch, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                stats["update_s"] += time.perf_counter() - t0

        learner._update = counted
        learner.update_from_batch = timed
    return stats


def _rlx_learn(card, name, algo, gate, max_iters, at_least=False,
               ret_of=lambda r: r.get("episode_return_mean")):
    """Train until the best mean return passes ``gate`` (``>=`` with
    ``at_least``) or ``max_iters`` iterations; the gate's iteration, env
    steps, env steps/s and updates/s."""
    stats = _rlx_count(algo)
    best, reached, res = -math.inf, None, {}
    t0 = time.perf_counter()
    for it in range(max_iters):
        res = algo.train()
        ret = ret_of(res)
        if ret is not None and ret == ret:
            best = max(best, ret)
        if best >= gate if at_least else best > gate:
            reached = it
            break
    train_s = time.perf_counter() - t0
    steps = res.get("num_env_steps_sampled_lifetime", 0)
    out = dict(card=card, algo=name, gate=gate, best=best,
               reached=reached is not None, reached_at_iteration=reached,
               iterations=max_iters if reached is None else reached + 1,
               env_steps=steps, train_s=train_s,
               env_steps_per_s=steps / train_s, updates=stats["updates"],
               updates_per_s=(stats["updates"] / stats["update_s"]
                              if stats["update_s"] else None),
               update_s=stats["update_s"])
    return out, res


def _rlx_iterations(card, name, algo, iters):
    """``iters`` iterations; the last result, env steps/s and updates/s."""
    stats = _rlx_count(algo)
    t0 = time.perf_counter()
    results = [algo.train() for _ in range(iters)]
    train_s = time.perf_counter() - t0
    steps = results[-1].get("num_env_steps_sampled_lifetime", 0)
    return dict(card=card, algo=name, iterations=iters, env_steps=steps,
                train_s=train_s, env_steps_per_s=steps / train_s,
                updates=stats["updates"],
                updates_per_s=(stats["updates"] / stats["update_s"]
                               if stats["update_s"] else None),
                update_s=stats["update_s"]), results


def _rlx_card_vs_cpu(make, batch, device, noise=None, **update_kw):
    """One learner per device from one seed (so one set of weights), the
    same batch through ``update_from_batch`` (and, with ``noise``, the same
    noise in place of each learner's draw): the largest weight difference,
    and how far the update moved the weights."""
    learners = {}
    for dev in ("cpu", device):
        learners[dev] = make(dev)
        if noise is not None:
            learners[dev]._draw_noise = (
                lambda b, dev=dev: {k: v.to(dev) for k, v in noise.items()})
    start = {k: v.clone() for k, v in learners["cpu"].module.state_dict().items()}
    if _rl_max_diff(start, learners[device].module.state_dict()) != 0.0:
        fail("RL learners from one seed start from other weights on the "
             "card and the CPU")
    for learner in learners.values():
        learner.update_from_batch(dict(batch), **update_kw)
    after = learners["cpu"].module.state_dict()
    return learners, dict(
        max_abs_err=_rl_max_diff(after, learners[device].module.state_dict()),
        moved=_rl_max_diff(after, start))


def _rlx_cartpole(n_steps, mixed):
    """Transitions of the port's CartPole-v1 under the reference tests'
    scripted expert, or half expert and half random (numpy seed 0), in
    memory (the card's machine has no pyarrow for the files)."""
    import numpy as np

    from ray_tpu_torch.rl.connectors import episodes_to_transitions
    from ray_tpu_torch.rl.env import cartpole
    from ray_tpu_torch.rl.env.episode import SingleAgentEpisode

    env = cartpole.make("CartPole-v1")
    rng = np.random.default_rng(0)
    episodes, steps = [], 0
    while steps < n_steps:
        obs, _ = env.reset(seed=steps)
        ep = SingleAgentEpisode()
        ep.add_env_reset(np.asarray(obs, np.float32))
        done = False
        while not done:
            if not mixed or rng.random() < 0.5:
                act = int(obs[2] + obs[3] > 0)
            else:
                act = int(rng.integers(0, 2))
            obs, reward, term, trunc, _ = env.step(act)
            ep.add_env_step(np.asarray(obs, np.float32), act, reward,
                            terminated=term, truncated=trunc)
            steps += 1
            done = term or trunc
        episodes.append(ep)
    return episodes_to_transitions(episodes)


def _rlx_pendulum(n_steps):
    """The reference test's random Pendulum-v1 transitions (reset seeds by
    step count, uniform torques from numpy seed 0), in memory."""
    import numpy as np

    from ray_tpu_torch.rl.connectors import episodes_to_transitions
    from ray_tpu_torch.rl.env import cartpole
    from ray_tpu_torch.rl.env.episode import SingleAgentEpisode

    env = cartpole.make("Pendulum-v1")
    rng = np.random.default_rng(0)
    episodes, steps = [], 0
    while steps < n_steps:
        obs, _ = env.reset(seed=steps)
        ep = SingleAgentEpisode()
        ep.add_env_reset(np.asarray(obs, np.float32))
        done = False
        while not done and steps < n_steps + 200:
            act = rng.uniform(-2, 2, size=(1,)).astype(np.float32)
            obs, reward, term, trunc, _ = env.step(act)
            ep.add_env_step(np.asarray(obs, np.float32), act, reward,
                            terminated=term, truncated=trunc)
            steps += 1
            done = term or trunc
        episodes.append(ep)
    return episodes_to_transitions(episodes)


def _rlx_agreement(algo, seed) -> float:
    """Greedy agreement with the scripted expert on 512 fresh states."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import Columns

    module = algo.learner_group._local.module
    obs = np.random.default_rng(seed).uniform(-1, 1, (512, 4)).astype(np.float32)
    with torch.no_grad():
        inputs = module.forward_inference(obs)[Columns.ACTION_DIST_INPUTS]
        greedy = module.action_dist.deterministic(inputs).cpu().numpy()
    expert = (obs[:, 2] + obs[:, 3] > 0).astype(np.int64)
    return float((greedy == expert).mean())


def _rlx_vtrace_batch(seed):
    """A (B, T) V-trace batch of padded CartPole-shaped fragments from numpy
    ``seed`` (behaviour log-probs near the module's, a bootstrap value)."""
    import numpy as np

    from ray_tpu_torch.rl import Columns, SingleAgentEpisode
    from ray_tpu_torch.rl.algorithms.impala import build_vtrace_batch

    rng = np.random.default_rng(seed)
    episodes = []
    for i, n in enumerate((50, 37, 50, 12, 25, 50, 8, 44)):
        ep = SingleAgentEpisode()
        ep.add_env_reset(rng.normal(size=4).astype(np.float32))
        for t in range(n):
            ep.add_env_step(rng.normal(size=4).astype(np.float32),
                            int(rng.integers(0, 2)), 1.0,
                            terminated=(i % 3 == 0 and t == n - 1),
                            extra={Columns.ACTION_LOGP: float(
                                -0.69 + 0.2 * rng.normal())})
        episodes.append(ep)
    batch = build_vtrace_batch(episodes, 25, 0.99)
    batch.pop("bootstrap_obs")
    batch.pop("bootstrap_terminated")
    batch["bootstrap_value"] = rng.normal(size=len(batch["mask"])).astype(np.float32)
    return batch


def phase_rl_extras(card: str, device: str = "cuda") -> Dict[str, object]:
    """The rest of the RL stack on the card (see the module docstring,
    phase 17)."""
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.rl import Columns, MultiAgentCartPole, RLModuleSpec
    from ray_tpu_torch.rl.algorithms import (APPOConfig, APPOLearner, BCConfig,
                                             CQLConfig, DQNConfig, DQNLearner,
                                             IMPALAConfig, IMPALALearner,
                                             MARWILConfig, PPOConfig, SACConfig,
                                             SACLearner)
    from ray_tpu_torch.rl.algorithms.sac import SACModule
    from ray_tpu_torch.rl.core.rl_module import (CNNActorCritic,
                                                 DefaultActorCritic,
                                                 DefaultQModule)
    from ray_tpu_torch.rl.env.pixel_gridworld import make_pixel_gridworld

    t_phase = time.perf_counter()
    result: Dict[str, object] = {"card": card}
    lines: Dict[str, Dict[str, object]] = {}

    def emit(key, line):
        lines[key] = line
        print(f"rl_extras_{key} " + json.dumps(line), flush=True)

    _reset_counts()
    ray_tpu_torch.init()
    try:
        # (a) DQN: tests/test_rl.py's plain and prioritized configurations.
        plain = (DQNConfig().environment("CartPole-v1")
                 .env_runners(num_env_runners=0, num_envs_per_env_runner=1,
                              rollout_fragment_length=8)
                 .training(train_batch_size=32, replay_buffer_capacity=2000,
                           num_steps_sampled_before_learning_starts=64,
                           target_network_update_freq=10)
                 .resources(device=device).debugging(seed=0))
        algo = plain.build_algo()
        dqn, results = _rlx_iterations(card, "dqn", algo, 12)
        algo.stop()
        dqn["replay_size"] = results[-1]["replay_size"]
        dqn["td_error_mean"] = results[-1]["learners"].get("td_error_mean")
        per_cfg = (DQNConfig().environment("CartPole-v1")
                   .env_runners(num_env_runners=0, rollout_fragment_length=8)
                   .training(train_batch_size=16, prioritized_replay=True,
                             replay_buffer_capacity=500,
                             num_steps_sampled_before_learning_starts=32,
                             target_network_update_freq=5)
                   .resources(device=device).debugging(seed=0))
        algo = per_cfg.build_algo()
        per, _ = _rlx_iterations(card, "dqn_per", algo, 8)
        prios = algo.replay._priorities[:len(algo.replay)]
        per["distinct_priorities"] = len(set(np.round(prios[prios > 0], 6)))
        algo.stop()
        rng = np.random.default_rng(0)
        n = 64
        q_batch = {Columns.OBS: rng.normal(size=(n, 4)).astype(np.float32),
                   Columns.ACTIONS: rng.integers(0, 2, n).astype(np.int64),
                   Columns.REWARDS: rng.normal(size=n).astype(np.float32),
                   Columns.NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
                   Columns.TERMINATEDS: (rng.random(n) < 0.2).astype(np.float32),
                   Columns.WEIGHTS: rng.uniform(0.2, 1, n).astype(np.float32)}
        q_spec = RLModuleSpec(module_class=DefaultQModule, observation_dim=4,
                              action_dim=2)
        learners, q_vs = _rlx_card_vs_cpu(
            lambda dev: DQNLearner(config=DQNConfig().training(
                target_network_update_freq=1).resources(device=dev),
                module_spec=q_spec, seed=0), q_batch, device)
        td = {dev: l.compute_td_errors(q_batch) for dev, l in learners.items()}
        q_vs["td_max_abs_err"] = float(np.abs(td["cpu"] - td[device]).max())
        q_vs["atol"] = RL_ATOL
        emit("a", dict(card=card, dqn=dqn, dqn_per=per, card_vs_cpu=q_vs))
        if not (dqn["replay_size"] > 64 and dqn["td_error_mean"] is not None):
            fail(f"DQN on the card: {dqn}")
        if per["distinct_priorities"] <= 1:
            fail(f"DQN's priorities were not refreshed: {per}")
        if not (q_vs["max_abs_err"] <= RL_ATOL and q_vs["td_max_abs_err"]
                <= RL_ATOL and q_vs["moved"] > 1e-5):
            fail(f"DQN's update on the card differs from the CPU's: {q_vs}")

        # (b) IMPALA through two aggregator actors, and APPO: the reference
        # tests' learning gates; one update of each on the card and the CPU.
        impala_cfg = (IMPALAConfig().environment("CartPole-v1")
                      .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                                   rollout_fragment_length=25)
                      .training(train_batch_size=100, num_aggregator_actors=2,
                                lr=1e-3, entropy_coeff=0.005)
                      .resources(device=device).debugging(seed=0))
        algo = impala_cfg.build_algo()
        impala, _ = _rlx_learn(card, "impala", algo, RLX_IMPALA_BEST,
                               RLX_IMPALA_ITERS, ret_of=lambda r: r.get(
                                   "env_runners", {}).get("episode_return_mean"))
        algo.stop()
        appo_cfg = (APPOConfig().environment("CartPole-v1")
                    .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                                 rollout_fragment_length=32)
                    .training(train_batch_size=256, lr=5e-4, entropy_coeff=0.01,
                              clip_param=0.3)
                    .resources(device=device).debugging(seed=0))
        algo = appo_cfg.build_algo()
        appo, res = _rlx_learn(card, "appo", algo, RLX_APPO_BEST,
                               RLX_APPO_ITERS)
        algo.stop()
        appo["mean_ratio"] = res["learners"].get("mean_ratio")
        appo["total_loss"] = res["learners"].get("total_loss", 0.0)
        ac_spec = RLModuleSpec(module_class=DefaultActorCritic,
                               observation_dim=4, action_dim=2)
        v_batch = _rlx_vtrace_batch(0)
        _, impala_vs = _rlx_card_vs_cpu(
            lambda dev: IMPALALearner(config=IMPALAConfig().resources(
                device=dev), module_spec=ac_spec, seed=0), v_batch, device)
        kl_batch = dict(v_batch, kl_coeff=np.float32(1.0))
        _, appo_vs = _rlx_card_vs_cpu(
            lambda dev: APPOLearner(config=APPOConfig().training(
                use_kl_loss=True).resources(device=dev), module_spec=ac_spec,
                seed=0), kl_batch, device)
        emit("b", dict(card=card, impala=impala, appo=appo,
                       impala_card_vs_cpu=impala_vs, appo_card_vs_cpu=appo_vs,
                       atol=RL_ATOL))
        if not impala["reached"]:
            fail(f"IMPALA through aggregators did not pass {RLX_IMPALA_BEST} "
                 f"in {RLX_IMPALA_ITERS} iterations: {impala}")
        if not (appo["reached"] and appo["mean_ratio"] is not None
                and math.isfinite(appo["total_loss"])):
            fail(f"APPO did not pass {RLX_APPO_BEST} in {RLX_APPO_ITERS} "
                 f"iterations: {appo}")
        for name, vs in (("IMPALA", impala_vs), ("APPO", appo_vs)):
            if not (vs["max_abs_err"] <= RL_ATOL and vs["moved"] > 1e-5):
                fail(f"{name}'s update on the card differs from the CPU's: {vs}")

        # (c) Pixel IMPALA: the CNN on the gridworld (tests/test_rl_pixel.py).
        pixel_cfg = (IMPALAConfig()
                     .environment(make_pixel_gridworld,
                                  env_config={"n": 4, "cell": 2,
                                              "max_steps": 16, "shaped": True})
                     .rl_module(module_class=CNNActorCritic,
                                model_config={"obs_shape": (8, 8, 3),
                                              "conv_filters": ((8, 3, 2),
                                                               (16, 3, 1)),
                                              "hiddens": (64,)})
                     .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                                  rollout_fragment_length=20)
                     .training(train_batch_size=160, lr=2e-3,
                               entropy_coeff=0.003)
                     .resources(device=device).debugging(seed=0))
        algo = pixel_cfg.build_algo()
        pixel, _ = _rlx_learn(card, "pixel_impala", algo, RLX_PIXEL_BEST,
                              RLX_PIXEL_ITERS, at_least=True,
                              ret_of=lambda r: r.get("env_runners", {}).get(
                                  "episode_return_mean"))
        algo.stop()
        emit("c", dict(card=card, pixel_impala=pixel))
        if not pixel["reached"]:
            fail(f"pixel IMPALA did not reach {RLX_PIXEL_BEST} in "
                 f"{RLX_PIXEL_ITERS} iterations: {pixel}")

        # (d) SAC on the port's Pendulum-v1 at its default (256, 256)
        # torsos; one update on the card and the CPU with the same noise;
        # CQL offline on the reference test's Pendulum transitions.
        sac_cfg = (SACConfig().environment("Pendulum-v1")
                   .env_runners(num_envs_per_env_runner=1,
                                rollout_fragment_length=32)
                   .training(train_batch_size=64,
                             num_steps_sampled_before_learning_starts=128,
                             replay_buffer_capacity=10_000)
                   .rl_module(model_config={"hiddens": (256, 256),
                                            "action_scale": 2.0})
                   .resources(device=device).debugging(seed=0))
        algo = sac_cfg.build_algo()
        sac, results = _rlx_iterations(card, "sac", algo, 6)
        algo.stop()
        sac["learners"] = results[-1]["learners"]
        sac["replay_size"] = results[-1]["replay_size"]
        sac_spec = RLModuleSpec(module_class=SACModule, observation_dim=3,
                                action_dim=1, discrete=False,
                                model_config={"action_scale": 2.0})
        rng = np.random.default_rng(1)
        n = 256
        sac_batch = {
            Columns.OBS: rng.normal(size=(n, 3)).astype(np.float32),
            Columns.ACTIONS: rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            Columns.REWARDS: -rng.uniform(0, 10, n).astype(np.float32),
            Columns.NEXT_OBS: rng.normal(size=(n, 3)).astype(np.float32),
            Columns.TERMINATEDS: (rng.random(n) < 0.1).astype(np.float32)}
        gen = torch.Generator().manual_seed(1)
        noise = {"next": torch.randn((n, 1), generator=gen),
                 "new": torch.randn((n, 1), generator=gen)}
        _, sac_vs = _rlx_card_vs_cpu(
            lambda dev: SACLearner(config=SACConfig().resources(device=dev),
                                   module_spec=sac_spec, seed=0),
            sac_batch, device, noise=noise)
        sac_vs["atol"] = SAC_ATOL
        cql_cfg = (CQLConfig().environment("Pendulum-v1")
                   .offline_data(input_=_rlx_pendulum(600),
                                 updates_per_iteration=15)
                   .training(train_batch_size=64, min_q_weight=5.0)
                   .rl_module(model_config={"hiddens": (32, 32),
                                            "action_scale": 2.0})
                   .resources(device=device).debugging(seed=0))
        algo = cql_cfg.build_algo()
        cql, results = _rlx_iterations(card, "cql", algo, 3)
        algo.stop()
        cql["learners"] = results[-1]["learners"]
        cql["dataset_size"] = results[-1]["dataset_size"]
        emit("d", dict(card=card, sac=sac, sac_card_vs_cpu=sac_vs, cql=cql))
        if not (all(math.isfinite(v) for v in sac["learners"].values())
                and sac["learners"]["alpha"] > 0 and sac["replay_size"] > 128):
            fail(f"SAC on the card: {sac}")
        if not (sac_vs["max_abs_err"] <= SAC_ATOL and sac_vs["moved"] > 1e-5):
            fail(f"SAC's update on the card differs from the CPU's: {sac_vs}")
        if not (all(math.isfinite(v) for v in cql["learners"].values())
                and cql["dataset_size"] >= 600
                and cql["learners"]["critic_loss"] != 0.0):
            fail(f"CQL on the card: {cql}")

        # (e) BC and MARWIL on CartPole transitions recorded in memory.
        def offline(cfg_cls, data, updates, **training):
            return (cfg_cls().environment("CartPole-v1")
                    .offline_data(input_=data, updates_per_iteration=updates)
                    .training(train_batch_size=256, lr=3e-3, **training)
                    .rl_module(model_config={"hiddens": (32, 32)})
                    .resources(device=device).debugging(seed=0))

        algo = offline(BCConfig, _rlx_cartpole(2000, mixed=False), 40).build_algo()
        bc, results = _rlx_iterations(card, "bc", algo, 5)
        bc["bc_logp"] = results[-1]["learners"]["bc_logp"]
        bc["agreement"] = _rlx_agreement(algo, 0)
        bc["eval_return"] = algo.evaluate()["env_runners"]["episode_return_mean"]
        algo.stop()
        mixed = _rlx_cartpole(3000, mixed=True)
        algo = offline(MARWILConfig, mixed, 40, beta=1.0).build_algo()
        marwil, results = _rlx_iterations(card, "marwil", algo, 6)
        marwil["policy_loss"] = results[-1]["learners"]["policy_loss"]
        marwil["agreement"] = _rlx_agreement(algo, 1)
        algo.stop()
        # BC on the same mixed data, for comparison (not gated).
        algo = offline(BCConfig, mixed, 40).build_algo()
        for _ in range(6):
            algo.train()
        marwil["bc_agreement_on_mixed"] = _rlx_agreement(algo, 1)
        algo.stop()
        emit("e", dict(card=card, bc=bc, marwil=marwil))
        if not (bc["bc_logp"] > RLX_BC_LOGP and bc["agreement"] > RLX_BC_AGREE
                and bc["eval_return"] > RLX_BC_RETURN):
            fail(f"BC on the card: {bc}")
        if not (math.isfinite(marwil["policy_loss"])
                and marwil["agreement"] > RLX_MARWIL_AGREE):
            fail(f"MARWIL on the card: {marwil}")

        # (f) Multi-agent PPO: two policies on MultiAgentCartPole; their
        # weights differ; a checkpoint round trip bit for bit.
        def ma_cfg():
            return (PPOConfig()
                    .environment(MultiAgentCartPole, env_config={"num_agents": 2})
                    .multi_agent(policies={"p0": None, "p1": None},
                                 policy_mapping_fn=_rlx_policy)
                    .env_runners(rollout_fragment_length=64)
                    .training(train_batch_size=512, minibatch_size=128,
                              num_epochs=4, lr=1e-3, entropy_coeff=0.01)
                    .rl_module(model_config={"hiddens": (32, 32)})
                    .resources(device=device).debugging(seed=0))

        algo = ma_cfg().build_algo()
        ma, res = _rlx_learn(card, "multi_agent_ppo", algo, RLX_MA_BEST,
                             RLX_MA_ITERS)
        # The reference's gate looks at the best of all 12 iterations.
        for _ in range(ma["iterations"], RLX_MA_ITERS):
            res = algo.train()
        w = algo.get_weights()
        ma["policies_differ"] = not torch.equal(w["p0"]["pi.head.w"],
                                                w["p1"]["pi.head.w"])
        ma["losses_finite"] = all(math.isfinite(r["total_loss"])
                                  for r in res["learners"].values())
        with tempfile.TemporaryDirectory() as ckpt:
            algo.save_checkpoint(ckpt)
            algo2 = ma_cfg().build_algo()
            algo2.load_checkpoint(None, ckpt)
        w2 = algo2.get_weights()
        ma["restore_bit_for_bit"] = all(
            list(w[p]) == list(w2[p])
            and all(torch.equal(w[p][k], w2[p][k]) for k in w[p])
            and all(torch.equal(a, b) for a, b in zip(
                _rlx_opt_leaves(algo.learner_groups[p]),
                _rlx_opt_leaves(algo2.learner_groups[p])))
            for p in w)
        algo.stop()
        algo2.stop()
        emit("f", dict(card=card, multi_agent_ppo=ma))
        if not (ma["reached"] and ma["policies_differ"] and ma["losses_finite"]
                and ma["restore_bit_for_bit"]):
            fail(f"multi-agent PPO on the card: {ma}")
    finally:
        ray_tpu_torch.shutdown()

    # (g) The RL paths launch none of the port's kernels.
    result["launches"] = _counts()
    if any(result["launches"].values()):
        fail(f"the RL paths launched a port kernel: {result['launches']}")
    result["seconds"] = time.perf_counter() - t_phase
    per_algo = {}
    for key, names in (("a", ("dqn", "dqn_per")), ("b", ("impala", "appo")),
                       ("c", ("pixel_impala",)), ("d", ("sac", "cql")),
                       ("e", ("bc", "marwil")), ("f", ("multi_agent_ppo",))):
        for name in names:
            x = lines[key][name]
            per_algo[name] = {k: x.get(k) for k in (
                "reached_at_iteration", "iterations", "env_steps", "train_s",
                "env_steps_per_s", "updates", "updates_per_s")}
    summary = dict(card=card, seconds=result["seconds"], algorithms=per_algo,
                   launches=result["launches"])
    result.update(lines)
    print("rl_extras " + json.dumps(summary), flush=True)
    return result


# DreamerV3 on the card (phase 18): tests/test_dreamerv3.py's gates.
DREAMER_BEST, DREAMER_ITERS = 0.8, 60
# The reference test's deadline on a 1-CPU host (printed beside the card's
# seconds; not a gate here).
DREAMER_CPU_DEADLINE_S = 240.0
# Batches the telemetry phase sends through the prefetcher.
PREFETCH_BATCHES = 16


class _LineWalk:
    """tests/test_dreamerv3.py's env: a 1-D walk from 0 to +1 (reward 1,
    terminate) within 12 steps, step cost -0.02; optimal return ~0.92."""

    class _Space:
        def __init__(self, n=None, shape=None):
            self.n = n
            self.shape = shape

    def __init__(self):
        import numpy as np

        self._np = np
        self.observation_space = self._Space(shape=(2,))
        self.action_space = self._Space(n=2)
        self._x = 0.0
        self._t = 0

    def reset(self, seed=None):
        self._x, self._t = 0.0, 0
        return self._obs(), {}

    def _obs(self):
        return self._np.array([self._x, self._t / 12.0], self._np.float32)

    def step(self, action):
        self._x += 0.25 if action == 1 else -0.25
        self._t += 1
        if self._x >= 1.0:
            return self._obs(), 1.0, True, False, {}
        return self._obs(), -0.02, False, self._t >= 12, {}


def _dreamer_gridworld():
    from ray_tpu_torch.rl.env.pixel_gridworld import PixelGridworld

    return PixelGridworld(n=4, cell=2, max_steps=12, shaped=True)


def _dreamer_count(algo) -> Dict[str, float]:
    """Count DreamerV3's policy steps and world-model updates and time its
    env loop and its training steps (each update ends in copies of its
    metrics to the host, so the time covers the device's work)."""
    stats = {"policy_steps": 0, "collect_s": 0.0, "updates": 0,
             "step_s": 0.0}
    collect, wm_update, training_step = (algo._collect, algo._wm_update,
                                         algo.training_step)

    def counted_collect(n):
        t0 = time.perf_counter()
        try:
            got = collect(n)
            stats["policy_steps"] += got
            return got
        finally:
            stats["collect_s"] += time.perf_counter() - t0

    def counted_update(batch):
        stats["updates"] += 1
        return wm_update(batch)

    def timed_step():
        t0 = time.perf_counter()
        try:
            return training_step()
        finally:
            stats["step_s"] += time.perf_counter() - t0

    algo._collect = counted_collect
    algo._wm_update = counted_update
    algo.training_step = timed_step
    return stats


def _dreamer_rates(stats) -> Dict[str, object]:
    update_s = stats["step_s"] - stats["collect_s"]
    return dict(policy_steps=stats["policy_steps"],
                policy_steps_per_s=(stats["policy_steps"] / stats["collect_s"]
                                    if stats["collect_s"] else None),
                updates=stats["updates"], update_s=update_s,
                updates_per_s=(stats["updates"] / update_s
                               if stats["updates"] else None))


def _dreamer_state(algo) -> list:
    """Every tensor of a DreamerV3's state: weights, target critic, both
    optimizers' moments and counts, in a fixed order."""
    out = [*algo.model.state_dict().values(),
           *algo.target_critic.state_dict().values()]
    for opt in (algo._wm_opt, algo._ac_opt):
        state = opt.state_dict()["state"]
        out += [t for p in sorted(state) for _, t in sorted(state[p].items())]
    return out


def _dreamer_card_vs_cpu(device) -> Dict[str, object]:
    """One world-model and one actor-critic update at the defaults on the
    card and on the CPU, from the same weights (drawn on the host from one
    seed), batch and Gumbel noise: the largest difference of any weight or
    the target critic, how far the updates moved them, the losses."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl.algorithms import DreamerV3Config

    algos = {dev: (DreamerV3Config().environment(_LineWalk)
                   .resources(device=dev).debugging(seed=0).build_algo())
             for dev in ("cpu", device)}
    cfg = algos["cpu"].algo_config
    start = [t.clone() for t in _dreamer_state(algos["cpu"])]
    if any(not torch.equal(a.cpu(), b) for a, b in zip(
            _dreamer_state(algos[device]), start)):
        fail("DreamerV3 from one seed starts from other weights on the card "
             "and the CPU")
    B, T, H = cfg.batch_size, cfg.batch_length, cfg.horizon
    S, C, A = cfg.stoch_groups, cfg.stoch_classes, 2
    rng = np.random.default_rng(0)
    first = (rng.random((B, T)) < 0.1).astype(np.float32)
    first[:, 0] = 1.0
    batch = {"obs": rng.normal(0, 1, (B, T, 2)).astype(np.float32),
             "actions": rng.integers(0, A, (B, T)).astype(np.int32),
             "rewards": rng.normal(0, 0.5, (B, T)).astype(np.float32),
             "terminateds": (rng.random((B, T)) < 0.05).astype(np.float32),
             "is_first": first}
    gen = torch.Generator().manual_seed(1)

    def gumbel(*shape):
        u = torch.rand(shape, generator=gen).clamp_min(
            torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    noise = [{"z": gumbel(T, B, S, C)},
             {"action": gumbel(H, B * T, A), "z": gumbel(H, B * T, S, C)}]
    metrics = {}
    for dev, algo in algos.items():
        draws = iter(noise)
        algo._draw_noise = (lambda site, *lead, it=draws, dev=dev:
                            {k: v.to(dev) for k, v in next(it).items()})
        loss, aux, feat = algo._wm_update(
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        _, ac_aux = algo._ac_update(feat.reshape(-1, feat.shape[-1]), 1.0)
        metrics[dev] = {"world_model_loss": float(loss),
                        **{k: float(v) for k, v in aux.items()},
                        **{k: float(v) for k, v in ac_aux.items()}}
    cpu_after = _dreamer_state(algos["cpu"])
    n_weights = (len(algos["cpu"].model.state_dict())
                 + len(algos["cpu"].target_critic.state_dict()))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _dreamer_state(algos[device])[:n_weights], cpu_after[:n_weights]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        cpu_after[:n_weights], start[:n_weights]))
    metric_err = max(abs(metrics[device][k] - v)
                     for k, v in metrics["cpu"].items())
    return dict(max_abs_err=err, moved=moved, metric_max_abs_err=metric_err,
                atol=RL_ATOL, metrics=metrics[device])


def phase_rl_dreamer(card: str, device: str = "cuda") -> Dict[str, object]:
    """DreamerV3 on the card (see the module docstring, phase 18)."""
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch.rl.algorithms import DreamerV3Config
    from ray_tpu_torch.rl.algorithms.dreamerv3 import _DeconvDecoder

    t_phase = time.perf_counter()
    _reset_counts()
    result: Dict[str, object] = {"card": card}

    # (a) LineWalk at the reference's defaults, seed 0.
    cfg = (DreamerV3Config().environment(_LineWalk)
           .resources(device=device).debugging(seed=0))
    algo = cfg.build_algo()
    stats = _dreamer_count(algo)
    best, reached, res = -10.0, None, {}
    t0 = time.perf_counter()
    for it in range(DREAMER_ITERS):
        res = algo.train()
        best = max(best, res.get("episode_return_mean", -10.0))
        if best > DREAMER_BEST:
            reached = it
            break
    train_s = time.perf_counter() - t0
    line = dict(card=card, gate=DREAMER_BEST, best=best,
                reached=reached is not None, reached_at_iteration=reached,
                iterations=DREAMER_ITERS if reached is None else reached + 1,
                env_steps=res.get("num_env_steps_sampled_lifetime"),
                train_s=train_s, reference_cpu_deadline_s=DREAMER_CPU_DEADLINE_S,
                learners=res.get("learners"), **_dreamer_rates(stats))
    result["linewalk"] = line
    print("rl_dreamer_a " + json.dumps(line), flush=True)
    if not line["reached"]:
        fail(f"DreamerV3 did not pass {DREAMER_BEST} on LineWalk in "
             f"{DREAMER_ITERS} iterations: {line}")

    # (e) The trained algorithm saved and restored into a new one.
    with tempfile.TemporaryDirectory() as ckpt:
        algo.save_checkpoint(ckpt)
        restored = cfg.build_algo()
        restored.load_checkpoint(None, ckpt)
    a, b = _dreamer_state(algo), _dreamer_state(restored)
    ckpt_ok = (len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
               and restored._retnorm == algo._retnorm
               and restored._lifetime_steps == algo._lifetime_steps
               and any(o.state_dict()["state"]
                       for o in (algo._wm_opt, algo._ac_opt)))
    algo.stop()
    restored.stop()

    # (b) tests/test_dreamerv3.py::test_world_model_losses_decrease.
    wm_algo = (DreamerV3Config().environment(_LineWalk)
               .training(env_steps_per_iteration=300,
                         updates_per_iteration=0, min_buffer_steps=200)
               .resources(device=device).debugging(seed=0).build_algo())
    wm_algo.training_step()  # fill the buffer only (0 updates)
    wm_algo.algo_config.env_steps_per_iteration = 1
    wm_algo.algo_config.updates_per_iteration = 1
    history = []
    for _ in range(30):
        r = wm_algo.training_step()["learners"]
        if r:
            history.append((r["recon_loss"], r["reward_loss"]))
    wm_algo.stop()
    wm = dict(updates=len(history),
              recon_first=float(np.mean([h[0] for h in history[:3]])),
              recon_last=float(np.mean([h[0] for h in history[-3:]])),
              reward_first=float(np.mean([h[1] for h in history[:3]])),
              reward_last=float(np.mean([h[1] for h in history[-3:]])))

    # (c) tests/test_dreamerv3.py::test_dreamerv3_pixel_conv_encoder.
    px = (DreamerV3Config().environment(_dreamer_gridworld)
          .training(obs_shape=(8, 8, 3), conv_filters=((8, 2, 2), (16, 2, 1)),
                    deter_dim=64, hidden=64, stoch_groups=4, stoch_classes=4,
                    batch_size=4, batch_length=8, env_steps_per_iteration=120,
                    updates_per_iteration=5, min_buffer_steps=120)
          .resources(device=device).debugging(seed=0).build_algo())
    pstats = _dreamer_count(px)
    recon, finite = [], True
    for _ in range(10):
        r = px.training_step()["learners"]
        if r:
            recon.append(r["recon_loss"])
            finite = finite and math.isfinite(r["world_model_loss"])
    pixel = dict(deconv=bool(px._deconv and isinstance(px.model.decoder,
                                                       _DeconvDecoder)),
                 recon=recon, finite=finite, **_dreamer_rates(pstats))
    px.stop()

    # (d) One update of each kind on the card and the CPU.
    vs = _dreamer_card_vs_cpu(device)
    line = dict(card=card, world_model=wm, pixel=pixel, card_vs_cpu=vs,
                checkpoint_bit_for_bit=ckpt_ok)
    result.update(line)
    print("rl_dreamer_b " + json.dumps(line), flush=True)
    if not (wm["updates"] >= 20 and wm["recon_last"] < wm["recon_first"] * 0.75
            and wm["reward_last"] < wm["reward_first"] - 0.25):
        fail(f"DreamerV3's world-model losses did not fall: {wm}")
    if not (pixel["deconv"] and pixel["finite"] and len(recon) >= 6
            and recon[-1] < recon[0] * 0.9):
        fail(f"pixel DreamerV3 did not fit its pixels: {pixel}")
    if not (vs["max_abs_err"] <= RL_ATOL and vs["moved"] > 1e-5):
        fail(f"DreamerV3's updates on the card differ from the CPU's: {vs}")
    if not ckpt_ok:
        fail("DreamerV3's checkpoint round trip is not bit for bit")

    # (f) DreamerV3 launches none of the port's kernels.
    result["launches"] = _counts()
    if any(result["launches"].values()):
        fail(f"DreamerV3 launched a port kernel: {result['launches']}")
    result["seconds"] = time.perf_counter() - t_phase
    print("rl_dreamer " + json.dumps(dict(
        card=card, seconds=result["seconds"], launches=result["launches"],
        reached_at_iteration=result["linewalk"]["reached_at_iteration"],
        policy_steps_per_s=result["linewalk"]["policy_steps_per_s"],
        updates_per_s=result["linewalk"]["updates_per_s"])), flush=True)
    return result


class _TelemetryEcho:
    """A replica with no model: ``serve.status()``'s rows to read."""

    def __call__(self, request) -> str:
        return "ok"


def _tensor_leaf_bytes(tree) -> int:
    from torch.utils import _pytree

    return sum(t.numel() * t.element_size()
               for t in _pytree.tree_leaves(tree) if hasattr(t, "numel"))


def phase_telemetry(card: str) -> Dict[str, object]:
    """The device-telemetry plane on the card (see the module docstring,
    phase 19)."""
    import asyncio
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import kernel_build
    from ray_tpu_torch._private.torch_compat import instrumented_step
    from ray_tpu_torch.checkpoint import CheckpointCoordinator, ShardWriter
    from ray_tpu_torch.data.ingest.prefetch import DeviceBatchIterator
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util import device_telemetry as dt
    from ray_tpu_torch.util import forensics

    t_phase = time.perf_counter()
    result: Dict[str, object] = {"card": card}

    # (a) The kernel builds this process ran, then GPT-2 steps through the
    # step tap: B=8 three times, then B=4.
    builds = {r["label"]: r["compile_s"] for r in dt.compile_records()
              if r["label"].startswith("kernel:")}
    want_builds = ([f"kernel:{n}" for n in kernel_build.kernel_names()]
                   if kernel_build.NVCC_RUNS else [])
    if sorted(builds) != sorted(want_builds) or len(
            [r for r in dt.compile_records()
             if r["label"].startswith("kernel:")]) != len(want_builds):
        fail(f"kernel builds recorded {sorted(builds)}, expected "
             f"{want_builds} (nvcc runs {kernel_build.NVCC_RUNS})")
    dt.reset()
    _reset_counts()
    config = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    params = gpt2.init_params(config, seed=0, device="cuda")
    optimizer = gpt2.make_optimizer(3e-4)
    opt_state = optimizer.init(params)
    step = instrumented_step(gpt2.make_train_step(config, optimizer),
                             label="gpt2_step")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 50257, (8, config.seq_len + 1)), device="cuda")
    want = {"splash_attention_fwd": config.n_layer,
            "splash_attention_bwd": config.n_layer}
    losses, step_s = [], []
    for i, b in enumerate((8, 8, 8, 4)):
        before = _counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, toks[:b, :-1],
                                       toks[:b, 1:])
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in _counts().items()}
        if delta != {k: want.get(k, 0) for k in delta}:
            fail(f"telemetry step {i}: launches {delta}, expected {want}")
    compiles = [(r["trigger"], r["compile_s"])
                for r in dt.compile_records("gpt2_step")]
    tap = dict(builds=builds, nvcc_runs=kernel_build.NVCC_RUNS,
               triggers=[t for t, _ in compiles],
               first_call_s=[s for _, s in compiles], step_s=step_s,
               losses=losses)

    # (b) The allocator's figures, as torch.cuda gives them.
    torch.cuda.synchronize()
    rows = dt.device_memory_snapshot()
    allocated = torch.cuda.memory_allocated(0)
    total = torch.cuda.mem_get_info(0)[1]
    memory = dict(rows=rows, memory_allocated=allocated, total=total)

    # (c) The prefetcher: 16 batches of a 64 MiB float32 column and token
    # ids. Its rate counts the batches whose copies start after batch RING
    # is handed out (the first RING batches also page-lock the ring's
    # buffers; batch i is handed out once batch i + 1's copy has started).
    batches = [{"x": np.full((64, 1024, 256), float(i), np.float32),
                "tokens": np.full((16, 1025), i, np.int64),
                "names": ["row"] * 16} for i in range(PREFETCH_BATCHES)]
    sizes = [sum(v.nbytes for k, v in b.items() if k != "names")
             for b in batches]
    torch.cuda.synchronize()
    seen, marks = [], [time.perf_counter()]
    for out in DeviceBatchIterator(iter(batches), device="cuda:0"):
        seen.append((float(out["x"][0, 0, 0]), out["x"].device.type))
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    marks[-1] = time.perf_counter()
    ledgered_h2d = sum(r["bytes"] for r in dt.transfer_records()
                       if r["src"] == "ingest_prefetch")
    ring = DeviceBatchIterator.RING
    steady = sum(sizes[ring + 2:]) / (marks[-1] - marks[ring + 1])
    prefetch = dict(bytes=sum(sizes), ledgered=ledgered_h2d,
                    seconds=marks[-1] - marks[0],
                    gb_per_s_with_ring_setup=sum(sizes)
                    / (marks[-1] - marks[0]) / 1e9,
                    gb_per_s=steady / 1e9,
                    batches_in_order=seen == [(float(i), "cuda") for i in
                                              range(PREFETCH_BATCHES)])
    del batches

    # (d) Two async saves of the GPT-2 state, each persisted before the
    # next: the first also page-locks the writer's buffers, the second's
    # block is the snapshot's copy alone.
    state = {"params": params, "opt_state": opt_state}
    state_bytes = _tensor_leaf_bytes(state)
    blocks = []
    with tempfile.TemporaryDirectory() as root:
        writer = ShardWriter(CheckpointCoordinator(root, keep=1,
                                                   replicate_to_peer=False),
                             replicate=False)
        try:
            for save in range(2):
                handle = writer.save_async(save, state)
                handle.result(timeout=300)
                blocks.append(handle.block_seconds)
        finally:
            writer.close()
    d2h = [r["bytes"] for r in dt.transfer_records()
           if r["src"] == "ckpt_snapshot"]
    ckpt = dict(state_bytes=state_bytes, ledgered=d2h,
                staging=dt.pool_bytes()["ckpt_staging"], block_s=blocks,
                gb_per_s=state_bytes / blocks[1] / 1e9,
                gb_per_s_first=state_bytes / blocks[0] / 1e9)

    # (e) A multiplexed GPT-2 charged to mux_weights, then evicted.
    @serve.multiplexed(max_num_models_per_replica=1)
    async def load(model_id):
        return gpt2.init_params(config, seed=int(model_id.split("-")[1]),
                                device="cuda")

    async def mux():
        model = await load("seed-1")
        out = dict(loaded=dt.pool_bytes()["mux_weights"]["bytes"],
                   model_bytes=_tensor_leaf_bytes(model))
        del model
        for wrapper in load._multiplex_wrappers.values():
            await wrapper.unload_all()
        out["after_eviction"] = dt.pool_bytes()["mux_weights"]["bytes"]
        return out

    mux_line = asyncio.run(mux())

    # (f) A forensics bundle and serve.status() carry the telemetry.
    ray_tpu_torch.init()
    try:
        serve.start(http_options={"port": 0})
        serve.run(serve.deployment(_TelemetryEcho).bind(), name="telemetry")
        status = serve.status()
        bundle = forensics.build_bundle()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    snap = bundle["device_telemetry"]
    device_rows = [row.get("device") for row in status.values()]
    carried = dict(
        bundle=snap is not None and snap["compiles"]["totals"]["by_trigger"]
        == {dt.TRIGGER_FIRST: 1, dt.TRIGGER_SHAPE: 1}
        and len(snap["device_memory"]) == 1
        and snap["pools"].get("ckpt_staging", {}).get("peak") == state_bytes,
        status=bool(device_rows) and all(
            d is not None and set(d) == {"pools", "transfer_bw"}
            and d["pools"].get("mux_weights", {}).get("peak")
            == mux_line["model_bytes"] for d in device_rows))
    result["launches"] = _counts()
    result["seconds"] = time.perf_counter() - t_phase
    line = dict(card=card, tap=tap, memory=memory, prefetch=prefetch,
                checkpoint=ckpt, mux=mux_line, carried=carried,
                launches=result["launches"], seconds=result["seconds"])
    result.update(line)
    print("telemetry " + json.dumps(line), flush=True)
    if tap["triggers"] != [dt.TRIGGER_FIRST, dt.TRIGGER_SHAPE]:
        fail(f"the step tap recorded {tap['triggers']}, expected one "
             f"first_compile then one shape_change")
    if not all(math.isfinite(x) for x in losses):
        fail(f"telemetry GPT-2 losses not finite: {losses}")
    if not (len(rows) == torch.cuda.device_count() == 1
            and rows[0]["platform"] == "gpu"
            and rows[0]["bytes_in_use"] == allocated
            and rows[0]["bytes_limit"] == total
            and rows[0]["peak_bytes_in_use"] >= allocated):
        fail(f"device memory rows disagree with torch.cuda: {memory}")
    if not (ledgered_h2d == prefetch["bytes"]
            and prefetch["batches_in_order"]):
        fail(f"the prefetcher's h2d ledger: {prefetch}")
    if not (d2h == [state_bytes] * 2 and ckpt["staging"] == {
            "bytes": 0.0, "peak": float(state_bytes)}):
        fail(f"the checkpoint snapshot's d2h ledger: {ckpt}")
    if not (mux_line["loaded"] == mux_line["model_bytes"] > 0
            and mux_line["after_eviction"] == 0.0):
        fail(f"mux_weights: {mux_line}")
    if not (carried["bundle"] and carried["status"]):
        fail(f"the bundle or serve.status() lacks the telemetry: {carried}")
    return result


def _rlx_policy(agent_id: str) -> str:
    return f"p{int(agent_id.split('_')[1]) % 2}"


def _rlx_opt_leaves(group):
    state = group.get_state()["opt_state"]["state"]
    return [t for p in sorted(state) for t in state[p].values()
            if hasattr(t, "shape")]


def _leaf_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def _check_mesh_shapes(cells) -> None:
    """Each mesh rank attends over its batch shard (a pipeline stage over a
    microbatch of it) and its heads, a seq rank over its sequence shard:
    phases 2 and 5 hold the kernels to their plain versions at those shapes
    (the splash and CE kernels at the rank's, the ring's per-rank launches
    at RING_RANK_SHAPES)."""
    for label, spec, extra in cells:
        b = MESH_BATCH // (spec.get("data", 1) * spec.get("fsdp", 1))
        h = 12 // spec.get("tensor", 1)
        s = 1024 // spec.get("seq", 1)
        if extra.get("attn_impl") == "ring":
            covered = (b, s, h, 64, True, spec["seq"]) in RING_RANK_SHAPES
        else:
            mb = b // extra.get("pp_microbatches", 1)
            covered = (mb, s, h, 64, True) in KERNEL_SHAPES and \
                (mb, s, h, 64, True) in BWD_SHAPES
        if not covered or (b * s, 768, 50304) not in CE_SHAPES:
            fail(f"train_mesh ({label}) ran a rank shape ({b}, {s}, {h}, "
                 f"64) that no kernel check covers")


def main_mesh_cards() -> int:
    """``--mesh-cards``: only the meshes of MESH_CARDS_CELLS, one process
    rank on each of four cards over NCCL, after building the kernels. The
    whole script on one card holds the kernels to their plain versions at
    these ranks' shapes; this run prints a ``train_mesh_<cell>`` line for
    each, the ranks' launches and the device line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    cards = max(math.prod(spec.values()) for _, spec, _ in MESH_CARDS_CELLS)
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: --mesh-cards needs {cards} cards, torch finds "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from ray_tpu_torch._private import kernel_build

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards_seen = card_lines()
    card = cards_seen[0]
    for line in cards_seen:
        print(line, flush=True)
    t0 = time.perf_counter()
    kernel_build.build()
    print(f"build_seconds {time.perf_counter() - t0:.3f}", flush=True)
    train_mesh = phase_train_mesh(card, MESH_CARDS_CELLS, cards)
    _check_mesh_shapes(MESH_CARDS_CELLS)
    print("launches " + json.dumps({"train_mesh": train_mesh["launches"]}),
          flush=True)
    print(f"seconds {time.perf_counter() - started:.1f}", flush=True)
    for line in cards_seen:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch._private import kernel_build

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    kernel_build.build()
    print(f"build_seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name in kernel_build.kernel_names():
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    resources = ring_resources()
    for kernel, res in resources.items():
        print(f"resources ring {kernel} " + json.dumps(res), flush=True)
    splash_res = splash_resources()
    for kernel, res in splash_res.items():
        print(f"resources splash {kernel} " + json.dumps(res), flush=True)
    ce_res = ce_resources()
    for kernel, res in ce_res.items():
        print(f"resources ce {kernel} " + json.dumps(res), flush=True)
    # The CE forward keeps a 64 x 256 fp32 logits tile in registers, the
    # backward a 64 x 384 fp32 accumulator, at D=768: a spill, or wgmma
    # serialised by ptxas, is a fault of the build.
    for kernel in ("fwd", "dx", "dw"):
        if ce_res[f"{kernel} D=768"]["spill_bytes"]:
            fail(f"fused CE {kernel} spills at D=768: "
                 f"{ce_res[f'{kernel} D=768']}")
    if "C751" in kernel_build.build_log("fused_ce"):
        fail("ptxas serialised the fused CE kernels' wgmma (a C751x note)")

    # Each phase's seconds, printed as it ends: the script must end within
    # its time limit, and a later slice cuts the longest first.
    phase_s: Dict[str, float] = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase_seconds {name} {phase_s[name]:.1f}", flush=True)
        return out

    kern = run("kernel", phase_kernel, peaks)
    ce = run("ce", phase_ce, peaks)
    ring = run("ring", phase_ring, peaks)
    weights = serve_weights()
    serve = run("serve", phase_serve, weights)
    train = run("train", phase_train, peaks, card)
    train_ring = run("train_ring", phase_train_ring, peaks, card)
    # After every in-process phase, so that none of their numbers moves;
    # before the profiled ones, whose tracing slows small kernels.
    serve_http = run("serve_http", phase_serve_http, weights, serve)
    serve_batch = run("serve_batch", phase_serve_batch, weights)
    serve_slo = run("serve_slo", phase_serve_slo, weights)
    serve_process = run("serve_process", phase_serve_process, weights, serve)
    dag_compiled = run("dag_compiled", phase_dag_compiled, weights)
    serve_compiled = run("serve_compiled", phase_serve_compiled, weights)
    del weights
    data_batch = run("data_batch", phase_data_batch)
    ce["fused_ce_fwd"]["worst_abs"] = max(
        ce["fused_ce_fwd"]["worst_abs"],
        data_batch["ce_fwd_at_path"]["max_abs_err"])
    train_fit = run("train_fit", phase_train_fit)
    train_elastic = run("train_elastic", phase_train_elastic)
    # The phase's ranks ran at these batches: each kernel was held to its
    # plain version at their shapes by phase 2 (the forward and CE
    # kernels) and below (the splash backward).
    for b, s in train_elastic["rank_shapes"]:
        if (b, s - 1, 12, 64, True) not in KERNEL_SHAPES or \
                (b, s - 1, 12, 64, True) not in BWD_SHAPES or \
                (b * (s - 1), 768, 50304) not in CE_SHAPES:
            fail(f"train_elastic ran a rank batch of {b} x {s} that no "
                 f"kernel check covers")
    train_mesh = run("train_mesh", phase_train_mesh, card)
    _check_mesh_shapes(MESH_CELLS)
    tune_fit = run("tune_fit", phase_tune_fit)
    workflow_fit = run("workflow_fit", phase_workflow_fit)
    models = run("models", phase_models, peaks, card)
    rl = run("rl_ppo", phase_rl_ppo, card)
    rl_extras = run("rl_extras", phase_rl_extras, card)
    rl_dreamer = run("rl_dreamer", phase_rl_dreamer, card)
    telemetry = run("telemetry", phase_telemetry, card)
    # Last: its yardstick runs under torch.profiler, whose tracing slowed
    # the serving forward's many small kernels when it ran before them.
    bwd = run("attn_bwd", phase_attn_bwd, peaks)
    ce_dense = run("ce_yardstick", phase_ce_yardstick, ce)

    def entry(name, source, replaces, function, rows, by_path, worst, row,
              library_ms, shape, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    replaces_function=function, rows=rows,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=worst, ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_us=row["bound_ms"] * 1e3,
                    bound_by=row["bound_by"], library_ms=library_ms,
                    shape=shape, **extra)

    def paths(name):
        """Launches of kernel ``name`` on each main path, counted from 0
        just before the path ran."""
        out = {"serve": serve["launches"][name],
               "serve_http": serve_http["launches"][name],
               "serve_batch": serve_batch["launches"][name],
               "serve_slo": serve_slo["launches"][name],
               "serve_process": serve_process["launches"].get(name, 0),
               "dag_compiled": dag_compiled["launches"].get(name, 0),
               "serve_compiled": serve_compiled["launches"].get(name, 0),
               "data_batch": data_batch["launches"].get(name, 0),
               "train_fit": train_fit["launches"].get(name, 0),
               "train_elastic": train_elastic["launches"].get(name, 0),
               "train_mesh": train_mesh["launches"].get(name, 0),
               "tune_fit": tune_fit["launches"].get(name, 0),
               "workflow_fit": workflow_fit["launches"].get(name, 0)}
        for impl in ("dense", "fused"):
            out[f"train_{impl}"] = train["launches"][impl][name]
        out["train_ring"] = train_ring["run"]["launches"][name]
        for model in ("llama", "moe", "vit"):
            out[f"models_{model}"] = models[model]["run"]["launches"][name]
        out["rl_ppo"] = rl["launches"].get(name, 0)
        out["rl_extras"] = rl_extras["launches"].get(name, 0)
        out["rl_dreamer"] = rl_dreamer["launches"].get(name, 0)
        out["telemetry"] = telemetry["launches"].get(name, 0)
        return out

    kernels = [
        entry("splash_attention_fwd",
              "ray_tpu_torch/csrc/splash_attention_fwd.cu",
              "ray_tpu/ops/attention.py:95",
              "ray_tpu.ops.attention.splash_attention (and flash_attention "
              ":128), forward", [1, 3], paths("splash_attention_fwd"),
              kern["worst"], kern["main"], kern["main"]["library_ms"],
              {k: kern["main"][k] for k in ("B", "S", "H", "hd", "causal")},
              train_shape_ms=kern["rows"][0]["ms"],
              serving_batch_shapes=[
                  {k: r[k] for k in ("B", "S", "H", "hd", "causal", "ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "plain_ms")}
                  for r in kern["rows"]
                  if (r["B"], r["S"], r["causal"]) in ((8, 1024, True),
                                                      (32, 1024, True),
                                                      (8, 517, True))],
              resources={k: r for k, r in splash_res.items()
                         if k.startswith("fwd")},
              llama_shape={k: v for k, v in models["kernels"]["llama"].items()
                           if not k.startswith(("bwd", "d"))}),
        entry("splash_attention_bwd",
              "ray_tpu_torch/csrc/splash_attention_bwd.cu",
              "ray_tpu/ops/attention.py:56",
              "ray_tpu.ops.attention.splash_attention fused dq/dk/dv "
              "backward (and flash_attention's dkv and dq kernels)", [2, 4],
              paths("splash_attention_bwd"), bwd["worst_abs"], bwd["main"],
              bwd["main"]["library_ms"],
              {k: bwd["main"][k] for k in ("B", "S", "H", "hd", "causal")},
              max_rel_err=bwd["worst_rel"],
              library_ms_by=bwd["main"]["library_ms_by"],
              library_loop_ms=bwd["main"]["library_loop_ms"],
              profiled_ms=bwd["main"]["profiled_ms"],
              resources={k: r for k, r in splash_res.items()
                         if not k.startswith("fwd")},
              llama_shape={k: v for k, v in models["kernels"]["llama"].items()
                           if not k.startswith(("fwd", "max", "lse"))}),
    ]
    for name, row_no, line, function in (
            ("fused_ce_fwd", 5, 81, "_fwd_pallas (_fwd_kernel :53)"),
            ("fused_ce_dx", 6, 154, "_bwd_pallas dx (_dx_kernel :113)"),
            ("fused_ce_dw", 7, 167, "_bwd_pallas dW (_dw_kernel :131)")):
        main_row = ce[name]["main"]
        kernels.append(entry(
            name, "ray_tpu_torch/csrc/fused_ce.cu",
            f"ray_tpu/ops/fused_ce.py:{line}",
            f"ray_tpu.ops.fused_ce.{function}", [row_no], paths(name),
            ce[name]["worst_abs"], main_row, None,
            {k: main_row[k] for k in ("N", "D", "V")},
            dense_ms=main_row["dense_ms"],
            resources={k: r for k, r in ce_res.items()
                       if k.startswith(name[len("fused_ce_"):])},
            **(dict(matmul_ms=main_row["matmul_ms"])
               if name == "fused_ce_fwd" else dict(
                   dx_plus_dw_ms=main_row["dx_plus_dw_ms"],
                   dense_bwd_profiled_ms=ce_dense["profiled_ms"],
                   dense_bwd_matmul_ms=ce_dense["matmul_ms"]))))
    # The ring kernels' time is one layer's W=4 launches at the training
    # path's shape; SDPA is the one PyTorch call for the same attention.
    ring_shape = {k: ring["main"][k]
                  for k in ("B", "S_local", "H", "hd", "W", "causal")}
    for name, which, line, function, worst, extra in (
            ("ring_attention_fwd", "fwd", 200,
             "_fused_ring_fwd (_block_kernel :148, merge :232)",
             ring["worst"]["fwd"], {}),
            ("ring_attention_bwd", "bwd", 242,
             "_fused_ring_bwd (_splash_attention_bwd_dkv :270)",
             ring["worst"]["bwd_abs"],
             {"max_rel_err": ring["worst"]["bwd_rel"]})):
        timed = ring["main"][which]
        kernels.append(entry(
            name, f"ray_tpu_torch/csrc/{name}.cu",
            f"ray_tpu/ops/ring_attention.py:{line}",
            f"ray_tpu.ops.ring_attention.{function}", [8 if which == "fwd"
                                                       else 9],
            paths(name), worst, timed, ring["whole"][f"{which}_ms"]["sdpa"],
            ring_shape, ms_unit="one layer's W=4 launches",
            launches_per_layer=timed["launches"],
            per_launch=[{key: launch[key] for key in launch
                         if key in ("step", "pairs")
                         or key.startswith(which)}
                        for launch in ring["main"]["per_launch"]],
            whole_ring_ms=ring["whole"][f"{which}_ms"],
            bound_ms_accumulate=timed["bound_ms_accumulate"],
            # The process ring's launch: one rank's block on its own shard
            # at train_mesh (c)'s shape, and every per-rank row's match
            # with the folded launches.
            per_rank_launch=dict(
                {k: RING_RANK_SHAPES[0][i] for i, k in enumerate(
                    ("B", "S_local", "H", "hd", "causal", "W"))},
                **{k[len(which) + 1:]: v
                   for k, v in ring["per_rank"]["timed"].items()
                   if k.startswith(which)}),
            per_rank_equal_folded=[r["equal_folded"]
                                   for r in ring["per_rank"]["rows"]],
            resources={key: res for key, res in resources.items()
                       if key.split()[0] in (("fwd",) if which == "fwd"
                                             else ("dkv", "dq"))},
            **extra))
    print(f"script_seconds {time.perf_counter() - started:.1f} "
          + json.dumps({k: round(v, 1) for k, v in phase_s.items()}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh-cards", action="store_true",
                        help="run only the fsdp x tensor mesh, one rank on "
                             "each of four cards over NCCL")
    args = parser.parse_args()
    sys.exit(main_mesh_cards() if args.mesh_cards else main())
