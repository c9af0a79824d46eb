#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pytorch_distributed_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all at once) and drives the main paths of the port,
serving (tensor-parallel and multihost serving too), GPT-2 training (FSDP, ZeRO1,
DataParallel, TensorParallel; the mixture-of-experts model under FSDP,
ExpertDataParallel, TensorParallel and context parallelism; selective
recomputation and dropout; the dry-run grid of every family),
context-parallel training, ResNet training
(also from JPEG files), and checkpointed training that the elastic
launcher restarts (its checkpoints go under the gitignored build
directory and are deleted), printing one JSON line per phase. The
serving steps and the pipelined
training step run as CUDA graph replays (one a step); the serving phases
run the same requests through the eager step bodies too, as the
reference the graphs are held against. A replay calls no kernel wrapper,
so the wrappers' launch counters count eager launches and the launches a
capture records; what the replays launched is counted in device traces
(torch.profiler lists a replay's kernels):

  device        the card (``nvidia-smi`` name and power limit), library
                versions, the kernel build time, and the registers, stack
                and HGMMA (tensor-core) instructions of the Hopper-route
                kernels (B1-B6 in bf16/fp16) read from the built
                libraries with ``cuobjdump``;
  profiler_edges  how far device timestamps sit before their launches on
                the host clock, and a check that every profiled window,
                fenced by idle host time at its edges, keeps all its
                device records (the traced counts below rely on it);
  kernels       each CUDA kernel against its plain PyTorch version at its
                main path's shapes, in fp32 and bf16, with its time, the
                plain version's time, the least time the card could take
                (bound) and one PyTorch library call's time for comparison,
                SDPA timed under each backend that takes the call (B7 paged
                decode on four length sets: ragged, around its split
                boundaries, the serve phase's lengths, and the spec step's
                verify window over them, 4 rows a chain; B1-B3 causal
                flash forward, dq, dk/dv, with a ragged T, fp16 and D=128
                checked too; B4-B6 position-masked flash forward, dq, dk/dv
                on every position pattern a ring hop gives them, with a
                ragged fp16 and a D=128 pattern);
  bn_kernels    the four BatchNorm kernels of BatchNorm over a stats group
                (bn_stats, bn_fwd_elemt, bn_bwd_reduce, bn_bwd_elemt) in
                bf16 at every BatchNorm shape of ResNet-50 at 224 px and
                256 images, and fp16, fp32 and narrow-channel checks: each
                against its plain version, each reduction's bits equal over
                two launches, a refused launch, a CUDA graph's capture and
                replays, the launch counts; times per layer and summed over
                the 53 layers of a step, beside the bound, the plain
                version's and PyTorch's SyncBatchNorm pieces;
  cp_hops       the ring's own hop functions for 4 ranks emulated on the
                card (plain and zigzag ring, T=4096): merged outputs and
                gradients against B1-B3 on the whole sequence;
  parity        GPT-2 125M at full width, fp32, paged cache: the engine's
                greedy tokens equal the argmax of the port's own uncached
                forward, every decode step of every layer launched B7 (device
                trace), and every decode step was one graph replay;
  spec_parity   GPT-2 125M at full width, fp32, TF32 off, 8 requests on the
                slotted and the paged cache: speculative greedy streams
                (spec_k 3; a 6-layer self-draft, and a separate distilgpt2-
                shaped draft holding the target's first six layers) equal
                the plain scheduler's, with equal accept counts in every
                round; a mid-stream swap of equal weights changes nothing
                and keeps every data_ptr; B7 launches draft_layers x k +
                n_layer times a paged self-draft round and n_layer times a
                draft-model round;
  graph_parity  the same runs (and plain decode, and a sampled plain and
                spec run) through the graphs and through the eager step
                bodies: streams token for token and accept counts equal, B7's
                device launches (graphs) equal to its wrapper launches
                (eager), one replay a step or round and no wrapper launch in
                the graph runs, no replay in the eager runs;
  serve         serving's main path: GPT-2 125M at full width in bf16, 16
                requests with a shared prefix through the continuous-batching
                scheduler over the paged cache, through the graphs and the
                eager bodies (tokens/s, step p50/p99, TTFT, equal streams),
                then once more through the graphs under a device trace: B7
                n_layer times a step (the kernels line's launches);
  profile       torch.profiler over 10 decode steps of that engine, graphs
                and eager: host wall time against device busy time per
                step, the replay's device span between CUDA events, the top
                kernels, and B7 n_layer times a step in both;
  serve_spec    the serve phase with spec_k 3 and a 6-layer self-draft:
                tokens/s, spec-round p50/p99, TTFT, accept rate, tokens per
                target forward, the share of streams equal to serve's, and
                B7's launches (the self-draft's one-token forwards and the
                verify window), which must be 30 a round in the device trace;
  spec_profile  as profile, over 10 spec rounds of that engine (also
                through the graphs and the eager bodies), B7 30 a round;
  serve_example ``examples/serve_gpt2.py``'s ``main`` at GPT-2 125M's shape,
                paged, 16 requests with a shared prefix, ``--spec-k 3``;
  train_parity  GPT-2 125M at full width, fp32 with TF32 off, B=2, T=1024,
                3 steps: the trainer with the flash kernels against the same
                trainer with dense attention (losses, step-1 gradients), and
                every step of every layer launched B1, B2 and B3;
  train         training's main path: ``examples/train_gpt2.py``'s ``main``
                at its defaults (12 x 768, T=1024, global batch 8, bf16,
                flash attention, FSDP on a one-rank NCCL group), 3 warm-up
                and 20 timed steps; then 10 steps on one fixed batch, whose
                loss must fall;
  train_profile torch.profiler over 3 training steps: device busy share, top
                kernels, and B1-B3's share of the busy time; the Hopper
                B1, B2 and B3 kernels launch n_layer times a step;
  head          the 16-bit LM head (``head_in_fp32=False``, one tensor-core
                GEMM with fp32 accumulation, ``aten::mm.dtype``) and the
                chunked loss in bf16 at B=8, T=1024: logits, per-token
                losses and gradients against the same functions on widened
                fp32 operands (a bf16-output GEMM must fail the logits
                check), the head's forward + backward timed in both modes,
                and 10 timed training steps with the 16-bit head;
  runner_train  the train cell through ``AsyncRunner`` (``Trainer.run``'s
                executor, one graph replay a step) against the eager
                ``Trainer.step`` loop from the same weights and 10 batches:
                losses, parameters and buffers equal, or within the eager
                loop's own run-to-run spread; B1-B3's wrappers launch only in
                the warm-up and the capture; step time, tokens/s, MFU, peak
                memory of both;
  train_graph_profile  torch.profiler and CUDA events over 3 replayed
                training steps: device busy share, kernels per step, B1-B3
                12 each a replayed step and no B4-B6; the span marks, 16 a
                replay, the ring's ms equal to the trace's and the four
                phases 97-100.5% of the traced device time;
  fsdp_train    the entry point's FSDP (the train phase: a one-rank NCCL
                group, every parameter whole) against NoShard (the entry
                point with FSDP patched out, 8 steps): losses equal bit for
                bit, step time and peak memory of both;
  train_bf16_parity  bf16 GPT-2 125M, 5 steps on one fixed batch from the
                same weights: flash attention (B1-B3), and ring flash
                attention (B4-B6) under ``CPStrategy`` on a one-rank NCCL
                group (one card: cp = 1), each against dense attention,
                losses within 1% at every step;
  moe_train     the mixture-of-experts path: ``examples/train_gpt2.py
                --moe-experts 8 --moe-top-k 2`` at GPT-2 125M's full width
                and depth (MoE in blocks 1, 3, ..., 11: 322,634,544
                parameters, 152,765,232 a token runs through), B = 8 x
                1024, bf16, B1-B3, AdamW: step time, tokens/s, MFU over the
                active parameters, peak memory, ``moe_aux`` a step, B1-B3
                n_layer a step; then the same step on one repeated batch
                through ``AsyncRunner`` against the eager loop (losses
                fall, bit for bit or within the loop's spread, one replay
                a step, B1-B3 n_layer a replayed step in a device trace),
                and one MoE block's forward and backward split into the
                router and masks, the one-hot einsums and the experts
                (device traces) beside the replayed step's busy time;
  moe_parity    a 2-layer MoE GPT-2 at full width (E = 4, k = 2), fp32 with
                TF32 off, card against CPU from the same weights: routes
                equal, logits, ``moe_aux`` and one backward's gradients
                within 1e-5 of the CPU's largest value;
  remat_dropout GPT-2 125M, B = 8 x 1024, bf16: one forward and backward
                with recomputation off (twice: its spread), full, and the
                ``dots_with_no_batch_dims_saveable``, ``dots_saveable`` and
                ``nothing_saveable`` policies, bit for bit with remat off,
                with peak memory and step time each; then dropout 0.1
                through the runner against the eager loop, a mask's keep
                share within 5 sigma of 0.9, and a resume from an
                in-memory checkpoint drawing the masks of the run it
                resumes;
  train_cp_parity  the same model, batches and limits as train_parity, with
                ring flash attention (B4-B6) under ``CPStrategy`` on a
                one-rank NCCL group (one card: cp = 1) against
                train_parity's dense run;
  train_cp      context-parallel training's main path: GPT-2 125M, bf16,
                B=8, T=1024, ring flash attention under ``CPStrategy``, 3
                warm-up and 20 timed steps; then 10 steps on one fixed batch,
                whose loss must fall;
  train_cp_profile  as train_profile, for train_cp's steps and B4-B6; the
                Hopper B4-B6 kernels launch n_layer times a step, and no
                CUDA-core flash kernel launches;
  sharded_runner  runner_train's cell under DataParallel, ZeRO1 and FSDP on
                a one-rank NCCL group: the runner (one replay a step, the
                collectives captured in the graph) against the eager loop
                (losses, parameters, buffers), the collectives issued,
                nccl_ms_per_step and B1-B3's launches in 3 traced replays,
                step time against runner_train's NoShard runner;
  analysis      the port's own analysis on the card's machine: graftlint
                (``python -m pytorch_distributed_tpu_torch.analysis``)
                over the package, its bench and this script (zero
                findings, the five torch rules, the summary counts); then
                graftir's checks on sharded_runner's DataParallel trainer
                (one-rank NCCL group) through ``AsyncRunner``: 3 submits
                are 3 dispatches of 1 built Program and 3 graph launches
                in a torch.profiler trace, the trace's NCCL kernels a
                replay equal the inventory's collectives that NCCL runs
                as kernels (none at one rank: NCCL skips an in-place
                all-reduce over one rank), every state and ring tensor
                keeps its data_ptr, the inventory's tensor all-reduce
                moves 4 B x the parameter count, the collective and
                layout audits are clean, and the losses are
                sharded_runner's DataParallel runner's;
  powersgd      the train cell's step (GPT-2 125M, B=8, T=1024, bf16, B1-B3)
                under DataParallel on the one-rank NCCL group with
                ``PowerSGD(rank=2, start_iter=3)``, 8 steps across
                ``start_iter``: the runner (two programs, one a branch)
                against the eager loop, B1-B3 n_layer times a replayed
                step, the hook's device time against the allreduce
                hook's, the wire elements against ``wire_elements``
                (521,890 of 124,439,808), the error buffers' bytes, step
                time against sharded_runner's DataParallel runner; then a
                checkpoint of the whole state (Q and the error buffers
                too) saved, 3 runner steps, a restore into the live
                runner, the same 3 steps bit for bit;
  ckpt_gpt2     checkpoints of GPT-2 125M (bf16, AdamW): the entry point
                (FSDP, its own one-rank NCCL group) saves with
                ``--ckpt-dir`` and a second run resumes (steps numbered on);
                the checkpoint restored in place into a live
                ``AsyncRunner`` keeps its captured step, and its losses
                equal the eager loop's from the same checkpoint; blocking
                and async save, restore, bytes;
  tp_train      runner_train's cell under ``TensorParallel`` on the
                one-rank NCCL group (dp 1, tp 1), sequence parallelism off
                and on: the runner equals NoShard's runner bit for bit,
                B1-B3 12 each a replayed step, the collectives counted a
                step; step time against NoShard's runner;
  pp_train      (in the one-rank NCCL group) GPT2Pipe under
                ``PipelineParallel`` at pp 1: GPT-2 125M, bf16, flash
                attention, B = 8 x 1024 in 4 microbatches, with remat on
                and off: the losses against runner_train's NoShard eager
                losses (within 1e-4), each parameter group's first-step
                gradient norm against NoShard's (within 1e-2),
                ``Trainer.run`` (one replay a step) against the eager loop
                (within its spread), B1-B3's launches a step exactly the
                count the code gives (B1 twice a block and microbatch under
                remat), also in a device trace of the replays; step time,
                tokens/s, MFU, peak memory; then dropout 0.1 on the runner
                (captured, equal to the eager loop);
  tp_moe        (same group) TP x MoE: moe_train's repeated-batch run (GPT-2
                125M, E = 8, top-2, B = 8 x 1024, bf16, B1-B3) under
                ``TensorParallel`` at (dp 1, tp 1) with ``ExpertParallel``
                in the plan (the MoE blocks' f and g over tp): the eager
                loop twice and ``Trainer.run`` (one replay a step, equal to
                the eager loop within its spread), the losses within 1e-2
                of moe_train's NoShard eager losses (the EP route combines
                in fp32), and with the stacks left whole bit for bit
                NoShard's; B1-B3 n_layer a step from the wrappers and in a
                device trace of 3 replays; step time, tokens/s, MFU over
                the active parameters, peak memory, collectives;
  cp_moe        (same group) CP x MoE: the same model and batches under
                ``CPStrategy`` with ring flash attention at cp 1 (the
                diagonal hop through B4-B6), within 1e-2 of the causal
                route's losses, B4-B6 n_layer a step and no B1-B3;
  tp_serve      the serve phase through a model cut over a (dp 1, tp 1)
                serving mesh with its paged cache on tp (NCCL: graphs, the
                tp all-reduces in the capture): streams equal serve's, one
                replay and B7 12 times a decode step; tokens/s and decode
                p50 against serve's;
  redistribute  A.16 on the same group: ``reshard_gpt2_params`` of a 498 MB
                fp32 host state onto the (dp 1, tp 1) serving layout, bit
                for bit, staged through 16 MiB and not; mid-stream
                ``swap_params`` of host weights of equal value into serve's
                bf16 paged engine (staged and not) and into an fp32 engine:
                seconds, the card's allocation above its resident bytes
                beside the plan's peak and naive gather, every ``data_ptr``
                kept, no new capture, one replay a decode step either side,
                streams equal the uninterrupted run's;
  observability  (same group) ``observability.StepProfiler`` (2 warm-up
                steps, 3 captured) over runner_train's trainer replayed
                through ``AsyncRunner``: its ``trace_op_breakdown`` counts
                B1-B3 n_layer times each a captured step and its kernel
                time lies between half the replays' CUDA-event span and
                the span; ``memory_breakdown`` of one eager step (the
                batch's bytes exactly, a positive temp); the eager process
                group's NCCL collectives completed in the flight recorder
                with their bytes; ``nan_check`` on a card inf;
  serve_ckpt    ``examples/serve_gpt2.py``'s ``main`` with ``--ckpt-dir`` on
                ckpt_gpt2's checkpoint (run inside that phase);
  fsdp_ranks    four spawned ranks sharing the card over gloo (where gloo
                takes card tensors; the four processes start here once, a
                pool whose one gloo group serves hooks_ranks, tp_ranks,
                ep_ranks, pp_ranks and grid_ranks too): GPT-2 125M, bf16,
                2 rows a rank, 3
                steps under FSDP and ZeRO1 against NoShard in this process
                (losses within 1%), each rank's parameter and
                optimizer-state bytes (a quarter of NoShard's) and peak
                memory;
  hooks_ranks   the same four ranks and cell under DataParallel with the
                allreduce, bf16_compress, reduce_scatter and ring_allreduce
                hooks and PowerSGD, each where gloo takes its collectives
                on card tensors (the probe; a refused hook is printed with
                the probe's error): the ranks' synced gradients equal, the
                losses within 1% of NoShard's, the bytes on the wire a step
                (bf16 half of fp32; PowerSGD's = ``wire_elements``), and
                ``average_parameters`` one all-reduce per dtype;
  bn_group      ResNet-50 at 224 px, 32 images a rank, bf16, 3 steps under
                DataParallel, so BatchNorm runs over the dp group through
                the four BatchNorm kernels: the same four ranks, eager
                (one card), or one rank a card over NCCL through
                AsyncRunner's captured step (two cards or more); 53
                launches of each kernel a step (at the runner's start,
                none in its replays), no plain version, the ranks' states
                equal, the losses within 1% of NoShard's;
  tp_ranks      the same four ranks: TensorParallel at (dp 1, tp 4), with
                and without sequence parallelism, and (dp 2, tp 2), 3 bf16
                steps within 1% of NoShard's losses, the collectives and
                bytes a rank the plan's, B1-B3 on every rank; then fp32
                TP serving at tp 4 through the eager bodies (gloo), its
                greedy streams against the one-rank engine's; the (1, 4)
                job saves its state (``CheckpointManager``), a fresh TP
                trainer restored from it takes one more step bit for bit
                with the continued one, and every rank loads the
                checkpoint whole through ``load_gpt2_params`` at tp = 1:
                the gathered live weights;
  tp_reshard    (in tp_ranks' ranks) the same (1, 4) state moved to (dp 2,
                tp 2) by ``reshard_state`` onto ``state_shardings`` (no
                checkpoint), bit for bit the checkpoint's resume at (2, 2),
                the next step's loss bit for bit, B1-B3 n_layer times, each
                card leaf's measured peak within a source plus a
                destination block plus one staging chunk;
  dp_slots      (in tp_ranks' ranks) the fp32 TP serving on a slotted
                cache of 8 slots with the slots on dp at (dp 2, tp 2),
                eager (gloo), spec_k 0 (24 new tokens) and 3 (12, the
                6-layer self-draft): every rank's streams equal, each the
                one-rank engine's or departing at a top-2 gap under 1e-5;
                each rank holds 4 slots and a quarter of the cache's bytes;
  redistribute_ranks  at the end of tp_ranks' ranks: GPT-2 125M (fp32)
                laid out FSDP over the 4 ranks moves to the (1, 4) serving
                layout through ``reshard_gpt2_params`` and serves tp_ranks'
                prompts (streams equal the TP engine cut from the same
                weights); a dp-4 FSDP AdamW state (one bf16 step) is saved,
                moved to dp 2 on ranks 0 and 1 by ``reshard_state`` under a
                16 MiB staging bound (ranks 2 and 3 only send), equal bit
                for bit to ``resume_from_checkpoint``'s at dp 2, and the
                resized trainer's step runs B1-B3; per rank the plan's
                bytes, peak and naive gather, the bytes sent and staged
                through the host, and the measured peak (below the naive
                gather's);
  ep_ranks      four ranks sharing the card over gloo (pp_ranks'
                processes, which run it first): the MoE
                GPT-2 at full width, 4 layers (E = 8, k = 2), bf16, 2 x 1024
                tokens a dp row, 3 steps under ``ExpertDataParallel`` on
                (dp 1, ep 4) and (dp 2, ep 2) against NoShard in this
                process (losses within 1%): E/ep experts a rank, the other
                parameters bit for bit on every rank, the all-reduces and
                bytes a step the design's, the (1, 4) checkpoint resumed
                bit for bit, step time and peak memory a rank;
  pp_ranks      four spawned ranks sharing the card over gloo: GPT2Pipe
                (GPT-2 125M at full width and depth, bf16, flash
                attention, 4 microbatches) under ``PipelineParallel`` at
                pp 4 (3 layers a stage) and (dp 2, pp 2), 8 x 1024 global,
                3 eager steps against NoShard in this process (losses
                within 1e-4, each group's first-step gradient norm within
                1e-2): each rank's layers plus the replicated tables
                (parameter bytes), the host-staged link bytes a step and
                B1-B3's launches a step against the shapes' count, the pp 4
                checkpoint resumed bit for bit; then the eager executor
                with 8 of GPT-2 125M's blocks (fp32, TF32 off) as stages
                under all eight schedules, the loss and every gradient
                against plain autograd of the same blocks here; step time
                and peak memory a rank, each schedule's step time;
  pp_reshard    (in pp_ranks' ranks) the pp 4 state after its steps moved to
                (dp 2, pp 2) by ``reshard_state`` onto ``state_shardings``
                (``placed_state``: each layer whole on its stage's ranks),
                bit for bit the DCP resume of the same state, the next
                step's loss bit for bit and B1-B3's launches the shapes'
                count, the bytes each rank sent exactly its layers' for
                each new holder lacking them, each card leaf's measured
                peak within a source plus a destination block plus one
                staging chunk;
  grid_ranks    at the end of pp_ranks' ranks (no second start): the port's
                ``dryrun.run_grid(4)`` (fsdp, hsdp, tp_sp, pp, cp, ep: each
                mode's shard shapes, collectives and one-rank parity, fp32
                tiny GPT-2s on the card); TP x MoE at (dp 2, tp 2) and
                (dp 1, tp 4), sequence parallelism off and on, ep_ranks'
                model (full width, 4 layers) in fp32 with TF32 off, 3
                steps against NoShard here (losses and the router's, a
                stack's and ``wte``'s first-step gradient norms within
                1e-4); the EP reshard: an ``ExpertDataParallel`` state at
                (dp 1, ep 4) after one step moved by ``reshard_state`` onto
                ``state_shardings`` at (dp 2, ep 2), bit for bit the DCP
                resume's, each expert leaf's measured peak within a source
                plus a destination block plus one staging chunk;
  fr_stall      the pool's four ranks: rank 0's eager ``all_reduce`` waits
                under the flight recorder's 1 s watchdog for the others,
                who join 2.5 s later: the dump exists, ``stalled()`` is
                true, ``fr_trace`` of the dump names the all_reduce as the
                hang suspect, and it then completes;
  multihost     multihost serving: two worker processes (a ``HostWorker``
                each around the serve phase's paged engine, GPT-2 125M in
                fp32 with TF32 off, the decode step captured with B7 12
                times) on a ``TCPStore`` whose master is here, behind a
                ``Router`` with a 2 s heartbeat TTL: 32 requests, worker 0
                SIGKILLed mid-decode, every request finished once with the
                uninterrupted engine's stream (or a departure at a top-2
                gap under 1e-5), one eviction; a third process rejoins on a
                fresh channel and takes traffic while ``push_weights``
                swaps a checkpoint of the same weights into every live
                worker during 16 more requests; the seconds from the kill
                to the eviction and to the first refed token, p50/p99,
                TTFT, tokens/s (processes sharing one card);
  multihost_example  ``examples/serve_multihost.py``'s ``main`` at GPT-2
                125M's shape in bf16, two host threads, host0 killed: 16
                of 16 served, one eviction;
  resnet_parity ResNet-18 (CIFAR stem, B=16) and ResNet-50 (ImageNet stem
                at 64 px, B=8), fp32 with TF32 off and cuDNN's
                deterministic algorithms: the port on the card
                against the port on the CPU (train and eval logits with
                random BN state; losses, parameters and BN buffers after 3
                SGD steps from the BN init with random running statistics);
  resnet_amp_accum  the reference's config #3: ResNet-50 in fp16 with the
                loss scaler and 2 accumulated microbatches, 10 steps on a
                fixed batch; the loss falls, and the loss scale is printed;
  resnet_example  ``examples/train_resnet_ddp.py``'s ``main`` at
                ``--model resnet50 --dataset imagenet --global-batch 128
                --steps-per-epoch 5``, with 6 loader workers;
  disk_data     the disk datasets: 1,280 random-pixel JPEGs (10 classes,
                256 x 320) and a repeating token file, written under the
                build directory and deleted after: the loader's images/s at
                1 and 6 workers, the ResNet entry point from ``--data-dir``
                (ResNet-50, batch 128, bf16, 6 workers, 2 epochs of 10
                steps) against the same flags on synthetic ImageNet, and
                the GPT-2 entry
                point from ``--data-bin`` (10 steps, the loss must fall)
                against the train phase's tokens/s;
  elastic_resnet  BASELINE config #5 on one card: the same entry point
                (bf16, ``--ckpt-dir``) under the port's
                ``LocalElasticAgent`` in this process, its worker killed
                once checkpoint 10 is committed: one restart, the steps
                numbered on, the resumed losses against an uninterrupted
                run's; images/s before and after, the time to recover
                split by stage, and ResNet-50's checkpoint costs;
  comm_hooks    the same entry point at ResNet-50, batch 128, bf16, 10
                steps with each ``--comm-hook`` (its own one-rank NCCL
                group) and twice without: allreduce, reduce_scatter and
                ring_allreduce give the hookless losses (within their
                spread), bf16/fp16 compression differs within 5e-2;
                images/s, collectives and bytes a step;
  resnet_train  the bench twin (``pytorch_distributed_tpu_torch/bench.py``)
                at its ImageNet shapes: ResNet-50, batch 128 at 224 px,
                bf16, SGD(0.1, 0.9): images/s, step p50/p90/p99, MFU, peak
                memory, and whether cuDNN's algorithm search was on (the
                bench switches it on, for this phase and the next); the
                bench times images/s on ``AsyncRunner`` and the step
                percentiles on the synchronized eager loop;
  resnet_runner the bench's step through ``AsyncRunner`` against the eager
                loop, 8 steps from the same weights: losses, parameters and
                BatchNorm buffers equal (or within the eager spread),
                images/s and peak memory (graph pool included) of both;
  resnet_profile  torch.profiler over 3 of the bench's steps: device busy
                and idle share, kernels per step, and device time by kernel
                family (conv forward / data grad / weight grad, BatchNorm,
                elementwise, optimizer, GEMM, reductions).

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile, schedule

from portbench import spans as bench_spans
from portbench.trace import Trace
from pytorch_distributed_tpu_torch import _graphs, bench, dryrun, observability
from pytorch_distributed_tpu_torch import distributed as pdist
from pytorch_distributed_tpu_torch.analysis.ir import (
    StepProgram,
    collective_inventory,
    inplace_findings,
    summarize_collectives,
)
from pytorch_distributed_tpu_torch.analysis.ir.audit import (
    collective_findings,
    sharding_findings,
)
from pytorch_distributed_tpu_torch.checkpoint import (
    CheckpointManager,
    get_state_dict,
    set_state_dict,
)
from pytorch_distributed_tpu_torch.distributed import TCPStore
from pytorch_distributed_tpu_torch.observability import spans as obs_spans
from pytorch_distributed_tpu_torch.elastic import (
    DynamicRendezvous,
    LocalElasticAgent,
    WorkerSpec,
    placed_state,
    reshard_state,
    resume_from_checkpoint,
    state_shardings,
)
from pytorch_distributed_tpu_torch.data import (
    DistributedSampler,
    ImageFolderDataset,
    make_image_transform,
    make_loader,
    write_image_folder,
    write_token_bin,
)
from pytorch_distributed_tpu_torch.examples import (
    serve_gpt2,
    serve_multihost,
    train_gpt2,
    train_resnet_ddp,
)
from pytorch_distributed_tpu_torch.mesh import init_device_mesh
from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config, gpt2_125m
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops import batch_norm as bnk
from pytorch_distributed_tpu_torch.ops import chunked_xent
from pytorch_distributed_tpu_torch.ops import paged_attention as pa
from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner
from pytorch_distributed_tpu_torch.pipeline_exec.runner import (
    _named_step_tensors,
    _step_tensors,
)
from pytorch_distributed_tpu_torch.redistribute import (
    Placed,
    Sharding,
    plan_tree,
)
from pytorch_distributed_tpu_torch.redistribute import executor as rdx
from pytorch_distributed_tpu_torch.redistribute import plan as rplan
from pytorch_distributed_tpu_torch.parallel import (
    CPStrategy,
    DataParallel,
    EagerPipelineExecutor,
    ExpertDataParallel,
    ExpertParallel,
    FullyShardedDataParallel,
    GPT2Pipe,
    MoEMLP,
    NoShard,
    PipelineParallel,
    TensorParallel,
    ZeRO1,
    comm,
    gpt2_tp_plan,
    make_dispatch_masks,
    make_state_specs,
    make_ring_attention,
    stage_links,
    zigzag_reorder,
    zigzag_restore,
)
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    Request,
    SamplingParams,
    Scheduler,
    kv_cache_sharding,
    paged_kv_cache_sharding,
    reshard_gpt2_params,
    serving_mesh,
    shard_gpt2_params,
)
from pytorch_distributed_tpu_torch.trainer import (
    Trainer,
    classification_loss,
    lm_loss,
)

# the modules (the package attributes of the same names are functions)
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")
gpt2_module = importlib.import_module("pytorch_distributed_tpu_torch.models.gpt2")
cp = importlib.import_module(
    "pytorch_distributed_tpu_torch.parallel.context_parallel")

# Published dense peaks (NVIDIA data sheets), used for the bounds, keyed by
# a substring of torch.cuda.get_device_name: bf16 tensor-core FLOP/s, fp32
# (CUDA-core) FLOP/s, HBM bytes/s. The first match wins; "H100" alone is the
# SXM part (e.g. "NVIDIA H100 80GB HBM3").
PEAKS = (
    ("H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("H100 NVL", (835e12, 60e12, 3.9e12)),
    ("H100", (989e12, 67e12, 3.35e12)),
)

# speculative serving on the card: draft tokens a round proposes, and the
# self-draft's layers (the first half of GPT-2 125M's 12)
SPEC_K = 3
DRAFT_LAYERS = 6
SERVE_KW = dict(n_slots=8, max_len=1024, prefill_len=128, cache_kind="paged",
                page_size=16)
SERVE_NEW_TOKENS = 64
# B7's split kernel, by a substring of its name in device traces (the merge
# kernel launches only where a chain is split across CTAs)
B7_TRACE_NAME = "paged_decode_split"

KERNEL_SOURCE = "pytorch_distributed_tpu_torch/ops/csrc/paged_decode_attention.cu"
KERNEL_REPLACES = "pytorch_distributed_tpu/ops/paged_attention.py:128"
TOLERANCE = {"float32": 2e-5, "bfloat16": 1.6e-2}  # atol = rtol

FLASH_SOURCE = "pytorch_distributed_tpu_torch/ops/csrc/flash_attention_causal.cu"
FLASH_KERNELS = (  # (name, counter key, replaced TPU kernel)
    ("flash_causal_fwd", "fwd",
     "pytorch_distributed_tpu/ops/flash_attention.py:179"),
    ("flash_causal_dq", "dq",
     "pytorch_distributed_tpu/ops/flash_attention.py:293"),
    ("flash_causal_dkv", "dkv",
     "pytorch_distributed_tpu/ops/flash_attention.py:334"),
)
MASKED_SOURCE = "pytorch_distributed_tpu_torch/ops/csrc/flash_attention_masked.cu"
MASKED_KERNELS = (
    ("flash_masked_fwd", "mfwd",
     "pytorch_distributed_tpu/ops/flash_attention.py:73"),
    ("flash_masked_dq", "mdq",
     "pytorch_distributed_tpu/ops/flash_attention.py:525"),
    ("flash_masked_dkv", "mdkv",
     "pytorch_distributed_tpu/ops/flash_attention.py:575"),
)
CAUSAL_KEYS = tuple(key for _, key, _ in FLASH_KERNELS)
MASKED_KEYS = tuple(key for _, key, _ in MASKED_KERNELS)
LIBRARIES = ("paged_decode_attention", "flash_attention_causal",
             "flash_attention_masked", "batch_norm")
BN_SOURCE = "pytorch_distributed_tpu_torch/ops/csrc/batch_norm.cu"
# kernel vs plain version, |a - b| <= tol * (1 + |b|): fp32 sums in another
# order; bf16 outputs rounded once from fp32 (one bf16 ulp is 2**-8 of the
# value) and p rounded to bf16 before PV in both
FLASH_TOLERANCE = {"float32": 2e-4, "bfloat16": 2e-2, "float16": 2e-2}
# the Hopper route (bf16/fp16) of B1-B3 and of B4-B6: kernel names in the
# profiles and in the built libraries
SM90_KERNELS = ("flash_causal_fwd_kernel_sm90", "flash_causal_dq_kernel_sm90",
                "flash_causal_dkv_kernel_sm90")
MASKED_SM90_KERNELS = ("flash_masked_fwd_kernel_sm90",
                       "flash_masked_dq_kernel_sm90",
                       "flash_masked_dkv_kernel_sm90")
# counter keys of the kernels with a Hopper route (bf16/fp16)
SM90_KEYS = ("fwd", "dq", "dkv", "mfwd", "mdq", "mdkv")
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# Every profiled window (``traced``) runs one warm-up under the profiler,
# then calls prof.step(): the warm-up enables the device tracing and only
# what follows is recorded. The profiler keeps only the device records whose
# timestamps fall between the window's edges on the host clock, and on the
# card a record's timestamp can sit milliseconds before the launch that made
# it (the profiler_edges phase measures by how much). Work launched right at
# an edge then vanishes from the trace: a train-step window lost two layers'
# forward, a window of 20 decode calls lost all of them. So each window
# leaves EDGE_S of idle host time after its opening edge and before its
# closing one.
WARM_SCHEDULE = schedule(wait=0, warmup=1, active=1, repeat=1)
EDGE_S = 0.05


def path(key: str) -> str:
    """The route of a kernel inside its CUDA C++ source, by dtype."""
    return ("bf16/fp16: wgmma + TMA (sm90); fp32: CUDA cores"
            if key in SM90_KEYS else "CUDA cores")


def peaks():
    name = torch.cuda.get_device_name(0)
    for key, value in PEAKS:
        if key in name:
            return value
    raise SystemExit(f"chip_smoke: no published peaks for {name!r}")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's carries ``at_s``, the seconds since the
    script started, so that each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int, flush) -> float:
    """Median device time of one call, CUDA events around each call, with
    the 50 MB L2 cache flushed before it (decode finds the pools cold)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


@contextlib.contextmanager
def eager_bodies(engine):
    """The engine's step bodies run eagerly, with no graph replay: the
    reference that the graphs are held against (a patch made by this
    script; the port has no such switch)."""
    with mock.patch.object(engine, "_run", lambda kind, cache, dcache=None:
                           engine._body(kind, cache, dcache)()):
        yield


@contextlib.contextmanager
def replay_spans():
    """CUDA events before and after every step program's call
    (``_graphs.Program``): the device span of each graph replay."""
    spans = []
    call = _graphs.Program.__call__

    def timed(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(self)
        end.record()
        spans.append((start, end))
        return out

    with mock.patch.object(_graphs.Program, "__call__", timed):
        yield spans


def _switch_on():
    torch.ones(1, device="cuda").add_(1)


@contextlib.contextmanager
def traced(warm_up=_switch_on, cpu=True):
    """torch.profiler over the block: ``warm_up()`` runs first and is not
    recorded, and the block is fenced by EDGE_S of idle host time at each
    edge (see WARM_SCHEDULE). ``cpu`` records the host activity too.
    Yields the profiler; read it after the block."""
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities, schedule=WARM_SCHEDULE) as prof:
        warm_up()
        # graftlint: disable-next-line=host-sync-in-hot-loop -- the profiled window's opening edge: the warm-up must finish before recording starts
        torch.cuda.synchronize()
        prof.step()
        time.sleep(EDGE_S)
        yield prof
        # graftlint: disable-next-line=host-sync-in-hot-loop -- the profiled window's closing edge: every recorded kernel must finish inside it
        torch.cuda.synchronize()
        time.sleep(EDGE_S)


@contextlib.contextmanager
def device_launches(*names):
    """Device activity traced over the block (``traced``): yields a dict
    that holds, after the block, the device launches of the kernels whose
    names contain each of ``names``. This is what the card ran, graph
    replays included; a replay calls no wrapper, so the wrappers' counters
    see only eager launches and the launches a capture records."""
    counts = {}
    with traced(cpu=False) as prof:
        yield counts
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    counts.update({n: sum(e.count for e in events if n in e.key)
                   for n in names})


def recounted(run, ok):
    """``run()``, and once more if ``ok`` of its result is false: a second
    guard beside ``traced``'s edge fences, should a device record still
    fall outside its window (see WARM_SCHEDULE). Returns the last result
    and the first one if it was repeated (None otherwise); the caller's
    checks hold the last."""
    out = run()
    if ok(out):
        return out, None
    return run(), out


def _spans_ms(spans) -> float:
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans)


def _decode_tables(lengths, trash_row, B, M, page, P, g):
    """Block tables of B chains: each live row holds the pages its length
    reaches (shuffled page ids), ``trash_row`` (if any) stays all zero."""
    perm = torch.randperm(P - 1, generator=g) + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
    for b in range(B):
        if b != trash_row:
            n = min(int(lengths[b]) // page + 1, M)
            tables[b, :n] = perm[b * M: b * M + n].int()
    return tables


def profiler_edges_phase():
    """How far the card's device timestamps sit from the host clock, and
    whether ``traced``'s fenced windows keep every record: 24 windows over
    200 pairs of tiny elementwise kernels each. For each kernel, its start
    less the host start of its launch: a kernel cannot start before its
    launch, so a negative value is the timestamps' error, and an error
    larger than the time from a window's edge to its first launch drops the
    record (see WARM_SCHEDULE). Every window must hold all 400 kernels."""
    x = torch.zeros(1 << 16, device="cuda")
    n, windows = 200, 24
    seen, offsets = [], []
    for _ in range(windows):
        with traced() as prof:
            for _ in range(n):
                x.add_(1)
                x.mul_(1.0)
        events = prof.profiler.kineto_results.events()
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() == DeviceType.CPU
                  and "LaunchKernel" in e.name()}
        kernels = [e for e in events if e.device_type() == DeviceType.CUDA
                   and "elementwise" in e.name()]
        seen.append(len(kernels))
        offsets += [(e.start_ns() - launch[e.correlation_id()]) / 1e6
                    for e in kernels if e.correlation_id() in launch]
    emit({"phase": "profiler_edges", "edge_s": EDGE_S, "windows": windows,
          "kernels_per_window": 2 * n, "fewest_seen_in_a_window": min(seen),
          "launch_to_start_ms_min": min(offsets),
          "launch_to_start_ms_median": statistics.median(offsets),
          "records_before_their_launch": sum(o < 0 for o in offsets),
          "records": len(offsets)})
    check(all(k == 2 * n for k in seen),
          f"a fenced profiler window lost device records: {seen} of {2 * n}")
    check(len(offsets) == windows * 2 * n,
          "a kernel record has no launch record beside it")


def kernel_phase():
    """B7 at GPT-2 125M geometry (H=12, D=64, page 16, 8 sequences, 64 table
    entries) on four length sets: ``ragged`` (this phase's first set: an
    all-zero trash row, lengths 0 to 1023); ``split_boundaries`` (one split
    of the kernel minus one position, exactly one, one plus one, two, a
    live row of length 0, a chain that fills every table entry, and the
    trash row); ``serve`` (the serve phase's decode lengths: prompts of
    40-96 tokens plus 0-64 generated); ``verify`` (the spec step's verify
    window at spec_k = 3 over the serve chains: 4 rows a chain at
    positions base .. base + 3, the chain's table row repeated, 32 rows).
    Each is checked against the plain version in fp32 and bf16 and timed
    in bf16 (and fp32 on ``ragged`` and ``verify``):
    CUDA-event medians with the L2 flushed, and ``device_ms``, the split
    and merge kernels' own time from torch.profiler (each also alone).
    Then checks alone of the other head sizes (B=4, H=2, 16 table
    entries): D=60 (element loads: D is no multiple of 8), D=128 and D=256
    (a split takes 2 and 4 groups of row passes, merged online)."""
    B, H, D, page, M = 8, 12, 64, 16, 64
    S = M * page
    P = B * M + 1
    g = torch.Generator().manual_seed(0)
    span = pa.pages_per_split(page) * page   # positions of one split
    rng = np.random.default_rng(13)
    serve_lengths = [int(rng.integers(40, 97)) + int(rng.integers(0, 65))
                     for _ in range(B)]
    length_sets = {  # name: (chain lengths, trash row, rows per chain)
        "ragged": ([0, 1, 15, 16, 17, 300, 1023, 0], 7, 1),
        "split_boundaries": ([span - 1, span, span + 1, 2 * span, 0, S - 1,
                              2 * span - 1, 0], 7, 1),
        "serve": (serve_lengths, None, 1),
        "verify": (serve_lengths, None, SPEC_K + 1),
    }
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    _, fp32_peak, hbm = peaks()
    results = {}
    for set_name, (chain_lens, trash_row, n_rows) in length_sets.items():
        # row r of chain b sits at position chain_lens[b] + r
        chains = torch.tensor(chain_lens, dtype=torch.int32)
        tables = _decode_tables(chains + n_rows - 1, trash_row, B, M, page,
                                P, g).repeat_interleave(n_rows, dim=0)
        lengths = (chains[:, None] + torch.arange(n_rows, dtype=torch.int32)
                   ).reshape(-1)
        nb = lengths.shape[0]
        last = torch.clamp(lengths.long(), max=S - 1)
        chain_last = torch.clamp(chains.long() + n_rows - 1, max=S - 1)
        n_visible = int((last + 1).sum())              # K/V rows the rows read
        n_unique = int((chain_last + 1).sum())         # K/V rows of the chains
        n_entries = int((last // page + 1).sum())      # table entries read
        per_set = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q = torch.randn(nb, 1, H, D, generator=g).to(dtype).cuda()
            kp = torch.randn(P, page, H, D, generator=g).to(dtype).cuda()
            vp = torch.randn(P, page, H, D, generator=g).to(dtype).cuda()
            tbl, lens = tables.cuda(), lengths.cuda()
            args = (q, kp, vp, tbl, lens)
            out = pa.paged_decode_attention(*args)
            ref = pa.paged_decode_attention_reference(*args)
            torch.cuda.synchronize()
            tol = TOLERANCE[name]
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"kernel vs plain version in {name}, {set_name} lengths: "
                  f"max_abs_err {err}")
            per_set[name] = {"max_abs_err": err, "tolerance": tol}
            if dtype == torch.float32 and set_name not in ("ragged",
                                                           "verify"):
                continue

            # library yardstick: SDPA over a dense view gathered beforehand
            # (the gather is excluded from its time), masked to positions <=
            # length
            kd = kp[tbl.long()].reshape(nb, S, H, D).transpose(1, 2).contiguous()
            vd = vp[tbl.long()].reshape(nb, S, H, D).transpose(1, 2).contiguous()
            qd = q.transpose(1, 2).contiguous()
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= lens.long()[:, None])
            mask = mask[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
            lib_err = (lib_out.transpose(1, 2).float()
                       - ref.float()).abs().max().item()

            # each K/V row of a chain read once, however many rows read it
            elt = q.element_size()
            n_bytes = (2 * n_unique * H * D * elt + 2 * nb * H * D * elt
                       + 4 * n_entries + 4 * nb)
            n_flops = 4 * n_visible * H * D
            t_bytes = n_bytes / hbm * 1e3
            t_ops = n_flops / fp32_peak * 1e3
            per_set[name].update({
                "ms": time_ms(lambda: pa.paged_decode_attention(*args),
                              200, flush),
                **{f"{part}_device_ms": _device_ms(
                    lambda: pa.paged_decode_attention(*args), 20,
                    f"paged_decode_{part}") for part in ("split", "merge")},
                "plain_ms": time_ms(
                    lambda: pa.paged_decode_attention_reference(*args),
                    20, flush),
                "library_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=mask), 200, flush),
                "library_max_abs_err": lib_err,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes,
                "flops": n_flops,
            })
            per_set[name]["device_ms"] = (per_set[name]["split_device_ms"]
                                          + per_set[name]["merge_device_ms"])
        results[set_name] = {"lengths": lengths.tolist(),
                             "trash_row": trash_row, "rows": nb,
                             "visible_positions": n_visible, **per_set}
    checks = {}
    for cname, (Dc, dtype) in {"float32_D60": (60, torch.float32),
                               "bfloat16_D60": (60, torch.bfloat16),
                               "bfloat16_D128": (128, torch.bfloat16),
                               "float32_D256": (256, torch.float32)}.items():
        lengths = torch.tensor([span - 1, span + 1, 16 * page - 1, 0],
                               dtype=torch.int32)
        tables = _decode_tables(lengths, 3, 4, 16, page, 4 * 16 + 1, g)
        q = torch.randn(4, 1, 2, Dc, generator=g).to(dtype).cuda()
        kp, vp = (torch.randn(4 * 16 + 1, page, 2, Dc, generator=g).to(dtype)
                  .cuda() for _ in range(2))
        args = (q, kp, vp, tables.cuda(), lengths.cuda())
        out = pa.paged_decode_attention(*args).float()
        ref = pa.paged_decode_attention_reference(*args).float()
        tol = TOLERANCE[str(dtype).removeprefix("torch.")]
        checks[cname] = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=tol, rtol=tol),
              f"kernel vs plain version, {cname}: max_abs_err {checks[cname]}")
    emit({"phase": "kernels", "kernel": "paged_decode_attention",
          "checks": checks,
          "shape": {"B": B, "H": H, "D": D, "page_size": page,
                    "max_pages": M, "n_pages": P,
                    "pages_per_split": pa.pages_per_split(page),
                    "splits": -(-M // pa.pages_per_split(page))},
          "library_call": "F.scaled_dot_product_attention on a dense view "
                          "gathered beforehand (gather excluded)",
          "results": results})
    return results


def parity_phase():
    """fp32 full-width GPT-2 125M: engine greedy == uncached argmax; every
    decode step is one graph replay (no wrapper launches B7 while the
    scheduler runs), and the device trace shows B7 n_layer times a
    step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt2_125m(device="cuda", seed=0)
    cfg = model.cfg
    engine = InferenceEngine(model, n_slots=8, max_len=1024, prefill_len=128,
                             cache_kind="paged", page_size=16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 37)]
    n_new = 12

    def run():
        sched = Scheduler(engine, emit_events=False)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=n_new))
        pa.launches = 0
        replays = engine.replays
        with device_launches(B7_TRACE_NAME) as device:
            finished = sched.run()
        return (sched, finished, pa.launches, engine.replays - replays,
                device[B7_TRACE_NAME])
    (sched, finished, launches, replays, device), lost = recounted(
        run, lambda r: r[4] == cfg.n_layer * r[0].decode_steps)
    got = {f.request_id: f.tokens for f in finished}
    want = {}
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            seq = [int(t) for t in p]
            for _ in range(n_new):
                logits = model(torch.tensor([seq], device="cuda"))
                seq.append(int(torch.argmax(logits[0, -1])))
            want[rid] = seq[len(p):]
    expected = cfg.n_layer * sched.decode_steps
    emit({"phase": "parity", "dtype": "float32", "requests": len(prompts),
          "new_tokens": n_new, "tokens_match": got == want,
          "device_launches": device, "expected_launches": expected,
          "wrapper_launches": launches,
          "first_window_device_launches": lost and lost[4],
          "decode_steps": sched.decode_steps, "graph_replays": replays})
    check(got == want, f"greedy tokens {got} != uncached argmax {want}")
    check(replays == sched.decode_steps and launches == 0,
          f"graph replays {replays} in {sched.decode_steps} decode steps, "
          f"{launches} wrapper launches of B7 (an eager step)")
    check(device == expected > 0,
          f"B7 device launches {device} != n_layer x decode steps {expected}")


def _serve_requests(vocab: int, n: int = 16):
    """The serve phases' requests (seed 2): a warm-up prompt of 40 tokens,
    then ``n`` prompts of one 32-token shared prefix plus 8-64 random
    tokens (the first 16 are the serve phase's at any ``n``)."""
    rng = np.random.default_rng(2)
    warm = rng.integers(0, vocab, 40)
    shared = rng.integers(0, vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab,
                                                    int(rng.integers(8, 65)))])
               for _ in range(n)]
    return warm, shared, prompts


def _serve_run(engine, warm=True, count=False):
    """Warm-up on a throwaway scheduler (its own cache and radix tree;
    skipped without ``warm``), then the 16 requests on a fresh one (its
    step program captured when it is built), B7's wrapper count set to 0
    just before and read just after, and with ``count`` B7's device
    launches traced meanwhile (the wall time is then not one to report).
    Returns the scheduler, the finished requests, the wall time, B7's
    wrapper launches and device launches (None without ``count``), the
    graph replays, the capture's host time, the device memory reserved at
    the capture beyond the caches (the graph's pool), the shared prefix and
    the prompts."""
    warm_prompt, shared, prompts = _serve_requests(engine.cfg.vocab_size)
    if warm:
        throwaway = Scheduler(engine, emit_events=False)
        throwaway.submit(Request(prompt=warm_prompt, max_new_tokens=4))
        throwaway.run()
        del throwaway

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    sched = Scheduler(engine, emit_events=False)
    caches = [c for c in (sched.cache, sched.draft_cache) if c is not None]
    pool = torch.cuda.memory_reserved() - reserved - sum(
        t.nbytes for c in caches for t in (c.k, c.v, c.lengths))
    program = engine._program("spec" if engine.spec_k else "decode",
                              sched.cache, sched.draft_cache)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS))
    torch.cuda.synchronize()
    pa.launches = 0
    replays = engine.replays
    t0 = time.perf_counter()
    with (device_launches(B7_TRACE_NAME) if count
          else contextlib.nullcontext({})) as device:
        finished = sched.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    replays = engine.replays - replays
    sched.allocator.check()
    check(len(finished) == len(prompts),
          f"{len(finished)} of {len(prompts)} requests done")
    check(all(len(f.tokens) == SERVE_NEW_TOKENS and f.reason == "length"
              and all(0 <= t < engine.cfg.vocab_size for t in f.tokens)
              for f in finished), "a request's tokens are short or out of vocab")
    check(int(sched.allocator.reserved.sum()) == 0, "reservations not drained")
    return dict(sched=sched, finished=finished, wall=wall, launches=launches,
                device=device.get(B7_TRACE_NAME),
                replays=replays, capture_s=program.capture_s,
                pool_reserved_bytes=pool, shared=shared, prompts=prompts)


def _serve_pair(engine, what, per_step):
    """``_serve_run`` through the graphs, then through the eager bodies on
    the same engine, then through the graphs once more with B7's device
    launches traced (``counted``). The graph run's step count is held to
    its replays, with no wrapper launch of B7 (an eager step would make
    some); the eager run's wrapper launches and the counted run's device
    launches to ``per_step`` x steps, and the counted run's streams to the
    graph run's. Returns the three runs, the first counted run if it was
    repeated (see ``recounted``), the graph run's streams and the number
    of requests whose streams agree with the eager run's."""
    graph = _serve_run(engine)
    with eager_bodies(engine):
        eager = _serve_run(engine)
    counted, lost = recounted(
        lambda: _serve_run(engine, warm=False, count=True),
        lambda r: r["device"] == per_step * r["sched"].decode_steps)
    streams = [{f.request_id: f.tokens for f in r["finished"]}
               for r in (graph, eager, counted)]
    equal = sum(streams[0][r] == streams[1].get(r) for r in streams[0])
    steps = graph["sched"].decode_steps
    check(graph["replays"] == steps > 0 and eager["replays"] == 0
          and graph["launches"] == 0,
          f"{what}: {graph['replays']} replays and {graph['launches']} "
          f"wrapper launches of B7 in {steps} steps (graphs), "
          f"{eager['replays']} replays (eager)")
    check(eager["launches"] == per_step * eager["sched"].decode_steps > 0,
          f"{what}: eager B7 launches {eager['launches']} != {per_step} x "
          f"{eager['sched'].decode_steps} steps")
    check(counted["device"] == per_step * counted["sched"].decode_steps > 0
          and streams[2] == streams[0],
          f"{what}: B7 device launches {counted['device']} through the "
          f"graphs != {per_step} x {counted['sched'].decode_steps} steps, "
          f"or the counted run's streams differ")
    lost = lost and lost["device"]
    return graph, eager, counted, lost, streams[0], equal


def _latency(run, step_key="decode_step") -> dict:
    stats = run["sched"].stats()
    return {"tokens_per_s": stats["tokens_generated"] / run["wall"],
            f"{step_key}_p50_s": stats["decode_step_p50_s"],
            f"{step_key}_p99_s": stats["decode_step_p99_s"],
            "ttft_p50_s": stats["ttft_p50_s"], "wall_s": run["wall"],
            "steps": run["sched"].decode_steps,
            "kernel_launches": run["launches"]}


def serve_phase():
    """The main path: bf16 GPT-2 125M serving 16 shared-prefix requests."""
    model = gpt2_125m(device="cuda", seed=1, dtype=torch.bfloat16)
    cfg = model.cfg
    engine = InferenceEngine(model, **SERVE_KW)
    graph, eager, counted, lost, streams, equal = _serve_pair(
        engine, "serve", cfg.n_layer)
    sched, finished, wall = graph["sched"], graph["finished"], graph["wall"]
    launches, shared, prompts = counted["device"], graph["shared"], \
        graph["prompts"]
    stats = sched.stats()
    emit({"phase": "serve", "model": "gpt2-125m", "dtype": "bfloat16",
          "n_slots": SERVE_KW["n_slots"], "max_len": SERVE_KW["max_len"],
          "page_size": SERVE_KW["page_size"],
          "prefill_len": SERVE_KW["prefill_len"],
          "requests": len(prompts), "shared_prefix": len(shared),
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW_TOKENS,
          "finished": len(finished), "wall_s": wall,
          "tokens_per_s": stats["tokens_generated"] / wall,
          "decode_step_p50_s": stats["decode_step_p50_s"],
          "decode_step_p99_s": stats["decode_step_p99_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "radix_hits": stats["radix_hits"],
          "prefill_tokens_cached": stats["prefill_tokens_cached"],
          "decode_steps": sched.decode_steps, "kernel_launches": launches,
          "kernel_launches_from": "device trace of a repeat of the run",
          "first_trace_kernel_launches": lost,
          "wrapper_launches": graph["launches"],
          "graph_replays": graph["replays"], "capture_s": graph["capture_s"],
          "graph_pool_reserved_bytes": graph["pool_reserved_bytes"],
          "eager": _latency(eager), "streams_equal_to_eager": equal})
    check(stats["radix_hits"] >= len(prompts) - 1,
          "shared prefix missed the radix")
    return launches, engine, streams, _latency(graph)


def serve_spec_phase(model, serve_streams):
    """Speculative serving's main path: the serve phase's model, requests
    and warm-up with ``spec_k = 3`` and a 6-of-12-layer self-draft. Every
    spec round launches B7 ``DRAFT_LAYERS * SPEC_K`` times for the draft's
    one-token forwards and ``n_layer`` times for the verify window; prefill
    launches none. In bf16 the verify window's logits come from another
    arithmetic path than a one-token step's, so the share of streams equal
    to the serve phase's is reported, with no limit."""
    cfg = model.cfg
    engine = InferenceEngine(model, spec_k=SPEC_K, draft_layers=DRAFT_LAYERS,
                             **SERVE_KW)
    per_round = DRAFT_LAYERS * SPEC_K + cfg.n_layer
    graph, eager, counted, lost, streams, equal = _serve_pair(
        engine, "serve_spec", per_round)
    sched, finished, wall = graph["sched"], graph["finished"], graph["wall"]
    launches, prompts = counted["device"], graph["prompts"]
    stats = sched.stats()
    emit({"phase": "serve_spec", "model": "gpt2-125m", "dtype": "bfloat16",
          "spec_k": SPEC_K, "draft_layers": DRAFT_LAYERS,
          "requests": len(prompts), "new_tokens": SERVE_NEW_TOKENS,
          "finished": len(finished), "wall_s": wall,
          "tokens_per_s": stats["tokens_generated"] / wall,
          "spec_round_p50_s": stats["decode_step_p50_s"],
          "spec_round_p99_s": stats["decode_step_p99_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "accept_rate": stats["accept_rate"],
          "tokens_per_target_forward": stats["tokens_per_target_forward"],
          "tokens_per_slot_round": 1 + stats["accept_rate"] * SPEC_K,
          "spec_rounds": sched.decode_steps,
          "kernel_launches": launches,
          "kernel_launches_from": "device trace of a repeat of the run",
          "first_trace_kernel_launches": lost,
          "wrapper_launches": graph["launches"],
          "expected_launches": per_round * sched.decode_steps,
          "streams_equal_to_serve": sum(
              streams[r] == serve_streams[r] for r in serve_streams)
          / len(serve_streams),
          "graph_replays": graph["replays"], "capture_s": graph["capture_s"],
          "graph_pool_reserved_bytes": graph["pool_reserved_bytes"],
          "eager": {**_latency(eager, "spec_round"),
                    "accept_rate": eager["sched"].stats()["accept_rate"]},
          "streams_equal_to_eager": equal})
    return launches, engine


def _spec_parity_run(engine, prompts, n_new, swap_at=None, eager=False,
                     count=False):
    """Serve ``prompts`` on ``engine`` (B7's wrapper count from 0) through
    its graphs, or its eager bodies with ``eager``, recording each spec
    round's per-slot counts, with ``count`` B7's device launches traced; at
    step ``swap_at`` swap in clones of the current parameters (and the
    draft's) and check that every parameter and every compute-dtype copy
    kept its ``data_ptr``. Returns the scheduler, the streams, B7's wrapper
    launches, the per-round counts, the swap's report, the graph replays
    and B7's device launches (None without ``count``)."""
    sched = Scheduler(engine, emit_events=False)
    rounds = []
    if engine.spec_k:
        spec_decode = engine.spec_decode

        def recorded(*args):
            out = spec_decode(*args)
            rounds.append(out[3].tolist())
            return out
        engine.spec_decode = recorded
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=n_new))
    models = [m for m in (engine.model, engine.draft_model) if m is not None]

    def ptrs():
        return [t.data_ptr() for m in models
                for t in (*m.parameters(), *m._copies.values())]

    swap = None
    finished = []
    torch.cuda.synchronize()
    pa.launches = 0
    replays = engine.replays
    with (eager_bodies(engine) if eager else contextlib.nullcontext()), \
            (device_launches(B7_TRACE_NAME) if count
             else contextlib.nullcontext({})) as device:
        while sched.has_work:
            finished.extend(sched.step())
            if sched.decode_steps == swap_at and swap is None:
                before = ptrs()
                clones = [{n: t.clone() for n, t in m.state_dict().items()}
                          for m in models]
                cost = sched.swap_params(*clones[:1], draft_params=(
                    clones[1] if len(clones) > 1 else None))
                swap = {"at_step": swap_at, "bytes_moved": cost.bytes_moved,
                        "data_ptr_unchanged": before == ptrs()}
    torch.cuda.synchronize()
    if engine.spec_k:
        del engine.spec_decode
    return (sched, {f.request_id: f.tokens for f in finished}, pa.launches,
            rounds, swap, engine.replays - replays, device.get(B7_TRACE_NAME))


def spec_parity_phase():
    """GPT-2 125M at full width, fp32, TF32 off: 8 requests of 24-72
    tokens, 32 new tokens each, on the slotted and the paged cache (page
    16), each served twice: through the step graphs and through the eager
    step bodies. Plain decode, the self-draft (6 layers) and the separate
    draft model (distilgpt2's shape, 6 x 768, its weights the target's
    first six layers with wte, wpe and ln_f), all with spec_k = 3 where
    they speculate.

    spec_parity (on the graph runs): both drafts give the plain
    scheduler's greedy streams token for token, and the same accept counts
    in every round. On the paged cache every run swaps in equal weights
    after its third step (every ``data_ptr`` kept, of the parameters and of
    their compute-dtype copies; streams unchanged); B7 launches n_layer
    times a decode step, ``DRAFT_LAYERS * SPEC_K + n_layer`` times a
    self-draft round and ``n_layer`` times a draft-model round (its draft
    cache is slotted), by the device trace of each paged graph run, and the
    slotted runs launch it never; after the
    drain every reservation and every non-radix page is back in the pool.
    One paged self-draft run samples (temperature 0.8, top-k 40): leftover
    sampling on the card fills every budget with tokens of the vocab.

    graph_parity: every graph run's streams equal its eager twin's token
    for token, with the same accept counts in every round; its B7 device
    launches equal the eager twin's wrapper launches; a graph run replays
    exactly once a step or round, with no wrapper launch of B7, and its
    eager twin never. The sampled spec run and a sampled plain decode run
    (temperature 0.8, top-k 40, the generator registered with the graph)
    give their eager twins' streams for the same seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt2_125m(device="cuda", seed=0)
    cfg = model.cfg
    draft = GPT2(GPT2Config(n_layer=DRAFT_LAYERS), device="cuda", seed=1)
    target_state = model.state_dict()
    draft_params = {n: target_state[n] for n in draft.state_dict()}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(24, 73)))
               for _ in range(8)]
    n_new = 32
    out, graph_out = {}, {}

    def twins(what, make, swap_at, per_step):
        """The graph run and its eager twin on fresh engines: checks of
        graph_parity and of the launch counts; returns the graph run."""
        count = per_step > 0
        graph, lost = recounted(
            lambda: _spec_parity_run(make(), prompts, n_new, swap_at,
                                     count=count),
            lambda r: not count or r[6] == per_step * r[0].decode_steps)
        eager = _spec_parity_run(make(), prompts, n_new, swap_at, eager=True)
        sched, streams, wrapper, rounds, swap, replays, device = graph
        launches = device if count else wrapper
        steps = sched.decode_steps
        graph_out[what] = {
            "steps": steps, "replays": replays,
            "eager_replays": eager[5], "streams_equal": streams == eager[1],
            "round_counts_equal": rounds == eager[3],
            "device_launches": device, "wrapper_launches": wrapper,
            "first_trace_device_launches": lost and lost[6],
            "eager_launches": eager[2]}
        check(streams == eager[1] and rounds == eager[3],
              f"graph_parity {what}: graph and eager streams or accept "
              f"counts differ")
        check(replays == steps > 0 and eager[5] == 0 and wrapper == 0,
              f"graph_parity {what}: {replays} replays and {wrapper} wrapper "
              f"launches of B7 in {steps} steps, eager {eager[5]} replays")
        check(launches == per_step * steps and eager[2] == per_step
              * eager[0].decode_steps,
              f"graph_parity {what}: B7 launches {launches} (graphs, device "
              f"trace), {eager[2]} (eager), expected {per_step} a step")
        if swap_at is not None:
            for r in (swap, eager[4]):
                check(r is not None and r["data_ptr_unchanged"]
                      and r["bytes_moved"] > 0, f"{what}: swap {r}")
        return sched, streams, launches, rounds, swap

    for kind in ("slotted", "paged"):
        kw = dict(SERVE_KW, cache_kind=kind)
        paged = kind == "paged"
        swap_at = 3 if paged else None
        _, plain, plain_launches, _, _ = twins(
            f"{kind}/plain", lambda: InferenceEngine(model, **kw), swap_at,
            cfg.n_layer if paged else 0)
        runs = {}
        for flavour, spec_kw, per_round in (
                ("self_draft", dict(draft_layers=DRAFT_LAYERS),
                 DRAFT_LAYERS * SPEC_K + cfg.n_layer),
                ("draft_model", dict(draft_model=draft,
                                     draft_params=draft_params),
                 cfg.n_layer)):
            sched, streams, launches, rounds, swap = twins(
                f"{kind}/{flavour}",
                lambda: InferenceEngine(model, spec_k=SPEC_K, **spec_kw,
                                        **kw),
                swap_at, per_round if paged else 0)
            stats = sched.stats()
            runs[flavour] = {
                "streams_equal": streams == plain, "rounds": len(rounds),
                "accept_rate": stats["accept_rate"],
                "tokens_per_target_forward":
                    stats["tokens_per_target_forward"],
                "launches": launches,
                "expected_launches": (per_round if paged else 0)
                * sched.decode_steps,
                "swap": swap, "round_counts": rounds}
            check(streams == plain,
                  f"spec_parity {kind} {flavour}: greedy streams differ from "
                  f"the plain scheduler's")
            if paged:
                alloc = sched.allocator
                alloc.check()
                pinned = int((alloc.refcount[1:] > 0).sum())
                check(int(alloc.reserved.sum()) == 0
                      and alloc.free_pages == alloc.n_pages - 1 - pinned,
                      f"spec_parity {kind} {flavour}: pages not returned")
        check(runs["draft_model"]["round_counts"]
              == runs["self_draft"]["round_counts"],
              f"spec_parity {kind}: the draft model's accept counts differ "
              f"from the self-draft's")
        for r in runs.values():
            del r["round_counts"]
        out[kind] = {"plain_launches": plain_launches, **runs}
    # sampling on the card from CUDA generators registered with the
    # graphs: leftover sampling fills every budget with tokens of the
    # vocab, and both sampled runs give their eager twins' streams
    sampled = SamplingParams(temperature=0.8, top_k=40)
    per_round = DRAFT_LAYERS * SPEC_K + cfg.n_layer
    sched, streams, launches, _, _ = twins(
        "paged/self_draft/sampled",
        lambda: InferenceEngine(model, spec_k=SPEC_K,
                                draft_layers=DRAFT_LAYERS, sampling=sampled,
                                seed=5, **SERVE_KW), None, per_round)
    out["sampled"] = {"temperature": 0.8, "top_k": 40,
                      "rounds": sched.decode_steps,
                      "accept_rate": sched.stats()["accept_rate"],
                      "launches": launches}
    check(len(streams) == len(prompts)
          and all(len(t) == n_new and all(0 <= x < cfg.vocab_size for x in t)
                  for t in streams.values()),
          f"spec_parity sampled: {out['sampled']}")
    twins("paged/plain/sampled",
          lambda: InferenceEngine(model, sampling=sampled, seed=6,
                                  **SERVE_KW), None, cfg.n_layer)
    emit({"phase": "spec_parity", "dtype": "float32", "spec_k": SPEC_K,
          "draft_layers": DRAFT_LAYERS, "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
          **out})
    emit({"phase": "graph_parity", "dtype": "float32", "tf32": False,
          **graph_out})


def serve_example_phase():
    """The entry point ``examples.serve_gpt2``'s ``main`` at GPT-2 125M's
    shape, paged, with a 16-token shared prefix and ``--spec-k 3`` (its
    default draft: 6 of 12 layers), bf16 on the card: it returns 0 and
    prints its accept-rate line."""
    argv = ["--layers", "12", "--embd", "768", "--heads", "12", "--vocab",
            "50257", "--seq-len", "1024", "--cache", "paged", "--page-size",
            "16", "--shared-prefix", "16", "--slots", "8", "--prefill-len",
            "128", "--requests", "16", "--max-new-tokens", "64", "--spec-k",
            "3"]
    buf = io.StringIO()
    pa.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_gpt2.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    spec = [ln for ln in lines if ln.startswith("spec k=3: accept-rate")]
    emit({"phase": "serve_example", "argv": argv, "returned": rc,
          "wall_s": wall, "kernel_launches": pa.launches,
          "summary": lines[lines.index("") + 1:] if "" in lines else lines})
    check(rc == 0 and len(spec) == 1 and pa.launches > 0,
          f"serve_example returned {rc}, printed {lines[-4:]}")


def _device_kernels(prof):
    """Device-side events summed by name, without the ranges that
    ``record_function`` annotations (``Optimizer.step#...``) leave on the
    device timeline: those cover kernels already counted. Such a range
    carries the name of its host-side event, which no kernel does."""
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host
            and not getattr(e, "is_user_annotation", False)]


def _profile_window(sched, spans):
    """torch.profiler over 10 steady steps of ``sched`` after one warm-up
    step inside the window; ``spans`` (a list, or None) collects CUDA events
    around each graph replay."""
    with traced(sched.step) as prof:
        if spans is not None:
            spans.clear()
        steps0 = sched.decode_steps
        t0 = time.perf_counter()
        for _ in range(10):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_steps = sched.decode_steps - steps0
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    paged_ms = sum(e.self_device_time_total for e in kernels
                   if "paged_decode" in e.key) / 1e3
    paged_calls = sum(e.count for e in kernels
                      if "paged_decode_split" in e.key)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"decode_steps": n_steps,
           "active_slots": int(sched.active.sum()),
           "paged_decode_launches_per_step": paged_calls / n_steps,
           "wall_ms_per_step": wall_ms / n_steps,
           "device_busy_ms_per_step": busy_ms / n_steps,
           "device_busy_share": busy_ms / wall_ms,
           "paged_decode_ms_per_step": paged_ms / n_steps,
           "device_kernels_per_step": sum(e.count for e in kernels) / n_steps,
           "top_kernels": [{"name": e.key[:80],
                            "ms_per_step":
                                e.self_device_time_total / 1e3 / n_steps,
                            "calls_per_step": e.count / n_steps}
                           for e in top]}
    if spans is not None:
        replay_ms = _spans_ms(spans)
        out.update(replays=len(spans), replay_ms_per_step=replay_ms / n_steps,
                   replay_share_of_wall=replay_ms / wall_ms)
    return out


def profile_phase(engine, per_step, phase="profile", new_tokens=16):
    """Where a decode step's time goes: 10 steady decode steps (spec rounds,
    for a speculative engine: ``spec_profile``) of the serve engine at 8
    active slots, through the graphs and then through the eager bodies:
    host wall time against the profiler's device busy time, B7's time and
    launches (``per_step`` a step, in both modes: the trace lists a
    replay's kernels), the top kernels by device time and, for the graphs,
    the device span of each replay between CUDA events. A window whose B7
    count is off is profiled once more (see ``recounted``)."""
    out, lost = {}, {}

    def window(mode):
        rng = np.random.default_rng(3)
        sched = Scheduler(engine, emit_events=False)
        for _ in range(engine.n_slots):
            sched.submit(Request(prompt=rng.integers(0, engine.cfg.vocab_size,
                                                     48),
                                 max_new_tokens=new_tokens))
        sched.step()  # admissions and the first step stay outside
        torch.cuda.synchronize()
        with (replay_spans() if mode == "graph" else eager_bodies(engine)
              ) as spans:
            return _profile_window(sched, spans)

    for mode in ("graph", "eager"):
        out[mode], first = recounted(
            lambda: window(mode),
            lambda r: r["paged_decode_launches_per_step"] == per_step)
        lost[mode] = first and first["paged_decode_launches_per_step"]
    emit({"phase": phase, **out["graph"], "eager": out["eager"],
          "expected_paged_decode_launches_per_step": per_step,
          "first_window_launches_per_step": lost})
    check(out["graph"]["replays"] == out["graph"]["decode_steps"],
          f"{phase}: {out['graph']['replays']} replays in "
          f"{out['graph']['decode_steps']} steps")
    for mode in out:
        check(out[mode]["paged_decode_launches_per_step"] == per_step,
              f"{phase} ({mode}): B7 launches "
              f"{out[mode]['paged_decode_launches_per_step']} a step in the "
              f"trace, expected {per_step}")


def _flash_inputs(B, T, H, D, dtype, g):
    """q, k, v as the strided views of one fused qkv projection (the layout
    GPT-2's c_attn split hands the kernels) and a contiguous upstream grad."""
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(dtype).cuda()
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g).to(dtype).cuda()
    return q, k, v, do


def _flash_check(q, k, v, do, tol):
    """B1-B3 each against its plain version; the backward kernels take the
    plain forward's lse and delta, so each kernel is held on its own.
    Returns the max abs error per kernel, lse and delta."""
    out, lse = fa.flash_causal_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_causal_fwd_reference(q, k, v)
    delta = torch.einsum("bthd,bthd->bht", do.float(),
                         ref_out.float()).contiguous()
    args = (q, k, v, do, ref_lse, delta)
    pairs = {
        "fwd": [(out, ref_out), (lse, ref_lse)],
        "dq": [(fa.flash_causal_dq(*args), fa.flash_causal_dq_reference(*args))],
        "dkv": list(zip(fa.flash_causal_dkv(*args),
                        fa.flash_causal_dkv_reference(*args))),
    }
    torch.cuda.synchronize()
    errs = {}
    for key, items in pairs.items():
        errs[key] = 0.0
        for a, b in items:
            a, b = a.float(), b.float()
            err = (a - b).abs()
            check(bool((err <= tol * (1 + b.abs())).all()),
                  f"flash {key} kernel vs plain version ({q.dtype}, "
                  f"T={q.shape[1]}): max_abs_err {err.max().item()}")
            errs[key] = max(errs[key], err.max().item())
    return errs, ref_lse, delta


def _device_ms(fn, reps: int, match: str) -> float:
    """Device time of one call of the kernels whose name holds ``match``,
    from torch.profiler over ``reps`` calls (no host work included; the
    host activity is recorded so that ``_device_kernels`` can drop the
    device-side ranges of host annotations). A window that saw none of
    them lost its records (see WARM_SCHEDULE) and is taken once more."""
    def window():
        with traced(fn) as prof:
            for _ in range(reps):
                fn()
        return sum(e.self_device_time_total for e in _device_kernels(prof)
                   if match in e.key) / 1e3 / reps

    ms, _ = recounted(window, lambda ms: ms > 0)
    check(ms > 0, f"the profiler saw no device time of {match!r} kernels "
                  f"in two windows")
    return ms


def _sdpa_times(q, k, v, do, flush, **sdpa_kw):
    """SDPA forward and autograd backward (dq, dk and dv together) with
    ``sdpa_kw`` (``is_causal=True``, or a boolean ``attn_mask``) under each
    backend of SDPA_BACKENDS, on [B, H, T, D] copies made beforehand (the
    transposes excluded): CUDA-event times as for the kernels, and the
    device time of all the kernels a call launches (``*_device``); None
    where the backend refuses the call."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    times = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

                def lib_fwd():
                    with torch.no_grad():
                        F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

                def lib_bwd():
                    torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                        retain_graph=True)

                times[name] = {"fwd": time_ms(lib_fwd, 50, flush),
                               "bwd": time_ms(lib_bwd, 50, flush),
                               "fwd_device": _device_ms(lib_fwd, 10, ""),
                               "bwd_device": _device_ms(lib_bwd, 10, "")}
                del lib_out
        except RuntimeError:
            times[name] = None
    return times


def _fastest(times, key):
    """(device ms, backend) of the fastest backend for ``key`` (fwd or
    bwd). Device time, because the CUDA-event window of the autograd
    backward also holds its host work, which can outlast the L2 flush."""
    ms, name = min((t[f"{key}_device"], n) for n, t in times.items()
                   if t is not None)
    return ms, name


def flash_kernel_phase():
    """B1-B3 at the training path's shape (B=8, T=1024, H=12, D=64) in fp32
    (the CUDA-core route) and bf16 (the Hopper route), each
    checked against its plain version and timed; then checks alone: a
    ragged T=1000 in fp32, bf16 and fp16 (B=2), and D=128 in bf16 (B=1,
    T=256). Times are CUDA-event medians with the L2 flushed before each
    call by a 512 MB write, long enough that the wrapper's host work is
    enqueued before the card reaches the kernel; ``device_ms`` is the
    kernel's own time from torch.profiler. The library call is SDPA under
    each backend that takes it; the fastest by device time is the
    yardstick."""
    B, T, H, D = 8, 1024, 12, 64
    g = torch.Generator().manual_seed(4)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device="cuda")
    bf16_peak, fp32_peak, hbm = peaks()
    n_vis = B * H * T * (T + 1) // 2   # visible (query, key) pairs
    checks = {  # name: (B, T, H, D, dtype)
        "float32_T1000": (2, 1000, H, D, torch.float32),
        "bfloat16_T1000": (2, 1000, H, D, torch.bfloat16),
        "float16_T1000": (2, 1000, H, D, torch.float16),
        "bfloat16_D128_T256": (1, 256, H, 128, torch.bfloat16),
    }
    check_errs = {}
    for cname, (Bc, Tc, Hc, Dc, dtype) in checks.items():
        tol = FLASH_TOLERANCE[str(dtype).removeprefix("torch.")]
        check_errs[cname] = _flash_check(
            *_flash_inputs(Bc, Tc, Hc, Dc, dtype, g), tol)[0]
    results, sdpa = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = FLASH_TOLERANCE[name]
        q, k, v, do = _flash_inputs(B, T, H, D, dtype, g)
        errs, lse, delta = _flash_check(q, k, v, do, tol)
        args = (q, k, v, do, lse, delta)
        sdpa[name] = _sdpa_times(q, k, v, do, flush, is_causal=True)
        library = {key: _fastest(sdpa[name], key) for key in ("fwd", "bwd")}
        elt, n = q.element_size(), B * T * H * D
        stats = B * H * T * 4                 # one fp32 [B, H, T] vector
        work = {  # bytes (inputs read once, outputs written once), flops
            "fwd": (4 * n * elt + stats, 4 * D * n_vis),
            "dq": (5 * n * elt + 2 * stats, 6 * D * n_vis),
            "dkv": (6 * n * elt + 2 * stats, 8 * D * n_vis),
        }
        calls = {
            "fwd": (lambda: fa.flash_causal_fwd(q, k, v),
                    lambda: fa.flash_causal_fwd_reference(q, k, v)),
            "dq": (lambda: fa.flash_causal_dq(*args),
                   lambda: fa.flash_causal_dq_reference(*args)),
            "dkv": (lambda: fa.flash_causal_dkv(*args),
                    lambda: fa.flash_causal_dkv_reference(*args)),
        }
        peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
        per = {}
        for key, (kernel, plain) in calls.items():
            n_bytes, n_flops = work[key]
            t_bytes = n_bytes / hbm * 1e3
            t_ops = n_flops / peak * 1e3
            ms = time_ms(kernel, 20, flush)
            lib_ms, lib_backend = library["fwd" if key == "fwd" else "bwd"]
            per[key] = {
                "max_abs_err": errs[key],
                "tolerance": tol,
                "ms": ms,
                "device_ms": _device_ms(kernel, 10,
                                        f"flash_causal_{key}_kernel"),
                "plain_ms": time_ms(plain, 3, flush),
                "library_ms": lib_ms,
                "library_backend": lib_backend,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes,
                "flops": n_flops,
                "tflops": n_flops / ms / 1e9,
                "ms_over_bound": ms / max(t_bytes, t_ops),
            }
        per["dq_plus_dkv_ms"] = per["dq"]["ms"] + per["dkv"]["ms"]
        results[name] = per
    emit({"phase": "kernels", "kernel": "flash_causal (B1 fwd, B2 dq, B3 dkv)",
          "shape": {"B": B, "T": T, "H": H, "D": D,
                    "layout": "q/k/v strided views of a fused [B, T, 3*H*D]"},
          "route": {"float32": "CUDA cores (B1-B3)",
                    "bfloat16": "wgmma + TMA (sm90; B1-B3)"},
          "checks": {k_: {"shape": list(v_[:4]),
                          "dtype": str(v_[4]).removeprefix("torch."),
                          "max_abs_err": check_errs[k_]}
                     for k_, v_ in checks.items()},
          "tolerance": "|kernel - plain| <= tol * (1 + |plain|)",
          "library_call": "F.scaled_dot_product_attention(is_causal=True) "
                          "forward for B1; its autograd backward (dq, dk "
                          "and dv together) for B2 and B3; the fastest of "
                          "the backends below by device time",
          "sdpa_ms_by_backend": sdpa,
          "peak_flops": {"bfloat16": bf16_peak, "float32": fp32_peak},
          "results": results})
    return results


def _zigzag_positions(owner, n, T):
    """Global positions of rank ``owner``'s chunk of a zigzag ring."""
    half = T // 2
    idx = torch.arange(half)
    return torch.cat([owner * half + idx, (2 * n - 1 - owner) * half + idx])


def _masked_check(q, k, v, do, q_pos, kv_pos, tol, out_dtype=None):
    """B4-B6 each against its plain version on one position pattern; the
    backward kernels take the plain forward's lse and delta, so each kernel
    is held on its own. Returns the max abs error per kernel and the
    kernels' own results."""
    pos = (q_pos, kv_pos)
    out, lse = fa.flash_masked_fwd(q, k, v, *pos, out_dtype=out_dtype)
    ref_out, ref_lse = fa.flash_masked_fwd_reference(q, k, v, *pos,
                                                     out_dtype=out_dtype)
    delta = fa.attention_delta(do, ref_out)
    args = (q, k, v, do, ref_lse, delta, *pos)
    dq, (dk, dv) = fa.flash_masked_dq(*args), fa.flash_masked_dkv(*args)
    pairs = {
        "mfwd": [(out, ref_out), (lse, ref_lse)],
        "mdq": [(dq, fa.flash_masked_dq_reference(*args))],
        "mdkv": list(zip((dk, dv), fa.flash_masked_dkv_reference(*args))),
    }
    torch.cuda.synchronize()
    errs = {}
    for key, items in pairs.items():
        errs[key] = 0.0
        for a, b in items:
            a, b = a.float(), b.float()
            err = (a - b).abs()
            check(bool((err <= tol * (1 + b.abs())).all()),
                  f"masked flash {key} kernel vs plain version ({q.dtype}, "
                  f"Tq={q.shape[1]}, Tk={k.shape[1]}): max_abs_err "
                  f"{err.max().item()}")
            errs[key] = max(errs[key], err.max().item())
    return errs, (out, lse, dq, dk, dv)


def _masked_inputs(Bp, Tq, Tk, H, D, dtype, g):
    """q, k, v as strided views of fused projections (k and v of their own
    when Tk != Tq), and a contiguous upstream grad."""
    qkv = torch.randn(Bp, Tq, 3 * H * D, generator=g).to(dtype).cuda()
    q = qkv[..., :H * D].view(Bp, Tq, H, D)
    kv = (qkv if Tk == Tq else torch.randn(
        Bp, Tk, 3 * H * D, generator=g).to(dtype).cuda())
    k, v = (kv[..., i * H * D:(i + 1) * H * D].view(Bp, Tk, H, D)
            for i in (1, 2))
    do = torch.randn(Bp, Tq, H, D, generator=g).to(dtype).cuda()
    return q, k, v, do


def masked_kernel_phase(resources):
    """B4-B6 on every position pattern a ring hop gives them, in fp32 and
    bf16, on strided q/k/v views of a fused projection (B=8, T=1024, H=12,
    D=64): the diagonal hop, an all-visible past hop, an all-future hop
    (exact zeros, lse -1e30), hop 1 of rank 1 of a 4-rank zigzag ring, no
    positions, a rectangular hop (Tq=256, Tk=1024), a ragged T=1000 with
    zigzag positions (B=2; each tile pair straddling the jump between the
    two runs) and, in bf16, fp32 partial outputs; then checks alone of the
    Hopper B4's and B6's other instantiations: a ragged fp16 zigzag (B=2,
    T=1000) and a bf16 zigzag at D=128 (B=1, T=256). Times are taken on the
    diagonal hop (the one train_cp runs): CUDA-event medians with the L2
    flushed by a 512 MB write, and ``device_ms``, the kernel's own time
    from torch.profiler. The library call is
    ``F.scaled_dot_product_attention`` with the boolean mask built from the
    positions under each backend of SDPA_BACKENDS that takes it; the
    fastest by device time is the yardstick. In bf16 the backward, B5 and
    B6 (with their registers from ``resources``, ``kernel_resources``'s
    result) and their sum, is printed beside that library backward."""
    B, T, H, D = 8, 1024, 12, 64
    g = torch.Generator().manual_seed(9)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device="cuda")
    bf16_peak, fp32_peak, hbm = peaks()
    ar = torch.arange(T)
    patterns = {  # name: (Tq, Tk, B, q_pos, kv_pos, out_dtype)
        "diagonal": (T, T, B, ar, ar, None),
        "past": (T, T, B, T + ar, ar, None),
        "future": (T, T, B, ar, T + ar, None),
        "zigzag_rank1_hop1": (T, T, B, _zigzag_positions(1, 4, T),
                              _zigzag_positions(0, 4, T), None),
        "no_positions": (T, T, B, None, None, None),
        "rectangular": (256, T, B, 768 + torch.arange(256), ar, None),
        "ragged_T1000_zigzag": (1000, 1000, 2, _zigzag_positions(1, 4, 1000),
                                _zigzag_positions(1, 4, 1000), None),
        "fp32_out": (T, T, B, ar, ar, torch.float32),
    }
    checks = {  # name: (Tq, B, D, q_pos, kv_pos, dtype)
        "float16_ragged_T1000_zigzag": (
            1000, 2, D, _zigzag_positions(1, 4, 1000),
            _zigzag_positions(0, 4, 1000), torch.float16),
        "bfloat16_D128_T256_zigzag": (
            256, 1, 128, _zigzag_positions(1, 4, 256),
            _zigzag_positions(0, 4, 256), torch.bfloat16),
    }
    check_errs = {}
    for cname, (Tc, Bc, Dc, qp, kp, dtype) in checks.items():
        tol = FLASH_TOLERANCE[str(dtype).removeprefix("torch.")]
        pos = [p.cuda() for p in (qp, kp)]
        check_errs[cname] = _masked_check(
            *_masked_inputs(Bc, Tc, Tc, H, Dc, dtype, g), *pos, tol)[0]
    results, pattern_errs, sdpa = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = FLASH_TOLERANCE[name]
        pattern_errs[name] = {}
        for pname, (Tq, Tk, Bp, qp, kp, od) in patterns.items():
            if od is not None and dtype == torch.float32:
                continue   # fp32 out from fp32 inputs is the plain case
            q, k, v, do = _masked_inputs(Bp, Tq, Tk, H, D, dtype, g)
            pos = [None if p is None else p.cuda() for p in (qp, kp)]
            errs, got = _masked_check(q, k, v, do, *pos, tol, od)
            pattern_errs[name][pname] = errs
            if pname == "future":
                check(all(not bool(x.any()) for x in (got[0], *got[2:]))
                      and bool((got[1] == -1e30).all()),
                      "all-future hop: out and gradients not exactly 0 or "
                      "lse not -1e30")
            if pname != "diagonal":
                continue
            ref_lse = fa.flash_masked_fwd_reference(q, k, v, *pos)[1]
            delta = fa.attention_delta(do, got[0])
            args = (q, k, v, do, ref_lse, delta, *pos)
            # library yardstick: SDPA with the boolean mask of the positions;
            # its autograd backward computes dq, dk and dv together
            mask = pos[0][:, None] >= pos[1][None, :]
            sdpa[name] = _sdpa_times(q, k, v, do, flush, attn_mask=mask)
            library = {key: _fastest(sdpa[name], key) for key in ("fwd", "bwd")}
            n_vis = Bp * H * int(mask.sum())   # visible (query, key) pairs
            elt, n = q.element_size(), Bp * T * H * D
            stats, n_pos = Bp * H * T * 4, 2 * T * 4
            work = {  # bytes (inputs once, outputs once), flops
                "mfwd": (4 * n * elt + stats + n_pos, 4 * D * n_vis),
                "mdq": (5 * n * elt + 2 * stats + n_pos, 6 * D * n_vis),
                "mdkv": (6 * n * elt + 2 * stats + n_pos, 8 * D * n_vis),
            }
            calls = {
                "mfwd": (lambda: fa.flash_masked_fwd(q, k, v, *pos),
                         lambda: fa.flash_masked_fwd_reference(q, k, v, *pos)),
                "mdq": (lambda: fa.flash_masked_dq(*args),
                        lambda: fa.flash_masked_dq_reference(*args)),
                "mdkv": (lambda: fa.flash_masked_dkv(*args),
                         lambda: fa.flash_masked_dkv_reference(*args)),
            }
            peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
            per = {}
            for kname, key, _ in MASKED_KERNELS:
                kernel, plain = calls[key]
                n_bytes, n_flops = work[key]
                t_bytes = n_bytes / hbm * 1e3
                t_ops = n_flops / peak * 1e3
                ms = time_ms(kernel, 20, flush)
                lib_ms, lib_backend = library["fwd" if key == "mfwd" else "bwd"]
                per[key] = {
                    "max_abs_err": errs[key],
                    "tolerance": tol,
                    "ms": ms,
                    "device_ms": _device_ms(kernel, 10, f"{kname}_kernel"),
                    "plain_ms": time_ms(plain, 3, flush),
                    "library_ms": lib_ms,
                    "library_backend": lib_backend,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": n_bytes,
                    "flops": n_flops,
                    "tflops": n_flops / ms / 1e9,
                    "ms_over_bound": ms / max(t_bytes, t_ops),
                }
            results[name] = per
    bf16 = results["bfloat16"]
    backward = {key: {f: bf16[key][f] for f in ("ms", "device_ms", "tflops",
                                                 "ms_over_bound")}
                for key in ("mdq", "mdkv")}
    for key, kname in (("mdq", "flash_masked_dq"), ("mdkv", "flash_masked_dkv")):
        backward[key]["registers"] = {
            d: resources[f"{kname}_kernel_sm90<bf16,{d}>"]["registers"]
            for d in (64, 128)}
    backward["mdq_plus_mdkv_ms"] = bf16["mdq"]["ms"] + bf16["mdkv"]["ms"]
    backward["mdq_plus_mdkv_device_ms"] = (bf16["mdq"]["device_ms"]
                                           + bf16["mdkv"]["device_ms"])
    backward["library_ms"] = bf16["mdq"]["library_ms"]
    backward["library_backend"] = bf16["mdq"]["library_backend"]
    emit({"phase": "kernels",
          "kernel": "flash_masked (B4 fwd, B5 dq, B6 dkv)",
          "shape": {"B": B, "T": T, "H": H, "D": D,
                    "layout": "q/k/v strided views of a fused [B, T, 3*H*D]"},
          "route": {"float32": "CUDA cores (B4-B6)",
                    "bfloat16": "wgmma + TMA (sm90; B4-B6)"},
          "timed_pattern": "diagonal",
          "max_abs_err_by_pattern": pattern_errs,
          "checks": {k_: {"T": v_[0], "B": v_[1], "D": v_[2],
                          "dtype": str(v_[5]).removeprefix("torch."),
                          "max_abs_err": check_errs[k_]}
                     for k_, v_ in checks.items()},
          "tolerance": "|kernel - plain| <= tol * (1 + |plain|)",
          "library_call": "F.scaled_dot_product_attention(attn_mask=q_pos >= "
                          "kv_pos) forward for B4; its autograd backward (dq, "
                          "dk and dv together) for B5 and B6; the fastest of "
                          "the backends below by device time",
          "sdpa_ms_by_backend": sdpa,
          "peak_flops": {"bfloat16": bf16_peak, "float32": fp32_peak},
          "backward_bfloat16": backward,
          "results": results})
    return results


# ResNet-50's BatchNorm shapes at 224 px (C, H = W, layers), 53 layers in
# all: bn_init, then each stage's 1x1, 3x3 (v1.5's stride), 1x1 and the
# first block's downsample
RESNET50_BN_SHAPES = (
    (64, 112, 1), (64, 56, 6), (256, 56, 4), (128, 56, 1), (128, 28, 7),
    (512, 28, 5), (256, 28, 1), (256, 14, 11), (1024, 14, 7), (512, 14, 1),
    (512, 7, 5), (2048, 7, 4))
BN_BATCH = 256        # a rank's images in resnet50.ddp4
BN_EPS = 1e-5
# activations read and written a call, in passes over x: bn_stats reads x;
# bn_fwd_elemt reads x, writes y; bn_bwd_reduce reads dy, x; bn_bwd_elemt
# reads dy, x, writes dx
BN_PASSES = {"bn_stats": 1, "bn_fwd_elemt": 2, "bn_bwd_reduce": 2,
             "bn_bwd_elemt": 3}
# beside the ResNet shapes, the kernels' other routes in one check each:
# C 24 (3 groups of 8 channels: a CTA's lanes partly idle), fp16, fp32 (4
# channels a load)
BN_CHECKS = {"bfloat16_C24": (3, 24, 5, 7, torch.bfloat16),
             "float16_C40": (4, 40, 3, 9, torch.float16),
             "float32_C64": (8, 64, 9, 9, torch.float32)}
# kernel against plain version, both fp32 inside:
#  * sums: |k - p| <= 3e-5 * (the same sum of absolute terms): fp32 sums of
#    up to 3.2M terms a channel in two orders, each with a longest chain of
#    about 200 sequential adds (2**-24 * 200 = 1.2e-5 of the absolute sum a
#    side, worst case);
#  * mean and var from the same sums: equal, the same IEEE operations in
#    the same order (reported; held within 1e-6 of their largest);
#  * y and dx in 16 bits: one rounding of fp32 values that differ by fp32
#    round-off (the kernel fuses a multiply-add), so at most one ulp of the
#    output type (2**-7 of the value in bf16, 2**-10 in fp16) plus 1e-5 of
#    the largest value near zero; fp32 outputs 1e-5 of the value plus 1e-5
#    of the largest.
BN_SUM_TOL = 3e-5
# PyTorch's SyncBatchNorm pieces that compute each kernel's function: the
# yardstick of bn_kernels' times
BN_LIBRARY_CALLS = {"bn_stats": "torch.batch_norm_stats",
                    "bn_fwd_elemt": "torch.batch_norm_elemt",
                    "bn_bwd_reduce": "torch.batch_norm_backward_reduce",
                    "bn_bwd_elemt": "torch.batch_norm_backward_elemt"}
BN_ULP = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 1e-5}


def _bn_inputs(N, C, H, W, dtype, g):
    """x with per-channel means in [-1, 1] and spreads in [0.5, 2], dy,
    weight and bias: channels_last activations on the card."""
    def cl(t):
        return t.permute(0, 3, 1, 2)
    mean = torch.rand(C, generator=g) * 2 - 1
    spread = torch.rand(C, generator=g) * 1.5 + 0.5
    x = cl(torch.randn(N, H, W, C, generator=g) * spread + mean)
    dy = cl(torch.randn(N, H, W, C, generator=g))
    weight = torch.rand(C, generator=g) + 0.5
    bias = torch.randn(C, generator=g)
    return (x.to("cuda", dtype), dy.to("cuda", dtype),
            weight.to("cuda"), bias.to("cuda"))


def _bn_rel(k, p, scale) -> float:
    """max |k - p| / scale (elementwise scale, or one number)."""
    return float(((k.float() - p.float()).abs() / scale).max())


def _bn_check(x, dy, weight, bias):
    """Each kernel against its plain version on the same inputs (the
    plain version's sums feed both sides of the later kernels), two
    launches of each reduction on the same input (their bits equal), and
    the worst error of each as a share of its tolerance."""
    dims = (0, 2, 3)
    C = x.shape[1]
    ulp = BN_ULP[x.dtype]
    out = {}
    stats_p = bnk.bn_stats_reference(x)
    stats_k = bnk.bn_stats(x)
    stats_again = bnk.bn_stats(x)
    xf = x.float()
    absum = torch.cat([xf.abs().sum(dims), (xf * xf).sum(dims)])
    out["bn_stats"] = {
        "share_of_tol": _bn_rel(stats_k[:2 * C], stats_p[:2 * C],
                                BN_SUM_TOL * absum),
        "max_abs_err": _bn_rel(stats_k, stats_p, 1.0),
        "count_equal": bool(stats_k[-1] == stats_p[-1]),
        "repeat_bit_equal": torch.equal(stats_k, stats_again)}
    y_p, mean_p, var_p = bnk.bn_fwd_elemt_reference(x, stats_p, weight,
                                                     bias, BN_EPS)
    y_k, mean_k, var_k = bnk.bn_fwd_elemt(x, stats_p, weight, bias, BN_EPS)
    ymax = float(y_p.float().abs().max())
    out["bn_fwd_elemt"] = {
        "share_of_tol": _bn_rel(y_k, y_p, ulp * y_p.float().abs()
                                + 1e-5 * ymax),
        "max_abs_err": _bn_rel(y_k, y_p, 1.0),
        "mean_var_equal": torch.equal(mean_k, mean_p)
        and torch.equal(var_k, var_p),
        "mean_var_rel": max(_bn_rel(mean_k, mean_p,
                                    float(mean_p.abs().max())),
                            _bn_rel(var_k, var_p, float(var_p.abs().max())))}
    del y_p, y_k
    dw_p, db_p, sums_p = bnk.bn_bwd_reduce_reference(dy, x, stats_p, BN_EPS)
    dw_k, db_k, sums_k = bnk.bn_bwd_reduce(dy, x, stats_p, BN_EPS)
    _, _, sums_again = bnk.bn_bwd_reduce(dy, x, stats_p, BN_EPS)
    dyf = dy.float()
    absdy = dyf.abs().sum(dims)
    absdyx = (dyf.abs() * (xf - mean_p.view(1, C, 1, 1)).abs()).sum(dims)
    invstd = torch.rsqrt(var_p + BN_EPS)
    out["bn_bwd_reduce"] = {
        "share_of_tol": max(
            _bn_rel(sums_k, sums_p, BN_SUM_TOL * torch.cat([absdy, absdyx])),
            _bn_rel(db_k, db_p, BN_SUM_TOL * absdy),
            _bn_rel(dw_k, dw_p, BN_SUM_TOL * absdyx * invstd)),
        "max_abs_err": max(_bn_rel(sums_k, sums_p, 1.0),
                           _bn_rel(db_k, db_p, 1.0),
                           _bn_rel(dw_k, dw_p, 1.0)),
        "repeat_bit_equal": torch.equal(sums_k, sums_again)}
    del xf, dyf
    dx_p = bnk.bn_bwd_elemt_reference(dy, x, stats_p, weight, sums_p, BN_EPS)
    dx_k = bnk.bn_bwd_elemt(dy, x, stats_p, weight, sums_p, BN_EPS)
    dxmax = float(dx_p.float().abs().max())
    out["bn_bwd_elemt"] = {
        "share_of_tol": _bn_rel(dx_k, dx_p, ulp * dx_p.float().abs()
                                + 1e-5 * dxmax),
        "max_abs_err": _bn_rel(dx_k, dx_p, 1.0)}
    torch.cuda.synchronize()
    return out, (stats_p, mean_p, var_p, sums_p)


def _bn_library(x, dy, weight, bias, stats):
    """The library calls that compute each kernel's function (PyTorch's
    SyncBatchNorm pieces), as yardsticks: torch.batch_norm_stats (mean and
    invstd), batch_norm_elemt, batch_norm_backward_reduce,
    batch_norm_backward_elemt."""
    mean, invstd = torch.batch_norm_stats(x, BN_EPS)
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
        dy, x, mean, invstd, weight, True, True, True)
    count = torch.tensor([x.numel() // x.shape[1]], dtype=torch.int32,
                         device=x.device)
    return {
        "bn_stats": lambda: torch.batch_norm_stats(x, BN_EPS),
        "bn_fwd_elemt": lambda: torch.batch_norm_elemt(
            x, weight, bias, mean, invstd, BN_EPS),
        "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True),
        "bn_bwd_elemt": lambda: torch.batch_norm_backward_elemt(
            dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count),
    }


def _bn_graph_check(x, dy, weight, bias):
    """The four wrappers captured in a CUDA graph: the capture counts one
    launch of each, three replays count none while the card runs their
    kernels each time (6 a replay: the two reductions are two kernels
    each), and a replay's outputs equal the eager ones bit for bit."""
    def body():
        stats = bnk.bn_stats(x)
        y, _, _ = bnk.bn_fwd_elemt(x, stats, weight, bias, BN_EPS)
        _, _, sums = bnk.bn_bwd_reduce(dy, x, stats, BN_EPS)
        return stats, y, sums, bnk.bn_bwd_elemt(dy, x, stats, weight, sums,
                                                BN_EPS)

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(bnk.launches)
    with torch.cuda.graph(graph):
        captured = body()
    at_capture = {k: bnk.launches[k] - before[k] for k in bnk.KERNELS}
    before = dict(bnk.launches)
    with device_launches("bn_") as device:
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    replays = {k: bnk.launches[k] - before[k] for k in bnk.KERNELS}
    equal = all(torch.equal(a, b) for a, b in zip(captured, eager))
    check(at_capture == dict.fromkeys(bnk.KERNELS, 1),
          f"bn_kernels: a capture counted {at_capture}, expected 1 each")
    check(not any(replays.values()),
          f"bn_kernels: replays counted launches {replays}")
    check(device["bn_"] == 3 * 6,
          f"bn_kernels: 3 replays ran {device['bn_']} kernels, expected 18")
    check(equal, "bn_kernels: a replay's outputs differ from eager ones")
    del graph
    return {"capture": at_capture, "replays": replays,
            "device_launches_3_replays": device["bn_"],
            "replay_bit_equal": equal}


def _bn_refusals(x):
    """A launch the kernels' entry point refuses (a CTA of 48 x 8 threads)
    raises and counts nothing; so do the wrapper's refusals (fp64; a
    contiguous NCHW tensor; rows that do not start 16-byte aligned: C 20
    in bf16)."""
    before = dict(bnk.launches)
    refused = {}
    cases = {
        "entry_point": (RuntimeError, lambda: bnk.bn_stats(x)),
        "float64": (TypeError, lambda: bnk.bn_stats(x.double())),
        "nchw": (ValueError, lambda: bnk.bn_stats(x.contiguous())),
        "unaligned_rows": (ValueError, lambda: bnk.bn_stats(
            x[:, :20].contiguous(memory_format=torch.channels_last))),
    }
    for name, (error, call) in cases.items():
        patch = (mock.patch.object(bnk, "_geometry",
                                   lambda *a: (48, 8, 1, 1))
                 if name == "entry_point" else contextlib.nullcontext())
        try:
            with patch:
                call()
            refused[name] = None
        except error as e:
            refused[name] = str(e)[:120]
    torch.cuda.synchronize()
    check(all(refused.values()), f"bn_kernels: not refused: {refused}")
    check(bnk.launches == before,
          f"bn_kernels: refused launches were counted: {bnk.launches}")
    return refused


def bn_resources():
    """Registers and stack bytes of each kernel of the BatchNorm library
    (``cuobjdump -res-usage``), by mangled name."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    lib = str(_build._target("batch_norm")[1])
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout
    return {fn: {"registers": int(reg), "stack_bytes": int(stack)}
            for fn, reg, stack in re.findall(
                r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+)", usage)}


def bn_kernel_phase():
    """The four BatchNorm kernels (``ops/batch_norm.py``,
    ``csrc/batch_norm.cu``) in bf16 at every BatchNorm shape of ResNet-50
    at 224 px and 256 images (a rank's batch in resnet50.ddp4), and at
    three small checks of their other routes: each against its plain
    version (tolerances: BN_SUM_TOL, BN_ULP), each reduction twice on the
    same input (bit-equal), a refused launch, a CUDA graph capture and its
    replays, the launch counts. Times: CUDA-event medians with the L2
    flushed before each call, for the kernel, its plain version and the
    library call; per step: summed over the 53 layers; bound: the passes
    over the activation (BN_PASSES) at the card's published bandwidth."""
    g = torch.Generator().manual_seed(25)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device="cuda")
    hbm = peaks()[2]
    for k in bnk.KERNELS:
        bnk.launches[k] = 0
    expected = dict.fromkeys(bnk.KERNELS, 0)
    # eager calls of each kernel in one _bn_check
    per_check = {"bn_stats": 2, "bn_fwd_elemt": 1, "bn_bwd_reduce": 2,
                 "bn_bwd_elemt": 1}
    checks = {}
    for name, (N, C, H, W, dtype) in BN_CHECKS.items():
        checks[name], _ = _bn_check(*_bn_inputs(N, C, H, W, dtype, g))
        for k in bnk.KERNELS:
            expected[k] += per_check[k]
    reps, plain_reps = 20, 3
    shapes, per_step = [], {k: dict.fromkeys(
        ("ms", "bound_ms", "plain_ms", "library_ms"), 0.0)
        for k in bnk.KERNELS}
    for C, HW, layers in RESNET50_BN_SHAPES:
        x, dy, weight, bias = _bn_inputs(BN_BATCH, C, HW, HW, torch.bfloat16,
                                         g)
        errs, (stats, _, _, sums) = _bn_check(x, dy, weight, bias)
        for k in bnk.KERNELS:
            expected[k] += per_check[k]
        calls = {
            "bn_stats": (lambda: bnk.bn_stats(x),
                         lambda: bnk.bn_stats_reference(x)),
            "bn_fwd_elemt": (
                lambda: bnk.bn_fwd_elemt(x, stats, weight, bias, BN_EPS),
                lambda: bnk.bn_fwd_elemt_reference(x, stats, weight, bias,
                                                   BN_EPS)),
            "bn_bwd_reduce": (
                lambda: bnk.bn_bwd_reduce(dy, x, stats, BN_EPS),
                lambda: bnk.bn_bwd_reduce_reference(dy, x, stats, BN_EPS)),
            "bn_bwd_elemt": (
                lambda: bnk.bn_bwd_elemt(dy, x, stats, weight, sums, BN_EPS),
                lambda: bnk.bn_bwd_elemt_reference(dy, x, stats, weight,
                                                   sums, BN_EPS)),
        }
        library = _bn_library(x, dy, weight, bias, stats)
        row = {"shape": [BN_BATCH, C, HW, HW], "layers": layers,
               "checks": errs}
        for k, (kernel, plain) in calls.items():
            bound = BN_PASSES[k] * x.numel() * x.element_size() / hbm * 1e3
            ms = time_ms(kernel, reps, flush)
            expected[k] += 3 + reps      # time_ms's warm-up calls and reps
            lib_ms = time_ms(library[k], reps, flush)
            plain_ms = time_ms(plain, plain_reps, flush)
            row[k] = {"ms": ms, "bound_ms": bound, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "ms_over_bound": ms / bound}
            for key, value in (("ms", ms), ("bound_ms", bound),
                               ("plain_ms", plain_ms),
                               ("library_ms", lib_ms)):
                per_step[k][key] += layers * value
        shapes.append(row)
        del x, dy, calls, library
        torch.cuda.empty_cache()
    worst = {k: max([r["checks"][k]["share_of_tol"] for r in shapes]
                    + [c[k]["share_of_tol"] for c in checks.values()])
             for k in bnk.KERNELS}
    max_abs_err = {k: max([r["checks"][k]["max_abs_err"] for r in shapes]
                          + [c[k]["max_abs_err"] for c in checks.values()])
                   for k in bnk.KERNELS}
    rows = shapes + [{"checks": c} for c in checks.values()]
    repeat_equal = all(r["checks"][k]["repeat_bit_equal"] for r in rows
                       for k in ("bn_stats", "bn_bwd_reduce"))
    counts_equal = all(r["checks"]["bn_stats"]["count_equal"] for r in rows)
    mean_var_rel = max(r["checks"]["bn_fwd_elemt"]["mean_var_rel"]
                       for r in rows)
    check(all(w <= 1.0 for w in worst.values()),
          f"bn_kernels: kernel against plain version over tolerance "
          f"(share of tolerance {worst})")
    check(repeat_equal, "bn_kernels: a repeated reduction gave other bits")
    check(counts_equal, "bn_kernels: the count differs from the plain one")
    check(mean_var_rel <= 1e-6,
          f"bn_kernels: mean or var {mean_var_rel} from the plain one")
    check(bnk.launches == expected,
          f"bn_kernels: launches {bnk.launches}, expected {expected}")
    x, dy, weight, bias = _bn_inputs(BN_BATCH, 256, 14, 14, torch.bfloat16, g)
    graph = _bn_graph_check(x, dy, weight, bias)
    for k in bnk.KERNELS:   # eager, the capture's warm-up, the capture
        expected[k] += 3
    refused = _bn_refusals(x)
    check(bnk.launches == expected,
          f"bn_kernels: launches {bnk.launches}, expected {expected}")
    emit({"phase": "bn_kernels", "dtype": "bfloat16", "batch": BN_BATCH,
          "source": BN_SOURCE, "replaces": None,
          "resources": bn_resources(),
          "launches": dict(bnk.launches), "expected_launches": expected,
          "worst_share_of_tol": worst, "max_abs_err": max_abs_err,
          "repeat_bit_equal": repeat_equal,
          "mean_var_equal": all(r["checks"]["bn_fwd_elemt"]["mean_var_equal"]
                                for r in rows),
          "mean_var_rel": mean_var_rel,
          "per_step_53_layers": per_step, "graph": graph,
          "refused": refused, "shapes": shapes, "checks": checks,
          "library_call": BN_LIBRARY_CALLS})
    return {"per_step": per_step, "worst_share_of_tol": worst,
            "max_abs_err": max_abs_err}


def cp_hops_phase():
    """The ring's own hop functions (``_hop_forward``, ``_merge_partial``,
    ``_hop_backward`` of ``parallel.context_parallel``) for a ring of 4
    ranks emulated on the one card, plain and zigzag, at B=2, T=4096 global
    (T_local 1024), bf16. The K/V (and dK/dV) rotation is a list rotation in
    this process, so this phase does not exercise NCCL; it is the on-card
    check of the merge over more than one hop. Each rank's merged output and
    its dq, dk, dv, put together over the ranks (and zigzag-restored), must
    match B1-B3 on the whole sequence within the bf16 tolerance."""
    n, B, T, H, D = 4, 2, 4096, 12, 64
    dtype = torch.bfloat16
    tol = FLASH_TOLERANCE["bfloat16"]
    g = torch.Generator().manual_seed(10)
    q, k, v, do = _flash_inputs(B, T, H, D, dtype, g)
    ref_out, ref_lse = fa.flash_causal_fwd(q, k, v)
    ref_args = (q, k, v, do, ref_lse, fa.attention_delta(do, ref_out))
    ref = {"out": ref_out, "dq": fa.flash_causal_dq(*ref_args)}
    ref["dk"], ref["dv"] = fa.flash_causal_dkv(*ref_args)
    report = {}
    for zigzag in (False, True):
        xs = [zigzag_reorder(x, n) if zigzag else x for x in (q, k, v, do)]
        qs, ks, vs, dos = ([c for c in x.chunk(n, dim=1)] for x in xs)

        def rotate(chunks):   # rank r receives what rank r - 1 held
            return chunks[-1:] + chunks[:-1]

        acc, kc, vc = [None] * n, ks, vs
        for hop in range(n):
            acc = [cp._merge_partial(acc[r], cp._hop_forward(
                qs[r], kc[r], vc[r], r, n, hop, True, zigzag))
                for r in range(n)]
            kc, vc = rotate(kc), rotate(vc)
        outs = [a[0].to(dtype) for a in acc]
        deltas = [fa.attention_delta(dos[r], outs[r]) for r in range(n)]
        grads = {name: [torch.zeros(B, T // n, H, D, device="cuda")
                        for _ in range(n)] for name in ("dq", "dk", "dv")}
        kc, vc = ks, vs
        for hop in range(n):
            for r in range(n):
                parts = cp._hop_backward(qs[r], kc[r], vc[r], dos[r],
                                         acc[r][1], deltas[r], r, n, hop,
                                         True, zigzag)
                for name, part in zip(("dq", "dk", "dv"), parts):
                    grads[name][r] += part
            kc, vc = rotate(kc), rotate(vc)
            grads["dk"], grads["dv"] = rotate(grads["dk"]), rotate(grads["dv"])
        got = {"out": outs, **{k_: [x.to(dtype) for x in xs_]
                               for k_, xs_ in grads.items()}}
        errs = {}
        for name, chunks in got.items():
            full = torch.cat(chunks, dim=1)
            if zigzag:
                full = zigzag_restore(full, n)
            a, b = full.float(), ref[name].float()
            err = (a - b).abs()
            check(bool((err <= tol * (1 + b.abs())).all()),
                  f"cp_hops ({'zigzag' if zigzag else 'plain'} ring) {name} "
                  f"vs B1-B3 on the whole sequence: max_abs_err "
                  f"{err.max().item()}")
            errs[name] = err.max().item()
        report["zigzag" if zigzag else "plain"] = errs
    torch.cuda.synchronize()
    emit({"phase": "cp_hops", "ranks": n, "B": B, "T": T, "T_local": T // n,
          "H": H, "D": D, "dtype": "bfloat16", "tolerance": tol,
          "nccl": False, "reference": "B1-B3 on the whole sequence",
          "max_abs_err": report})


def train_cp_parity_phase(mesh, batches, dense):
    """train_parity's recipe (fp32 GPT-2 125M, TF32 off, B=2, T=1024, the
    same weights and batches, the same limits) with ring flash attention
    under ``CPStrategy`` on the one-rank NCCL group: the cp = 1 ring runs
    the diagonal hop through B4-B6. Held against train_parity's dense run;
    B4-B6 each launch n_layer x steps times, B1-B3 never."""
    steps = len(batches)
    ring = _parity_run(batches, attn_impl=make_ring_attention(mesh, "cp"),
                       strategy=CPStrategy(mesh))
    loss_rel, worst, worst_name = _parity_errors(ring, dense)
    n_layer = GPT2Config().n_layer
    emit({"phase": "train_cp_parity", "dtype": "float32", "tf32": False,
          "B": 2, "T": 1024, "steps": steps, "cp": mesh.size("cp"),
          "backend": torch.distributed.get_backend(),
          "loss_ring": ring[0], "loss_dense": dense[0],
          "loss_rel_err": loss_rel, "grad_worst_err_over_limit": worst,
          "grad_worst_param": worst_name, "launches_ring": ring[2],
          "expected_launches": n_layer * steps})
    check(loss_rel[0] <= 1e-5 and max(loss_rel) <= 1e-4,
          f"ring vs dense losses {ring[0]} vs {dense[0]}")
    check(worst <= 1.0, f"step-1 gradient of {worst_name} off by "
                        f"{worst:.3g} x its limit")
    check(all(ring[2][k] == n_layer * steps for k in MASKED_KEYS)
          and not any(ring[2][k] for k in CAUSAL_KEYS),
          f"ring launches {ring[2]} != n_layer x steps {n_layer * steps} "
          "of B4-B6 and none of B1-B3")


def train_cp_phase(mesh):
    """Context-parallel training's main path: GPT-2 125M at full width, bf16
    policy, B=8, T=1024, ring flash attention under ``CPStrategy`` on the
    NCCL group (cp = 1 on one card), dense LM loss, AdamW; 3 warm-up and 20
    timed steps, each timed on the host clock to a synchronise; then 10
    steps on one fixed batch, whose loss must fall, and a profile of 3
    more (train_cp_profile)."""
    warm, timed = 3, 20
    B, T = 8, 1024
    bf16_peak, _, _ = peaks()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, state = _trainer(seed=1, dtype=torch.bfloat16,
                              attn_impl=make_ring_attention(mesh, "cp"),
                              strategy=CPStrategy(mesh))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = _lm_batches(warm + timed, B, T, seed=8)
    _reset_flash_counts()
    losses, step_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        # graftlint: disable-next-line=host-sync-in-hot-loop -- each step is timed on its own: its latency quantiles are the figure
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"].detach())
    launches = dict(fa.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = step_s[warm:]
    tokens_per_s = B * T * len(step_s) / sum(step_s)
    quant = statistics.quantiles(step_s, n=100, method="inclusive")
    fixed = _lm_batches(1, B, T, seed=6)[0]
    fixed_losses = []
    for _ in range(10):
        state, m = trainer.step(state, fixed)
        fixed_losses.append(m["loss"])
    fixed_losses = [float(x) for x in fixed_losses]
    n_layer = GPT2Config().n_layer
    expected = n_layer * (warm + timed)
    emit({"phase": "train_cp", "model": "gpt2-125m", "dtype": "bfloat16",
          "attn": "ring flash (B4-B6)", "cp": mesh.size("cp"),
          "backend": torch.distributed.get_backend(), "global_batch": B,
          "seq_len": T, "n_params": n_params, "warmup_steps": warm,
          "timed_steps": timed, "step_p50_s": statistics.median(step_s),
          "step_p99_s": quant[98], "tokens_per_s": tokens_per_s,
          "mfu": 6 * n_params * tokens_per_s / bf16_peak,
          "mfu_peak_flops": bf16_peak,
          "max_memory_allocated_bytes": peak_mem,
          "loss_first": losses[0], "loss_last": losses[-1],
          "fixed_batch_losses": fixed_losses,
          "kernel_launches": launches, "expected_launches": expected})
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(all(np.isfinite(fixed_losses)) and fixed_losses[-1] < fixed_losses[0],
          f"loss did not fall on a fixed batch: {fixed_losses}")
    check(all(launches[k] == expected for k in MASKED_KEYS)
          and not any(launches[k] for k in CAUSAL_KEYS),
          f"ring launches {launches} != n_layer x steps {expected} of B4-B6 "
          "and none of B1-B3")
    split = train_profile_phase(trainer, state, fixed, phase="train_cp_profile",
                                kernels=MASKED_KERNELS,
                                expect_calls=MASKED_SM90_KERNELS)
    del trainer, state
    torch.cuda.empty_cache()
    return launches, split


def _reset_flash_counts() -> None:
    for key in fa.launches:
        fa.launches[key] = 0


def _lm_batches(n, B, T, seed):
    rng = np.random.default_rng(seed)
    vocab = GPT2Config().vocab_size
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _trainer(strategy=None, **cfg):
    model = gpt2_125m(device="cuda", **cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    policy = "bf16" if cfg.get("dtype") == torch.bfloat16 else "fp32"
    trainer = Trainer(model, opt, strategy or NoShard("cuda"),
                      loss_fn=lm_loss, policy=policy)
    return trainer, trainer.init()


def _parity_run(batches, **cfg):
    """fp32 steps on the parity batches: losses, step-1 grads (kept on the
    host, out of the later phases' peak memory), launches."""
    trainer, state = _trainer(seed=0, **cfg)
    losses, grads = [], None
    _reset_flash_counts()
    for batch in batches:
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
        if grads is None:
            grads = {n: p.grad.detach().cpu()
                     for n, p in trainer.model.named_parameters()}
    launches = dict(fa.launches)
    del trainer, state
    torch.cuda.empty_cache()
    return losses, grads, launches


def _parity_errors(got, want):
    """Per-step relative loss errors, and the step-1 gradient furthest from
    its limit (1e-4 of the tensor's largest element plus 1e-7)."""
    (gl, gg, _), (wl, wg, _) = got, want
    worst, worst_name = 0.0, None
    for name, w in wg.items():
        err = (gg[name] - w).abs().max().item()
        limit = 1e-4 * w.abs().max().item() + 1e-7
        if worst_name is None or err / limit > worst:
            worst, worst_name = err / limit, name
    return [abs(a - b) / abs(b) for a, b in zip(gl, wl)], worst, worst_name


def train_parity_phase():
    """fp32 full-width GPT-2 125M, TF32 off, B=2, T=1024, 3 steps on the
    same weights and batches: flash attention (B1-B3) against the dense
    reference attention. Step-1 losses agree at rtol 1e-5 and later ones at
    1e-4 (the runs' weights drift apart by rounding once Adam steps); every
    step-1 gradient at 1e-4 of its tensor's largest element plus 1e-7
    (sums taken in another order; the key-bias gradients are rounding noise
    near 1e-9 in both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = 3
    batches = _lm_batches(steps, 2, 1024, seed=5)
    dense = _parity_run(batches)
    flash = _parity_run(batches, attn_impl=fa.flash_attention)
    loss_rel, worst, worst_name = _parity_errors(flash, dense)
    n_layer = GPT2Config().n_layer
    emit({"phase": "train_parity", "dtype": "float32", "tf32": False,
          "B": 2, "T": 1024, "steps": steps, "loss_flash": flash[0],
          "loss_dense": dense[0], "loss_rel_err": loss_rel,
          "grad_worst_err_over_limit": worst, "grad_worst_param": worst_name,
          "launches_flash": flash[2], "launches_dense": dense[2],
          "expected_launches": n_layer * steps})
    check(loss_rel[0] <= 1e-5 and max(loss_rel) <= 1e-4,
          f"flash vs dense losses {flash[0]} vs {dense[0]}")
    check(worst <= 1.0, f"step-1 gradient of {worst_name} off by "
                        f"{worst:.3g} x its limit")
    check(all(flash[2][k] == n_layer * steps for k in CAUSAL_KEYS)
          and not any(flash[2][k] for k in MASKED_KEYS),
          f"flash launches {flash[2]} != n_layer x steps {n_layer * steps} "
          "of B1-B3 and none of B4-B6")
    check(not any(dense[2].values()), f"dense run launched {dense[2]}")
    return batches, dense


def train_phase():
    """Training's main path: the entry point at its defaults (GPT-2 125M,
    12 x 768, T=1024, global batch 8, bf16 policy, flash attention, dense
    LM loss), 3 warm-up and 20 timed steps."""
    warm, timed = 3, 20
    bf16_peak, _, _ = peaks()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    out = train_gpt2.main(["--steps", str(warm + timed)])
    launches = dict(fa.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    step_s = out["step_s"][warm:]
    tokens_per_s = out["tokens_per_step"] * len(step_s) / sum(step_s)
    q = statistics.quantiles(step_s, n=100, method="inclusive")
    n_layer = GPT2Config().n_layer
    expected = n_layer * (warm + timed)
    result = {"step_p50_s": statistics.median(step_s),
              "tokens_per_s": tokens_per_s,
              "mfu": 6 * out["n_params"] * tokens_per_s / bf16_peak}
    emit({"phase": "train", "model": "gpt2-125m", "dtype": out["dtype"],
          "attn": out["attn"], "global_batch": 8, "seq_len": 1024,
          "n_params": out["n_params"], "warmup_steps": warm,
          "timed_steps": timed, **result,
          "step_p99_s": q[98],
          "mfu_peak_flops": bf16_peak,
          "max_memory_allocated_bytes": peak_mem,
          "loss_first": out["losses"][0], "loss_last": out["losses"][-1],
          "kernel_launches": launches, "expected_launches": expected})
    check(out["dtype"] == "bfloat16" and out["attn"] == "flash",
          "the entry point's defaults are not bf16 + flash on the card")
    check(all(np.isfinite(out["losses"])), "a training loss is not finite")
    check(all(launches[k] == expected for k in CAUSAL_KEYS)
          and not any(launches[k] for k in MASKED_KEYS),
          f"flash launches {launches} != n_layer x steps {expected} of B1-B3 "
          "and none of B4-B6")
    check(out["strategy"] == "FullyShardedDataParallel" and out["world"] == 1,
          f"the entry point ran {out['strategy']} on {out['world']} ranks")
    return launches, result, dict(out, max_memory_allocated_bytes=peak_mem)


def fsdp_train_phase(fsdp_out):
    """The entry point's FSDP (the train phase: one rank, so the rule keeps
    every parameter whole) against NoShard on the same batches: the entry
    point again with ``FullyShardedDataParallel`` patched to ``NoShard``
    (a patch made by this script; the port has no such switch), 8 steps.
    The losses are equal bit for bit: the sharded route's all-reduces on a
    one-rank NCCL group and its norm (the whole gradients' sum of squares
    plus an all-reduced zero) change no bit. B1-B3 launch n_layer times a
    step in the NoShard run."""
    steps = 8
    parallel = importlib.import_module("pytorch_distributed_tpu_torch.parallel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    with mock.patch.object(parallel, "FullyShardedDataParallel",
                           lambda mesh, **kw: NoShard(mesh.device)):
        out = train_gpt2.main(["--steps", str(steps)])
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    n_layer = GPT2Config().n_layer
    fsdp_losses = fsdp_out["losses"][:steps]
    emit({"phase": "fsdp_train", "model": "gpt2-125m", "dtype": out["dtype"],
          "global_batch": 8, "seq_len": 1024, "steps": steps,
          "fsdp": {"strategy": fsdp_out["strategy"], "mesh": fsdp_out["mesh"],
                   "losses": fsdp_losses,
                   "step_p50_s": statistics.median(fsdp_out["step_s"][3:]),
                   "max_memory_allocated_bytes":
                       fsdp_out["max_memory_allocated_bytes"]},
          "noshard": {"strategy": out["strategy"], "losses": out["losses"],
                      "step_p50_s": statistics.median(out["step_s"][3:]),
                      "max_memory_allocated_bytes": peak,
                      "kernel_launches": launches},
          "losses_equal": out["losses"] == fsdp_losses})
    check(out["strategy"] == "NoShard", "the patch did not take")
    check(out["losses"] == fsdp_losses,
          f"FSDP losses {fsdp_losses} != NoShard's {out['losses']}")
    check(all(launches[k] == n_layer * steps for k in CAUSAL_KEYS),
          f"fsdp_train NoShard launches {launches}")


@contextlib.contextmanager
def _products(product, shared_logits=False):
    """Routes the head's and the chunked loss's products (``matmul_f32``)
    through ``product``; ``shared_logits`` keeps the chunked loss's logits
    (``_logits``) on the unpatched product."""
    unpatched = chunked_xent.matmul_f32
    with contextlib.ExitStack() as stack:
        for module in (gpt2_module, chunked_xent):
            stack.enter_context(mock.patch.object(module, "matmul_f32", product))
        if shared_logits:
            stack.enter_context(mock.patch.object(
                chunked_xent, "_logits",
                lambda x, W, v0, v1: unpatched(x, W[v0:v1].t())))
        yield


def _widened(a, b):
    """The reference product: widened fp32 operands (``matmul_f32``'s CPU
    route), TF32 off."""
    return torch.mm(a.float(), b.float())


def _bf16_output(a, b):
    """The control: a bf16 GEMM whose output is rounded to bf16."""
    return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()


def _head_logits(model, x):
    """The fp32 logits [N, V] of ``GPT2._head`` and of the chunked loss's
    product (its ``_logits`` over the whole vocabulary)."""
    x2d = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        return {"head": model._head(x).reshape(x2d.shape[0], -1),
                "chunked": chunked_xent._logits(
                    x2d, model.wte.to(x.dtype), 0, model.cfg.vocab_size)}


def _head_losses(model, x, targets):
    """Per-token cross-entropy [N] through ``GPT2._head`` and through the
    chunked loss (8 chunks, the tied head in the compute dtype), and the
    gradients of their means against x and wte."""
    out = {}
    for name in ("head", "chunked"):
        xg = x.detach().requires_grad_()
        model.wte.grad = None
        if name == "head":
            logits = model._head(xg)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1), reduction="none")
        else:
            w = model.wte.to(xg.dtype)
            loss = chunked_xent.chunked_cross_entropy(
                xg.reshape(-1, xg.shape[-1]), w, targets.reshape(-1), 8)
        loss.mean().backward()
        out[name] = {"loss": loss.detach(), "dx": xg.grad,
                     "dwte": model.wte.grad}
    model.wte.grad = None
    return out


def _bf16_step(t):
    """One bf16 step (ulp) at each element of t: 2^(e - 8) for
    |t| in [2^(e-1), 2^e), 0 at 0."""
    _, e = torch.frexp(t)
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t), e - 8))


def _head_err(got, want, rounded):
    """max |got - want| over its limit, 1e-4 x max |want|; for a gradient
    that both sides round to bf16 (``rounded``) the limit adds one bf16
    step of the larger side at each element, since unrounded values a hair
    apart can round to neighbours."""
    a, b = got.float(), want.float()
    err = (a - b).abs()
    limit = 1e-4 * b.abs().max()
    if rounded:
        limit = limit + _bf16_step(torch.maximum(a.abs(), b.abs()))
    ok = bool((err <= limit).all()) and bool(torch.isfinite(a).all())
    return ok, {"max_abs_err": err.max().item(),
                "ref_max_abs": b.abs().max().item(),
                "over_1e-4_of_max": int((err > 1e-4 * b.abs().max()).sum())}


def head_phase(train_result):
    """The 16-bit LM head (``head_in_fp32=False``) on the tensor cores
    (``aten::mm.dtype``): bf16, B=8, T=1024, vocab 50257, TF32 off. Against
    the same functions with their products on widened fp32 operands on the
    card, each within 1e-4 x the reference's largest element:
      * the fp32 logits of ``GPT2._head`` and of ``chunked_cross_entropy``'s
        product, and the per-token losses of both (8 chunks). A control
        routes the products through a bf16-output GEMM: its logits must
        fail the same limit, so the check sees an fp32 output;
      * the gradients (x, wte), which both sides round to bf16: within that
        limit plus one bf16 step of the element. The head's backward takes
        g from the logits; the chunked loss's reference keeps the logits
        under test (only its two backward products are widened), because
        that loss rounds p g to bf16 before them, as the reference does, and
        logits a few ulp apart flip some of those roundings.
    Then forward + backward of the head timed in both modes (and its top
    kernels from torch.profiler), and 3 warm-up and 10 timed training steps
    (the train phase's recipe, dense LM loss) with the 16-bit head."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T = 8, 1024
    model = gpt2_125m(device="cuda", seed=12, dtype=torch.bfloat16,
                      head_in_fp32=False, n_layer=1)
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(B, T, cfg.n_embd, generator=g, device="cuda").to(
        torch.bfloat16)
    targets = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                            device="cuda")
    errs, control = {}, {}

    def held(name, key, got, want, rounded=False):
        ok, err = _head_err(got, want, rounded)
        errs.setdefault(name, {})[key] = err
        check(ok, f"16-bit head ({name}) {key} vs widened fp32 products: "
                  f"{errs[name][key]}")

    got = _head_logits(model, x)
    with _products(_widened):
        want = _head_logits(model, x)
    for name in got:
        held(name, "logits", got[name], want[name])
    del got
    with _products(_bf16_output):
        rounded = _head_logits(model, x)
    for name in want:
        ok, control[name] = _head_err(rounded[name], want[name], False)
        check(not ok, f"control: bf16-output logits ({name}) pass the fp32 "
                      f"check: {control[name]}")
    del want, rounded
    torch.cuda.empty_cache()

    got = _head_losses(model, x, targets)
    with _products(_widened):
        want = _head_losses(model, x, targets)
    with _products(_widened, shared_logits=True):
        shared = _head_losses(model, x, targets)["chunked"]
    want["chunked"].update(dx=shared["dx"], dwte=shared["dwte"])
    for name in got:
        held(name, "loss", got[name]["loss"], want[name]["loss"])
        for key in ("dx", "dwte"):
            held(name, key, got[name][key], want[name][key], rounded=True)
    del shared

    flush = torch.empty(128 * 2**20, dtype=torch.int32, device="cuda")
    times, kernels = {}, {}
    for mode, in_fp32 in (("fp32", True), ("bf16", False)):
        m = gpt2_125m(device="cuda", seed=12, dtype=torch.bfloat16,
                      head_in_fp32=in_fp32, n_layer=1)
        xg = x.detach().requires_grad_()

        def fwd_bwd():
            logits = m._head(xg)
            F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1)).backward()
        times[mode] = time_ms(fwd_bwd, 5, flush)
        with traced(fwd_bwd) as prof:
            fwd_bwd()
        top = sorted(_device_kernels(prof),
                     key=lambda e: -e.self_device_time_total)[:4]
        kernels[mode] = [{"name": e.key[:90],
                          "ms": e.self_device_time_total / 1e3} for e in top]
        del m
    del model, got, want
    torch.cuda.empty_cache()

    warm, timed = 3, 10
    bf16_peak, _, _ = peaks()
    trainer, state = _trainer(seed=1, dtype=torch.bfloat16,
                              attn_impl=fa.flash_attention,
                              head_in_fp32=False)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    losses, step_s = [], []
    for batch in _lm_batches(warm + timed, B, T, seed=14):
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    del trainer, state
    torch.cuda.empty_cache()
    step_s = step_s[warm:]
    tokens_per_s = B * T * len(step_s) / sum(step_s)
    emit({"phase": "head", "dtype": "bfloat16", "B": B, "T": T,
          "vocab": cfg.vocab_size, "tf32": False,
          "product": "torch.mm(out_dtype=torch.float32) (aten::mm.dtype)",
          "reference": "the same functions on widened fp32 operands",
          "errors": errs,
          "control_bf16_output_logits": control,
          "head_fwd_bwd_ms": times,
          "head_fwd_bwd_top_kernels": kernels,
          "train_head_bf16": {
              "warmup_steps": warm, "timed_steps": timed,
              "step_p50_s": statistics.median(step_s),
              "tokens_per_s": tokens_per_s,
              "mfu": 6 * n_params * tokens_per_s / bf16_peak,
              "loss_first": losses[0], "loss_last": losses[-1]},
          "train_head_fp32": {k: train_result[k] for k in
                              ("step_p50_s", "tokens_per_s", "mfu")}})
    check(all(np.isfinite(losses)), "a 16-bit head training loss is not finite")


def train_fixed_batch_phase():
    """10 bf16 steps on one fixed batch (B=8, T=1024): the loss must fall."""
    trainer, state = _trainer(seed=2, dtype=torch.bfloat16,
                              attn_impl=fa.flash_attention)
    batch = _lm_batches(1, 8, 1024, seed=6)[0]
    losses = []
    for _ in range(10):
        state, m = trainer.step(state, batch)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    emit({"phase": "train_fixed_batch", "dtype": "bfloat16", "steps": 10,
          "losses": losses})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"loss did not fall on a fixed batch: {losses}")
    return trainer, state, batch


def train_bf16_parity_phase(mesh):
    """bf16 GPT-2 125M (B=8, T=1024, the train phase's policy), 5 steps on
    one fixed batch from the same weights: the trainer with the flash
    kernels (B1-B3 on the Hopper route, rounding ds, and B3 p, to bf16
    before their products), and with ring flash attention under
    ``CPStrategy`` on ``mesh``'s one-rank NCCL group (the cp = 1 ring runs
    the diagonal hop through B4-B6 on the Hopper route), each
    against the same trainer with dense attention. The loss lists are
    printed; each must agree with dense within 1% at every step."""
    steps = 5
    batch = _lm_batches(1, 8, 1024, seed=11)[0]
    runs = {}
    for name, extra in (
            ("flash", {"attn_impl": fa.flash_attention}),
            ("ring", {"attn_impl": make_ring_attention(mesh, "cp"),
                      "strategy": CPStrategy(mesh)}),
            ("dense", {})):
        trainer, state = _trainer(seed=3, dtype=torch.bfloat16, **extra)
        _reset_flash_counts()
        losses = []
        for _ in range(steps):
            state, m = trainer.step(state, batch)
            losses.append(m["loss"])
        runs[name] = ([float(x) for x in losses], dict(fa.launches))
        del trainer, state
        torch.cuda.empty_cache()
    dense = runs["dense"][0]
    rel = {name: [abs(a - b) / abs(b) for a, b in zip(runs[name][0], dense)]
           for name in ("flash", "ring")}
    n_layer = GPT2Config().n_layer
    emit({"phase": "train_bf16_parity", "dtype": "bfloat16", "B": 8,
          "T": 1024, "steps": steps, "cp": mesh.size("cp"),
          "loss_flash": runs["flash"][0], "loss_ring": runs["ring"][0],
          "loss_dense": dense, "loss_rel_err": rel, "limit": 0.01,
          "launches_flash": runs["flash"][1],
          "launches_ring": runs["ring"][1]})
    for name, keys in (("flash", CAUSAL_KEYS), ("ring", MASKED_KEYS)):
        losses, launches = runs[name]
        check(all(np.isfinite(losses + dense)) and max(rel[name]) <= 0.01,
              f"bf16 {name} vs dense losses {losses} vs {dense}")
        check(all(launches[k] == n_layer * steps for k in keys)
              and not any(launches[k] for k in fa.launches if k not in keys),
              f"{name} launches {launches} != n_layer x steps "
              f"{n_layer * steps} of {keys} and none of the others")


def train_profile_phase(trainer, state, batch, phase="train_profile",
                        kernels=FLASH_KERNELS, expect_calls=()):
    """Where a training step's time goes: torch.profiler over 3 bf16 steps
    (B=8, T=1024): host wall time against device busy time, top kernels,
    and the flash kernels' (``kernels``) share of the busy time. Each
    kernel name in ``expect_calls`` must launch n_layer times a step, and
    no other kernel of ``kernels`` may launch. Before ``traced`` fenced
    its edges, one window in four on the card lost device records (44
    kernels of a train_cp window, one B4 among them, while the wrappers
    counted every launch); a window whose calls are still off is profiled
    once more, the check holds the second window, and the first one's
    calls are printed beside it."""
    steps = 3
    n_layer = GPT2Config().n_layer
    lost = []

    def warm_up():  # a step not recorded
        nonlocal state
        state, _ = trainer.step(state, batch)

    for _ in range(2):
        with traced(warm_up) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = trainer.step(state, batch)
            # graftlint: disable-next-line=host-sync-in-hot-loop -- closes the profiled steps' wall time, once per window
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = _device_kernels(prof)
        calls = {name: sum(e.count for e in device if name in e.key) / steps
                 for name in expect_calls}
        if all(c == n_layer for c in calls.values()):
            break
        lost.append({"calls_per_step": calls,
                     "device_kernels_per_step":
                         sum(e.count for e in device) / steps})
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    flash_ms = {key: sum(e.self_device_time_total for e in device
                         if f"{name}_kernel" in e.key) / 1e3
                for name, key, _ in kernels}
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    # kernels of the family that are none of expect_calls: the CUDA-core
    # ones, whose names the Hopper ones extend
    stray = sorted({e.key for e in device for name, _, _ in kernels
                    if f"{name}_kernel" in e.key
                    and not any(c in e.key for c in expect_calls)})
    emit({"phase": phase, "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": busy_ms / steps,
          "device_busy_share": busy_ms / wall_ms,
          "flash_ms_per_step": {k: v / steps for k, v in flash_ms.items()},
          "flash_share_of_busy": sum(flash_ms.values()) / busy_ms,
          "calls_per_step": calls,
          "windows_with_lost_records": lost,
          "nccl_ms_per_step": sum(e.self_device_time_total for e in device
                                  if "nccl" in e.key.lower()) / 1e3 / steps,
          "device_kernels_per_step": sum(e.count for e in device) / steps,
          "top_kernels": [{"name": e.key[:80],
                           "ms_per_step": e.self_device_time_total / 1e3 / steps,
                           "calls_per_step": e.count / steps} for e in top]})
    check(busy_ms > 0, "the profiler saw no device time")
    check(all(c == n_layer for c in calls.values()),
          f"{phase}: calls per step {calls}, expected {n_layer} each")
    check(not stray, f"{phase}: kernels off the Hopper route: {stray}")
    return {k: v / steps for k, v in flash_ms.items()}


def _runner_runs(build, batches, name, flops_per_step=None,
                 keep_final=False):
    """Three runs from the same weights on the same batches: the eager
    ``Trainer.step`` loop twice (its run-to-run spread) and ``AsyncRunner``
    (its start, warm-up and capture off the clock). Each: per-step losses,
    the wall time a step (closed by one sync; the eager loop's first step,
    which grows the allocator's pools, is left off the clock), peak device
    memory (graph pool included), the flash launches, and the final
    parameters and buffers (kept on the card for the comparison; the
    runner's stay in ``runs["runner"]["_final"]`` with ``keep_final``)."""
    runs = {}
    for run in ("eager_a", "eager_b", "runner"):
        trainer, state = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_flash_counts()
        extra = {}
        if run == "runner":
            runner = AsyncRunner(trainer, depth=2, drain_every=len(batches))
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            runner.start(state, batches[0])
            torch.cuda.synchronize()
            extra = {"start_s": time.perf_counter() - t0,
                     "start_reserved_bytes":
                         torch.cuda.memory_reserved() - reserved}
            t0 = time.perf_counter()
            for batch in batches:
                runner.submit(batch)
            programs = runner.programs.values()
            extra.update(
                programs=len(programs),
                capture_s=sum(p.capture_s for p in programs),
                captured=all(p.captured for p in programs),
                replays=sum(p.replays for p in programs))
            state, hist = runner.finish()
            step_s = (time.perf_counter() - t0) / len(batches)
            losses = hist["loss"].tolist()
        else:
            out = []
            for i, batch in enumerate(batches):
                state, m = trainer.step(state, batch)
                out.append(m["loss"])
                if i == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            losses = [float(x) for x in out]
            step_s = (time.perf_counter() - t0) / (len(batches) - 1)
        model = trainer.model
        runs[run] = {
            "losses": losses, "step_s": step_s,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "memory_reserved_bytes": torch.cuda.memory_reserved(),
            "launches": dict(fa.launches), **extra,
            "_final": [t.detach().clone() for t in
                       (*model.parameters(), *model.buffers())]}
        if run == "runner":
            runs[run]["_runner"] = (runner, trainer, state)
        else:
            del trainer, state
        torch.cuda.empty_cache()
    a, b, r = runs["eager_a"], runs["eager_b"], runs["runner"]

    def diff(x, y):
        return max(float((s - t).abs().max()) for s, t in
                   zip(x["_final"], y["_final"]))
    spread = {"losses": max(abs(p - q) for p, q in zip(a["losses"],
                                                        b["losses"])),
              "state": diff(a, b)}
    got = {"losses": max(abs(p - q) for p, q in zip(r["losses"],
                                                     a["losses"])),
           "state": diff(r, a)}
    for k in ("losses", "state"):
        check(got[k] <= spread[k],
              f"{name}: runner vs eager {k} differ by {got[k]}, beyond the "
              f"eager loop's own spread {spread[k]}")
    check(r["captured"] and r["replays"] == len(batches),
          f"{name}: {r['replays']} replays for {len(batches)} steps")
    for key, run in runs.items():
        if not (keep_final and key == "runner"):
            del run["_final"]
    return runs, spread, got


def _replays(runner) -> int:
    """Graph replays of the runner's programs so far."""
    return sum(p.replays for p in runner.programs.values())


def _span_marks(prof, steps, hist) -> dict:
    """The span marks (``observability.spans``) of a traced window of
    ``steps`` replays: per span, its mark pairs a step and its ms a step as
    the benchmark reads them from the trace (``portbench.spans``) and as
    the runner's ring holds them (``hist``'s last ``steps`` rows); and the
    window's device time a step, first to last device operation."""
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()]
    out = {"window_ms_per_step": (max(op[2] for op in ops)
                                  - min(op[1] for op in ops)) / 1e6 / steps,
           "spans": {}}
    trace = Trace(ops)
    for name in obs_spans.SPANS:
        found = bench_spans.pairs(trace, name)
        row = f"span_ms.{name}"
        if found is None and row not in hist:
            continue
        out["spans"][name] = {
            "pairs_per_step": len(found or ()) / steps,
            "trace_ms_per_step": bench_spans.ms_per_step(trace, (name,),
                                                         steps),
            "ring_ms_per_step": (float(np.mean(hist[row][-steps:]))
                                 if row in hist else None)}
    return out


def _replay_window(runner, state, batches, prof_steps, expect_calls):
    """``prof_steps`` replays of a started runner's step under ``traced``:
    the device kernels, the calls per step of each name in
    ``expect_calls``, the replays' CUDA-event spans, the wall time and the
    span marks (``_span_marks``)."""
    runner.start(state, batches[0])           # the same step, no rebuild
    with replay_spans() as spans:
        with traced(lambda: (runner.submit(batches[0]),
                             runner.sync())) as prof:
            spans.clear()
            t0 = time.perf_counter()
            for i in range(prof_steps):
                runner.submit(batches[i + 1])
            runner.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _, hist = runner.finish()
    device = _device_kernels(prof)
    calls = {name: sum(e.count for e in device if name in e.key)
             / prof_steps for name in expect_calls}
    return device, calls, spans, wall_ms, _span_marks(prof, prof_steps, hist)


def _gpt2_runner_trainer():
    """train's model and step (GPT-2 125M, bf16, flash attention, AdamW),
    AdamW built ``capturable`` so that the eager loop and the runner take
    the same update arithmetic."""
    model = gpt2_125m(device="cuda", seed=2, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, NoShard("cuda"), loss_fn=lm_loss,
                      policy="bf16")
    return trainer, trainer.init()


#: a GPT-2 step's mark pairs through the runner: each phase once, the head
#: and the loss forward and backward (16 marks)
SPAN_PAIRS_GPT2 = {"forward": 1, "backward": 1, "grad_exchange": 1,
                   "update": 1, "lm_head": 2, "lm_loss": 2}
#: the ring's reading of a span against the trace's: within 2%, or within
#: 0.05 ms for a span under 2.5 ms
SPAN_RTOL, SPAN_ATOL_MS, SPAN_SMALL_MS = 0.02, 0.05, 2.5
#: the four phases' share of the traced device time a step
PHASES_SHARE = (0.97, 1.005)


def _check_span_marks(phase, marks, want_pairs):
    """The marks of a traced window (``_span_marks``): ``want_pairs`` pairs
    a replay of each span and of no other, the ring's ms a step equal to
    the trace's (the program's clock is the trace's), and the four phases,
    which partition the step body, all but the whole traced window."""
    got = marks["spans"]
    pairs = {name: v["pairs_per_step"] for name, v in got.items()}
    check(pairs == want_pairs,
          f"{phase}: span mark pairs a replay {pairs}, expected {want_pairs}")
    for name, v in got.items():
        ring, read = v["ring_ms_per_step"], v["trace_ms_per_step"]
        ok = ring is not None and read is not None and abs(ring - read) <= (
            SPAN_ATOL_MS if read < SPAN_SMALL_MS else SPAN_RTOL * read)
        check(ok, f"{phase}: span {name} reads {ring} ms a step in the ring "
                  f"and {read} ms in the trace")
    phases = sum(got[n]["ring_ms_per_step"] or 0.0
                 for n in ("forward", "backward", "grad_exchange", "update")
                 if n in got)
    share = phases / marks["window_ms_per_step"]
    check(PHASES_SHARE[0] <= share <= PHASES_SHARE[1],
          f"{phase}: the four phases are {share:.4f} of the traced window "
          f"({phases} of {marks['window_ms_per_step']} ms a step)")


def runner_train_phase():
    """The train cell through ``Trainer.run``'s executor: GPT-2 125M, bf16,
    B = 8 x 1024, flash attention, 10 steps on distinct batches. The
    runner's losses, parameters and buffers against the eager
    ``Trainer.step`` loop from the same weights and batches: equal bit for
    bit where the eager loop is deterministic run to run, else within its
    own spread (two eager runs). One replay a step; B1-B3's wrappers launch
    n_layer times each warm-up step and the capture, and never at a
    replay. Step time, tokens/s, MFU and peak memory for both; then 3
    profiled replays (the train_graph_profile line): the profiler's device
    time and the CUDA-event span of each replay against the wall time, and
    B1-B3's launches in the trace, n_layer each a replayed step (a window
    whose counts are off is profiled once more, see ``recounted``); and
    the span marks in those replays (``_check_span_marks``): 16 a replay,
    the ring's reading of each span equal to the trace's, the four phases
    all but the whole traced device time."""
    steps = 10
    bf16_peak, _, _ = peaks()
    batches = _lm_batches(steps, 8, 1024, seed=12)
    runs, spread, got = _runner_runs(_gpt2_runner_trainer, batches,
                                     "runner_train", keep_final=True)
    n_layer = GPT2Config().n_layer
    runner, trainer, state = runs["runner"].pop("_runner")
    final = runs["runner"].pop("_final")
    n_params = sum(p.numel() for p in trainer.model.parameters())
    for run in runs.values():
        run["tokens_per_s"] = 8 * 1024 / run["step_s"]
        run["mfu"] = 6 * n_params * run["tokens_per_s"] / bf16_peak
    expected = {k: n_layer * steps for k in CAUSAL_KEYS}
    warm = {k: n_layer * (AsyncRunner.warmup_steps + 1) for k in CAUSAL_KEYS}
    emit({"phase": "runner_train", "model": "gpt2-125m", "dtype": "bfloat16",
          "global_batch": 8, "seq_len": 1024, "steps": steps,
          "warmup_steps": AsyncRunner.warmup_steps,
          "eager_spread": spread, "runner_vs_eager": got,
          "expected_launches": {"eager": expected, "runner": warm}, **runs})
    for run in ("eager_a", "eager_b"):
        check(all(runs[run]["launches"][k] == expected[k] for k in CAUSAL_KEYS),
              f"runner_train {run}: launches {runs[run]['launches']}")
    check(all(runs["runner"]["launches"][k] == warm[k] for k in CAUSAL_KEYS)
          and not any(runs["runner"]["launches"][k] for k in MASKED_KEYS),
          f"runner_train: wrapper launches {runs['runner']['launches']} != "
          f"n_layer x (warm-up steps + the capture) of B1-B3 and none of "
          f"B4-B6")
    check(all(np.isfinite(runs["runner"]["losses"])), "a runner loss is not "
          "finite")

    # the replayed step's busy share and kernels
    prof_steps = 3
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})

    def window():
        return _replay_window(runner, state, batches, prof_steps, expect_calls)

    (device, calls, spans, wall_ms, marks), first = recounted(
        window, lambda r: r[1] == expect_calls)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    replay_ms = _spans_ms(spans)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "train_graph_profile", "steps": prof_steps,
          "wall_ms_per_step": wall_ms / prof_steps,
          "device_busy_ms_per_step": busy_ms / prof_steps,
          "device_busy_share": busy_ms / wall_ms,
          "device_kernels_per_step": sum(e.count for e in device) / prof_steps,
          "flash_calls_per_step": calls,
          "first_window_flash_calls_per_step": first and first[1],
          "replays": len(spans), "replay_ms_per_step": replay_ms / prof_steps,
          "replay_share_of_wall": replay_ms / wall_ms,
          "top_kernels": [{"name": e.key[:80],
                           "ms_per_step": e.self_device_time_total / 1e3
                           / prof_steps,
                           "calls_per_step": e.count / prof_steps}
                          for e in top],
          "span_marks": marks})
    check(len(spans) == prof_steps and replay_ms > 0,
          f"train_graph_profile: {len(spans)} replays, {replay_ms} ms")
    check(calls == expect_calls,
          f"train_graph_profile: flash calls per replayed step {calls}, "
          f"expected {expect_calls}")
    _check_span_marks("train_graph_profile", marks, SPAN_PAIRS_GPT2)
    del runner, trainer, state
    torch.cuda.empty_cache()
    return runs, final


# -- the sharded strategies on the card ------------------------------------
SHARDED_KINDS = ("DataParallel", "ZeRO1", "FullyShardedDataParallel")


def _sharded_trainer(kind):
    """runner_train's model and step (GPT-2 125M, bf16, flash attention,
    capturable AdamW) under ``kind`` on the one-rank NCCL group; ZeRO1 and
    FSDP with the entry point's ``min_shard_size=8``."""
    n = pdist.get_world_size()
    if kind == "FullyShardedDataParallel":
        strategy = FullyShardedDataParallel(
            init_device_mesh((n,), ("fsdp",)), min_shard_size=8)
    elif kind == "ZeRO1":
        strategy = ZeRO1(init_device_mesh((n,), ("dp",)), min_shard_size=8)
    else:
        strategy = DataParallel(init_device_mesh((n,), ("dp",)))
    model = gpt2_125m(device="cuda", seed=2, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def sharded_runner_phase(noshard_runs):
    """The runner under ``DataParallel``, ``ZeRO1`` and
    ``FullyShardedDataParallel`` on a one-rank NCCL group (one card: every
    parameter whole, but the step runs the sharded route: the update
    layout's all-reduces and the norm's all-reduce, NCCL calls captured in
    the step's graph). runner_train's cell: GPT-2 125M, bf16, B = 8 x 1024,
    10 steps; per strategy the eager loop twice and the runner (one replay
    a step), whose losses, parameters and buffers must equal the eager
    loop's (or lie within its spread), and the collectives: ``comm.counts``
    over the two eager runs, the warm-up steps and the runner's replays
    must be the step's collectives (DataParallel's one all-reduce; at one
    rank ZeRO1's and FSDP's whole-gradient all-reduce and the norm's)
    times the steps those ran (a capture records its collectives
    uncounted, a replay counts them), and the profiled replays must count
    one step's collectives each and call no collective wrapper. Then 3
    profiled replays of each:
    ``nccl_ms_per_step`` (the device time of kernels named nccl; NCCL's
    in-place all-reduce on one rank launches none), B1-B3 n_layer times a
    replayed step, and step time against runner_train's NoShard
    runner."""
    steps = 10
    prof_steps = 3
    n_layer = GPT2Config().n_layer
    batches = _lm_batches(steps, 8, 1024, seed=12)
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})
    out = {}
    for kind in SHARDED_KINDS:
        comm.reset_counts()
        runs, spread, got = _runner_runs(lambda: _sharded_trainer(kind),
                                         batches, f"sharded_runner {kind}")
        runner, trainer, state = runs["runner"].pop("_runner")
        captured = dict(comm.counts)   # the eager runs', the warm-up's and
        comm.reset_counts()            # the runner's replays' collectives
        replays = _replays(runner)
        (device, calls, spans, wall_ms, _), first = recounted(
            lambda: _replay_window(runner, state, batches, prof_steps,
                                   expect_calls),
            lambda r: r[1] == expect_calls)
        replays = _replays(runner) - replays
        replays_counted, wrapper_calls = dict(comm.counts), len(comm.calls)
        nccl = [e for e in device if "nccl" in e.key.lower()]
        out[kind] = {
            "sharded_update": runner.sharded_update,
            "losses_runner": runs["runner"]["losses"],
            "eager_spread": spread, "runner_vs_eager": got,
            "step_s": {k: runs[k]["step_s"] for k in runs},
            "max_memory_allocated_bytes": {
                k: runs[k]["max_memory_allocated_bytes"] for k in runs},
            "replays": runs["runner"]["replays"],
            "collectives_eager_warmup_replays": captured,
            "collectives_in_replays": replays_counted,
            "nccl_ms_per_step": sum(e.self_device_time_total for e in nccl)
            / 1e3 / prof_steps,
            "nccl_kernels_per_step": sum(e.count for e in nccl) / prof_steps,
            "nccl_kernels": sorted({e.key[:80] for e in nccl}),
            "device_busy_ms_per_step": sum(e.self_device_time_total
                                           for e in device) / 1e3 / prof_steps,
            "wall_ms_per_step": wall_ms / prof_steps,
            "replay_ms_per_step": _spans_ms(spans) / prof_steps,
            "flash_calls_per_step": calls,
            "first_window_flash_calls_per_step": first and first[1],
            "step_s_over_noshard_runner":
                runs["runner"]["step_s"] / noshard_runs["runner"]["step_s"],
        }
        check(calls == expect_calls,
              f"sharded_runner {kind}: flash calls per replayed step {calls}")
        per_step = 1 if kind == "DataParallel" else 2
        # the eager runs, the warm-up and the runner's replays (a capture
        # records its collectives uncounted, a replay counts them)
        runs_steps = 3 * steps + AsyncRunner.warmup_steps
        check(captured == {"all_reduce": per_step * runs_steps,
                           "reduce_scatter": 0, "all_gather": 0,
                           "broadcast": 3},
              f"sharded_runner {kind}: collectives {captured}, expected "
              f"{per_step} all-reduces a step over {runs_steps} steps and "
              f"one broadcast an init")
        check(wrapper_calls == 0 and replays_counted == {
                  "all_reduce": per_step * replays, "reduce_scatter": 0,
                  "all_gather": 0, "broadcast": 0},
              f"sharded_runner {kind}: {replays} replays counted "
              f"{replays_counted}, {wrapper_calls} collective wrapper calls")
        del runner, trainer, state, runs
        torch.cuda.empty_cache()
    emit({"phase": "sharded_runner", "model": "gpt2-125m",
          "dtype": "bfloat16", "global_batch": 8, "seq_len": 1024,
          "steps": steps, "profiled_steps": prof_steps,
          "ranks": pdist.get_world_size(),
          "noshard_runner_step_s": noshard_runs["runner"]["step_s"], **out})
    return out


#: graftlint's gate: the paths linted and the rules it must run
LINT_PATHS = ("pytorch_distributed_tpu_torch/",
              "pytorch_distributed_tpu_torch/bench.py", "chip_smoke.py")
LINT_RULES = {"collective-axis-mismatch", "comm-staging",
              "hand-rolled-reshard", "host-sync-in-hot-loop",
              "uncoalesced-collective"}


def analysis_phase(sharded, smi):
    """(a) graftlint over the linted tree, run here as a user runs it; (b)
    graftir's checks on runner_train's cell under ``DataParallel`` on the
    one-rank NCCL group: sharded_runner's trainer and its first 3 batches
    through ``AsyncRunner``, the step's Program and inventory from
    ``step_artifacts``, 3 submits traced (torch.profiler: the graph
    launches on the host, the NCCL kernels on the card), the in-place
    check over every step and ring tensor, the collective and layout
    audits, and the losses against sharded_runner's DataParallel runner
    (equal bit for bit where its eager loop is deterministic run to run,
    else within that loop's spread)."""
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.analysis",
         *LINT_PATHS, "--format", "json"],
        capture_output=True, text=True, cwd=repo)
    lint_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"analysis: graftlint exited "
          f"{proc.returncode}: {proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    lint = json.loads(proc.stdout)["summary"]
    check(lint["findings"] == 0 and set(lint["rules_run"]) == LINT_RULES,
          f"analysis: graftlint summary {lint}")

    t0 = time.perf_counter()
    steps = 3
    batches = _lm_batches(steps, 8, 1024, seed=12)   # sharded_runner's first
    trainer, state = _sharded_trainer("DataParallel")
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    program = StepProgram(
        name="runner_train:DataParallel", strategy_name="dp", amp="bf16",
        trainer=trainer, state=state, batch=batches[0],
        declared=make_state_specs(model, trainer.optimizer,
                                  trainer.strategy),
        shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    runner = AsyncRunner(trainer, depth=2, drain_every=steps)
    runner.start(state, batches[0])
    step_program, calls = runner.step_artifacts(batches[0])
    ops = collective_inventory(calls)
    findings = collective_findings(program, ops)
    layout, layout_findings = sharding_findings(program)
    findings += layout_findings
    named = _named_step_tensors(trainer, state) + [
        ("ring.idx", runner._ring.idx), ("ring.buf", runner._ring.buf)]
    before = [t.data_ptr() for _, t in named]
    comm.reset_counts()
    with traced() as prof:
        for batch in batches:
            runner.submit(batch)
        runner.sync()
    in_replays, wrapper_calls = dict(comm.counts), len(comm.calls)
    after = [t.data_ptr() for _, t in _named_step_tensors(trainer, state)
             + [("ring.idx", runner._ring.idx),
                ("ring.buf", runner._ring.buf)]]
    inplace, moved = inplace_findings(
        f"{program.name}[runner]", [p for p, _ in named], before, after)
    findings += moved
    dispatches, built = runner.dispatch_count, runner.executable_count
    state, hist = runner.finish()
    losses = hist["loss"].tolist()
    events = prof.key_averages()
    graph_launches = sum(e.count for e in events
                         if e.device_type == DeviceType.CPU
                         and "cudaGraphLaunch" in e.key)
    nccl = [e for e in _device_kernels(prof) if "nccl" in e.key.lower()]
    nccl_per_replay = sum(e.count for e in nccl) / steps
    # NCCL runs a kernel for a collective over more than one rank; an
    # in-place all-reduce over one rank is a no-op it skips
    nccl_expected = sum(1 for op in ops if op.group_size > 1)
    summary = summarize_collectives(ops)
    all_reduce = summary["tensor"].get("all-reduce", {})
    dp = sharded["DataParallel"]
    want = dp["losses_runner"][:steps]
    spread = dp["eager_spread"]["losses"]
    loss_err = max(abs(a - b) for a, b in zip(losses, want))
    emit({"phase": "analysis", "nvidia_smi": smi,
          "lint": {k: lint[k] for k in ("files", "findings", "suppressed",
                                        "baselined", "by_rule",
                                        "rules_run")},
          "lint_s": lint_s, "ranks": pdist.get_world_size(),
          "model": "gpt2-125m", "dtype": "bfloat16", "global_batch": 8,
          "seq_len": 1024, "submits": steps, "dispatches": dispatches,
          "executables": built,
          "programs_per_step": AsyncRunner.programs_per_step,
          "graph_launches": graph_launches,
          "captured": step_program.captured,
          "inventory": [op.describe() for op in ops],
          "collectives": summary, "n_params": n_params,
          "nccl_kernels_per_replay": nccl_per_replay,
          "nccl_kernels_expected": nccl_expected,
          "nccl_kernels": sorted({e.key[:80] for e in nccl}),
          "collectives_in_replays": in_replays,
          "inplace": inplace, "layout": layout,
          "findings": [f.render() for f in findings],
          "losses": losses, "sharded_runner_losses": want,
          "loss_err": loss_err, "eager_spread": spread,
          "audit_s": time.perf_counter() - t0})
    check(not findings, f"analysis: graftir findings "
          f"{[f.render() for f in findings]}")
    check(dispatches == steps and built == 1,
          f"analysis: {dispatches} dispatches and {built} Programs for "
          f"{steps} submits")
    check(step_program.captured and graph_launches == steps,
          f"analysis: {graph_launches} graph launches for {steps} submits")
    check(nccl_per_replay == nccl_expected,
          f"analysis: {nccl_per_replay} NCCL kernels a replay, the "
          f"inventory {[op.describe() for op in ops]} runs "
          f"{nccl_expected} as kernels on this group")
    check(wrapper_calls == 0 and in_replays == {
              "all_reduce": steps * len(calls), "reduce_scatter": 0,
              "all_gather": 0, "broadcast": 0},
          f"analysis: {steps} replays counted {in_replays}, "
          f"{wrapper_calls} collective wrapper calls")
    check(inplace["donated"] == inplace["realized"] == len(named),
          f"analysis: in-place {inplace}")
    check(all_reduce == {"count": 1, "bytes": 4 * n_params},
          f"analysis: the inventory's all-reduce {all_reduce}, the "
          f"parameters' fp32 bytes {4 * n_params}")
    check(loss_err <= spread, f"analysis: losses {losses} against "
          f"sharded_runner's {want}: {loss_err} beyond its eager spread "
          f"{spread}")
    del runner, trainer, state, program, step_program
    torch.cuda.empty_cache()


FSDP_RANKS = 4
FSDP_RANKS_STEPS = 3
FSDP_RANKS_LOSS_RTOL = 1e-2   # bf16, as train_bf16_parity's limit
#: the probe's collectives that FSDP and ZeRO1 issue
FSDP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor")


def _pool_worker(rank, port, world, device, jobs, results):
    """A rank of ``_RankPool``: its gloo group made once, then each job's
    rank body in turn (``fn(rank, *args)``, in that group), its outcome
    put on ``results``; a body's exception ends the process (the other
    ranks' collectives then fail too)."""
    import traceback

    pdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world, device=device)
    try:
        _build.load_all(LIBRARIES)
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args = job
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            try:
                fn(rank, *args)
            except BaseException:
                results.put((rank, traceback.format_exc()))
                raise
            results.put((rank, None))
    finally:
        pdist.destroy_process_group()


class _RankPool:
    """FSDP_RANKS processes sharing the card over one gloo group, started
    once for every four-rank phase (fsdp_ranks, hooks_ranks, tp_ranks and
    pp_ranks with ep_ranks and grid_ranks): a phase's rank body runs in
    them (``run``), so four processes start once, not once a phase. A
    body runs in the pool's process group and writes its results to its
    phase's directory."""

    def __init__(self, device, world: int = FSDP_RANKS):
        ctx = torch.multiprocessing.get_context("spawn")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            self.port = sock.getsockname()[1]
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_pool_worker, args=(
            r, self.port, world, device, self.jobs[r], self.results))
            for r in range(world)]
        for proc in self.procs:
            proc.start()

    def run(self, fn, args, timeout_s: float, what: str) -> float:
        """``fn(rank, *args)`` on every rank; the seconds it took.
        A rank's error, a rank's death or the deadline fails the script."""
        import queue

        t0 = time.perf_counter()
        for jobs in self.jobs:
            jobs.put((fn, args))
        deadline = time.monotonic() + timeout_s
        done = 0
        while done < len(self.procs):
            try:
                rank, error = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close(kill=True)
                    check(False, f"{what}: the ranks did not finish in "
                                 f"{timeout_s} s (exit codes {dead})")
                continue
            if error is not None:
                self.close(kill=True)
                check(False, f"{what}: rank {rank} failed:\n{error}")
            done += 1
        return time.perf_counter() - t0

    def close(self, kill: bool = False) -> None:
        for proc, jobs in zip(self.procs, self.jobs):
            if kill:
                proc.kill()
            elif proc.is_alive():
                jobs.put(None)
        for proc in self.procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()


def _probe_gloo_cuda(device):
    """Which collectives a gloo group runs on card tensors here: True, or
    the error. Every rank calls every probe, in one order. Sends and
    receives are probed apart (``_probe_gloo_p2p``)."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_bf16": lambda: dist.all_reduce(x.to(torch.bfloat16)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * FSDP_RANKS, device=device), x.clone()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // FSDP_RANKS, device=device), x.clone()),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(device)
            out[name] = True
        except RuntimeError as e:   # the probe's answer, not a failure
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _fsdp_rank(rank, out_dir, batches):
    """One of FSDP_RANKS ranks sharing the card over gloo: the probe, then
    GPT-2 125M (bf16, flash attention, AdamW) for FSDP_RANKS_STEPS eager
    steps under FSDP and under ZeRO1, each from the same seeded weights."""
    device = torch.device("cuda", 0)
    result = {"rank": rank}
    try:
        result["probe"] = _probe_gloo_cuda(device)
        if all(result["probe"][k] is True for k in FSDP_COLLECTIVES):
            _build.load_all(LIBRARIES)
            for kind in ("FullyShardedDataParallel", "ZeRO1"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
                if kind == "ZeRO1":
                    strategy = ZeRO1(init_device_mesh((FSDP_RANKS,), ("dp",)),
                                     min_shard_size=8)
                else:
                    strategy = FullyShardedDataParallel(
                        init_device_mesh((FSDP_RANKS,), ("fsdp",)),
                        min_shard_size=8)
                model = gpt2_125m(device=device, seed=7, dtype=torch.bfloat16,
                                  attn_impl=fa.flash_attention)
                opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                        weight_decay=0.01, eps=1e-8)
                trainer = Trainer(model, opt, strategy, loss_fn=lm_loss,
                                  policy="bf16")
                state = trainer.init()
                losses, step_s = [], []
                for batch in batches:
                    t0 = time.perf_counter()
                    state, m = trainer.step(state, batch)
                    losses.append(float(m["loss"]))
                    step_s.append(time.perf_counter() - t0)
                result[kind] = {
                    "losses": losses, "step_s": step_s,
                    "param_bytes": sum(p.numel() * p.element_size()
                                       for p in model.parameters()),
                    "opt_bytes": sum(v.numel() * v.element_size()
                                     for st in opt.state.values()
                                     for v in st.values()),
                    "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated(device),
                    "sharded_leaves": sum(leaf.sharded for leaf in
                                          trainer.layout.leaves),
                }
                del trainer, state, model, opt
    finally:
        torch.save(result, f"{out_dir}/fsdp_rank{rank}.pt")


def fsdp_ranks_phase(pool):
    """FSDP_RANKS spawned ranks on the one card over gloo (NCCL will not
    put two ranks on one GPU), with real sharding: first a probe of
    whether gloo takes card tensors for ``all_reduce``,
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor``; where it
    does, GPT-2 125M at full width and depth, 8 x 1024 global (2 rows a
    rank), bf16, 3 eager steps under FSDP and under ZeRO1 against NoShard
    on the same batches in this process (the mean of the ranks' losses
    within FSDP_RANKS_LOSS_RTOL), with each rank's parameter and
    optimizer-state bytes against NoShard's (a quarter: every GPT-2 125M
    tensor divides by 4) and its peak memory. Where gloo refuses card
    tensors, the phase prints the probe and trains nothing."""
    import tempfile

    batches = _lm_batches(FSDP_RANKS_STEPS, 8, 1024, seed=21)
    model = gpt2_125m(device="cuda", seed=7, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    trainer = Trainer(model, opt, NoShard("cuda"), loss_fn=lm_loss,
                      policy="bf16")
    state = trainer.init()
    want = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        want.append(float(m["loss"]))
    noshard_bytes = {
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "opt_bytes": sum(v.numel() * v.element_size()
                         for st in opt.state.values() for v in st.values())}
    del trainer, state, model, opt
    torch.cuda.empty_cache()
    # the ranks' results go under the port's (gitignored) build directory
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        wall_s = pool.run(_fsdp_rank, (out_dir, batches), 240, "fsdp_ranks")
        ranks = [torch.load(f"{out_dir}/fsdp_rank{r}.pt", weights_only=False)
                 for r in range(FSDP_RANKS)]
    probe = ranks[0]["probe"]
    ran = all(probe[k] is True for k in FSDP_COLLECTIVES)
    line = {"phase": "fsdp_ranks", "ranks": FSDP_RANKS, "backend": "gloo",
            "gloo_takes_card_tensors": probe, "ran": ran, "wall_s": wall_s,
            "model": "gpt2-125m", "dtype": "bfloat16", "global_batch": 8,
            "seq_len": 1024, "steps": FSDP_RANKS_STEPS,
            "noshard": {"losses": want, **noshard_bytes},
            "loss_rtol": FSDP_RANKS_LOSS_RTOL}
    if not ran:
        line["left_out"] = ("gloo refuses card tensors for a collective the "
                            "strategies issue; no host-staging path is added")
        emit(line)
        return line
    for kind in ("FullyShardedDataParallel", "ZeRO1"):
        mean = [float(np.mean([r[kind]["losses"][i] for r in ranks]))
                for i in range(FSDP_RANKS_STEPS)]
        rel = [abs(a - b) / abs(b) for a, b in zip(mean, want)]
        line[kind] = {
            "mean_losses": mean, "loss_rel_err": rel,
            "per_rank": [{k: r[kind][k] for k in (
                "param_bytes", "opt_bytes", "max_memory_allocated_bytes",
                "sharded_leaves", "step_s")} for r in ranks],
            "param_bytes_over_noshard": ranks[0][kind]["param_bytes"]
            / noshard_bytes["param_bytes"],
            "opt_bytes_over_noshard": ranks[0][kind]["opt_bytes"]
            / noshard_bytes["opt_bytes"]}
    emit(line)
    for kind in ("FullyShardedDataParallel", "ZeRO1"):
        r = line[kind]
        check(max(r["loss_rel_err"]) <= FSDP_RANKS_LOSS_RTOL,
              f"fsdp_ranks {kind}: losses {r['mean_losses']} vs {want}")
        check(r["opt_bytes_over_noshard"] <= 0.26,
              f"fsdp_ranks {kind}: optimizer state not in quarters")
    check(line["FullyShardedDataParallel"]["param_bytes_over_noshard"] <= 0.26,
          "fsdp_ranks: FSDP parameters not in quarters")
    check(line["ZeRO1"]["param_bytes_over_noshard"] == 1.0,
          "fsdp_ranks: ZeRO1 parameters not whole")
    return line


# -- gradient communication: hooks, PowerSGD, model averaging --------------
HOOKS = ("allreduce", "bf16_compress", "fp16_compress", "reduce_scatter",
         "ring_allreduce")
HOOK_STEPS = 10
HOOK_LOSS_TOL = 5e-2      # the 16-bit hooks against the hookless losses
PSGD_STEPS = 8
PSGD_RESUME_STEPS = 3     # the runner's steps after a save and a restore
PSGD = dict(rank=2, start_iter=3)
RESNET_HOOK_ARGS = ("--model", "resnet50", "--dataset", "imagenet",
                    "--policy", "bf16", "--global-batch", "128",
                    "--steps-per-epoch", str(HOOK_STEPS), "--dataset-size",
                    "1280", "--num-workers", "6", "--log-every", "100")


def _per_step(counts, wire, steps, init_broadcasts):
    """Collectives and bytes a step of ``comm``'s totals over ``steps``
    steps, the start-up broadcasts left out."""
    counts = dict(counts)
    counts["broadcast"] -= init_broadcasts
    wire = {k: v for k, v in wire.items() if not k.startswith("broadcast")}
    return ({k: v / steps for k, v in counts.items() if v},
            {k: v / steps for k, v in wire.items()})


def comm_hooks_phase():
    """``examples/train_resnet_ddp.py``'s ``main`` at ResNet-50, ImageNet,
    batch 128 at 224 px, bf16, HOOK_STEPS steps with each ``--comm-hook``
    (DataParallel on the entry point's own one-rank NCCL group) and twice
    with none (NoShard; the two give the eager loop's run-to-run spread).
    At one rank per-rank BatchNorm is the global batch's and a mean over
    one rank is exact, so allreduce, reduce_scatter and ring_allreduce give
    the hookless losses (within the spread, 0 when the step is
    deterministic); bf16 and fp16 compression round the gradients and
    differ, within HOOK_LOSS_TOL. Images/s, and the collectives and bytes
    a step (``parallel.comm``)."""
    runs = {}
    for name in ("none_a", "none_b") + HOOKS:
        torch.cuda.empty_cache()
        comm.reset_counts()
        args = list(RESNET_HOOK_ARGS)
        if not name.startswith("none"):
            args += ["--comm-hook", name]
        out = train_resnet_ddp.main(args)
        step_s = out["step_s"][1:]       # the first step grows the pools
        runs[name] = {
            "losses": out["losses"],
            "images_per_s": out["images_per_step"] * len(step_s)
            / sum(step_s),
            "world": out["world"]}
        if not name.startswith("none"):
            per_step, wire = _per_step(comm.counts, comm.wire_bytes,
                                       len(out["losses"]), 1)
            runs[name].update(collectives_per_step=per_step,
                              wire_bytes_per_step=wire)
    base = runs["none_a"]["losses"]
    spread = max(abs(a - b) for a, b in zip(base, runs["none_b"]["losses"]))
    for name in HOOKS:
        runs[name]["max_loss_diff"] = max(
            abs(a - b) for a, b in zip(runs[name]["losses"], base))
    emit({"phase": "comm_hooks", "model": "resnet50", "dataset": "imagenet",
          "global_batch": 128, "dtype": "bfloat16", "steps": HOOK_STEPS,
          "ranks": 1, "backend": "nccl", "hookless_spread": spread,
          "loss_tol_16bit": HOOK_LOSS_TOL, **runs})
    for name in HOOKS:
        r = runs[name]
        check(len(r["losses"]) == HOOK_STEPS
              and all(np.isfinite(r["losses"])),
              f"comm_hooks {name}: losses {r['losses']}")
        if name.endswith("_compress"):
            check(0 < r["max_loss_diff"] <= HOOK_LOSS_TOL,
                  f"comm_hooks {name}: {r['max_loss_diff']} from the "
                  f"hookless losses (0 < d <= {HOOK_LOSS_TOL})")
            dtype = "bfloat16" if name.startswith("bf16") else "float16"
            check(f"all_reduce.{dtype}" in r["wire_bytes_per_step"],
                  f"comm_hooks {name}: no {dtype} on the wire: "
                  f"{r['wire_bytes_per_step']}")
        else:
            check(r["max_loss_diff"] <= spread,
                  f"comm_hooks {name}: losses {r['max_loss_diff']} from the "
                  f"hookless ones, beyond their spread {spread}")
    return runs


def _psgd_trainer(hook):
    """runner_train's model and step (GPT-2 125M, bf16, flash attention,
    capturable AdamW) under DataParallel on the one-rank NCCL group, with
    ``hook`` (a ``PowerSGD``, or None)."""
    strategy = DataParallel(init_device_mesh((pdist.get_world_size(),),
                                             ("dp",)))
    model = gpt2_125m(device="cuda", seed=2, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16",
                      comm_hook=hook)
    return trainer, trainer.init()


def _hook_device_ms(hook, grads, group, step, comm_state=None, reps=3):
    """Device time, kernels and host wall time of one hook call on
    ``grads``, from a traced window of ``reps`` calls."""
    def call():
        if comm_state is not None:
            hook.apply(comm_state, grads, group, step)
        else:
            hook(grads, group)

    with traced(call) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = _device_kernels(prof)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_ms": sum(e.self_device_time_total for e in device)
            / 1e3 / reps,
            "kernels": sum(e.count for e in device) / reps,
            "wall_ms": wall_ms / reps,
            "top_kernels": [{"name": e.key[:80],
                             "ms": e.self_device_time_total / 1e3 / reps}
                            for e in top]}


def _psgd_resume(runner, trainer, state, batches):
    """PowerSGD's checkpoint on the runner: a ``CheckpointManager`` save
    of the whole state (the model, AdamW, each leaf's Q and the error
    buffers as one tensor over dp), ``batches`` through the runner, a
    restore in place into the live runner, the same batches again: the
    losses and every state tensor (checksums) must be bit for bit the
    same, with the same programs replayed on the same addresses."""
    root = _fresh_dir("powersgd")
    sd = get_state_dict(trainer, state)
    state_bytes = sum((v.to_local() if hasattr(v, "to_local") else v).nbytes
                      for v in sd.values())
    comm_bytes = sum((v.to_local() if hasattr(v, "to_local") else v).nbytes
                     for k, v in sd.items() if k.startswith("train/comm/"))
    programs = dict(runner.programs)
    torch.cuda.synchronize()
    with CheckpointManager(str(root)) as mgr:
        t0 = time.perf_counter()
        mgr.save(state.step, sd)
        save_s = time.perf_counter() - t0
        at = state.step
        state, first = runner.run(state, batches)
        want = _checksums(trainer, state)
        ptrs = [t.data_ptr() for t in _step_tensors(trainer, state)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = set_state_dict(trainer, state,
                               mgr.restore(get_state_dict(trainer, state)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_step = state.step
        same_ptrs = [t.data_ptr() for t in _step_tensors(trainer, state)
                     ] == ptrs
        state, again = runner.run(state, batches)
        got = _checksums(trainer, state)
    shutil.rmtree(root, ignore_errors=True)
    first, again = ([float(v) for v in h["loss"]] for h in (first, again))
    return {"saved_at_step": at, "restored_step": restored_step,
            "steps": len(batches), "state_bytes": state_bytes,
            "comm_state_bytes": comm_bytes, "save_s": save_s,
            "restore_s": restore_s, "losses": first,
            "resumed_losses": again,
            "bit_for_bit": first == again and torch.equal(got, want)
            and restored_step == at,
            "restore_keeps_addresses": same_ptrs,
            "same_programs": all(runner.programs.get(k) is p
                                 for k, p in programs.items())}


def powersgd_phase(dp_runner_step_s):
    """GPT-2 125M at full width and depth, the train cell's step (B = 8,
    T = 1024, bf16, flash B1-B3, capturable AdamW), under DataParallel on
    the one-rank NCCL group with ``PowerSGD(rank=2, start_iter=3)``,
    PSGD_STEPS steps across ``start_iter``: the eager ``Trainer.step`` loop
    twice and ``AsyncRunner`` (losses, parameters and buffers within the
    eager spread; at most two programs captured, one for the warm-up
    branch and one for the compressed one). Then 3 traced replays of the
    compressed step (B1-B3 n_layer times each), the hook's own device time
    on GPT-2's gradients against the allreduce hook's, the elements on the
    wire against ``wire_elements`` (521,890 of 124,439,808), the error
    buffers' bytes, the compressed program's step time (PSGD_STEPS replays
    after the builds) against sharded_runner's DataParallel runner without
    a hook, and peak memory."""
    from pytorch_distributed_tpu_torch.parallel import (
        PowerSGD,
        allreduce_hook,
    )

    n_layer = GPT2Config().n_layer
    batches = _lm_batches(PSGD_STEPS, 8, 1024, seed=31)
    comm.reset_counts()
    runs, spread, got = _runner_runs(
        lambda: _psgd_trainer(PowerSGD(**PSGD)), batches, "powersgd")
    runner, trainer, state = runs["runner"].pop("_runner")
    hook, group = trainer.comm_hook, trainer.strategy.group
    compressed, dense = hook.wire_elements(trainer.model)
    # one eager compressed step's wire
    comm.reset_counts()
    state, _ = trainer.step(state, batches[0])
    step_wire = dict(comm.wire_bytes)
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})
    (device, calls, spans, wall_ms, _), first = recounted(
        lambda: _replay_window(runner, state, batches, 3, expect_calls),
        lambda r: r[1] == expect_calls)
    # the compressed program's replays alone (the runner's step time above
    # includes the second program's warm-up and capture at start_iter)
    runner.start(state, batches[0])
    runner.submit(batches[0])
    runner.sync()
    t0 = time.perf_counter()
    for batch in batches:
        runner.submit(batch)
    state, _ = runner.finish()
    compressed_step_s = (time.perf_counter() - t0) / len(batches)
    resume = _psgd_resume(runner, trainer, state, batches[:PSGD_RESUME_STEPS])
    grads = [torch.randn_like(p) for p in trainer._params]
    timing = {"powersgd": _hook_device_ms(hook, grads, group,
                                          hook.start_iter, state.comm_state),
              "allreduce": _hook_device_ms(allreduce_hook, grads, group, 0)}
    error_bytes = sum(e["e"].numel() * e["e"].element_size()
                      for e in state.comm_state.values())
    line = {
        "phase": "powersgd", "model": "gpt2-125m", "dtype": "bfloat16",
        "global_batch": 8, "seq_len": 1024, "steps": PSGD_STEPS,
        "powersgd": PSGD, "ranks": pdist.get_world_size(),
        "eager_spread": spread, "runner_vs_eager": got,
        "programs": runs["runner"]["programs"],
        "program_keys": sorted(runner.programs),
        "wire_elements": [compressed, dense],
        "wire_elements_per_step": step_wire.get("all_reduce.float32", 0) / 4,
        "error_feedback_bytes": error_bytes,
        "hook_device": timing,
        "flash_calls_per_replayed_step": calls,
        "first_window_flash_calls_per_step": first and first[1],
        "replay_ms_per_step": _spans_ms(spans) / 3,
        "device_busy_ms_per_replayed_step": sum(
            e.self_device_time_total for e in device) / 1e3 / 3,
        "step_s": {k: runs[k]["step_s"] for k in runs},
        "runner_compressed_step_s": compressed_step_s,
        "dp_runner_step_s": dp_runner_step_s,
        "compressed_step_s_over_dp_runner":
            compressed_step_s / dp_runner_step_s,
        "max_memory_allocated_bytes": {
            k: runs[k]["max_memory_allocated_bytes"] for k in runs},
        "losses": {k: runs[k]["losses"] for k in runs},
        "checkpoint_resume": resume}
    emit(line)
    check(resume["bit_for_bit"] and resume["same_programs"]
          and resume["restore_keeps_addresses"],
          f"powersgd: the resume on the runner after a restore {resume}")
    check(runs["runner"]["programs"] == 2
          and sorted(runner.programs) == [False, True],
          f"powersgd: programs {sorted(runner.programs)}")
    check(calls == expect_calls,
          f"powersgd: flash calls per replayed step {calls}")
    check((compressed, dense) == (521_890, 124_439_808),
          f"powersgd: wire_elements {(compressed, dense)}")
    check(line["wire_elements_per_step"] == compressed,
          f"powersgd: {line['wire_elements_per_step']} fp32 elements on "
          f"the wire a compressed step, wire_elements says {compressed}")
    del runner, trainer, state, runs, grads
    torch.cuda.empty_cache()
    return line


HOOK_RANKS_HOOKS = ("allreduce", "bf16_compress", "reduce_scatter",
                    "ring_allreduce", "powersgd")
#: the probe's collectives each hook issues (besides DataParallel's
#: start-up broadcast)
HOOK_COLLECTIVES = {
    "allreduce": ("all_reduce",),
    "bf16_compress": ("all_reduce_bf16", "all_reduce"),
    "reduce_scatter": ("reduce_scatter_tensor", "all_gather_into_tensor",
                       "all_reduce"),
    "ring_allreduce": ("send_recv", "all_reduce"),
    "powersgd": ("all_reduce",),
}


def _p2p_probe_rank(rank, port, device):
    pdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=2, device=device)
    try:
        x = torch.full((8,), float(rank), device=device)
        recv = torch.empty_like(x)
        comm.p2p(dist.group.WORLD, sends=[(x, 1 - rank)],
                 recvs=[(recv, 1 - rank)])
        check(float(recv[0]) == 1 - rank, "gloo send/recv: wrong data")
    finally:
        pdist.destroy_process_group()


def _probe_gloo_p2p(device):
    """Whether gloo sends and receives card tensors: True, or the error.
    Two throwaway ranks probe it apart from the ranks that train: gloo
    hands the socket a card tensor's device pointer (``writev``: "Bad
    address"), which raises in the caller or aborts the process from
    gloo's own thread, where a ``try`` cannot catch it."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.start_processes(
        _p2p_probe_rank, args=(port, device), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 60
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                return "the probe's ranks did not finish in 60 s"
    except (torch.multiprocessing.ProcessExitedException,
            torch.multiprocessing.ProcessRaisedException) as e:
        # the rank's own error is the last line of the report
        return f"{type(e).__name__}: {str(e).strip().splitlines()[-1]}"[:300]
    finally:   # the rank left waiting on its dead peer
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return True


def _hooks_rank(rank, out_dir, batches, device, p2p):
    """One of FSDP_RANKS ranks sharing the card over gloo: the probe, then
    GPT-2 125M (bf16, flash attention, AdamW) for FSDP_RANKS_STEPS eager
    steps under DataParallel with each hook the probe allows, from the same
    seeded weights; a digest of the synced gradients each step, the
    collectives and bytes a step; then ``average_parameters``'s
    all-reduces."""
    import hashlib

    from pytorch_distributed_tpu_torch.parallel import (
        PowerSGD,
        average_parameters,
    )

    result = {"rank": rank}
    try:
        probe = _probe_gloo_cuda(device)
        result["probe"] = probe = {**probe, "send_recv": p2p}
        _build.load_all(LIBRARIES)
        mesh = init_device_mesh((FSDP_RANKS,), ("dp",))
        for name in HOOK_RANKS_HOOKS:
            if not all(probe[k] is True for k in HOOK_COLLECTIVES[name]):
                continue
            torch.cuda.empty_cache()
            hook = PowerSGD(rank=2, start_iter=1) if name == "powersgd" \
                else name
            model = gpt2_125m(device=device, seed=7, dtype=torch.bfloat16,
                              attn_impl=fa.flash_attention)
            opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                    weight_decay=0.01, eps=1e-8)
            trainer = Trainer(model, opt, DataParallel(mesh, "dp"),
                              loss_fn=lm_loss, policy="bf16", comm_hook=hook)
            state = trainer.init()
            run = {"losses": [], "digests": [], "step_s": [], "wire": [],
                   "counts": []}
            for batch in batches:
                comm.reset_counts()
                t0 = time.perf_counter()
                state, m = trainer.step(state, batch)
                run["losses"].append(float(m["loss"]))
                torch.cuda.synchronize(device)
                run["step_s"].append(time.perf_counter() - t0)
                run["wire"].append(dict(comm.wire_bytes))
                run["counts"].append(dict(comm.counts))
                flat = torch.cat([p.grad.reshape(-1) for p in
                                  model.parameters()]).cpu().numpy()
                run["digests"].append(hashlib.sha1(flat.tobytes())
                                      .hexdigest())
            if name == "powersgd":
                run["wire_elements"] = hook.wire_elements(model)
            result[name] = run
            del trainer, state, model, opt
        # one all-reduce per dtype: fp32, and bf16 where gloo takes it
        pg = pdist.get_default_group()
        params = list(gpt2_125m(device=device, seed=rank).parameters())
        if probe["all_reduce_bf16"] is True:
            params.append(params[0].to(torch.bfloat16))
        before = observability.get_metrics().get("pg.all_reduce", 0)
        average_parameters(params, pg)
        result["average_parameters"] = {
            "dtypes": len({p.dtype for p in params}),
            "all_reduces": observability.get_metrics().get("pg.all_reduce", 0)
            - before}
    finally:
        torch.save(result, f"{out_dir}/hooks_rank{rank}.pt")


def hooks_ranks_phase(pool, want, device=torch.device("cuda", 0)):
    """FSDP_RANKS spawned ranks on the one card over gloo (as fsdp_ranks),
    GPT-2 125M at full width and depth, 8 x 1024 global (2 rows a rank),
    bf16, FSDP_RANKS_STEPS steps under DataParallel with the allreduce,
    bf16_compress, reduce_scatter and ring_allreduce hooks and
    ``PowerSGD(rank=2, start_iter=1)``, each where the probe allows its
    collectives (a hook the probe refuses is printed with the probe's
    error and not run). The ranks' synced gradients are equal (a digest a
    step); the mean of the ranks' losses within FSDP_RANKS_LOSS_RTOL of
    NoShard's (``want``, fsdp_ranks' run on the same batches); the bytes
    on the wire a step: bf16's half of the allreduce hook's, PowerSGD's
    compressed steps ``wire_elements``' fp32 elements; and
    ``average_parameters`` one all-reduce per dtype."""
    import tempfile

    batches = _lm_batches(FSDP_RANKS_STEPS, 8, 1024, seed=21)
    p2p = _probe_gloo_p2p(device)
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        wall_s = pool.run(_hooks_rank, (out_dir, batches, device, p2p), 300,
                          "hooks_ranks")
        ranks = [torch.load(f"{out_dir}/hooks_rank{r}.pt", weights_only=False)
                 for r in range(FSDP_RANKS)]
    probe = ranks[0]["probe"]
    line = {"phase": "hooks_ranks", "ranks": FSDP_RANKS, "backend": "gloo",
            "gloo_takes_card_tensors": probe, "wall_s": wall_s,
            "model": "gpt2-125m", "dtype": "bfloat16", "global_batch": 8,
            "seq_len": 1024, "steps": FSDP_RANKS_STEPS,
            "noshard_losses": want, "loss_rtol": FSDP_RANKS_LOSS_RTOL,
            "average_parameters": ranks[0]["average_parameters"]}
    for name in HOOK_RANKS_HOOKS:
        if name not in ranks[0]:
            line[name] = {"ran": False, "refused_by_probe": {
                k: probe[k] for k in HOOK_COLLECTIVES[name]
                if probe[k] is not True}}
            continue
        r0 = ranks[0][name]
        mean = [float(np.mean([r[name]["losses"][i] for r in ranks]))
                for i in range(FSDP_RANKS_STEPS)]
        line[name] = {
            "ran": True, "mean_losses": mean,
            "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(mean, want)],
            "grads_equal_across_ranks": all(
                r[name]["digests"] == r0["digests"] for r in ranks),
            "wire_bytes_per_step": r0["wire"],
            "collectives_per_step": r0["counts"],
            "step_s": [r[name]["step_s"] for r in ranks]}
        if name == "powersgd":
            line[name]["wire_elements"] = r0["wire_elements"]
    emit(line)
    ran = [n for n in HOOK_RANKS_HOOKS if line[n]["ran"]]
    for name in ran:
        r = line[name]
        check(r["grads_equal_across_ranks"],
              f"hooks_ranks {name}: the ranks' synced gradients differ")
        check(max(r["loss_rel_err"]) <= FSDP_RANKS_LOSS_RTOL,
              f"hooks_ranks {name}: losses {r['mean_losses']} vs {want}")
    if "bf16_compress" in ran and "allreduce" in ran:
        bf16 = line["bf16_compress"]["wire_bytes_per_step"][-1]
        fp32 = line["allreduce"]["wire_bytes_per_step"][-1]
        check(bf16["all_reduce.bfloat16"] * 2 == fp32["all_reduce.float32"],
              f"hooks_ranks: bf16 bytes {bf16} not half of fp32's {fp32}")
    if "powersgd" in ran:
        compressed = line["powersgd"]["wire_elements"][0]
        wire = line["powersgd"]["wire_bytes_per_step"][-1]
        check(wire["all_reduce.float32"] == compressed * 4,
              f"hooks_ranks powersgd: {wire} on the wire, wire_elements "
              f"{compressed}")
    avg = line["average_parameters"]
    check(avg["all_reduces"] == avg["dtypes"],
          f"hooks_ranks: average_parameters made {avg['all_reduces']} "
          f"all-reduces for {avg['dtypes']} dtypes")
    return line


# -- BatchNorm over a stats group in ResNet-50's own step: the path of the
# four BatchNorm kernels (bn_kernels) --

BN_GROUP_IMAGES = 32      # a rank's images, at 224 px
BN_GROUP_STEPS = 3
# the mean of the group's losses (bf16; flax's E[x^2] - E[x]^2 in the
# kernels) against NoShard's on the global batch (bf16; cuDNN's one-rank
# statistics): the two normalize with statistics that differ by rounding,
# so the bf16 limit of the other rank phases
BN_GROUP_LOSS_RTOL = FSDP_RANKS_LOSS_RTOL
BN_GROUP_TIMEOUT_S = 600


def _bn_group_trainer(device, world: int):
    """ResNet-50 (1000 classes, bf16 policy, seed 0) with SGD(0.1, 0.9):
    NoShard on one rank, else DataParallel over a ("dp",) mesh of
    ``world`` ranks, which binds every BatchNorm's ``stats_group``."""
    from pytorch_distributed_tpu_torch.models import resnet50

    model = resnet50(num_classes=1000, dtype=torch.bfloat16, device=device,
                     seed=0)
    strategy = (NoShard(device) if world == 1 else
                DataParallel(init_device_mesh((world,), ("dp",))))
    return Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                          momentum=0.9),
                   strategy, loss_fn=classification_loss, policy="bf16")


def _bn_group_batches(world: int):
    """BN_GROUP_STEPS global batches of ``world`` ranks' images (host
    arrays, the same in every process)."""
    rng = np.random.default_rng(25)
    n = BN_GROUP_IMAGES * world
    return [(rng.standard_normal((n, 224, 224, 3)).astype(np.float32),
             rng.integers(0, 1000, n).astype(np.int32))
            for _ in range(BN_GROUP_STEPS)]


def _bn_group_rank(rank, out_dir, world, device, captured):
    """A rank of the bn_group phase: ResNet-50 under DataParallel for
    BN_GROUP_STEPS steps, eager (``Trainer.step``) or through
    ``AsyncRunner`` (``captured``: warm-up steps, the capture, then
    replays); the BatchNorm kernels' launches counted from 0 around each
    eager step, or around the runner's start and its replays; the plain
    versions' calls; the losses; a digest of the final parameters and
    buffers."""
    import hashlib

    result = {"rank": rank}
    try:
        trainer = _bn_group_trainer(device, world)
        state = trainer.init()
        batches = _bn_group_batches(world)
        result["n_bn"] = len(trainer.model.batch_norms())
        plain = dict(bnk.plain_calls)
        launches = {}
        if captured:
            runner = AsyncRunner(trainer)
            for k in bnk.KERNELS:
                bnk.launches[k] = 0
            runner.start(state, batches[0])
            torch.cuda.synchronize(device)
            launches["start"] = dict(bnk.launches)
            launches["start_steps"] = runner.warmup_steps + 1
            for k in bnk.KERNELS:
                bnk.launches[k] = 0
            for batch in batches:
                runner.submit(batch)
            state, hist = runner.finish()
            launches["replays"] = dict(bnk.launches)
            result["losses"] = [float(x) for x in hist["loss"]]
        else:
            launches["steps"], result["losses"] = [], []
            for batch in batches:
                for k in bnk.KERNELS:
                    bnk.launches[k] = 0
                state, m = trainer.step(state, batch)
                result["losses"].append(float(m["loss"]))
                launches["steps"].append(dict(bnk.launches))
        torch.cuda.synchronize(device)
        result["launches"] = launches
        result["plain_calls"] = {k: bnk.plain_calls[k] - plain[k]
                                 for k in bnk.KERNELS}
        digest = hashlib.sha1()
        for t in trainer.model.state_dict().values():
            digest.update(t.detach().float().cpu().numpy().tobytes())
        result["digest"] = digest.hexdigest()
        result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        torch.save(result, f"{out_dir}/bn_group_rank{rank}.pt")


def _bn_group_nccl_worker(rank, world, port, out_dir):
    """A rank on card ``rank`` of an NCCL group: the captured bn_group
    body."""
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    pdist.init_process_group(init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world, device=device)
    try:
        _build.load("batch_norm")
        _bn_group_rank(rank, out_dir, world, device, True)
    finally:
        pdist.destroy_process_group()


def bn_group_phase(pool):
    """ResNet-50 at 224 px, BN_GROUP_IMAGES images a rank, bf16, SGD(0.1,
    0.9), BN_GROUP_STEPS steps under DataParallel, whose BatchNorms take
    the statistics of the group's whole batch (``_GroupBatchNorm``, the
    four kernels of bn_kernels), through the model's own entry. With two
    or more cards visible: one rank a card (up to 4) over NCCL through
    ``AsyncRunner``, as resnet50.ddp4 runs, the step captured as a CUDA
    graph: 53 launches of each kernel a step at the runner's start (its
    warm-up steps and the capture), none in the replays. With one card:
    the pool's FSDP_RANKS ranks over gloo, eager steps (gloo is not
    captured): 53 launches of each kernel every step. Either way no plain
    version runs, every rank ends with the same parameters and BatchNorm
    buffers, and the mean of the ranks' losses stays within
    BN_GROUP_LOSS_RTOL of NoShard's on the global batch here."""
    import tempfile

    cards = torch.cuda.device_count()
    captured = cards >= 2
    world = min(cards, 4) if captured else FSDP_RANKS
    torch.cuda.empty_cache()
    ref = _bn_group_trainer(torch.device("cuda", 0), 1)
    state = ref.init()
    want = []
    for batch in _bn_group_batches(world):
        state, m = ref.step(state, batch)
        want.append(float(m["loss"]))
    del ref, state
    torch.cuda.empty_cache()
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        if captured:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            ctx = torch.multiprocessing.start_processes(
                _bn_group_nccl_worker, args=(world, port, out_dir),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + BN_GROUP_TIMEOUT_S
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for proc in ctx.processes:
                        proc.kill()
                    check(False, f"bn_group: the NCCL ranks did not finish "
                                 f"in {BN_GROUP_TIMEOUT_S} s")
        else:
            pool.run(_bn_group_rank, (out_dir, world,
                                      torch.device("cuda", 0), False),
                     BN_GROUP_TIMEOUT_S, "bn_group")
        ranks = [torch.load(f"{out_dir}/bn_group_rank{r}.pt",
                            weights_only=False) for r in range(world)]
    wall_s = time.perf_counter() - t0
    mean = [float(np.mean([r["losses"][i] for r in ranks]))
            for i in range(BN_GROUP_STEPS)]
    per_step = dict.fromkeys(bnk.KERNELS, 53)
    if captured:
        steps = ranks[0]["launches"]["start_steps"]
        want_launches = {"start": {k: 53 * steps for k in bnk.KERNELS},
                         "start_steps": steps,
                         "replays": dict.fromkeys(bnk.KERNELS, 0)}
    else:
        want_launches = {"steps": [per_step] * BN_GROUP_STEPS}
    line = {"phase": "bn_group", "model": "resnet50", "dtype": "bfloat16",
            "hw": 224, "images_per_rank": BN_GROUP_IMAGES,
            "steps": BN_GROUP_STEPS, "ranks": world,
            "backend": "nccl" if captured else "gloo",
            "step": "AsyncRunner, captured" if captured
            else "Trainer.step, eager",
            "n_bn": [r["n_bn"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "expected_launches": want_launches,
            "plain_calls": [r["plain_calls"] for r in ranks],
            "states_equal_across_ranks": len({r["digest"] for r in ranks})
            == 1,
            "mean_losses": mean, "noshard_losses": want,
            "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(mean, want)],
            "loss_rtol": BN_GROUP_LOSS_RTOL,
            "peak_gib": [r["peak_gib"] for r in ranks], "wall_s": wall_s}
    emit(line)
    check(all(n == 53 for n in line["n_bn"]),
          f"bn_group: BatchNorms a model {line['n_bn']}, expected 53")
    check(all(r["launches"] == want_launches for r in ranks),
          f"bn_group: launches {line['launches']}, expected {want_launches}")
    check(not any(v for r in ranks for v in r["plain_calls"].values()),
          f"bn_group: plain versions ran on the card: {line['plain_calls']}")
    check(line["states_equal_across_ranks"],
          "bn_group: the ranks' parameters or BatchNorm buffers differ")
    check(max(line["loss_rel_err"]) <= BN_GROUP_LOSS_RTOL,
          f"bn_group: mean losses {mean} against NoShard's {want}")
    return line


# -- ResNet training (no kernel of the port runs on this path: convolutions,
# BatchNorm and GEMMs are cuDNN's and cuBLAS's, as XLA's were on the TPU) --

# card against CPU, fp32 with TF32 off (sums and conv algorithms in
# another order): logits and BN buffers within tol x the tensor's largest
# element, losses within tol relative. Parameters after 3 SGD steps within
# tol x the largest change any parameter made in those steps: a BN bias
# starts at 0 and its gradient sums the upstream gradient over batch and
# positions to a small residue, so against its own size it differed by
# 3.6e-3 to 1.2e-2 over three card runs, while against the step it is
# 4e-6 to 7e-6
RESNET_LOGITS_TOL = 1e-4
RESNET_LOSS_TOL = 1e-5
RESNET_BUFFER_TOL = 1e-5
RESNET_PARAM_TOL = 1e-4
# kernel families of a ResNet training step, by substrings of kernel names
# (cuDNN / cuBLAS / PyTorch); the first family that matches takes a kernel
RESNET_FAMILIES = (
    ("conv_dgrad", ("dgrad",)),
    ("conv_wgrad", ("wgrad",)),
    ("conv_fprop", ("fprop", "conv", "implicit_convolve", "xmma_fprop")),
    ("batch_norm", ("bn_", "batch_norm", "batchnorm")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copy_cast", ("copy",)),
    ("pool", ("pool",)),
    ("elementwise", ("elementwise", "threshold", "relu")),
    ("gemm", ("gemm", "cutlass", "gemv")),
    ("reduce", ("reduce",)),
)


def _resnet_models(ctor, kw, seed, scales):
    """The same fp32 ResNet on the card and on the CPU, with every BN
    running statistic, and with ``scales`` every BN scale and bias too,
    drawn at random."""
    cpu = ctor(10, device="cpu", seed=seed, **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in cpu.batch_norms():
            if scales:
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    card = ctor(10, device="cuda", seed=seed, **kw)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _rel(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().double()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)
            ).item()


def resnet_parity_phase():
    """ResNet-18 (CIFAR stem, B=16, 32 px) and ResNet-50 (ImageNet stem at
    64 px, B=8), 10 classes, fp32 with TF32 off and cuDNN's deterministic
    algorithms: the port on the card
    against the port on the CPU (the path the tests hold against flax).
    Train and eval logits with every BN scale, bias and running statistic
    drawn at random; then the losses of 3 ``SGD(0.01, momentum=0.9)``
    steps, and the parameters (against the largest change a parameter
    made) and BN buffers after them, from flax's BN init with random
    running statistics. (With random BN scales the fp32 steps are chaotic:
    on the CPU alone, ResNet-50's fp32 loss is 7% off the fp64 one at the
    second step; from the BN init it is 2e-7:
    ``tests/_torch_port_resnet_precision.py``.)"""
    from pytorch_distributed_tpu_torch.models import resnet18, resnet50

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms: the default ones sum ResNet-50's
    # stem weight gradient in a run-dependent order (card runs of this
    # phase in one process read 1.9e-4 and 6.9e-6 of the largest step)
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, ctor, kw, shape in (
                ("resnet18_cifar", resnet18, {"cifar_stem": True},
                 (16, 32, 32, 3)),
                ("resnet50_64px", resnet50, {}, (8, 64, 64, 3))):
            cpu, card = _resnet_models(ctor, kw, seed=4, scales=True)
            rng = np.random.default_rng(4)
            x = torch.from_numpy(rng.standard_normal(shape, np.float32))
            y = torch.from_numpy(rng.integers(0, 10, shape[0]))
            errs = {}
            for mode in ("eval", "train"):
                for m in (cpu, card):
                    m.train(mode == "train")
                with torch.no_grad():
                    errs[f"{mode}_logits"] = _rel(card(x.cuda()), cpu(x))
            cpu, card = _resnet_models(ctor, kw, seed=4, scales=False)
            init = {k: v.clone() for k, v in cpu.state_dict().items()}
            runs = []
            for m, dev in ((cpu, "cpu"), (card, "cuda")):
                opt = torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)
                trainer = Trainer(m, opt, NoShard(dev),
                                  loss_fn=classification_loss)
                state = trainer.init()
                losses = []
                for _ in range(3):
                    state, metrics = trainer.step(state, (x, y))
                    losses.append(float(metrics["loss"]))
                runs.append((losses, m.state_dict()))
            (cpu_losses, cpu_sd), (card_losses, card_sd) = runs
            errs["losses"] = [abs(a - b) / abs(b)
                              for a, b in zip(card_losses, cpu_losses)]
            params = {k for k, _ in cpu.named_parameters()}
            step = max((cpu_sd[k] - init[k]).abs().max().item()
                       for k in params)
            param_errs = {k: (card_sd[k].cpu() - cpu_sd[k]).abs().max().item()
                          / step for k in params}
            buffer_errs = {k: _rel(card_sd[k], v) for k, v in cpu_sd.items()
                           if k.endswith(("running_mean", "running_var"))}
            worst_p = max(param_errs, key=param_errs.get)
            worst_b = max(buffer_errs, key=buffer_errs.get)
            out[name] = {"max_rel_err": errs, "loss_card": card_losses,
                         "loss_cpu": cpu_losses, "largest_step": step,
                         "param_worst_over_step": [worst_p,
                                                   param_errs[worst_p]],
                         "buffer_worst": [worst_b, buffer_errs[worst_b]]}
            del cpu, card, runs, card_sd
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    emit({"phase": "resnet_parity", "dtype": "float32", "tf32": False,
          "cudnn_deterministic": True,
          "logits_tol": RESNET_LOGITS_TOL, "loss_tol": RESNET_LOSS_TOL,
          "buffer_tol": RESNET_BUFFER_TOL, "param_tol": RESNET_PARAM_TOL,
          **out})
    for name, r in out.items():
        errs = r["max_rel_err"]
        check(max(errs["train_logits"], errs["eval_logits"])
              <= RESNET_LOGITS_TOL, f"{name} card vs CPU logits {errs}")
        check(all(np.isfinite(r["loss_card"]))
              and max(errs["losses"]) <= RESNET_LOSS_TOL
              and r["param_worst_over_step"][1] <= RESNET_PARAM_TOL
              and r["buffer_worst"][1] <= RESNET_BUFFER_TOL,
              f"{name} card vs CPU after 3 steps: {r}")


def resnet_train_phase(smi):
    """The bench twin (``pytorch_distributed_tpu_torch.bench``) at its
    ImageNet shapes: ResNet-50, batch 128 at 224 px, bf16, SGD(0.1, 0.9),
    3 warm-up, 50 timed and 15 synchronized steps; the loss must fall and
    the MFU stay at most 1 (the bench refuses otherwise)."""
    torch.cuda.empty_cache()
    out = bench.run(torch.device("cuda"), **bench.IMAGENET)
    emit({"phase": "resnet_train", "nvidia_smi": smi, **out})
    check(out["platform"] == "gpu" and out["mfu"] is not None
          and 0 < out["mfu"] <= 1.0, f"resnet_train: {out}")
    check(out["metric"] == "resnet50_imagenet_images_per_sec_per_chip",
          f"resnet_train ran {out['metric']}")
    return out


def resnet_runner_phase(bench_out):
    """The bench twin's step (ResNet-50, batch 128 at 224 px, bf16,
    SGD(0.1, 0.9), one fixed batch, cuDNN's algorithm search on) through
    ``AsyncRunner`` against the eager ``Trainer.step`` loop, 8 steps from
    the same weights: losses, parameters and BatchNorm buffers equal bit for
    bit where the eager loop is deterministic run to run, else within its
    own spread (two eager runs); images/s of both and their peak memory,
    the graph pool included. The bench's own runner throughput and synced
    step p50 (resnet_train) are repeated beside them."""
    steps, batch = 8, 128

    def build():
        trainer, _ = bench.build(torch.device("cuda"), batch=batch, hw=224)
        return trainer, trainer.init()

    fixed = bench.build(torch.device("cuda"), batch=batch, hw=224)[1]
    runs, spread, got = _runner_runs(build, [fixed] * steps, "resnet_runner")
    del runs["runner"]["_runner"]
    for run in runs.values():
        run["images_per_s"] = batch / run["step_s"]
    emit({"phase": "resnet_runner", "model": "resnet50", "batch": batch,
          "hw": 224, "dtype": "bfloat16", "steps": steps,
          "warmup_steps": AsyncRunner.warmup_steps,
          "eager_spread": spread, "runner_vs_eager": got,
          "bench_images_per_s_runner": bench_out["value"],
          "bench_step_ms_p50_synced": bench_out["step_ms_p50"], **runs})
    torch.cuda.empty_cache()


def resnet_amp_accum_phase():
    """The reference's config #3: ResNet-50 computing in fp16 with the loss
    scaler, ``grad_accum_steps=2`` (two microbatches of 64), batch 128 at
    224 px, 10 steps on one fixed batch: every loss finite, the last below
    the first."""
    torch.cuda.empty_cache()
    trainer, fixed = bench.build(torch.device("cuda"), batch=128, hw=224,
                                 policy="fp16", grad_accum_steps=2)
    state = trainer.init()
    losses, finite, scales, step_s = [], [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        state, m = trainer.step(state, fixed)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        finite.append(bool(m["all_finite"]))
        scales.append(float(m["loss_scale"]))
    emit({"phase": "resnet_amp_accum", "model": "resnet50",
          "dtype": str(trainer.model.dtype), "policy": "fp16",
          "grad_accum_steps": 2, "batch": 128, "hw": 224, "losses": losses,
          "all_finite": finite, "loss_scale": scales,
          "step_p50_s": statistics.median(step_s[1:])})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"fp16 accumulation: loss did not fall: {losses}")
    del trainer, state, fixed


def resnet_example_phase():
    """The entry point ``examples.train_resnet_ddp`` (one process:
    ``NoShard``) at ``--model resnet50 --dataset imagenet --global-batch
    128 --steps-per-epoch 5``, synthetic ImageNet made by 6 loader workers
    and copied ahead by ``prefetch_to_device``; every loss finite."""
    torch.cuda.empty_cache()
    out = train_resnet_ddp.main([
        "--model", "resnet50", "--dataset", "imagenet", "--global-batch",
        "128", "--steps-per-epoch", "5", "--dataset-size", "640",
        "--num-workers", "6", "--log-every", "1"])
    emit({"phase": "resnet_example", **out})
    check(len(out["losses"]) == 5 and all(np.isfinite(out["losses"])),
          f"resnet_example losses {out['losses']}")
    return out


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in RESNET_FAMILIES
                 if any(k in low for k in keys)), "other")


def resnet_profile_phase():
    """Where a ResNet-50 training step's time goes (the bench's step:
    batch 128 at 224 px, bf16): torch.profiler over 3 steps after a warm-up
    inside the window; device busy time against host wall time, kernels per
    step, and device time by kernel family."""
    steps = 3
    torch.cuda.empty_cache()
    trainer, fixed = bench.build(torch.device("cuda"), batch=128, hw=224)
    state = trainer.init()
    state, _ = trainer.step(state, fixed)
    torch.cuda.synchronize()

    def warm_up():  # a step not recorded
        nonlocal state
        state, _ = trainer.step(state, fixed)

    with traced(warm_up) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.step(state, fixed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    families = {}
    for e in device:
        fam = families.setdefault(_family(e.key), {"ms_per_step": 0.0,
                                                   "calls_per_step": 0.0})
        fam["ms_per_step"] += e.self_device_time_total / 1e3 / steps
        fam["calls_per_step"] += e.count / steps
    top = sorted(device, key=lambda e: -e.self_device_time_total)
    other = [e for e in top if _family(e.key) == "other"][:5]
    emit({"phase": "resnet_profile", "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": busy_ms / steps,
          "device_busy_share": busy_ms / wall_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "device_kernels_per_step": sum(e.count for e in device) / steps,
          "families": families,
          "top_kernels": [{"name": e.key[:100], "family": _family(e.key),
                           "ms_per_step": e.self_device_time_total / 1e3 / steps,
                           "calls_per_step": e.count / steps}
                          for e in top[:10] + other]})
    check(busy_ms > 0, "resnet_profile: the profiler saw no device time")
    del trainer, state, fixed



# -- checkpoints and the elastic launcher (BASELINE config #5) ------------

CKPT_ROOT = Path(__file__).resolve().parent / "pytorch_distributed_tpu_torch" \
    / "_build" / "ckpt_smoke"
ELASTIC_K = 10            # steps an epoch, and steps between checkpoints
ELASTIC_EPOCHS = 3
# resumed against uninterrupted ResNet-50 losses (bf16): one bf16 step of
# the loss, relative
ELASTIC_LOSS_RTOL = 1e-2
RESNET_ELASTIC_ARGS = (
    "--model", "resnet50", "--dataset", "imagenet", "--global-batch", "128",
    "--policy", "bf16", "--steps-per-epoch", str(ELASTIC_K),
    "--epochs", str(ELASTIC_EPOCHS), "--ckpt-every", str(ELASTIC_K),
    "--dataset-size", str(128 * ELASTIC_K), "--num-workers", "6",
    "--log-every", "1")
STEP_LINE = re.compile(r"\[rank 0\] step (\d+) loss \S+ \(([\d.]+) ms\)")


def _fresh_dir(name: str) -> Path:
    d = CKPT_ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _dir_bytes(d: Path) -> int:
    return sum(p.stat().st_size for p in Path(d).rglob("*") if p.is_file())


def _checksums(trainer, state):
    """One fp64 sum of squares per state tensor (on the device)."""
    return torch.stack([
        (t.to_local() if hasattr(t, "to_local") else t).double().square().sum()
        .to("cpu") for t in get_state_dict(trainer, state).values()])


def _ckpt_times(trainer, state, step_fn, root: Path) -> dict:
    """Checkpoint costs of ``trainer``'s state: a blocking save; an async
    save (the stall until ``save`` returns: DCP's copy to host memory, and
    the whole write); one training step, then a restore of the async
    checkpoint into the live tensors (every state tensor keeps its address,
    every value comes back); the bytes on disk."""
    sd = get_state_dict(trainer, state)
    state_bytes = sum((v.to_local() if hasattr(v, "to_local") else v).nbytes
                      for v in sd.values())
    want = _checksums(trainer, state)
    torch.cuda.synchronize()
    with CheckpointManager(root / "blocking") as mgr:
        t0 = time.perf_counter()
        mgr.save(state.step, sd)
        save_s = time.perf_counter() - t0
    with CheckpointManager(root / "async", async_save=True) as mgr:
        t0 = time.perf_counter()
        mgr.save(state.step, sd)
        stall_s = time.perf_counter() - t0
        handle = type(mgr._pending._future).__name__
        mgr.wait_until_finished()
        async_s = time.perf_counter() - t0
        moved = step_fn(state)
        ptrs = [t.data_ptr() for t in _step_tensors(trainer, moved)]
        changed = not torch.equal(_checksums(trainer, moved), want)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = set_state_dict(trainer, moved,
                              mgr.restore(get_state_dict(trainer, moved)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    same_ptrs = [t.data_ptr() for t in _step_tensors(trainer, back)] == ptrs
    restored = torch.equal(_checksums(trainer, back), want)
    out = {"state_bytes": state_bytes,
           "disk_bytes": _dir_bytes(root / "async"),
           "save_blocking_s": save_s, "save_async_stall_s": stall_s,
           "save_async_total_s": async_s, "async_handle": handle,
           "restore_s": restore_s, "restore_keeps_addresses": same_ptrs,
           "restored_step": back.step}
    check(changed and restored and same_ptrs and back.step == state.step,
          f"checkpoint round trip: step changed the state {changed}, "
          f"restored values {restored}, addresses kept {same_ptrs}, step "
          f"{back.step} != {state.step}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def _elastic_run(name: str, kill: bool) -> dict:
    """``examples/train_resnet_ddp.py`` at RESNET_ELASTIC_ARGS under a
    ``LocalElasticAgent`` in this process (one worker, a one-rank NCCL
    group); with ``kill``, SIGKILL the worker as soon as checkpoint
    ELASTIC_K is committed."""
    root = _fresh_dir(name)
    ckpt = root / "ckpt"
    store = TCPStore("127.0.0.1", 0, is_master=True)
    repo = str(Path(__file__).resolve().parent)
    spec = WorkerSpec(
        cmd=[sys.executable, "-m",
             "pytorch_distributed_tpu_torch.examples.train_resnet_ddp",
             *RESNET_ELASTIC_ARGS, "--ckpt-dir", str(ckpt)],
        nproc_per_node=1, run_id=name, max_restarts=1,
        log_dir=str(root / "logs"), extra_env={"PYTHONPATH": repo})
    agent = LocalElasticAgent(spec, DynamicRendezvous(store, name, 1, 1))
    errors = []

    def run():
        try:
            agent.run()
        except Exception as e:        # re-raised by the check below
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    t_kill = None
    if kill:
        marker = ckpt / str(ELASTIC_K) / ".metadata"
        while not marker.exists():
            check(thread.is_alive(), f"{name}: the agent stopped: {errors}")
            time.sleep(0.005)
        pid = agent.workers[0].proc.pid
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)
    thread.join(timeout=600)
    store.close()
    check(not thread.is_alive() and not errors,
          f"{name}: the agent failed: {errors}")
    logs = {int(d.name.removeprefix("round")): (d / "worker_0.log").read_text()
            for d in (root / "logs" / name).iterdir()}
    events = [e for e in observability.recent_events(1000)
              if (e.metadata or {}).get("run_id") == name]
    return {"agent": agent, "logs": logs, "events": events, "t_kill": t_kill,
            "root": root}


def _summary(log: str) -> dict:
    return json.loads(log.strip().splitlines()[-1])


def elastic_resnet_phase(smi):
    """BASELINE config #5 on one card: ``examples/train_resnet_ddp.py``
    (ResNet-50, batch 128 at 224 px, bf16, synthetic ImageNet from 6
    loader workers, DataParallel over a one-rank NCCL group) under the
    port's ``LocalElasticAgent``, ``--ckpt-dir`` with ``--steps-per-epoch``
    equal to ``--ckpt-every`` (ELASTIC_K) and 3 epochs. Once checkpoint
    ELASTIC_K is committed the worker is SIGKILLed; the agent restarts it
    (exactly once), and the new process resumes at step ELASTIC_K + 1, on
    an epoch boundary, so it sees the batches of an uninterrupted run under
    the same agent: its losses are held against that run's within
    ELASTIC_LOSS_RTOL. Reported: images/s before the kill, after the
    resume and uninterrupted; the time to recover from the kill to the
    first step of the new process, split into the agent's detection, the
    restart (stopping the group and the rendezvous), the process start
    (Python and torch imported), CUDA, NCCL and model set-up, the restore
    and the first step (cuDNN's first plans; its algorithm search is off
    in the entry point); and the checkpoint costs of the same trainer in
    this process (a blocking and an async save, a restore, bytes)."""
    torch.cuda.empty_cache()
    whole = _elastic_run("elastic_whole", kill=False)
    killed = _elastic_run("elastic_resnet", kill=True)
    agent = killed["agent"]
    check(agent.restart_count == 1 and whole["agent"].restart_count == 0,
          f"elastic_resnet: {agent.restart_count} restarts")
    before = [(int(s), float(ms)) for s, ms in STEP_LINE.findall(
        killed["logs"][0])]
    resumed = _summary(killed["logs"][1])
    want = _summary(whole["logs"][0])
    k = resumed["resumed_from"]
    check(k is not None and k >= ELASTIC_K and resumed["first_step"] == k + 1,
          f"elastic_resnet: resumed from {k}, first step "
          f"{resumed['first_step']}: the steps did not continue")
    check(k % ELASTIC_K == 0, f"resumed from {k}, not an epoch boundary")
    got = np.array(resumed["losses"])
    ref = np.array(want["losses"][k:])
    check(got.shape == ref.shape and bool(np.all(np.isfinite(got))),
          f"elastic_resnet: resumed losses {got.tolist()}")
    rel = np.abs(got - ref) / np.abs(ref)
    check(float(rel.max()) <= ELASTIC_LOSS_RTOL,
          f"elastic_resnet: resumed losses {got.tolist()} against the "
          f"uninterrupted {ref.tolist()} (rtol {ELASTIC_LOSS_RTOL})")
    failed = [e.timestamp for e in killed["events"]
              if e.name == "elastic.group_failed"]
    started = [e.timestamp for e in killed["events"]
               if e.name == "elastic.workers_started"
               and e.metadata["round"] == 1]
    check(len(failed) == 1 and len(started) == 1,
          f"elastic_resnet: events {[e.name for e in killed['events']]}")
    m, t_kill = resumed["marks"], killed["t_kill"]
    recover = {
        "detect_s": failed[0] - t_kill,
        "restart_s": started[0] - failed[0],
        "process_start_s": m["start"] - started[0],
        "cuda_nccl_model_s": m["ready"] - m["start"],
        "restore_s": m["restored"] - m["ready"],
        "first_step_s": m["first_step_done"] - m["restored"],
    }
    recover["total_s"] = m["first_step_done"] - t_kill

    def images_per_s(step_s):
        return 128 / statistics.median(step_s) if step_s else None

    trainer, fixed = bench.build(torch.device("cuda"), batch=128, hw=224)
    state, _ = trainer.step(trainer.init(), fixed)
    costs = _ckpt_times(trainer, state,
                        lambda s: trainer.step(s, fixed)[0],
                        CKPT_ROOT / "resnet_times")
    del trainer, state, fixed
    emit({"phase": "elastic_resnet", "nvidia_smi": smi, "model": "resnet50",
          "dtype": "bfloat16", "global_batch": 128, "hw": 224,
          "steps_per_epoch": ELASTIC_K, "epochs": ELASTIC_EPOCHS,
          "restarts": agent.restart_count, "killed_after_commit_of": ELASTIC_K,
          "steps_before_kill": before[-1][0] if before else 0,
          "resumed_from": k, "first_step_after_resume": resumed["first_step"],
          "losses_resumed": got.tolist(), "losses_uninterrupted": ref.tolist(),
          "loss_max_rel_diff": float(rel.max()),
          "losses_bit_equal": bool(np.array_equal(got, ref)),
          "images_per_s_before_kill": images_per_s(
              [ms / 1e3 for _, ms in before[1:]]),
          "images_per_s_after_resume": images_per_s(resumed["step_s"][1:]),
          "images_per_s_uninterrupted": images_per_s(want["step_s"][1:]),
          "time_to_recover": recover, "checkpoint": costs})
    shutil.rmtree(whole["root"], ignore_errors=True)
    shutil.rmtree(killed["root"], ignore_errors=True)
    torch.cuda.empty_cache()


def ckpt_gpt2_phase(smi):
    """GPT-2 125M checkpoints (bf16 policy, fp32 parameters, AdamW): the
    entry point ``examples/train_gpt2.py`` (FSDP on its own one-rank NCCL
    group) saves at step 2 with ``--ckpt-dir``, and a second run of it
    resumes from step 2 for steps 3-4 and saves at the end (its time from
    ``main`` to its first step, split into the process group and model,
    the restore and the first step: a resume inside one process, no agent).
    Then, on a
    one-rank NCCL group, sharded_runner's FSDP trainer runs 3 steps on
    ``AsyncRunner`` (one replay a step), the entry point's step-4
    checkpoint is restored in place into its live tensors, and the runner
    goes on without rebuilding its captured step; its 3 losses from the
    restored state equal those of the eager ``Trainer.step`` from the same
    checkpoint (or lie within the eager loop's run-to-run spread). Also
    the checkpoint costs of that trainer (a blocking and an async save, a
    restore, bytes)."""
    torch.cuda.empty_cache()
    root = _fresh_dir("gpt2")
    args = ["--ckpt-dir", str(root / "ckpt"), "--ckpt-every", "2"]
    t0 = time.perf_counter()
    first = train_gpt2.main(["--steps", "2", *args])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = train_gpt2.main(["--steps", "4", *args])
    second_s = time.perf_counter() - t0
    check(first["resumed_from"] is None and len(first["losses"]) == 2,
          f"ckpt_gpt2: first run {first['resumed_from']}")
    check(second["resumed_from"] == 2 and second["first_step"] == 3
          and len(second["losses"]) == 2
          and all(np.isfinite(second["losses"])),
          f"ckpt_gpt2: the second run resumed from {second['resumed_from']}, "
          f"first step {second['first_step']}, losses {second['losses']}")
    with CheckpointManager(root / "ckpt") as mgr:
        steps = mgr.all_steps()
    check(steps == [2, 4], f"ckpt_gpt2: committed steps {steps}")
    m = second["marks"]
    resume = {"group_and_model_s": m["ready"] - m["start"],
              "restore_s": m["restored"] - m["ready"],
              "first_step_s": m["first_step_done"] - m["restored"],
              "total_s": m["first_step_done"] - m["start"]}

    batches = _lm_batches(3, 8, 1024, seed=21)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pdist.init_process_group(init_method=f"tcp://localhost:{port}", rank=0,
                             world_size=1)
    try:
        trainer, state = _sharded_trainer("FullyShardedDataParallel")
        runner = AsyncRunner(trainer, depth=2, drain_every=len(batches))
        state, _ = runner.run(state, batches)
        program = runner._program
        with CheckpointManager(root / "ckpt") as mgr:
            sd = get_state_dict(trainer, state)
            t0 = time.perf_counter()
            state = set_state_dict(trainer, state, mgr.restore(sd, step=4))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(state.step == 4, f"ckpt_gpt2: restored step {state.step}")
            state, hist = runner.run(state, batches)
            rebuilt = runner._program is not program
            eager = []
            for _ in range(2):
                st = set_state_dict(trainer, state,
                                    mgr.restore(get_state_dict(trainer, state),
                                                step=4))
                losses = []
                for b in batches:
                    st, m = trainer.step(st, b)
                    losses.append(float(m["loss"]))
                eager.append(losses)
        runner_losses = [float(x) for x in hist["loss"]]
        spread = max(abs(a - b) for a, b in zip(*eager))
        off = max(abs(a - b) for a, b in zip(runner_losses, eager[0]))
        check(not rebuilt, "ckpt_gpt2: the restore rebuilt the runner's step")
        check(off <= spread, f"ckpt_gpt2: runner losses {runner_losses} "
              f"after the restore against eager {eager}")
        check(st.step == 7 and state.step == 7, "ckpt_gpt2: steps")
        costs = _ckpt_times(trainer, state,
                            lambda s: trainer.step(s, batches[0])[0],
                            root / "times")
        del runner, trainer, state, st
    finally:
        pdist.destroy_process_group()
    serve_ckpt_phase(root / "ckpt")
    emit({"phase": "ckpt_gpt2", "nvidia_smi": smi, "model": "gpt2-125m",
          "dtype": "bfloat16", "global_batch": 8, "seq_len": 1024,
          "strategy": second["strategy"], "world": second["world"],
          "entry_point": {"first_run_s": first_s, "second_run_s": second_s,
                          "resumed_from": second["resumed_from"],
                          "first_step": second["first_step"],
                          "losses_first_run": first["losses"],
                          "losses_after_resume": second["losses"],
                          "committed_steps": steps,
                          "resume_in_process": resume},
          "runner": {"restore_into_live_runner_s": restore_s,
                     "rebuilt": rebuilt, "losses_after_restore": runner_losses,
                     "eager_losses": eager, "eager_spread": spread,
                     "runner_vs_eager": off},
          "checkpoint": costs})
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# -- tensor parallelism and the disk datasets --------------------------------
TP_RANKS = 4
TP_RANKS_STEPS = 3
TP_RANKS_LOSS_RTOL = 1e-2     # bf16, as fsdp_ranks' limit
#: (tag, (dp, tp), sequence_parallel) of the ranks' training runs
TP_RANKS_JOBS = (("dp1_tp4", (1, 4), False), ("dp1_tp4_sp", (1, 4), True),
                 ("dp2_tp2", (2, 2), False))
TP_RANKS_JOBS_BY_TAG = tuple((tag, shape) for tag, shape, _ in TP_RANKS_JOBS)
TP_SERVE_REQUESTS = 8
TP_SERVE_NEW_TOKENS = 24
TP_GAP_RTOL = 1e-5            # a departing greedy stream's top-2 gap
TP_CKPT_JOB = "dp1_tp4"       # the job whose state is saved and resumed
TP_RESHARD_DST = (2, 2)       # its state moved to (dp 2, tp 2) too
DP_SLOTS = (2, 2)             # serving with the slots on dp: (dp, tp)
DP_SLOTS_SPEC_NEW_TOKENS = 12  # spec_k 3's new tokens (spec_k 0: 24)
DISK_ROOT = Path(__file__).resolve().parent / "pytorch_distributed_tpu_torch" \
    / "_build" / "disk_smoke"
DISK_STEPS = 10


def _tp_step_collectives(n_layer: int, sp: bool) -> dict:
    """The collectives one ``TensorParallel`` step of GPT-2 issues (a dp
    axis, no fsdp): per layer Megatron's f and g twice (all-reduces; with
    sequence parallelism all-gathers and reduce-scatters along T), the two
    tables' gathers, the dp mean and the norm (with SP also the split and
    join of the sequence and the partial gradients' sum over tp)."""
    if sp:
        return {"all_reduce": 3, "reduce_scatter": 4 * n_layer,
                "all_gather": 4 * n_layer + 4, "broadcast": 0}
    return {"all_reduce": 4 * n_layer + 2, "reduce_scatter": 0,
            "all_gather": 2, "broadcast": 0}


def _tp_trainer(sp: bool):
    """runner_train's model and step (GPT-2 125M, bf16, flash attention,
    capturable AdamW, seed 2) under ``TensorParallel`` on a ``(dp 1, tp
    n)`` mesh of the process group."""
    n = pdist.get_world_size()
    strategy = TensorParallel(init_device_mesh((1, n), ("dp", "tp")),
                              gpt2_tp_plan(), sequence_parallel=sp)
    model = gpt2_125m(device="cuda", seed=2, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def tp_train_phase(noshard_runs, noshard_final):
    """TensorParallel training on the one-rank NCCL group (``(dp 1, tp
    1)``: every collective spans one rank), runner_train's cell (GPT-2
    125M, bf16, B = 8 x 1024, flash attention, 10 steps), with sequence
    parallelism off and on: the eager loop twice and the runner (one
    replay a step, the collectives captured in it); the runner's losses,
    parameters and buffers equal NoShard's runner (runner_train) bit for
    bit; ``comm.counts`` over the eager runs, the warm-up and the runner's
    replays equal ``_tp_step_collectives`` times the steps those ran (a
    capture records its collectives uncounted, a replay counts them), and
    the profiled replays count one step's collectives each and call no
    wrapper; B1-B3 launch n_layer times each a replayed step in a device
    trace; step time against NoShard's runner."""
    t_phase = time.perf_counter()
    steps, prof_steps = 10, 3
    n_layer = GPT2Config().n_layer
    batches = _lm_batches(steps, 8, 1024, seed=12)      # runner_train's
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})
    out = {}
    for sp in (False, True):
        key = "sequence_parallel" if sp else "tp"
        comm.reset_counts()
        runs, spread, got = _runner_runs(lambda: _tp_trainer(sp), batches,
                                         f"tp_train {key}", keep_final=True)
        runner, trainer, state = runs["runner"].pop("_runner")
        final = runs["runner"].pop("_final")
        captured = dict(comm.counts)
        same_losses = runs["runner"]["losses"] == noshard_runs["runner"][
            "losses"]
        same_state = len(final) == len(noshard_final) and all(
            torch.equal(a, b) for a, b in zip(final, noshard_final))
        comm.reset_counts()
        replays = _replays(runner)
        (device, calls, spans, wall_ms, _), first = recounted(
            lambda: _replay_window(runner, state, batches, prof_steps,
                                   expect_calls),
            lambda r: r[1] == expect_calls)
        replays = _replays(runner) - replays
        replays_counted, wrapper_calls = dict(comm.counts), len(comm.calls)
        per_step = _tp_step_collectives(n_layer, sp)
        # the eager runs, the warm-up and the runner's replays
        runs_steps = 3 * steps + AsyncRunner.warmup_steps
        want = {k: v * runs_steps for k, v in per_step.items()}
        want["broadcast"] = 3                       # one an init
        want_replays = {k: v * replays for k, v in per_step.items()}
        nccl = [e for e in device if "nccl" in e.key.lower()]
        out[key] = {
            "signature": trainer.strategy.collective_signature(),
            "losses_runner": runs["runner"]["losses"],
            "equal_to_noshard_runner": {"losses": same_losses,
                                        "parameters_and_buffers": same_state},
            "eager_spread": spread, "runner_vs_eager": got,
            "step_s": {k: runs[k]["step_s"] for k in runs},
            "step_s_over_noshard_runner":
                runs["runner"]["step_s"] / noshard_runs["runner"]["step_s"],
            "max_memory_allocated_bytes": {
                k: runs[k]["max_memory_allocated_bytes"] for k in runs},
            "replays": runs["runner"]["replays"],
            "collectives_per_step": per_step,
            "collectives_eager_warmup_replays": captured,
            "collectives_in_replays": replays_counted,
            "wire_bytes_in_replays": dict(comm.wire_bytes),
            "nccl_ms_per_step": sum(e.self_device_time_total for e in nccl)
            / 1e3 / prof_steps,
            "device_busy_ms_per_step": sum(e.self_device_time_total
                                           for e in device) / 1e3 / prof_steps,
            "replay_ms_per_step": _spans_ms(spans) / prof_steps,
            "flash_calls_per_step": calls,
            "first_window_flash_calls_per_step": first and first[1]}
        check(same_losses and same_state,
              f"tp_train {key}: the runner is not NoShard's runner bit for "
              f"bit (losses {same_losses}, state {same_state})")
        check(captured == want,
              f"tp_train {key}: collectives {captured}, expected {want}")
        check(wrapper_calls == 0 and {k: v for k, v in replays_counted.items()
                                      if v} == {k: v for k, v in
                                                want_replays.items() if v},
              f"tp_train {key}: {replays} replays counted {replays_counted}, "
              f"{wrapper_calls} collective wrapper calls")
        check(calls == expect_calls,
              f"tp_train {key}: flash calls per replayed step {calls}")
        del runner, trainer, state, runs, final
        torch.cuda.empty_cache()
    emit({"phase": "tp_train", "model": "gpt2-125m", "dtype": "bfloat16",
          "global_batch": 8, "seq_len": 1024, "steps": steps,
          "mesh": {"dp": 1, "tp": pdist.get_world_size()},
          "noshard_runner_step_s": noshard_runs["runner"]["step_s"],
          "phase_s": time.perf_counter() - t_phase, **out})


def tp_serve_phase(serve_streams, serve_latency):
    """TP serving's main path on the one-rank NCCL group: the serve phase's
    model (GPT-2 125M, bf16, seed 1) cut over a ``(dp 1, tp 1)`` serving
    mesh, its paged cache on tp (``paged_kv_cache_sharding``), the serve
    phase's 16 requests through the graphs, the eager bodies and the
    graphs under a device trace (``_serve_pair``). The engine runs graphs
    (NCCL); its capture records the step's tp all-reduces (2 x n_layer,
    ``comm.counts`` around building a scheduler's program), one replay a
    decode step, B7 n_layer times a step in the device trace, and the
    greedy streams equal the serve phase's. Tokens/s and decode p50 against
    serve's."""
    t_phase = time.perf_counter()
    n_layer = GPT2Config().n_layer
    mesh = serving_mesh(dp=1, tp=pdist.get_world_size())
    model = gpt2_125m(device="cuda", seed=1, dtype=torch.bfloat16)
    shard_gpt2_params(model, mesh)
    engine = InferenceEngine(model, cache_sharding=paged_kv_cache_sharding(
        mesh), **SERVE_KW)
    comm.reset_counts()
    probe = Scheduler(engine, emit_events=False)     # prepare: the capture
    captured = dict(comm.counts)
    del probe
    graph, eager, counted, lost, streams, equal = _serve_pair(
        engine, "tp_serve", n_layer)
    equal_serve = sum(streams[r] == serve_streams.get(r) for r in streams)
    line = {"phase": "tp_serve", "model": "gpt2-125m", "dtype": "bfloat16",
            "mesh": mesh.shape, "graphs": engine.graphs,
            "heads_a_rank": graph["sched"].cache.k.shape[3],
            "collectives_captured_a_step": captured,
            **_latency(graph), "kernel_launches": counted["device"],
            "kernel_launches_from": "device trace of a repeat of the run",
            "first_trace_kernel_launches": lost,
            "graph_replays": graph["replays"],
            "decode_steps": graph["sched"].decode_steps,
            "eager": _latency(eager), "streams_equal_to_eager": equal,
            "streams_equal_to_serve": equal_serve,
            "serve": serve_latency,
            "tokens_per_s_over_serve": _latency(graph)["tokens_per_s"]
            / serve_latency["tokens_per_s"],
            "phase_s": time.perf_counter() - t_phase}
    emit(line)
    check(engine.graphs, "tp_serve: the engine does not run graphs on NCCL")
    check(captured == {"all_reduce": 2 * n_layer, "reduce_scatter": 0,
                       "all_gather": 0, "broadcast": 0},
          f"tp_serve: the capture recorded {captured}, expected "
          f"{2 * n_layer} all-reduces")
    check(equal_serve == len(serve_streams) == len(streams),
          f"tp_serve: {equal_serve} of {len(serve_streams)} streams equal "
          "the serve phase's")
    del engine, model
    torch.cuda.empty_cache()


REDIST_STAGING = 16 * 2**20   # max_staging_bytes of the staged moves
REDIST_REQUESTS = 8
REDIST_NEW_TOKENS = 32
REDIST_SWAP_AT = 8            # decode steps before a mid-stream swap


def _host_state(model):
    """A state dict of ``model``'s whole weights on the host (equal values,
    other tensors): what a file read hands a server."""
    return {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}


def _swap_run(engine, prompts, host=None, staging=None):
    """The prompts on a fresh scheduler of ``engine`` (its capture made when
    it is built); with ``host``, a ``swap_params`` of it after
    REDIST_SWAP_AT steps. Returns the streams and, for a swap: seconds,
    the plan's cost, ``max_memory_allocated`` above what the card held
    just before, whether every parameter kept its ``data_ptr``, whether the
    engine captured no new program, and the replays per decode step
    before and after the swap."""
    sched = Scheduler(engine, emit_events=False)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=REDIST_NEW_TOKENS))
    out = {}
    marks = [(engine.replays, sched.decode_steps)]
    if host is not None:
        for _ in range(REDIST_SWAP_AT):
            sched.step()
        marks.append((engine.replays, sched.decode_steps))
        ptrs = [p.data_ptr() for p in engine.model.parameters()]
        programs = set(engine._programs)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rdx.reset_counts()
        t0 = time.perf_counter()
        cost = sched.swap_params(host, max_staging_bytes=staging)
        torch.cuda.synchronize()
        out.update(
            swap_s=time.perf_counter() - t0, cost=dataclasses.asdict(cost),
            counts=dict(rdx.counts),
            max_allocated_above_resident_bytes=(
                torch.cuda.max_memory_allocated() - resident),
            data_ptrs_kept=ptrs == [p.data_ptr()
                                   for p in engine.model.parameters()],
            no_new_capture=set(engine._programs) <= programs)
    finished = sched.run()
    torch.cuda.synchronize()
    marks.append((engine.replays, sched.decode_steps))
    out["replays_per_decode_step"] = [
        (r1 - r0) / max(1, s1 - s0)
        for (r0, s0), (r1, s1) in zip(marks, marks[1:])]
    out["streams"] = {f.request_id: list(f.tokens) for f in finished}
    check(len(finished) == len(prompts), "redistribute: requests lost")
    return out


def redistribute_phase(smi):
    """A.16 on the one-rank NCCL group, GPT-2 125M: ``reshard_gpt2_params``
    of a host state dict (fp32) onto the ``(dp 1, tp 1)`` serving layout,
    bit for bit, with and without staging; on the serve phase's bf16 paged
    engine a mid-stream ``swap_params`` of host weights of equal value
    with ``max_staging_bytes`` REDIST_STAGING and with None: the swap's
    seconds, the card's allocation above its resident bytes beside the
    plan's ``peak_bytes`` and ``naive_gather_bytes``, every ``data_ptr``
    kept, no new capture, one replay a decode step on both sides of the
    swap, the streams those of an uninterrupted run; and an fp32 engine's
    greedy streams across a staged swap equal to the uninterrupted
    engine's."""
    t_phase = time.perf_counter()
    cfg = GPT2Config()
    _, _, prompts = _serve_requests(cfg.vocab_size, REDIST_REQUESTS)
    mesh = serving_mesh(dp=1, tp=pdist.get_world_size())
    line = {"phase": "redistribute", "nvidia_smi": smi, "model": "gpt2-125m",
            "mesh": mesh.shape, "max_staging_bytes": REDIST_STAGING,
            "requests": len(prompts), "new_tokens": REDIST_NEW_TOKENS,
            "swap_after_steps": REDIST_SWAP_AT}

    # reshard_gpt2_params: a state dict on the host -> the serving layout
    # (the card's generator draws the weights: copy them from a card model)
    model = gpt2_125m(device="cuda", seed=1, dtype=torch.bfloat16)
    host = _host_state(model)
    line["host_state_bytes"] = sum(t.nbytes for t in host.values())
    line["reshard_gpt2_params"] = {}
    for tag, staging in (("staged", REDIST_STAGING), ("unstaged", None)):
        torch.cuda.synchronize()
        rdx.reset_counts()
        t0 = time.perf_counter()
        blocks, cost = reshard_gpt2_params(host, mesh, with_cost=True,
                                           max_staging_bytes=staging)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        exact = all(blocks[n].device.type == mesh.device.type
                    and torch.equal(blocks[n].cpu(), t)
                    for n, t in host.items())
        line["reshard_gpt2_params"][tag] = {
            "s": seconds, "cost": dataclasses.asdict(cost),
            "counts": dict(rdx.counts), "bit_exact": exact}
        check(exact, f"redistribute: reshard_gpt2_params ({tag}) is not "
                     "the host state bit for bit")
        del blocks

    # serve's bf16 paged engine: swaps mid-stream, staged and not
    engine = InferenceEngine(model, **SERVE_KW)
    line["engine_resident_bytes"] = torch.cuda.memory_allocated()
    plain = _swap_run(engine, prompts)
    line["bf16"] = {}
    for tag, staging in (("staged", REDIST_STAGING), ("unstaged", None)):
        run = _swap_run(engine, prompts, host, staging)
        run["streams_equal_uninterrupted"] = run.pop("streams") == \
            plain["streams"]
        line["bf16"][tag] = run
    line["bf16"]["uninterrupted_replays_per_decode_step"] = \
        plain["replays_per_decode_step"]
    del engine, model
    torch.cuda.empty_cache()

    # fp32: greedy streams across a staged swap of equal values
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt2_125m(device="cuda", seed=1)
    host = _host_state(model)
    engine = InferenceEngine(model, **SERVE_KW)
    plain = _swap_run(engine, prompts)
    run = _swap_run(engine, prompts, host, REDIST_STAGING)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    equal = sum(run["streams"][r] == plain["streams"][r]
                for r in plain["streams"])
    line["fp32"] = {k: v for k, v in run.items() if k != "streams"}
    line["fp32"]["streams_equal_uninterrupted"] = equal
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    for tag, run in (*line["bf16"].items(), ("fp32", line["fp32"])):
        if not isinstance(run, dict):
            continue
        check(run["data_ptrs_kept"] and run["no_new_capture"],
              f"redistribute {tag}: the swap moved a parameter or captured "
              "anew")
        check(all(r == 1.0 for r in run["replays_per_decode_step"]),
              f"redistribute {tag}: replays a decode step "
              f"{run['replays_per_decode_step']}")
    check(all(line["bf16"][t]["streams_equal_uninterrupted"]
              for t in ("staged", "unstaged")),
          "redistribute: bf16 streams across a swap of equal weights differ")
    check(line["bf16"]["staged"]["counts"]["staging_bytes_max"]
          <= REDIST_STAGING, "redistribute: staging over its bound")
    check(equal == len(prompts), f"redistribute: {equal} of {len(prompts)} "
          "fp32 streams across the swap equal the uninterrupted engine's")
    del engine, model, host
    torch.cuda.empty_cache()


def serve_ckpt_phase(ckpt_dir: Path):
    """``examples.serve_gpt2``'s ``main`` at GPT-2 125M's shape on the
    checkpoint ``train_gpt2.py --ckpt-dir`` wrote (ckpt_gpt2's, step 4):
    only its model entries are read; it returns 0 and serves 8 requests."""
    argv = ["--layers", "12", "--embd", "768", "--heads", "12", "--vocab",
            "50257", "--seq-len", "1024", "--cache", "paged", "--slots", "8",
            "--prefill-len", "128", "--requests", "8", "--max-new-tokens",
            "32", "--ckpt-dir", str(ckpt_dir)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_gpt2.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    emit({"phase": "serve_ckpt", "argv": argv, "returned": rc,
          "wall_s": time.perf_counter() - t0, "loaded": lines[0],
          "summary": lines[lines.index("") + 1:] if "" in lines else lines})
    check(rc == 0 and lines[0] == f"loaded params from {ckpt_dir} (step 4)"
          and any(ln.startswith("served 8 requests") for ln in lines),
          f"serve_ckpt returned {rc}, printed {lines[:2]} ... {lines[-3:]}")


def _tp_rank_trainer(shape, sp: bool, device, seed: int):
    """GPT-2 125M (bf16, flash attention, AdamW) under ``TensorParallel``
    on a ``shape`` ``(dp, tp)`` mesh of the ranks' group."""
    strategy = TensorParallel(init_device_mesh(shape, ("dp", "tp")),
                              gpt2_tp_plan(), sequence_parallel=sp)
    model = gpt2_125m(device=device, seed=seed, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def _tp_ckpt_round(trainer, state, batch, shape, sp, device, ckpt_dir):
    """On the ranks, after the job's steps: a ``CheckpointManager`` save of
    the TP trainer's state; one more step; a fresh TP trainer (other
    weights) restored from the checkpoint takes the same step, which must
    be bit for bit the continued one (loss, every gathered parameter);
    then every rank loads the checkpoint whole through
    ``load_gpt2_params`` at tp = 1 (the manager's group is collective),
    and the weights must equal the gathered live ones at the save."""
    from pytorch_distributed_tpu_torch.models import full_state_dict
    from pytorch_distributed_tpu_torch.serving import load_gpt2_params

    live = full_state_dict(trainer.model)
    sd = get_state_dict(trainer, state)
    state_bytes = sum((v.to_local() if hasattr(v, "to_local") else v).nbytes
                      for v in sd.values())
    torch.cuda.synchronize(device)
    with CheckpointManager(ckpt_dir) as mgr:
        t0 = time.perf_counter()
        mgr.save(state.step, sd)
        save_s = time.perf_counter() - t0
    # the same state moved to (dp 2, tp 2) without a checkpoint (before the
    # step below changes it)
    t0 = time.perf_counter()
    reshard = _reshard_round(
        trainer, state, sd, TensorParallel(init_device_mesh(
            TP_RESHARD_DST, ("dp", "tp")), gpt2_tp_plan()),
        lambda seed: _tp_rank_trainer(TP_RESHARD_DST, sp, device, seed),
        batch, device, ckpt_dir, save=False)
    reshard["wall_s"] = time.perf_counter() - t0
    _, m = trainer.step(state, batch)
    continued = (float(m["loss"]), full_state_dict(trainer.model))
    fresh, fresh_state = _tp_rank_trainer(shape, sp, device, seed=8)
    torch.cuda.synchronize(device)
    with CheckpointManager(ckpt_dir) as mgr:
        t0 = time.perf_counter()
        fresh_state = set_state_dict(fresh, fresh_state, mgr.restore(
            get_state_dict(fresh, fresh_state)))
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
    restored_step = fresh_state.step
    _, m = fresh.step(fresh_state, batch)
    resumed = (float(m["loss"]), full_state_dict(fresh.model))
    del fresh, fresh_state
    whole = gpt2_125m(device=device, seed=9)
    t0 = time.perf_counter()
    load_step = load_gpt2_params(ckpt_dir, whole)
    load_s = time.perf_counter() - t0
    return {
        "step": state.step, "restored_step": restored_step,
        "save_s": save_s, "restore_s": restore_s, "state_bytes": state_bytes,
        "disk_bytes": _dir_bytes(Path(ckpt_dir)),
        "losses": [continued[0], resumed[0]],
        "resume_bit_for_bit": continued[0] == resumed[0] and all(
            torch.equal(resumed[1][n], t) for n, t in continued[1].items()),
        "tp1_load_step": load_step, "tp1_load_s": load_s,
        "tp1_equals_live": all(torch.equal(t, live[n]) for n, t in
                               whole.state_dict().items()),
        "reshard": reshard}


def _fsdp_rank_trainer(mesh, device, seed: int):
    """GPT-2 125M (bf16, flash attention, AdamW) under FSDP on ``mesh``."""
    model = gpt2_125m(device=device, seed=seed, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    trainer = Trainer(model, opt, FullyShardedDataParallel(mesh),
                      loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def _leaf_report(counts, leaves, cost):
    """The executor's counts beside the plan's tree cost: the rank's
    measured peak (the largest leaf's resident source and destination
    blocks plus the transient above them) against the naive gather's,
    the largest leaf, the two c_proj weights, and the leaves with a
    sharded destination whose measured peak is not below their naive
    gather's (a whole destination's copy is the naive gather's size)."""
    return {"counts": counts, "leaves": len(leaves),
            "measured_peak_bytes": counts["measured_peak_bytes"],
            "measured_below_naive": 0 < counts["measured_peak_bytes"]
            < cost.naive_gather_bytes,
            "largest": max(leaves, key=lambda x: x["naive_gather_bytes"],
                           default=None),
            "c_proj": [x for x in leaves if x["name"] in (
                "h.0.attn.c_proj.weight", "h.0.mlp.c_proj.weight")],
            "sharded_not_below_naive": [
                x["name"] for x in leaves if x["dst_sharded"]
                and x["measured_peak_bytes"] >= x["naive_gather_bytes"]]}


def _redistribute_rank(rank, device, smesh, prompts, batch, ckpt_dir):
    """redistribute_ranks on one of the TP_RANKS gloo ranks sharing the
    card: GPT-2 125M fp32 (the serve model's seed) laid out FSDP over the
    4 ranks moves to the ``(1, 4)`` serving layout through
    ``reshard_gpt2_params`` and serves the tp serve prompts; then a dp-4
    FSDP AdamW state (bf16 training, one step) is saved and moved to dp 2
    on ranks 0 and 1 through ``reshard_state`` (max_staging_bytes
    REDIST_STAGING; ranks 2 and 3 only send), loaded through
    ``set_state_dict``, set beside a trainer that ``resume_from_checkpoint``
    restored at dp 2, and the resized trainer takes one step."""
    from pytorch_distributed_tpu_torch.parallel.fsdp import shard_module
    from pytorch_distributed_tpu_torch.parallel.strategies import (
        shard_spec_with_reason,
    )

    out = {}
    fmesh = init_device_mesh((TP_RANKS,), ("fsdp",))
    mesh2 = init_device_mesh((2,), ("fsdp",), ranks=(0, 1))
    src = gpt2_125m(device=device, seed=1)
    fsdp = FullyShardedDataParallel(fmesh)
    shard_module(src, fsdp)
    torch.cuda.synchronize(device)
    rdx.reset_counts()
    rdx.measure_peaks = True
    t0 = time.perf_counter()
    blocks, cost = reshard_gpt2_params(src, smesh, strategy=fsdp,
                                       with_cost=True)
    torch.cuda.synchronize(device)
    move_s = time.perf_counter() - t0
    rdx.measure_peaks = False
    out["fsdp_to_tp"] = {"s": move_s, "cost": dataclasses.asdict(cost),
                         **_leaf_report(dict(rdx.counts), rdx.leaf_peaks,
                                        cost)}
    del src
    model = gpt2_125m(device=device, seed=2)
    shard_gpt2_params(model, smesh)
    model.load_state_dict(blocks)
    del blocks
    sched = Scheduler(InferenceEngine(
        model, cache_sharding=paged_kv_cache_sharding(smesh), **SERVE_KW),
        emit_events=False)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=TP_SERVE_NEW_TOKENS))
    out["streams"] = {f.request_id: f.tokens for f in sched.run()}
    del sched, model
    torch.cuda.empty_cache()

    # reshard_state: a dp-4 FSDP AdamW state to dp 2 on ranks 0 and 1
    trainer, state = _fsdp_rank_trainer(fmesh, device, seed=7)
    state, _ = trainer.step(state, batch)
    sd = get_state_dict(trainer, state)
    with CheckpointManager(ckpt_dir) as mgr:
        mgr.save(state.step, sd)
    shardings = {}
    for k, v in sd.items():
        dim = (shard_spec_with_reason(tuple(v.shape), "fsdp", 2, 1024)[0]
               if hasattr(v, "to_local") else None)
        shardings[k] = Sharding.from_placement(
            mesh2, {} if dim is None else {"fsdp": dim}, v.dim())
    plan = plan_tree(sd, shardings, max_staging_bytes=REDIST_STAGING)
    torch.cuda.synchronize(device)
    rdx.reset_counts()
    rdx.measure_peaks = True
    t0 = time.perf_counter()
    moved = reshard_state(sd, shardings, max_staging_bytes=REDIST_STAGING)
    torch.cuda.synchronize(device)
    move_s = time.perf_counter() - t0
    rdx.measure_peaks = False
    step = state.step
    out["state"] = {"s": move_s, "cost": dataclasses.asdict(plan.cost),
                    "state_bytes_a_rank": sum(
                        (v.to_local() if hasattr(v, "to_local") else v).nbytes
                        for v in sd.values()),
                    "received_none": all(v is None for v in moved.values()),
                    **_leaf_report(dict(rdx.counts), rdx.leaf_peaks,
                                   plan.cost)}
    del trainer, state, sd
    torch.cuda.empty_cache()
    if rank < 2:
        resized, rstate = _fsdp_rank_trainer(mesh2, device, seed=8)
        rstate = set_state_dict(resized, rstate, moved)
        del moved
        fresh, fstate = _fsdp_rank_trainer(mesh2, device, seed=9)
        fstate = resume_from_checkpoint(ckpt_dir, fresh, fstate)
        a, b = get_state_dict(resized, rstate), get_state_dict(fresh, fstate)
        out["state"]["equal_to_resume"] = (rstate.step == fstate.step == step
                                           and all(torch.equal(
                                               _to_local(a[k]), _to_local(b[k]))
                                               for k in b))
        del fresh, fstate, a, b
        torch.cuda.empty_cache()
        _reset_flash_counts()
        rstate, m = resized.step(rstate, batch)
        out["state"]["resized_loss"] = float(m["loss"])
        out["state"]["launches"] = dict(fa.launches)
        del resized, rstate
    else:
        # ranks outside the new mesh take part in the checkpoint's
        # collectives, reading nothing
        with CheckpointManager(ckpt_dir) as mgr:
            mgr.restore({}, step=step)
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def _to_local(v):
    return v.to_local() if hasattr(v, "to_local") else v


def _want_sent(sd, shardings, me):
    """The bytes rank ``me`` must send to move ``sd`` onto ``shardings``,
    from the shapes alone: each piece of a source block that a destination
    rank needs and does not hold in its own source block, counted on its
    one holder (a pipeline's layer lies on one stage's rank, a tp block on
    one rank of a (1, tp) mesh; a piece with two holders raises, since the
    sender is the planner's choice). A whole tensor lies on every rank and
    moves no byte."""
    total = 0
    for k, v in sd.items():
        src = v.sharding if isinstance(v, Placed) else rdx.dtensor_sharding(v)
        dst = shardings.get(k)
        if src is None or dst is None:
            continue
        shape = tuple(v.shape)
        holders = {}
        for r, box in rplan.boxes(shape, src).items():
            holders.setdefault(box, []).append(r)
        for box, have in holders.items():
            for q, want in rplan.boxes(shape, dst).items():
                piece = rplan.intersect(box, want)
                if piece is None or q in have:
                    continue
                if len(have) > 1:
                    raise ValueError(f"{k}: a piece on ranks {have}")
                if have == [me]:
                    total += math.prod(b - a for a, b in piece) * \
                        v.dtype.itemsize
    return total


def _reshard_round(trainer, state, sd, strategy, make, batch, device,
                   ckpt_dir, save=True):
    """A live state moved without a checkpoint, against the checkpoint:
    ``sd`` (``placed_state``/``get_state_dict`` of ``trainer``'s state) is
    saved through DCP into ``ckpt_dir`` (unless ``save`` is False: it is
    there already), then moved by ``reshard_state`` onto
    ``state_shardings(sd, strategy)`` with each card leaf's peak measured;
    ``make(seed)`` builds a trainer on the new mesh twice, one loaded from
    the move (``set_state_dict``), one resumed from the checkpoint. Their
    states must be equal bit for bit, and each takes one step on
    ``batch`` (the losses must be equal bit for bit; B1-B3's launches of
    the moved trainer's step are returned). ``want_sent``: the bytes this
    rank must send, from the shapes (:func:`_want_sent`)."""
    if save:
        with CheckpointManager(ckpt_dir) as mgr:
            mgr.save(state.step, get_state_dict(trainer, state))
    shardings = state_shardings(sd, strategy)
    want_sent = _want_sent(sd, shardings, dist.get_rank())
    torch.cuda.synchronize(device)
    rdx.reset_counts()
    rdx.measure_peaks = True
    t0 = time.perf_counter()
    moved = reshard_state(sd, shardings)
    torch.cuda.synchronize(device)
    move_s = time.perf_counter() - t0
    rdx.measure_peaks = False
    counts, leaves = dict(rdx.counts), list(rdx.leaf_peaks)

    def nbytes(v):
        v = v.block if isinstance(v, Placed) else _to_local(v)
        return 0 if v is None else v.numel() * v.element_size()

    # a leaf's bound: its source and destination blocks here, and one
    # staging chunk of at most a destination block (a host-staged piece's
    # copy on the card, or the plan's unchunked staging across rank sets)
    blocks = {k: nbytes(sd[k]) + nbytes(moved[k]) for k in sd}
    bound = {k: blocks[k] + nbytes(moved[k]) for k in sd}
    del sd
    moved_tr, mstate = make(9)
    mstate = set_state_dict(moved_tr, mstate, moved)
    del moved
    resumed, rstate = make(10)
    rstate = resume_from_checkpoint(ckpt_dir, resumed, rstate)
    a = get_state_dict(moved_tr, mstate)
    b = get_state_dict(resumed, rstate)
    equal = mstate.step == rstate.step == state.step and a.keys() == b.keys() \
        and all(torch.equal(_to_local(a[k]), _to_local(b[k])) for k in b)
    del a, b
    _reset_flash_counts()
    _, m1 = moved_tr.step(mstate, batch)
    launches = {k: fa.launches[k] for k in CAUSAL_KEYS}
    _, m2 = resumed.step(rstate, batch)
    del moved_tr, mstate, resumed, rstate
    torch.cuda.empty_cache()
    # the bound holds the sizes asked of the allocator; the blocks it held
    # (rounded up to its segments) are reported beside them
    over = [dict(x, bound=bound[x["name"]]) for x in leaves
            if x["requested_peak_bytes"] > bound[x["name"]]]
    return {"move_s": move_s, "state_equal_to_resume": equal,
            "losses": [float(m1["loss"]), float(m2["loss"])],
            "launches": launches, "counts": counts, "want_sent": want_sent,
            "leaves_measured": len(leaves),
            "largest_leaf": max(leaves,
                                key=lambda x: x["requested_peak_bytes"],
                                default=None),
            "leaves_within_src_dst": sum(
                x["requested_peak_bytes"] <= blocks[x["name"]]
                for x in leaves),
            "leaves_over_bound": over}


def _tp_rank(rank, out_dir, batches, prompts):
    """One of TP_RANKS ranks sharing the card over gloo: GPT-2 125M (bf16,
    flash attention, AdamW, seed 7) for TP_RANKS_STEPS eager steps under
    each of TP_RANKS_JOBS, then TP serving at tp = TP_RANKS in fp32 (TF32
    off) through the eager bodies (a gloo group cannot be captured)."""
    device = torch.device("cuda", 0)
    result = {"rank": rank}
    try:
        _build.load_all(LIBRARIES)
        for tag, shape, sp in TP_RANKS_JOBS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            trainer, state = _tp_rank_trainer(shape, sp, device, seed=7)
            model = trainer.model
            _reset_flash_counts()
            losses, step_s = [], []
            for i, batch in enumerate(batches):
                if i == len(batches) - 1:
                    comm.reset_counts()
                t0 = time.perf_counter()
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))
                step_s.append(time.perf_counter() - t0)
            result[tag] = {
                "losses": losses, "step_s": step_s,
                "collectives_last_step": dict(comm.counts),
                "wire_bytes_last_step": dict(comm.wire_bytes),
                "launches": dict(fa.launches),
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters()),
                "held": {n: tuple(p.shape)
                         for n, p in model.named_parameters()},
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(device)}
            if tag == TP_CKPT_JOB:
                result["ckpt"] = _tp_ckpt_round(
                    trainer, state, batches[-1], shape, sp, device,
                    f"{out_dir}/ckpt")
            del trainer, state, model
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = serving_mesh(dp=1, tp=TP_RANKS)
        model = gpt2_125m(device=device, seed=1)
        shard_gpt2_params(model, mesh)
        engine = InferenceEngine(model, cache_sharding=paged_kv_cache_sharding(
            mesh), **SERVE_KW)
        sched = Scheduler(engine, emit_events=False)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=TP_SERVE_NEW_TOKENS))
        t0 = time.perf_counter()
        finished = sched.run()
        result["serve"] = {
            "graphs": engine.graphs, "replays": engine.replays,
            "wall_s": time.perf_counter() - t0,
            "decode_steps": sched.decode_steps,
            "heads_a_rank": sched.cache.k.shape[3],
            "streams": {f.request_id: f.tokens for f in finished}}
        del sched, engine, model
        torch.cuda.empty_cache()
        result["dp_slots"] = _dp_slots_serving(device, prompts)
        t0 = time.perf_counter()
        result["redistribute"] = _redistribute_rank(
            rank, device, mesh, prompts, batches[-1], f"{out_dir}/rs_ckpt")
        result["redistribute"]["wall_s"] = time.perf_counter() - t0
    finally:
        torch.save(result, f"{out_dir}/tp_rank{rank}.pt")


def _reshard_report(phase, rs, smi, src, dst, launches):
    """The line of a reshard that ``_reshard_round`` ran on every rank, and
    its checks: the moved state equal to the checkpoint's resume bit for
    bit and the next step's losses equal bit for bit, B1-B3's launches of
    that step the shapes' count, the bytes each rank sent the shapes'
    count (:func:`_want_sent`), each card leaf's peak (the sizes asked of
    the allocator; the blocks it held are reported beside them) within a
    source block plus a destination block plus one staging chunk."""
    line = {"phase": phase, "nvidia_smi": smi, "backend": "gloo",
            "ranks": len(rs), "src_mesh": list(src), "dst_mesh": list(dst),
            "phase_s": max(r["wall_s"] for r in rs),
            "move_s": [r["move_s"] for r in rs],
            "sent_bytes": [r["counts"]["sent_bytes"] for r in rs],
            "want_sent_bytes": [r["want_sent"] for r in rs],
            "host_staged_bytes": [r["counts"]["host_staged_bytes"]
                                  for r in rs],
            "requested_peak_bytes": [r["counts"]["requested_peak_bytes"]
                                     for r in rs],
            "measured_peak_bytes": [r["counts"]["measured_peak_bytes"]
                                    for r in rs],
            "leaves_measured": [r["leaves_measured"] for r in rs],
            "leaves_within_src_dst": [r["leaves_within_src_dst"] for r in rs],
            "largest_leaf": [r["largest_leaf"] for r in rs],
            "leaves_over_bound": [r["leaves_over_bound"] for r in rs],
            "state_equal_to_resume": [r["state_equal_to_resume"] for r in rs],
            "losses": [r["losses"] for r in rs],
            "launches": [r["launches"] for r in rs],
            "want_launches": launches}
    emit(line)
    check(all(line["state_equal_to_resume"]),
          f"{phase}: the moved state differs from the checkpoint's resume")
    check(all(a == b and math.isfinite(a) for a, b in line["losses"]),
          f"{phase}: the next step's losses {line['losses']}")
    check(all(x == launches for x in line["launches"]),
          f"{phase}: B1-B3 launches {line['launches']}, want {launches}")
    check(line["sent_bytes"] == line["want_sent_bytes"],
          f"{phase}: sent {line['sent_bytes']}, the shapes' "
          f"{line['want_sent_bytes']}")
    check(all(n > 0 for n in line["leaves_measured"])
          and not any(line["leaves_over_bound"]),
          f"{phase}: leaves above a source plus a destination block plus "
          f"one staging chunk {line['leaves_over_bound']}")
    return line


def _dp_slots_serving(device, prompts):
    """On a tp_ranks rank: the same fp32 TP serving (TF32 off) on a slotted
    cache of SERVE_KW's 8 slots with the slots on dp at DP_SLOTS, through
    the eager bodies (gloo), greedy, spec_k 0 (TP_SERVE_NEW_TOKENS new
    tokens) and SPEC_K with the DRAFT_LAYERS self-draft
    (DP_SLOTS_SPEC_NEW_TOKENS): the streams, the slots and the cache bytes
    this rank holds."""
    mesh = serving_mesh(dp=DP_SLOTS[0], tp=DP_SLOTS[1])
    out = {}
    for spec_k, n_new in ((0, TP_SERVE_NEW_TOKENS),
                          (SPEC_K, DP_SLOTS_SPEC_NEW_TOKENS)):
        model = gpt2_125m(device=device, seed=1)
        shard_gpt2_params(model, mesh)
        kw = dict(SERVE_KW, cache_kind="slotted")
        if spec_k:
            kw.update(spec_k=spec_k, draft_layers=DRAFT_LAYERS)
        engine = InferenceEngine(model, cache_sharding=kv_cache_sharding(
            mesh, dp_axis="dp"), **kw)
        sched = Scheduler(engine, emit_events=False)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=n_new))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        finished = sched.run()
        cache = sched.cache
        out[spec_k] = {
            "new_tokens": n_new, "graphs": engine.graphs,
            "wall_s": time.perf_counter() - t0,
            "steps": sched.decode_steps,
            "own_slots": [engine.own_slots.start, engine.own_slots.stop],
            "cache_shape": list(cache.k.shape),
            "cache_bytes": cache.k.nbytes + cache.v.nbytes,
            "streams": {f.request_id: f.tokens for f in finished}}
        del sched, engine, model, cache
        torch.cuda.empty_cache()
    return out


def _tp_held(name: str, shape, tp: int):
    """The block of ``shape`` a rank holds under ``gpt2_tp_plan`` at ``tp``
    (the first pattern that matches ``name``)."""
    style = next((st for pat, st in gpt2_tp_plan().items()
                  if re.search(pat, name)), None)
    dim = None if style is None else style.shard_dim(name, shape)
    return tuple(n // tp if d == dim else n for d, n in enumerate(shape))


def _top2_gap(model, prompt, tokens, i) -> float:
    """The relative gap between the two largest logits where a greedy
    stream chose ``tokens[i]`` (the uncached forward on the prompt and the
    stream's first ``i`` tokens)."""
    seq = torch.tensor(np.concatenate([prompt, tokens[:i]])[None],
                       device="cuda")
    with torch.no_grad():
        top = model(seq)[0, -1].topk(2).values
    return float((top[0] - top[1]) / top[0].abs())


def tp_ranks_phase(pool, smi=None):
    """TP_RANKS spawned ranks sharing the card over gloo: training under
    ``TensorParallel`` at ``(dp 1, tp 4)`` (3 heads a rank), with and
    without sequence parallelism, and at ``(dp 2, tp 2)``, GPT-2 125M,
    bf16, 8 x 1024 global, 3 eager steps against NoShard on the same
    batches in this process (the mean of the ranks' losses within
    TP_RANKS_LOSS_RTOL); the last step's collectives equal
    ``_tp_step_collectives`` (SP: reduce-scatters and all-gathers in place
    of the tp all-reduces); each rank's parameter shapes and bytes the
    plan's; B1-B3 launch n_layer times a step on every rank. Then TP
    serving at tp = 4 in fp32 (TF32 off), paged, 8 of the serve phase's
    prompts, greedy, through the eager bodies (the engine's ``graphs`` is
    False on gloo): every rank's streams equal, and equal to this process's
    one-rank fp32 engine's, except where a stream departs at a step whose
    top-2 logit gap is under TP_GAP_RTOL (printed)."""
    import tempfile

    t_phase = time.perf_counter()
    n_layer = GPT2Config().n_layer
    batches = _lm_batches(TP_RANKS_STEPS, 8, 1024, seed=23)
    model = gpt2_125m(device="cuda", seed=7, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    trainer = Trainer(model, opt, NoShard("cuda"), loss_fn=lm_loss,
                      policy="bf16")
    state = trainer.init()
    want = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        want.append(float(m["loss"]))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    del trainer, state, model, opt
    # the one-rank fp32 serving reference
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, prompts = _serve_requests(GPT2Config().vocab_size)
    prompts = prompts[:TP_SERVE_REQUESTS]
    ref_model = gpt2_125m(device="cuda", seed=1)
    sched = Scheduler(InferenceEngine(ref_model, **SERVE_KW),
                      emit_events=False)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=TP_SERVE_NEW_TOKENS))
    ref_streams = {f.request_id: f.tokens for f in sched.run()}
    del sched
    torch.cuda.empty_cache()
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        wall_s = pool.run(_tp_rank, (out_dir, batches, prompts), 420,
                          "tp_ranks")
        ranks = [torch.load(f"{out_dir}/tp_rank{r}.pt", weights_only=False)
                 for r in range(TP_RANKS)]
    line = {"phase": "tp_ranks", "ranks": TP_RANKS, "backend": "gloo",
            "model": "gpt2-125m", "dtype": "bfloat16", "global_batch": 8,
            "seq_len": 1024, "steps": TP_RANKS_STEPS, "wall_s": wall_s,
            "noshard_losses": want, "loss_rtol": TP_RANKS_LOSS_RTOL}
    for tag, (dp, tp), sp in TP_RANKS_JOBS:
        mean = [float(np.mean([r[tag]["losses"][i] for r in ranks]))
                for i in range(TP_RANKS_STEPS)]
        held = {n: _tp_held(n, sh, tp) for n, sh in shapes.items()}
        line[tag] = {
            "mesh": {"dp": dp, "tp": tp}, "sequence_parallel": sp,
            "mean_losses": mean,
            "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(mean, want)],
            "per_rank": [{k: r[tag][k] for k in (
                "step_s", "param_bytes", "max_memory_allocated_bytes",
                "launches")} for r in ranks],
            "collectives_last_step": ranks[0][tag]["collectives_last_step"],
            "wire_bytes_last_step": ranks[0][tag]["wire_bytes_last_step"],
            "param_bytes_planned": 4 * sum(math.prod(v)
                                           for v in held.values())}
        r = line[tag]
        check(max(r["loss_rel_err"]) <= TP_RANKS_LOSS_RTOL,
              f"tp_ranks {tag}: losses {mean} vs {want}")
        check(all(x[tag]["held"] == held for x in ranks)
              and all(p["param_bytes"] == r["param_bytes_planned"]
                      for p in r["per_rank"]),
              f"tp_ranks {tag}: the ranks do not hold the plan's blocks")
        check(all(x[tag]["collectives_last_step"]
                  == _tp_step_collectives(n_layer, sp) for x in ranks),
              f"tp_ranks {tag}: collectives "
              f"{[x[tag]['collectives_last_step'] for x in ranks]}")
        check(all(x[tag]["launches"][k] == n_layer * TP_RANKS_STEPS
                  for x in ranks for k in CAUSAL_KEYS),
              f"tp_ranks {tag}: B1-B3 launches "
              f"{[x[tag]['launches'] for x in ranks]}")
    departures = []
    for rid, tokens in ranks[0]["serve"]["streams"].items():
        want_tokens = ref_streams[rid]
        if tokens != want_tokens:
            i = next(j for j, (a, b) in enumerate(zip(tokens, want_tokens))
                     if a != b)
            departures.append({"request": rid, "at": i, "top2_rel_gap":
                               _top2_gap(ref_model, prompts[rid],
                                         want_tokens, i)})
    _dp_slots_report(smi, ranks, ref_model, prompts, ref_streams)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    serve = ranks[0]["serve"]
    line["serve"] = {
        "tp": TP_RANKS, "dtype": "float32", "tf32": False,
        "requests": len(prompts), "new_tokens": TP_SERVE_NEW_TOKENS,
        "graphs": [r["serve"]["graphs"] for r in ranks],
        "replays": serve["replays"], "decode_steps": serve["decode_steps"],
        "heads_a_rank": serve["heads_a_rank"], "wall_s": serve["wall_s"],
        "streams_equal_to_one_rank": sum(
            serve["streams"][r] == ref_streams[r] for r in ref_streams),
        "departures": departures}
    line["ckpt"] = {"job": TP_CKPT_JOB, "per_rank": [r["ckpt"]
                                                     for r in ranks]}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    check(all(r["ckpt"]["resume_bit_for_bit"]
              and r["ckpt"]["restored_step"] == TP_RANKS_STEPS
              and r["ckpt"]["tp1_equals_live"]
              and r["ckpt"]["tp1_load_step"] == TP_RANKS_STEPS
              for r in ranks),
          f"tp_ranks: the TP checkpoint's resume or its tp = 1 load "
          f"{line['ckpt']}")
    check(not any(line["serve"]["graphs"]) and serve["replays"] == 0,
          "tp_ranks: the engine on a gloo tp group did not run eagerly")
    check(all(r["serve"]["streams"] == serve["streams"] for r in ranks),
          "tp_ranks: the ranks' streams differ")
    check(len(serve["streams"]) == len(prompts)
          and serve["heads_a_rank"] == GPT2Config().n_head // TP_RANKS,
          "tp_ranks: requests or heads a rank")
    check(all(d["top2_rel_gap"] < TP_GAP_RTOL for d in departures),
          f"tp_ranks: streams depart from the one-rank engine's at a clear "
          f"argmax: {departures}")
    _reshard_report("tp_reshard", [r["ckpt"]["reshard"] for r in ranks], smi,
                    dict(TP_RANKS_JOBS_BY_TAG)[TP_CKPT_JOB], TP_RESHARD_DST,
                    {k: n_layer for k in CAUSAL_KEYS})
    _redistribute_ranks_report(smi, ranks, serve["streams"], ref_streams,
                               departures, n_layer)
    del ref_model
    torch.cuda.empty_cache()


def _dp_slots_report(smi, ranks, ref_model, prompts, ref_streams):
    """The dp_slots line from tp_ranks' ranks (``_dp_slots_serving``), and
    its checks: every rank's streams equal, each equal to the one-rank
    fp32 engine's (truncated to the run's new tokens) or departing at a
    top-2 gap under TP_GAP_RTOL; each rank holds its 8 / dp slots, and
    exactly a quarter of the whole cache's bytes."""
    cfg = GPT2Config()
    dp, tp = DP_SLOTS
    per = SERVE_KW["n_slots"] // dp
    whole = 2 * cfg.n_layer * SERVE_KW["n_slots"] * SERVE_KW["max_len"] \
        * cfg.n_embd * 4                                   # K and V, fp32
    line = {"phase": "dp_slots", "nvidia_smi": smi, "backend": "gloo",
            "mesh": {"dp": dp, "tp": tp}, "model": "gpt2-125m",
            "dtype": "float32", "tf32": False, "cache_kind": "slotted",
            "n_slots": SERVE_KW["n_slots"], "requests": len(prompts),
            "whole_cache_bytes": whole, "runs": {}}
    for spec_k in (0, SPEC_K):
        runs = [r["dp_slots"][spec_k] for r in ranks]
        first = runs[0]
        departures = []
        for rid, tokens in first["streams"].items():
            want = ref_streams[rid][:first["new_tokens"]]
            if tokens != want:
                i = next(j for j, (a, b) in enumerate(zip(tokens, want))
                         if a != b)
                departures.append({"request": rid, "at": i, "top2_rel_gap":
                                   _top2_gap(ref_model, prompts[rid], want,
                                             i)})
        line["runs"][spec_k] = {
            "spec_k": spec_k, "new_tokens": first["new_tokens"],
            "draft_layers": DRAFT_LAYERS if spec_k else None,
            "wall_s": [x["wall_s"] for x in runs],
            "steps": first["steps"], "graphs": [x["graphs"] for x in runs],
            "own_slots": [x["own_slots"] for x in runs],
            "cache_shape": [x["cache_shape"] for x in runs],
            "cache_bytes": [x["cache_bytes"] for x in runs],
            "streams_equal_to_one_rank": sum(
                first["streams"][rid] == ref_streams[rid][:first[
                    "new_tokens"]] for rid in first["streams"]),
            "departures": departures,
            "ranks_agree": all(x["streams"] == first["streams"]
                               for x in runs)}
    line["phase_s"] = max(sum(x["wall_s"] for x in r["dp_slots"].values())
                          for r in ranks)
    emit(line)
    for spec_k, r in line["runs"].items():
        check(r["ranks_agree"] and len(ranks[0]["dp_slots"][spec_k][
            "streams"]) == len(prompts),
              f"dp_slots spec_k {spec_k}: the ranks' streams differ")
        check(all(d["top2_rel_gap"] < TP_GAP_RTOL for d in r["departures"]),
              f"dp_slots spec_k {spec_k}: streams depart from the one-rank "
              f"engine's at a clear argmax: {r['departures']}")
        check(not any(r["graphs"]), f"dp_slots spec_k {spec_k}: graphs on "
              "a gloo group")
        check(all(b * dp * tp == whole for b in r["cache_bytes"])
              and all(o == [k * per, (k + 1) * per] for k, o in zip(
                  [i // tp for i in range(len(ranks))], r["own_slots"])),
              f"dp_slots spec_k {spec_k}: cache bytes {r['cache_bytes']} "
              f"(whole {whole}) or slots {r['own_slots']}")
    return line


def _redistribute_ranks_report(smi, ranks, tp_streams, ref_streams,
                               departures, n_layer):
    """The redistribute_ranks line from tp_ranks' ranks, and its checks:
    the resharded TP engine's streams equal to the TP engine cut from the
    same weights (and so to the one-rank engine's, but for tp_ranks'
    departures), every leaf's measured peak below its naive gather's, the
    4 -> 2 state bit for bit the checkpoint's resume, B1-B3 in the resized
    step, the staging bound kept, ranks 2 and 3 only sending."""
    per_rank = [r["redistribute"] for r in ranks]
    line = {"phase": "redistribute_ranks", "nvidia_smi": smi,
            "ranks": TP_RANKS, "backend": "gloo", "model": "gpt2-125m",
            "max_staging_bytes": REDIST_STAGING,
            "fsdp_to_tp": {"dtype": "float32", "from": {"fsdp": TP_RANKS},
                           "to": {"dp": 1, "tp": TP_RANKS},
                           "streams_equal_to_tp_cut": sum(
                               per_rank[0]["streams"][i] == tp_streams[i]
                               for i in tp_streams),
                           "streams_equal_to_one_rank": sum(
                               per_rank[0]["streams"][i] == ref_streams[i]
                               for i in ref_streams),
                           "one_rank_departures": departures,
                           "per_rank": [r["fsdp_to_tp"] for r in per_rank]},
            "state": {"dtype": "bfloat16 compute, fp32 state", "optimizer":
                      "AdamW", "from": {"fsdp": TP_RANKS}, "to": {"fsdp": 2},
                      "per_rank": [r["state"] for r in per_rank]},
            "wall_s": [r["wall_s"] for r in per_rank]}
    emit(line)
    check(all(r["streams"] == tp_streams for r in per_rank),
          "redistribute_ranks: the resharded engine's streams differ from "
          "the TP engine cut from the same weights")
    for what in ("fsdp_to_tp", "state"):
        bad = [(i, r[what]["measured_peak_bytes"],
                r[what]["sharded_not_below_naive"])
               for i, r in enumerate(per_rank)
               if not r[what]["measured_below_naive"]
               or r[what]["sharded_not_below_naive"]]
        check(not bad, f"redistribute_ranks {what}: measured peaks not below "
              f"the naive gather's: {bad}")
    for i, r in enumerate(per_rank):
        st = r["state"]
        check(st["counts"]["staging_bytes_max"] <= REDIST_STAGING,
              f"redistribute_ranks: rank {i} staged over the bound")
        if i < 2:
            check(st["equal_to_resume"] and math.isfinite(st["resized_loss"])
                  and all(st["launches"][k] == n_layer for k in CAUSAL_KEYS),
                  f"redistribute_ranks: rank {i}: resize against resume "
                  f"{st.get('equal_to_resume')}, loss {st['resized_loss']}, "
                  f"launches {st['launches']}")
        else:
            check(st["received_none"] and st["counts"]["sent_bytes"] > 0,
                  f"redistribute_ranks: rank {i} should only send")


def _images_per_s(loader, batches: int) -> float:
    """Images a second of ``loader`` over ``batches`` batches after its
    first (the workers' start-up left out)."""
    it = iter(loader)
    next(it)
    t0, n = time.perf_counter(), 0
    for _ in range(batches):
        n += next(it)[0].shape[0]
    rate = n / (time.perf_counter() - t0)
    del it
    return rate


def disk_data_phase(train_result, resnet_example):
    """The disk datasets: ``write_image_folder`` makes 10 classes x 128
    random-pixel JPEGs at 256 x 320, ``write_token_bin`` a corpus of one
    4,096-token random sequence repeated (both under the gitignored build
    directory, deleted after). The loader alone (``make_loader`` over
    ``ImageFolderDataset`` with the train transform at 224 px) in images/s
    at 1 and 6 workers; ``examples.train_resnet_ddp`` at ResNet-50, batch
    128, bf16, 6 workers, 2 epochs of DISK_STEPS steps on synthetic
    ImageNet and then from ``--data-dir`` (images/s over the wall time from
    the first step's end to the run's, the loader's waits included; and 128
    over the median step alone), beside resnet_example's (fp32, synthetic,
    the step alone); ``examples.train_gpt2`` at its defaults with
    ``--data-bin`` (2 workers) for DISK_STEPS steps, whose loss must fall,
    tokens/s against the train phase's. Random pixels compress badly:
    these JPEGs decode slower than photographs of the same size."""
    t_phase = time.perf_counter()
    shutil.rmtree(DISK_ROOT, ignore_errors=True)
    images, corpus = DISK_ROOT / "images", DISK_ROOT / "corpus.bin"
    t0 = time.perf_counter()
    write_image_folder(str(images), n_classes=10, per_class=128,
                       size=(256, 320), seed=0)
    base = np.random.default_rng(4).integers(0, GPT2Config().vocab_size, 4096)
    write_token_bin(str(corpus), np.tile(base, 2 * DISK_STEPS + 1))
    write_s = time.perf_counter() - t0
    try:
        ds = ImageFolderDataset(str(images), transform=make_image_transform(
            224, train=True, seed=0))
        loader_rate = {}
        for workers, n in ((1, 2), (6, 8)):
            sampler = DistributedSampler(ds, num_replicas=1, rank=0, seed=0)
            loader_rate[workers] = _images_per_s(make_loader(
                ds, 128, sampler, device=torch.device("cuda"),
                num_workers=workers), n)
        resnet = ["--model", "resnet50", "--dataset", "imagenet",
                  "--global-batch", "128", "--policy", "bf16",
                  "--steps-per-epoch", str(DISK_STEPS), "--epochs", "2",
                  "--num-workers", "6", "--log-every", "100"]
        runs = {}
        # synthetic first: its first bf16 steps pay cuDNN's first calls at
        # these shapes, which would otherwise give the disk run's workers
        # a head start
        for name, extra in (("synthetic", ["--dataset-size",
                                           str(128 * DISK_STEPS)]),
                            ("disk", ["--data-dir", str(images)])):
            torch.cuda.empty_cache()
            out = train_resnet_ddp.main(resnet + extra)
            end = time.time()
            # from the first step's end to the run's: the steps and the
            # loader's waits between them (the second epoch's workers start
            # afresh, with nothing decoded ahead)
            wall = end - out["marks"]["first_step_done"]
            n = len(out["losses"])
            runs[name] = {"losses": out["losses"], "step_s": out["step_s"],
                          "images_per_s": 128 * (n - 1) / wall,
                          "step_images_per_s": 128 / statistics.median(
                              out["step_s"][1:]), "data": out["data"]}
        torch.cuda.empty_cache()
        gpt2 = train_gpt2.main(["--steps", str(DISK_STEPS), "--data-bin",
                                str(corpus), "--num-workers", "2",
                                "--log-every", "100"])
        step_s = gpt2["step_s"][3:]
        tokens_per_s = gpt2["tokens_per_step"] * len(step_s) / sum(step_s)
    finally:
        shutil.rmtree(DISK_ROOT, ignore_errors=True)
    emit({"phase": "disk_data", "jpegs": 1280, "jpeg_size": [256, 320],
          "write_s": write_s, "cpu_count": os.cpu_count(),
          "loader_images_per_s": {"workers_1": loader_rate[1],
                                  "workers_6": loader_rate[6]},
          "resnet50_bf16_batch128": runs,
          "disk_over_synthetic": runs["disk"]["images_per_s"]
          / runs["synthetic"]["images_per_s"],
          "step_disk_over_synthetic": runs["disk"]["step_images_per_s"]
          / runs["synthetic"]["step_images_per_s"],
          "resnet_example_fp32_step_images_per_s": 128 / statistics.median(
              resnet_example["step_s"][1:]),
          "gpt2_data_bin": {"losses": gpt2["losses"],
                            "tokens_per_s": tokens_per_s,
                            "train_phase_tokens_per_s":
                                train_result["tokens_per_s"],
                            "data": gpt2["data"]},
          "note": "random-pixel JPEGs decode slower than photographs",
          "phase_s": time.perf_counter() - t_phase})
    check(runs["disk"]["data"] == str(images)
          and len(runs["disk"]["losses"]) == 2 * DISK_STEPS
          and all(np.isfinite(runs["disk"]["losses"])),
          f"disk_data: the ResNet run from files {runs['disk']['losses']}")
    check(len(gpt2["losses"]) == DISK_STEPS
          and gpt2["losses"][-1] < gpt2["losses"][0],
          f"disk_data: the GPT-2 loss from the token file did not fall: "
          f"{gpt2['losses']}")
    torch.cuda.empty_cache()


MH_HOSTS = 2              # worker processes from the start; one more rejoins
MH_REQUESTS = 32          # the first batch, across the SIGKILL
MH_PUSH_REQUESTS = 16     # the second batch, across the weight push
MH_NEW_TOKENS = 64
MH_TTL_S = 2.0
MH_NS = "mh_smoke"


#: what a multihost worker process builds: GPT-2 125M (``cfg``: overrides
#: of ``GPT2Config``, none) from seed 1 in fp32, the serve phase's engine
MH_SPEC = {"device": "cuda", "cfg": {}, "seed": 1, "serve_kw": SERVE_KW,
           "hosts": MH_HOSTS}


def _mh_worker(index, port, out_dir, spec):
    """One multihost host: loads the parent's kernel build (no ``nvcc``),
    builds the model and its engine in fp32 with TF32 off, has the
    ``Scheduler`` capture the decode step (B7's wrapper launches counted
    over the capture), drains a warm-up request, then serves behind a
    ``HostWorker`` on the parent's ``TCPStore`` until the router's stop key
    (or a SIGKILL). Worker ``spec["hosts"]`` is the rejoiner: warm, it
    waits for the parent's go key before it registers. Its checkpoint
    loader reads the pushed weights into a second model on the card and
    hands its state dict to ``swap_params``."""
    from datetime import timedelta

    from pytorch_distributed_tpu_torch.serving import (
        HostWorker,
        load_gpt2_params,
    )

    device = torch.device(spec["device"])
    torch.set_num_threads(1)       # the host processes share the cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        _build.load_all(LIBRARIES)
    model = gpt2_125m(device=device, seed=spec["seed"], **spec["cfg"])
    scratch = gpt2_125m(device=device, seed=spec["seed"] + 1, **spec["cfg"])
    engine = InferenceEngine(model, device=device, **spec["serve_kw"])
    pa.launches = 0
    sched = Scheduler(engine, emit_events=False)
    capture_launches = pa.launches
    sched.submit(Request(prompt=np.arange(8) + 5, max_new_tokens=4))
    sched.run()
    steps0, replays0 = sched.decode_steps, engine.replays

    def loader(ckpt_dir, step):
        load_gpt2_params(ckpt_dir, scratch, step=step)
        return scratch.state_dict()

    active_at_swap = []
    swap = sched.swap_params

    def counted_swap(params, **kw):
        active_at_swap.append(sched.n_active)
        return swap(params, **kw)

    sched.swap_params = counted_swap

    store = TCPStore("127.0.0.1", port, timeout=timedelta(seconds=600))
    store.set(f"{MH_NS}/capture/{index}", json.dumps(
        {"b7_capture_launches": capture_launches,
         "graphs": engine.graphs}))
    if index == spec["hosts"]:
        store.wait([f"{MH_NS}/rejoin"])
    worker = HostWorker(store, sched, host_id=f"host{index}",
                        param_loader=loader, emit_events=False)
    worker.register()
    worker.serve_forever()
    torch.save({"host": worker.host_id, "chan": worker.chan,
                "weights_version": worker.weights_version,
                "weight_swaps": sched.weight_swaps,
                "active_at_swap": active_at_swap,
                "decode_steps": sched.decode_steps - steps0,
                "replays": engine.replays - replays0,
                "capture_launches": capture_launches},
               f"{out_dir}/mh_worker{index}.pt")


def _mh_drive(router, finished, until, procs, what, timeout_s=240.0,
              step_s=None):
    """Step the router until ``until()``; a worker process that dies (other
    than a killed one: ``procs`` lists the ones expected alive) or the
    deadline fails the phase. ``step_s`` collects each step's seconds."""
    deadline = time.monotonic() + timeout_s
    while not until():
        t0 = time.perf_counter()
        finished.extend(router.step())
        if step_s is not None:
            step_s.append(time.perf_counter() - t0)
        dead = [p.pid for p in procs if not p.is_alive()]
        check(not dead, f"multihost: worker process(es) {dead} died ({what})")
        check(time.monotonic() < deadline,
              f"multihost: {what} did not happen in {timeout_s} s "
              f"({router.stats()})")
        time.sleep(0.001)


def _mh_departures(got, want, model, prompts):
    """Where a stream departs from the uninterrupted engine's: its index
    and the reference's top-2 logit gap there."""
    out = []
    for rid, tokens in got.items():
        ref = want[rid]
        if tokens != ref:
            i = next((j for j, (a, b) in enumerate(zip(tokens, ref))
                      if a != b), min(len(tokens), len(ref)))
            out.append({"request": rid, "at": i, "top2_rel_gap": _top2_gap(
                model, prompts[rid], ref, i) if i < len(ref) else 0.0})
    return out


def _mh_latency(finished, wall_s) -> dict:
    lat = {"request": observability.LatencyTracker(),
           "ttft": observability.LatencyTracker()}
    for f in finished:
        lat["request"].add(f.total_s)
        lat["ttft"].add(f.ttft_s)
    tokens = sum(len(f.tokens) for f in finished)
    return {"requests": len(finished), "tokens": tokens, "wall_s": wall_s,
            "tokens_per_s": tokens / wall_s,
            "request_p50_s": lat["request"].percentile(50),
            "request_p99_s": lat["request"].percentile(99),
            "ttft_p50_s": lat["ttft"].percentile(50),
            "ttft_p99_s": lat["ttft"].percentile(99)}


def multihost_phase(spec=None):
    """Multihost serving through the port's ``Router`` and ``HostWorker``s:
    two worker processes (``_mh_worker``) on one ``TCPStore`` with its
    master in this process, GPT-2 125M at full width in fp32 with TF32 off,
    paged (the serve phase's engine: 8 slots, page 16, prefill_len 128,
    graphs on), ``Router(heartbeat_ttl_s=2)``. 32 of the serve phase's
    prompts (the 16 and 16 more from its recipe), 64 greedy tokens each;
    worker 0 SIGKILLed once it has committed a strict prefix of a stream:
    every request finishes exactly once, every stream equals this
    process's uninterrupted fp32 engine's (or departs at a top-2 gap
    under TP_GAP_RTOL), one eviction, and the rebalanced requests are the
    victim's unfinished ones. Then a third worker process rejoins (a fresh
    channel) and 16 more requests run while ``push_weights`` sends a
    ``CheckpointManager`` checkpoint of the same weights: every live
    worker swaps it in (``weights_version`` 1), the rejoiner takes
    traffic, and the streams are the uninterrupted engine's. Reports the
    seconds from the SIGKILL to the eviction and to the first refed
    token, request and TTFT p50/p99, tokens/s and routes per host (two
    processes share one card: this measures the control plane and the
    contexts' time-slicing, not multi-host scaling), and each worker's
    replays per decode step and the B7 launches its capture recorded
    (n_layer)."""
    import tempfile

    from pytorch_distributed_tpu_torch.checkpoint import model_state_dict
    from pytorch_distributed_tpu_torch.serving import Keys, Router

    t_phase = time.perf_counter()
    spec = spec or MH_SPEC
    device = torch.device(spec["device"])
    cfg = GPT2Config(**spec["cfg"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, prompts = _serve_requests(cfg.vocab_size,
                                    MH_REQUESTS + MH_PUSH_REQUESTS)
    master = TCPStore("127.0.0.1", 0, is_master=True)
    ckpt = _fresh_dir("multihost")
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=_build._BUILD_DIR)
    ctx = torch.multiprocessing.start_processes(
        _mh_worker, args=(master.port, out_dir, spec),
        nprocs=spec["hosts"] + 1, join=False, start_method="spawn")
    procs = ctx.processes
    try:
        # meanwhile: the uninterrupted reference and the checkpoint to push
        ref_model = gpt2_125m(device=device, seed=spec["seed"], **spec["cfg"])
        sched = Scheduler(InferenceEngine(ref_model, device=device,
                                          **spec["serve_kw"]),
                          emit_events=False)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=MH_NEW_TOKENS))
        want = {f.request_id: f.tokens for f in sched.run()}
        del sched
        with CheckpointManager(str(ckpt)) as mgr:
            t0 = time.perf_counter()
            mgr.save(1, model_state_dict(ref_model))
            ckpt_save_s = time.perf_counter() - t0

        router = Router(master, heartbeat_ttl_s=MH_TTL_S)
        finished = []
        t0 = time.perf_counter()
        _mh_drive(router, finished, lambda: len(router.hosts) == spec["hosts"],
                  procs, "the workers' registration", timeout_s=300)
        ready_s = time.perf_counter() - t_phase
        chan0 = next(hv.chan for hv in router.hosts.values()
                     if hv.host == "host0")
        mark = len(observability.recent_events(10_000))
        ids = [router.submit(Request(prompt=p, max_new_tokens=MH_NEW_TOKENS))
               for p in prompts[:MH_REQUESTS]]
        t_batch = time.perf_counter()
        step_s = []
        _mh_drive(router, finished, lambda: not router._pending
                  or all(hv.outstanding for hv in router.hosts.values()),
                  procs, "the first routes", step_s=step_s)
        victims = sorted(rid for rid, inf in router._inflight.items()
                         if inf.chan == chan0)
        # worker 0's own snapshot says when its first step with requests is
        # done (each admitted stream has its first tokens out, a strict
        # prefix): the router's view lags while it drains the outboxes
        load_key = Keys().load(chan0)
        deadline = time.monotonic() + 120
        while True:
            raw = master.get_nowait(load_key)
            if raw is not None and json.loads(raw)["active"] > 0:
                break
            check(time.monotonic() < deadline and procs[0].is_alive(),
                  "multihost: worker 0 never started decoding")
            time.sleep(0.0005)
        os.kill(procs[0].pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        alive = procs[1:spec["hosts"]]
        _mh_drive(router, finished, lambda: router.evictions >= 1, alive,
                  "the eviction", step_s=step_s)
        t_evict = time.perf_counter()
        done_before = {f.request_id for f in finished}
        readmitted = {rid: len(inf.committed)
                      for rid, inf in router._inflight.items()
                      if inf.rebalances}
        done_ids = set()

        def refed():
            done_ids.update(f.request_id for f in finished)
            return any(rid in done_ids
                       or len(router._inflight[rid].committed) > n
                       for rid, n in readmitted.items())

        _mh_drive(router, finished, refed, alive, "the first refed token",
                  step_s=step_s)
        t_refeed = time.perf_counter()
        _mh_drive(router, finished, lambda: not router.has_work, alive,
                  "the first batch", step_s=step_s)
        wall1 = time.perf_counter() - t_batch
        batch1 = list(finished)
        stats1 = router.stats()
        rebalanced = sorted(
            e.metadata["request_id"] for e in observability.recent_events(
                10_000)[mark:] if e.name == "serving.rebalance")

        # a recovered host rejoins, then a push during a second batch
        master.set(f"{MH_NS}/rejoin", b"1")
        alive = procs[1:]
        _mh_drive(router, finished,
                  lambda: len(router.hosts) == spec["hosts"] + 1, alive,
                  "the rejoin", timeout_s=120)
        rejoined = next(hv for hv in router.hosts.values()
                        if hv.host == f"host{spec['hosts']}")
        finished = []
        ids2 = [router.submit(Request(prompt=p, max_new_tokens=MH_NEW_TOKENS))
                for p in prompts[MH_REQUESTS:]]
        t_batch = time.perf_counter()
        _mh_drive(router, finished, lambda: not router._pending, alive,
                  "the second batch's routes")
        # a worker reads the push at the top of its next loop: after the
        # loop that admitted its requests, so mid-stream
        t_push = time.perf_counter()
        router.push_weights(str(ckpt), step=1)
        _mh_drive(router, finished, lambda: not router.has_work, alive,
                  "the second batch")
        wall2 = time.perf_counter() - t_batch
        _mh_drive(router, finished,
                  lambda: router.stats()["weights_version_min"] == 1, alive,
                  "the weight push", timeout_s=120)
        push_s = time.perf_counter() - t_push
        stats2 = router.stats()
        router.stop_hosts()
        for p in alive:
            p.join(timeout=120)
        exits = [p.exitcode for p in procs]
        workers = [torch.load(f"{out_dir}/mh_worker{i}.pt",
                              weights_only=False)
                   for i in range(1, spec["hosts"] + 1)]
        captures = [json.loads(master.get(f"{MH_NS}/capture/{i}"))
                    for i in range(spec["hosts"] + 1)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        master.close()
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32

    got1 = {f.request_id: f.tokens for f in batch1}
    got2 = {f.request_id: f.tokens for f in finished}
    dep1 = _mh_departures(got1, want, ref_model, prompts)
    dep2 = _mh_departures(got2, want, ref_model, prompts)
    expected_rebalanced = sorted(set(victims) - done_before)
    check(all(rid in victims for rid in readmitted),
          f"multihost: re-admitted {readmitted} beyond worker 0's {victims}")
    n_layer = cfg.n_layer
    line = {
        "phase": "multihost", "model": "gpt2-125m", "dtype": "float32",
        "tf32": False, "hosts": spec["hosts"], "store": "TCPStore",
        "worker_processes": spec["hosts"] + 1,
        "heartbeat_ttl_s": MH_TTL_S, "new_tokens": MH_NEW_TOKENS,
        "serve_kw": {k: v for k, v in spec["serve_kw"].items()},
        "workers_ready_s": ready_s, "checkpoint_save_s": ckpt_save_s,
        "victims": victims, "readmitted_committed": readmitted,
        "router_steps": len(step_s), "router_step_p50_s": float(
            np.median(step_s)), "router_step_max_s": max(step_s),
        "kill_to_evict_s": t_evict - t_kill,
        "kill_to_first_refed_token_s": t_refeed - t_kill,
        "batch1": dict(_mh_latency(batch1, wall1), **{
            k: stats1[k] for k in ("routed", "rebalances", "evictions",
                                   "stale_chunks", "per_host_routed",
                                   "request_p50_s", "request_p99_s",
                                   "ttft_p50_s", "ttft_p99_s")}),
        "batch2": dict(_mh_latency(finished, wall2),
                       per_host_routed=stats2["per_host_routed"],
                       weights_version_min=stats2["weights_version_min"],
                       push_to_all_swapped_s=push_s),
        "rejoined_chan": rejoined.chan,
        "rejoined_routed": rejoined.routed_total,
        "rebalanced": rebalanced, "departures": dep1 + dep2,
        "exit_codes": exits, "workers": workers, "captures": captures,
        "note": "the worker processes share one card: time-sliced CUDA "
                "contexts, not multi-host scaling",
        "phase_s": time.perf_counter() - t_phase}
    emit(line)
    check(sorted(got1) == ids and len(batch1) == len(ids)
          and sorted(got2) == ids2 and len(finished) == len(ids2),
          "multihost: not every request finished exactly once")
    check(all(len(t) == MH_NEW_TOKENS for t in list(got1.values())
              + list(got2.values())),
          "multihost: a stream is short")
    check(all(d["top2_rel_gap"] < TP_GAP_RTOL for d in dep1 + dep2),
          f"multihost: streams depart from the uninterrupted engine's at a "
          f"clear argmax: {dep1 + dep2}")
    check(stats1["evictions"] == 1 and rebalanced == expected_rebalanced
          and stats1["rebalances"] == len(rebalanced) > 0,
          f"multihost: evictions {stats1['evictions']}, rebalanced "
          f"{rebalanced}, victims {victims}, finished before the eviction "
          f"{sorted(done_before)}")
    check(rejoined.chan == spec["hosts"] and rejoined.routed_total > 0,
          f"multihost: the rejoin's channel {rejoined.chan} or its routes "
          f"{rejoined.routed_total}")
    check(stats2["weights_version_min"] == 1 and stats2["evictions"] == 1
          and all(w["weights_version"] == 1 and w["weight_swaps"] == 1
                  for w in workers)
          and any(n > 0 for w in workers for n in w["active_at_swap"]),
          f"multihost: the weight push (swapped while serving?) {stats2} "
          f"{workers}")
    check(exits[0] == -signal.SIGKILL and all(e == 0 for e in exits[1:]),
          f"multihost: exit codes {exits}")
    check(all(c["b7_capture_launches"] == n_layer and c["graphs"]
              == (device.type == "cuda") for c in captures)
          and all(w["replays"] == (w["decode_steps"]
                                   if device.type == "cuda" else 0)
                  and w["decode_steps"] > 0 for w in workers),
          f"multihost: B7 in the captures {captures}, replays {workers}")
    del ref_model
    torch.cuda.empty_cache()
    return line


MH_EXAMPLE_ARGS = ("--layers", "12", "--embd", "768", "--heads", "12",
                   "--vocab", "50257", "--seq-len", "1024", "--hosts", "2",
                   "--slots", "8", "--prefill-len", "128", "--requests",
                   "16", "--max-new-tokens", "64", "--evict")


def multihost_example_phase():
    """The entry point ``examples.serve_multihost``'s ``main`` at GPT-2
    125M's shape in bf16: two host threads over a ``HashStore``, host0
    killed mid-decode; it returns 0, serves 16 of 16 and evicts once."""
    argv = list(MH_EXAMPLE_ARGS)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_multihost.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    served = re.search(
        r"served (\d+)/(\d+) requests in ([\d.]+)s \| request p50 "
        r"([\d.]+)ms p99 ([\d.]+)ms \| ttft p50 ([\d.]+)ms", out)
    hosts = re.search(r"evictions (\d+)", out)
    lines = out.splitlines()
    emit({"phase": "multihost_example", "argv": argv, "returned": rc,
          "dtype": "bfloat16", "wall_s": wall,
          "served": served and [int(served.group(1)), int(served.group(2))],
          "serve_wall_s": served and float(served.group(3)),
          "request_p50_ms": served and float(served.group(4)),
          "request_p99_ms": served and float(served.group(5)),
          "ttft_p50_ms": served and float(served.group(6)),
          "evictions": hosts and int(hosts.group(1)),
          "summary": lines[-3:]})
    check(rc == 0 and served is not None and served.group(1) == "16"
          and served.group(2) == "16" and hosts is not None
          and hosts.group(1) == "1",
          f"multihost_example returned {rc}, printed {lines[-4:]}")
    torch.cuda.empty_cache()


# -- mixture of experts, selective remat and dropout (slice 17) -------------
MOE_CFG = dict(moe_experts=8, moe_top_k=2)
MOE_BATCH, MOE_SEQ = 8, 1024  # the train cell's batch
MOE_DEVICE = torch.device("cuda", 0)
MOE_WARM, MOE_TIMED = 3, 10
MOE_FIXED_STEPS = 8          # the runner against the eager loop, one batch
MOE_PARITY = dict(n_layer=2, moe_experts=4, moe_top_k=2)
MOE_PARITY_BT = (2, 256)
MOE_PARITY_TOL = 1e-5        # of the reference's largest value
MOE_GAP = 1e-6               # a route may depart only at a top-k gap below
REMAT_RUNS = ("full", "dots_with_no_batch_dims_saveable", "dots_saveable",
              "nothing_saveable")
REMAT_REPS = 3
DROPOUT_RATE = 0.1
DROPOUT_STEPS = 6
EP_RANKS = 4
EP_RANKS_STEPS = 3
EP_RANKS_LAYERS = 4          # full width; depth cut to two MoE blocks
EP_ROW = 2                   # sequences of 1024 a dp row (a routing group)
EP_RANKS_LOSS_RTOL = 1e-2    # bf16, as fsdp_ranks' limit
EP_JOBS = {"dp1_ep4": (1, 4), "dp2_ep2": (2, 2)}
EP_CKPT_JOB = "dp1_ep4"      # saved after 2 steps, resumed for the third


def _moe_counts(cfg: GPT2Config) -> dict:
    """Parameters of an MoE GPT-2 (the whole model, the expert stacks, the
    ones a token runs through) and the MoE blocks' shapes."""
    C, E, k = cfg.n_embd, cfg.moe_experts, cfg.moe_top_k
    n_moe = sum((i + 1) % cfg.moe_every == 0 for i in range(cfg.n_layer))
    dense_mlp = 2 * C * 4 * C + 4 * C + C
    per_block_total = 12 * C * C + 13 * C           # attention, MLP, LNs
    n_params = (cfg.vocab_size * C + cfg.n_positions * C + 2 * C
                + cfg.n_layer * per_block_total
                + n_moe * (2 * E * C * 4 * C + E * C + E - dense_mlp))
    experts = n_moe * 2 * E * C * 4 * C
    return {"n_params": n_params, "expert_params": experts,
            "active_params": n_params - experts + experts * k // E,
            "n_moe": n_moe}


def _onehot_flops(n_tokens: int, cfg: GPT2Config, cap: int) -> float:
    """FLOPs a step of the one-hot einsums of one MoE block: dispatch
    (forward, and the tokens' gradient) and combine (forward, and the
    gradients of the expert outputs and of the gates' mask), each product
    ``2 n E cap C``."""
    one = 2.0 * n_tokens * cfg.moe_experts * cap * cfg.n_embd
    return 5 * one


def _card_trainer(seed=2, **cfg):
    """GPT-2 125M (``cfg`` on top), bf16, flash attention, AdamW built
    ``capturable`` (the runner's and the eager loop's update arithmetic
    alike), NoShard."""
    model = gpt2_125m(device=MOE_DEVICE, seed=seed, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention, **cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, NoShard(MOE_DEVICE), loss_fn=lm_loss,
                      policy="bf16")
    return trainer, trainer.init()


def _segment_ms(fn, reps: int = 3) -> float:
    """Device busy time of ``fn()`` (a forward and backward) in a traced
    window, per call."""
    with traced(fn) as prof:
        for _ in range(reps):
            fn()
    return sum(e.self_device_time_total
               for e in _device_kernels(prof)) / 1e3 / reps


def _moe_split(cfg: GPT2Config, n_tokens: int, device) -> dict:
    """One MoE block's forward and backward at the main path's shapes,
    split: the router, top-k and masks; the one-hot einsums (dispatch and
    combine); the expert MLPs. Device time of each from a trace."""
    g = torch.Generator(device=device).manual_seed(3)
    C, E, k, dt = cfg.n_embd, cfg.moe_experts, cfg.moe_top_k, torch.bfloat16
    layer = MoEMLP(E, 4 * C, C, k=k, dtype=dt, device=device)
    layer.reset_parameters(g)
    cap = layer.capacity(n_tokens)

    def rand(*shape, dtype=dt, grad=False):
        t = torch.randn(*shape, device=device, generator=g).to(dtype)
        return t.requires_grad_(grad)

    x = rand(1, n_tokens, C, grad=True)
    r = layer.router

    def masks():
        probs = torch.softmax(F.linear(x.float(), r.weight, r.bias), -1)
        gates, idx = torch.topk(probs, k, dim=-1)
        d, c = make_dispatch_masks(idx, gates, E, cap, dt)
        torch.autograd.backward([c], [g_c])
        return d, c

    g_c = rand(1, n_tokens, E, cap, dtype=torch.float32)
    d, c = masks()
    d, c = d.detach(), c.detach().requires_grad_()
    e_out = rand(1, E, cap, C, grad=True)
    g_in, g_out = rand(1, E, cap, C), rand(1, n_tokens, C)

    def onehot():
        e_in = torch.einsum("gnec,gnd->gecd", d, x)
        out = torch.einsum("gnec,gecd->gnd", c.to(dt), e_out)
        torch.autograd.backward([e_in, out], [g_in, g_out])

    e_in = rand(1, E, cap, C, grad=True)

    def experts():
        h = F.gelu(torch.einsum("gecd,edf->gecf", e_in,
                                layer.experts_up.to(dt)), approximate="tanh")
        y = torch.einsum("gecf,efd->gecd", h, layer.experts_down.to(dt))
        torch.autograd.backward([y], [g_in])

    out = {"capacity": cap, "masks_ms": _segment_ms(masks),
           "onehot_ms": _segment_ms(onehot),
           "experts_ms": _segment_ms(experts)}
    del layer, x, d, c, e_out, e_in, g_c, g_in, g_out
    torch.cuda.empty_cache()
    return out


def moe_train_phase():
    """The MoE path: ``examples/train_gpt2.py --moe-experts 8 --moe-top-k
    2`` at GPT-2 125M's full width and depth (MoE in blocks 1, 3, ..., 11),
    B = 8 x 1024, bf16, flash attention, AdamW, its one-rank group: 3
    warm-up and MOE_TIMED timed steps (step time, tokens/s, MFU over the
    parameters a token runs through, peak memory, B1-B3 n_layer a step,
    ``moe_aux`` a step). Then the same step, NoShard, on one repeated batch
    through ``AsyncRunner`` against the eager loop (losses fall; runner
    equal to the eager loop within the loop's own spread; one replay a
    step), 3 replayed steps under a device trace (B1-B3 n_layer each a
    step), and one MoE block's forward and backward split into the masks,
    the one-hot einsums and the experts (device traces), against the
    replayed step's busy time."""
    bf16_peak, _, _ = peaks()
    cfg = GPT2Config(**MOE_CFG)
    counts = _moe_counts(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    steps = MOE_WARM + MOE_TIMED
    out = train_gpt2.main(["--steps", str(steps), "--log-every", "100",
                           "--moe-experts", str(cfg.moe_experts),
                           "--moe-top-k", str(cfg.moe_top_k)])
    launches = dict(fa.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    step_s = out["step_s"][MOE_WARM:]
    tokens = out["tokens_per_step"]
    tokens_per_s = tokens * len(step_s) / sum(step_s)
    cap = max(1, int(cfg.moe_capacity_factor * tokens * cfg.moe_top_k
                     / cfg.moe_experts))
    onehot = counts["n_moe"] * _onehot_flops(tokens, cfg, cap)
    n_layer = cfg.n_layer
    expected = n_layer * steps
    line = {"phase": "moe_train", "model": "gpt2-125m-moe", **MOE_CFG,
            "moe_blocks": counts["n_moe"], "dtype": out["dtype"],
            "attn": out["attn"], "global_batch": MOE_BATCH,
            "seq_len": MOE_SEQ,
            "n_params": out["n_params"],
            "active_params": counts["active_params"],
            "capacity": cap, "warmup_steps": MOE_WARM,
            "timed_steps": MOE_TIMED,
            "step_p50_s": statistics.median(step_s),
            "tokens_per_s": tokens_per_s,
            "mfu_active": 6 * counts["active_params"] * tokens_per_s
            / bf16_peak,
            "mfu_note": "6 x active parameters x tokens/s over the bf16 "
                        "peak; the one-hot einsums are not in it",
            "onehot_tflop_per_step": onehot / 1e12,
            "mfu_with_onehot": (6 * counts["active_params"] * tokens
                                + onehot) * len(step_s) / sum(step_s)
            / bf16_peak,
            "max_memory_allocated_bytes": peak_mem,
            "param_bytes": out["n_params"] * 4,
            "adamw_state_bytes": 2 * out["n_params"] * 4,
            "losses": out["losses"], "moe_aux": out["moe_aux"],
            "kernel_launches": launches, "expected_launches": expected,
            "strategy": out["strategy"]}
    check(out["n_params"] == counts["n_params"],
          f"moe_train: {out['n_params']} parameters, the config's "
          f"{counts['n_params']}")
    check(all(np.isfinite(out["losses"] + out["moe_aux"]))
          and len(out["moe_aux"]) == steps and min(out["moe_aux"]) > 0,
          f"moe_train: losses {out['losses']} moe_aux {out['moe_aux']}")
    check(all(launches[k] == expected for k in CAUSAL_KEYS)
          and not any(launches[k] for k in MASKED_KEYS),
          f"moe_train: flash launches {launches} != n_layer x steps "
          f"{expected} of B1-B3 and none of B4-B6")

    # one repeated batch: the runner against the eager loop
    batches = _lm_batches(1, MOE_BATCH, MOE_SEQ, seed=51) * MOE_FIXED_STEPS
    runs, spread, got = _runner_runs(lambda: _card_trainer(**MOE_CFG),
                                     batches, "moe_train")
    runner, trainer, state = runs["runner"].pop("_runner")
    losses = runs["runner"]["losses"]
    check(losses[-1] < losses[0], f"moe_train: runner losses {losses} do "
                                  "not fall on a repeated batch")
    warm = n_layer * (AsyncRunner.warmup_steps + 1)
    check(all(runs["runner"]["launches"][k] == warm for k in CAUSAL_KEYS),
          f"moe_train: runner wrapper launches {runs['runner']['launches']}")
    prof_steps = 3
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})

    def window():
        return _replay_window(runner, state, batches, prof_steps,
                              expect_calls)

    (device, calls, spans, wall_ms, _), first = recounted(
        window, lambda r: r[1] == expect_calls)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / prof_steps
    del runner, trainer, state
    torch.cuda.empty_cache()
    split = _moe_split(cfg, tokens, MOE_DEVICE)
    moe_ms = counts["n_moe"] * (split["masks_ms"] + split["onehot_ms"]
                                + split["experts_ms"])
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    line.update(
        fixed_batch={"eager_spread": spread, "runner_vs_eager": got,
                     **{k: {kk: v[kk] for kk in (
                         "losses", "step_s", "max_memory_allocated_bytes",
                         "replays", "captured") if kk in v}
                        for k, v in runs.items()}},
        replayed={"steps": prof_steps, "flash_calls_per_step": calls,
                  "first_window_flash_calls_per_step": first and first[1],
                  "device_busy_ms_per_step": busy_ms,
                  "wall_ms_per_step": wall_ms / prof_steps,
                  "replay_ms_per_step": _spans_ms(spans) / prof_steps,
                  "top_kernels": [{"name": e.key[:80],
                                   "ms_per_step": e.self_device_time_total
                                   / 1e3 / prof_steps,
                                   "calls_per_step": e.count / prof_steps}
                                  for e in top]},
        split_per_block_ms=split,
        split_per_step_ms={
            "masks": counts["n_moe"] * split["masks_ms"],
            "onehot_einsums": counts["n_moe"] * split["onehot_ms"],
            "experts": counts["n_moe"] * split["experts_ms"],
            "dense_remainder": busy_ms - moe_ms,
            "replayed_step_busy": busy_ms})
    emit(line)
    check(calls == expect_calls,
          f"moe_train: flash calls per replayed step {calls}, expected "
          f"{expect_calls}")
    return line


def _moe_parity_run(model, batch, dev):
    """Logits, weighted aux, one backward's gradients (on the host) and
    each MoE block's routes: top-k expert indices and the smallest gap
    among the k + 1 largest router probabilities."""
    seen = []
    hooks = [b.moe.register_forward_pre_hook(
        lambda m, args: seen.append((m, args[0].detach())))
        for b in model.h if b.use_moe]
    tokens, targets = (torch.from_numpy(t).to(dev) for t in batch)
    logits, aux = model(tokens)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long()) + aux
    loss.backward()
    for h in hooks:
        h.remove()
    routes = []
    with torch.no_grad():
        for m, x in seen:
            probs = torch.softmax(F.linear(
                x.reshape(-1, x.shape[-1]).float(), m.router.weight.float(),
                m.router.bias.float()), -1)
            top, idx = torch.topk(probs, m.k + 1, dim=-1)
            routes.append((idx[:, :m.k].cpu(),
                           (top[:, :-1] - top[:, 1:]).min(-1).values.cpu()))
    return (logits.detach().cpu(), float(aux.detach()),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            routes)


def moe_parity_phase():
    """A 2-layer MoE GPT-2 at full width (E = 4, k = 2), fp32 with TF32
    off, on the card (B1-B3's fp32 route) and on the CPU (their plain
    versions) from the same weights and batch: the routes equal (a
    departure only at a top-k gap below MOE_GAP, counted), the logits,
    ``moe_aux`` and one backward's gradients within MOE_PARITY_TOL of the
    CPU's largest value (per tensor)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T = MOE_PARITY_BT
    batch = _lm_batches(1, B, T, seed=31)[0]
    card = gpt2_125m(device=MOE_DEVICE, seed=4, attn_impl=fa.flash_attention,
                     **MOE_PARITY)
    cpu = gpt2_125m(device="cpu", seed=4, attn_impl=fa.flash_attention,
                    **MOE_PARITY)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    _reset_flash_counts()
    got = _moe_parity_run(card, batch, card.wte.device)
    launches = dict(fa.launches)
    want = _moe_parity_run(cpu, batch, "cpu")
    departed, at_gap = 0, True
    for (gi, _), (wi, gap) in zip(got[3], want[3]):
        differ = (gi != wi).any(-1)
        departed += int(differ.sum())
        at_gap = at_gap and bool((gap[differ] < MOE_GAP).all())

    def err(g, w):
        return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)

    grad_err = {n: err(got[2][n], w) for n, w in want[2].items()}
    worst = max(grad_err, key=grad_err.get)
    line = {"phase": "moe_parity", "dtype": "float32", "tf32": False,
            "B": B, "T": T, **MOE_PARITY, "tol": MOE_PARITY_TOL,
            "tokens_routed": sum(len(r[0]) for r in want[3]),
            "route_departures": departed, "departures_at_near_ties": at_gap,
            "logits_rel_err": err(got[0], want[0]),
            "moe_aux": [got[1], want[1]],
            "moe_aux_rel_err": abs(got[1] - want[1]) / abs(want[1]),
            "grad_worst_rel_err": grad_err[worst], "grad_worst_param": worst,
            "launches": launches}
    emit(line)
    check(at_gap, "moe_parity: a route departs at a clear top-k gap")
    check(departed == 0, f"moe_parity: {departed} near-tie route departures "
                         "(they move their group's outputs)")
    check(line["logits_rel_err"] <= MOE_PARITY_TOL
          and line["moe_aux_rel_err"] <= MOE_PARITY_TOL
          and grad_err[worst] <= MOE_PARITY_TOL,
          f"moe_parity: logits {line['logits_rel_err']}, aux "
          f"{line['moe_aux_rel_err']}, gradient of {worst} "
          f"{grad_err[worst]} over {MOE_PARITY_TOL}")
    check(all(launches[k] == MOE_PARITY["n_layer"] for k in CAUSAL_KEYS),
          f"moe_parity: flash launches {launches}")
    del card, cpu
    torch.cuda.empty_cache()
    return line


def _remat_run(name, batch):
    """GPT-2 125M, bf16, flash attention, with the recomputation ``name``
    (``off``, ``full``, or a policy): one forward and backward kept (loss
    and gradients on the card), then REMAT_REPS timed, and the peak memory
    above the weights and gradients."""
    policy = None if name in ("off", "off_again", "full") else name
    model = gpt2_125m(device=MOE_DEVICE, seed=6, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention,
                      remat=name not in ("off", "off_again"),
                      remat_policy=policy)
    tokens, targets = (torch.from_numpy(t).to(model.wte.device)
                       for t in batch)

    def fwd_bwd():
        for p in model.parameters():
            p.grad = None
        loss, _ = lm_loss(model, (tokens, targets), True)
        loss.backward()
        return loss.detach()

    loss = fwd_bwd()
    grads = [p.grad for p in model.parameters()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(REMAT_REPS):
        fwd_bwd()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / REMAT_REPS
    peak = torch.cuda.max_memory_allocated() - base
    names = [n for n, _ in model.named_parameters()]
    del model
    return loss, dict(zip(names, grads)), {"step_ms": step_ms,
                                           "peak_above_weights_bytes": peak}


def remat_dropout_phase():
    """GPT-2 125M at full width, B = 8 x 1024, bf16, flash attention: one
    forward and backward with recomputation off (twice: its run-to-run
    spread, per tensor) and with each of REMAT_RUNS, whose loss and
    gradients must equal remat off's within that spread (0 where the card
    is deterministic; a tensor with a spread is named), with peak memory
    and step time each. Then ``dropout=DROPOUT_RATE`` through
    ``AsyncRunner`` against the eager loop (equal within the loop's own
    spread), the keep share of a mask within 5 sigma of ``1 - rate``, and
    a resume from an in-memory checkpoint after 2 steps drawing the masks
    of the run it resumes (the next 2 losses equal)."""
    batch = _lm_batches(1, MOE_BATCH, MOE_SEQ, seed=41)[0]
    ref_loss, ref, off = _remat_run("off", batch)
    runs = {"off": off}
    diffs = {}
    for name in ("off_again",) + REMAT_RUNS:
        loss, grads, runs[name] = _remat_run(name, batch)
        diffs[name] = {"loss": float((loss - ref_loss).abs()),
                       "grads": {n: float((g - ref[n]).abs().max())
                                 for n, g in grads.items()}}
        del grads
    torch.cuda.empty_cache()
    spread = diffs.pop("off_again")
    noisy = sorted(n for n, d in spread["grads"].items() if d > 0)
    beyond = {name: [n for n, dd in d["grads"].items()
                     if dd > spread["grads"][n]]
              for name, d in diffs.items()}
    beyond = {k: v for k, v in beyond.items() if v}
    loss_beyond = {k: d["loss"] for k, d in diffs.items()
                   if d["loss"] > spread["loss"]}
    del ref

    # dropout on the runner
    batches = _lm_batches(DROPOUT_STEPS, MOE_BATCH, MOE_SEQ, seed=43)
    druns, dspread, dgot = _runner_runs(
        lambda: _card_trainer(dropout=DROPOUT_RATE), batches, "dropout")
    runner, trainer, _ = druns["runner"].pop("_runner")
    trainer.seed_dropout(7)
    shape = (MOE_BATCH, MOE_SEQ, trainer.model.cfg.n_embd)
    keep = trainer.model._mask_drawer(shape)()
    share = float(keep.float().mean())
    sigma = math.sqrt(DROPOUT_RATE * (1 - DROPOUT_RATE) / keep.numel())
    del runner, trainer, keep
    torch.cuda.empty_cache()

    # a resume draws the masks of the run it resumes
    trainer, state = _card_trainer(dropout=DROPOUT_RATE)
    for b in batches[:2]:
        state, _ = trainer.step(state, b)
    saved = {k: v.clone() for k, v in get_state_dict(trainer, state).items()}
    want = []
    for b in batches[2:4]:
        state, m = trainer.step(state, b)
        want.append(float(m["loss"]))
    del trainer, state
    fresh, fstate = _card_trainer(seed=9, dropout=DROPOUT_RATE)
    fstate = set_state_dict(fresh, fstate, saved)
    resumed = []
    for b in batches[2:4]:
        fstate, m = fresh.step(fstate, b)
        resumed.append(float(m["loss"]))
    del fresh, fstate, saved
    torch.cuda.empty_cache()
    line = {"phase": "remat_dropout", "model": "gpt2-125m",
            "dtype": "bfloat16", "global_batch": MOE_BATCH,
            "seq_len": MOE_SEQ,
            "remat": runs, "loss_off": float(ref_loss),
            "off_spread": {"loss": spread["loss"],
                           "nondeterministic_grads": noisy},
            "grads_beyond_spread": beyond, "loss_beyond_spread": loss_beyond,
            "dropout": {"rate": DROPOUT_RATE, "steps": DROPOUT_STEPS,
                        "eager_spread": dspread, "runner_vs_eager": dgot,
                        "losses": druns["runner"]["losses"],
                        "runner_step_s": druns["runner"]["step_s"],
                        "eager_step_s": druns["eager_a"]["step_s"],
                        "keep_share": share, "keep_sigma": sigma,
                        "resume_losses": resumed,
                        "uninterrupted_losses": want}}
    emit(line)
    check(not beyond and not loss_beyond,
          f"remat_dropout: gradients {beyond} / losses {loss_beyond} beyond "
          "remat off's run-to-run spread")
    check(runs["nothing_saveable"]["peak_above_weights_bytes"]
          < runs["off"]["peak_above_weights_bytes"],
          "remat_dropout: recomputing everything saves no memory")
    check(abs(share - (1 - DROPOUT_RATE)) <= 5 * sigma,
          f"remat_dropout: keep share {share} not within 5 sigma of "
          f"{1 - DROPOUT_RATE}")
    check(max(abs(a - b) for a, b in zip(resumed, want))
          <= dspread["losses"],
          f"remat_dropout: resumed losses {resumed} vs {want}")
    return line


def _ep_trainer(mesh, device, seed=7):
    model = gpt2_125m(device=device, seed=seed, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention, n_layer=EP_RANKS_LAYERS,
                      moe_group_size=EP_ROW * MOE_SEQ, **MOE_CFG)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    strategy = (ExpertDataParallel(mesh) if mesh is not None
                else NoShard(device))
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def _param_hash(params) -> int:
    """An exact integer digest of the parameters' bits (equal digests:
    equal bits, but for a collision)."""
    total = 0
    for p in params:
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        weights = torch.arange(1, bits.numel() + 1, device=bits.device) \
            % 1000003
        total += int((bits * weights).sum())
    return total


def _ep_steps(trainer, state, batches, timed=True):
    out = {"losses": [], "moe_aux": [], "step_s": []}
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:
            comm.reset_counts()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        # graftlint: disable-next-line=host-sync-in-hot-loop -- the loss read closes the timed step: step_s is each step's latency
        out["losses"].append(float(m["loss"]))
        # graftlint: disable-next-line=host-sync-in-hot-loop -- read beside the loss, after the step has finished
        out["moe_aux"].append(float(m["moe_aux"]))
        out["step_s"].append(time.perf_counter() - t0)
    out["counts"] = dict(comm.counts)
    out["wire"] = dict(comm.wire_bytes)
    return state, out


def _ep_rank(rank, out_dir, job_batches, device) -> dict:
    """ep_ranks' work on one of the EP_RANKS ranks sharing the card over
    gloo (pp_ranks' processes, their group made): each EP_JOBS mesh,
    EP_RANKS_STEPS eager steps; EP_CKPT_JOB saves after 2 steps and a fresh
    trainer restored from it takes the third again."""
    result = {"rank": rank}
    t0 = time.perf_counter()
    for tag, shape in EP_JOBS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        mesh = init_device_mesh(shape, ("dp", "ep"))
        trainer, state = _ep_trainer(mesh, device)
        batches = job_batches[tag]
        model, opt = trainer.model, trainer.optimizer
        r = {"dp": trainer.strategy.data_shard_index,
             "held": {n: tuple(p.shape) for n, p in
                      model.named_parameters() if "experts" in n},
             "param_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
             "opt_bytes": sum(v.numel() * v.element_size()
                              for st in opt.state.values()
                              for v in st.values())}
        if tag == EP_CKPT_JOB:
            state, first = _ep_steps(trainer, state, batches[:2])
            ckpt = f"{out_dir}/ep_ckpt"
            with CheckpointManager(ckpt) as mgr:
                mgr.save(state.step, get_state_dict(trainer, state))
            state, last = _ep_steps(trainer, state, batches[2:])
            steps = {k: first[k] + last[k] if isinstance(first[k], list)
                     else last[k] for k in first}
            fresh, fstate = _ep_trainer(mesh, device, seed=8)
            with CheckpointManager(ckpt) as mgr:
                fstate = set_state_dict(fresh, fstate, mgr.restore(
                    get_state_dict(fresh, fstate)))
            fstate, again = _ep_steps(fresh, fstate, batches[2:])
            r["resumed_losses"] = again["losses"]
            r["resumed_hash"] = _param_hash(fresh.model.parameters())
            del fresh, fstate
        else:
            state, steps = _ep_steps(trainer, state, batches)
        r.update(steps)
        r["replica_hash"] = _param_hash(
            p for p in model.parameters() if not hasattr(p, "ep"))
        r["hash"] = _param_hash(model.parameters())
        r["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            device)
        result[tag] = r
        del trainer, state, model, opt
    result["work_s"] = time.perf_counter() - t0
    return result


def _ep_wire(cfg: GPT2Config, dp: int, held_params: int) -> dict:
    """The design's all-reduces and bytes a rank a step (see
    ``parallel/expert.py``): per MoE block g (fp32 [n, C]) forward and the
    two f's backward (the tokens' gradient in bf16, the gates' in fp32),
    with dp > 1 the aux statistics (``2 E`` fp32) each way; then the dp
    gradient all-reduce (fp32, the held parameters) and the norm's (2
    fp32)."""
    n_moe = _moe_counts(cfg)["n_moe"]
    n, C, k, E = EP_ROW * MOE_SEQ, cfg.n_embd, cfg.moe_top_k, cfg.moe_experts
    stats = 2 * 2 * E * 4 if dp > 1 else 0
    return {"all_reduce": n_moe * (3 + (2 if dp > 1 else 0)) + 2,
            "all_reduce.bfloat16": n_moe * n * C * 2,
            "all_reduce.float32": n_moe * (n * C * 4 + n * k * 4 + stats)
            + held_params * 4 + 8}


def _ep_reference():
    """ep_ranks' global batches and NoShard's run of each EP_JOBS job in
    this process."""
    job_batches = {tag: _lm_batches(EP_RANKS_STEPS, dp * EP_ROW, MOE_SEQ,
                                    seed=61 + dp)
                   for tag, (dp, _) in EP_JOBS.items()}
    want = {}
    for tag, batches in job_batches.items():
        trainer, state = _ep_trainer(None, MOE_DEVICE)
        _, want[tag] = _ep_steps(trainer, state, batches)
        del trainer, state
    torch.cuda.empty_cache()
    return {"batches": job_batches, "want": want}


def _ep_ranks_report(ranks, ep_in):
    """ep_ranks: EP_RANKS ranks on the one card over gloo (``_ep_rank``, in
    pp_ranks' processes): GPT-2 125M at full width, EP_RANKS_LAYERS deep
    (MoE in blocks 1 and 3, E = 8, k = 2, routing groups of one dp row),
    bf16, flash attention, EP_ROW x 1024 tokens a dp row, EP_RANKS_STEPS
    eager steps under ``ExpertDataParallel`` on (dp 1, ep 4) and (dp 2,
    ep 2), against NoShard in this process on the same global batches (the
    mean of the dp rows' losses within EP_RANKS_LOSS_RTOL): E/ep experts a
    rank (parameter bytes), the parameters outside the expert stacks bit
    for bit equal on every rank (digests), the all-reduces and bytes a
    step against the design's, the (1, 4) checkpoint resumed bit for bit,
    step time and peak memory a rank."""
    cfg = GPT2Config(n_layer=EP_RANKS_LAYERS,
                     moe_group_size=EP_ROW * MOE_SEQ, **MOE_CFG)
    want = ep_in["want"]
    counts = _moe_counts(cfg)
    line = {"phase": "ep_ranks", "ranks": EP_RANKS, "backend": "gloo",
            "spawn": "pp_ranks' ranks",
            "work_s": [r["work_s"] for r in ranks], "model": "gpt2-125m-moe",
            "n_layer": EP_RANKS_LAYERS, **MOE_CFG, "dtype": "bfloat16",
            "row_tokens": EP_ROW * MOE_SEQ, "steps": EP_RANKS_STEPS,
            "loss_rtol": EP_RANKS_LOSS_RTOL,
            "n_params": counts["n_params"]}
    for tag, (dp, ep) in EP_JOBS.items():
        rs = [r[tag] for r in ranks]
        mean = [float(np.mean([rs[d * ep]["losses"][i] for d in range(dp)]))
                for i in range(EP_RANKS_STEPS)]
        rel = [abs(a - b) / abs(b) for a, b in zip(mean, want[tag]["losses"])]
        held = (counts["n_params"] - counts["expert_params"]
                + counts["expert_params"] // ep)
        design = _ep_wire(cfg, dp, held)
        got = {"all_reduce": rs[0]["counts"]["all_reduce"],
               **{k: rs[0]["wire"].get(k, 0) for k in design if "." in k}}
        line[tag] = {
            "mean_losses": mean, "noshard_losses": want[tag]["losses"],
            "loss_rel_err": rel,
            "moe_aux": [r["moe_aux"] for r in rs[::ep]],
            "noshard_moe_aux": want[tag]["moe_aux"],
            "experts_held": rs[0]["held"],
            "param_bytes_a_rank": rs[0]["param_bytes"],
            "design_param_bytes": held * 4,
            "param_bytes_whole": counts["n_params"] * 4,
            "opt_bytes_a_rank": rs[0]["opt_bytes"],
            "collectives_a_step": got, "design": design,
            "replicas_equal": len({r["replica_hash"] for r in rs}) == 1,
            "step_s": [r["step_s"] for r in rs],
            "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                           for r in rs]}
        if tag == EP_CKPT_JOB:
            line[tag]["resumed_losses"] = [r["resumed_losses"] for r in rs]
            line[tag]["resume_bit_equal"] = all(
                r["resumed_losses"] == r["losses"][2:]
                and r["resumed_hash"] == r["hash"] for r in rs)
    emit(line)
    for tag, (dp, ep) in EP_JOBS.items():
        r = line[tag]
        check(max(r["loss_rel_err"]) <= EP_RANKS_LOSS_RTOL,
              f"ep_ranks {tag}: losses {r['mean_losses']} vs NoShard "
              f"{r['noshard_losses']}")
        check(r["experts_held"]["h.1.moe.experts_up"][0]
              == cfg.moe_experts // ep,
              f"ep_ranks {tag}: experts held {r['experts_held']}")
        check(r["param_bytes_a_rank"] == r["design_param_bytes"],
              f"ep_ranks {tag}: {r['param_bytes_a_rank']} parameter bytes "
              f"a rank, the design's {r['design_param_bytes']}")
        check(r["replicas_equal"],
              f"ep_ranks {tag}: replicas differ across ranks")
        check(r["collectives_a_step"] == r["design"],
              f"ep_ranks {tag}: collectives {r['collectives_a_step']}, the "
              f"design's {r['design']}")
        check(all(x["held"] == r["experts_held"] for x in
                  (rk[tag] for rk in ranks)),
              f"ep_ranks {tag}: ranks hold different expert shapes")
    check(line[EP_CKPT_JOB]["resume_bit_equal"],
          f"ep_ranks: resumed {line[EP_CKPT_JOB]['resumed_losses']}")
    return line


# -- pipeline parallelism ----------------------------------------------------
PP_MICRO = 4                 # GPT2Pipe's microbatches (B = 8: 2 rows each)
PP_TRAIN_STEPS = 6           # runner_train's first 6 batches
PP_LOSS_RTOL = 1e-4          # bf16 against NoShard: the losses move ~1e-3
#                              over the steps, so a broken stage shows
PP_GRAD_NORM_RTOL = 1e-2     # bf16: each group's first-step gradient norm
#                              (a block, wte, wpe, ln_f) against NoShard's
PP_RANKS = 4
PP_RANKS_STEPS = 3
PP_JOBS = {"pp4": (1, 4), "dp2_pp2": (2, 2)}
PP_CKPT_JOB = "pp4"          # saved after 2 steps, resumed for the third
PP_RESHARD_DST = (2, 2)      # its state after the steps moved to (dp, pp)
PP_EXEC_LAYERS = 8           # 4 stages of 2 blocks, or 8 virtual stages of 1
PP_EXEC_MICRO = 8            # DualPipeV needs 2 x 4; interleaved 4 | 8
PP_EXEC_ROWS = (1, 256)      # a microbatch: 1 sequence of 256 tokens
PP_EXEC_LOSS_RTOL = 1e-5     # fp32, TF32 off: sums in another order only
PP_EXEC_GRAD_TOL = 1e-4      # of each gradient tensor's largest element
PP_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("zb", 1), ("interleaved", 2),
                ("interleaved_zb", 2), ("looped_bfs", 2), ("zbv", 2),
                ("dualpipev", 2))


def _pp_launches(n_layer: int, remat: bool, n_micro: int = PP_MICRO) -> dict:
    """B1-B3's launches a step on a stage of ``n_layer`` blocks: one B1, B2
    and B3 a block and microbatch, and B1 once more under remat (the
    backward recomputes each stage application)."""
    per = n_layer * n_micro
    return {"fwd": per * (2 if remat else 1), "dq": per, "dkv": per}


def _pp_card_trainer(mesh, remat, seed=2, dp_axis=None, capturable=True,
                     dropout=0.0):
    """GPT2Pipe over ``mesh`` with runner_train's model and step: GPT-2
    125M, bf16, flash attention, AdamW (weights drawn as
    ``gpt2_125m(seed=seed)`` draws them)."""
    model = GPT2Pipe(GPT2Config(dtype=torch.bfloat16,
                                attn_impl=fa.flash_attention,
                                dropout=dropout), mesh,
                     dp_axis=dp_axis, n_microbatches=PP_MICRO, remat=remat,
                     seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=capturable)
    trainer = Trainer(model, opt, PipelineParallel(mesh, dp_axis=dp_axis),
                      loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def _record_grad_norms(trainer) -> dict:
    """Make ``trainer``'s next step record, into the dict returned, the
    norm of each parameter group's reduced gradient (a block ``h.{i}``,
    ``wte``, ``wpe``, ``ln_f``) as a tensor; later steps record nothing."""
    names = [n for n, p in trainer.model.named_parameters()
             if p.requires_grad]
    strategy = trainer.strategy
    reduce = strategy.reduce_grads
    out = {}

    def recording(grads):
        grads = reduce(grads)
        del strategy.reduce_grads          # the class's method again
        sq = {}
        for name, g in zip(names, grads):
            parts = name.split(".")
            key = ".".join(parts[:2]) if parts[0] == "h" else parts[0]
            sq[key] = sq.get(key, 0) + (g.float() ** 2).sum()
        out.update({k: v.sqrt() for k, v in sq.items()})
        return grads

    strategy.reduce_grads = recording
    return out


def _grad_norm_errs(got: dict, want: dict) -> dict:
    """Each group's relative difference of gradient norms (floats)."""
    return {k: abs(got[k] - want[k]) / want[k] for k in got}


def _noshard_grad_norms(batch, **cfg) -> dict:
    """NoShard's first-step gradient norm of each group on ``batch``, from
    the weights every pp phase draws (``gpt2_125m(seed=2)``)."""
    trainer, state = _trainer(seed=2, dtype=torch.bfloat16,
                              attn_impl=fa.flash_attention, **cfg)
    norms = _record_grad_norms(trainer)
    trainer.step(state, batch)
    out = {k: float(v) for k, v in norms.items()}
    del trainer, state
    torch.cuda.empty_cache()
    return out


def pp_train_phase(noshard_runs):
    """GPT2Pipe at pp 1 on the one-rank NCCL group, remat on and off:
    runner_train's first PP_TRAIN_STEPS batches, the eager loop twice and
    ``Trainer.run`` (``_runner_runs``), the losses against runner_train's
    NoShard eager losses (within PP_LOSS_RTOL), each group's first-step
    gradient norm against NoShard's (within PP_GRAD_NORM_RTOL), B1-B3's
    wrapper launches exactly ``_pp_launches`` a step (eager) and at the
    warm-up and capture (runner), and in a device trace of 3 replays.
    Then with dropout DROPOUT_RATE (remat on): the runner captures the
    step (the masks come from the card generator) and equals the eager
    loop within its spread. Returns B1-B3's launches a step as measured:
    the eager loop's wrapper counts and the replays' device trace."""
    mesh = init_device_mesh((1,), ("pp",))
    n_layer = GPT2Config().n_layer
    batches = _lm_batches(10, 8, 1024, seed=12)[:PP_TRAIN_STEPS]
    noshard = noshard_runs["eager_a"]["losses"][:PP_TRAIN_STEPS]
    ref_norms = _noshard_grad_norms(batches[0])
    bf16_peak, _, _ = peaks()
    line = {"phase": "pp_train", "model": "gpt2-125m", "dtype": "bfloat16",
            "global_batch": 8, "seq_len": 1024, "pp": 1,
            "n_microbatches": PP_MICRO, "steps": PP_TRAIN_STEPS,
            "noshard_losses": noshard, "loss_rtol": PP_LOSS_RTOL,
            "grad_norm_rtol": PP_GRAD_NORM_RTOL,
            "noshard_grad_norms": ref_norms}
    per_step = {}
    for remat in (True, False):
        tag = "remat" if remat else "no_remat"
        recorded = []

        def build():
            trainer, state = _pp_card_trainer(mesh, remat)
            if not recorded:                    # eager_a's first step
                recorded.append(_record_grad_norms(trainer))
            return trainer, state

        runs, spread, got = _runner_runs(build, batches, f"pp_train {tag}")
        norms = {k: float(v) for k, v in recorded[0].items()}
        norm_err = _grad_norm_errs(norms, ref_norms)
        runner, trainer, state = runs["runner"].pop("_runner")
        check(runner.graphs, f"pp_train {tag}: the NCCL pipeline was not "
                             "captured")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        for run in runs.values():
            run["tokens_per_s"] = 8 * 1024 / run["step_s"]
            run["mfu"] = 6 * n_params * run["tokens_per_s"] / bf16_peak
        want = _pp_launches(n_layer, remat)
        warm = {k: v * (AsyncRunner.warmup_steps + 1) for k, v in want.items()}
        expect_calls = {name: want[key] for name, key in
                        zip(SM90_KERNELS, CAUSAL_KEYS)}
        expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})
        (device, calls, spans, wall_ms, _), first = recounted(
            lambda: _replay_window(runner, state, batches, 3, expect_calls),
            lambda r: r[1] == expect_calls)
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        rel = [abs(a - b) / abs(b) for a, b in zip(runs["eager_a"]["losses"],
                                                   noshard)]
        per_step[tag] = {
            "eager": {k: runs["eager_a"]["launches"][k] / PP_TRAIN_STEPS
                      for k in CAUSAL_KEYS},
            "replayed": {key: calls[name] for name, key in
                         zip(SM90_KERNELS, CAUSAL_KEYS)}}
        line[tag] = {
            "eager_spread": spread, "runner_vs_eager": got,
            "loss_rel_err": rel, "grad_norms": norms,
            "grad_norm_rel_err": norm_err,
            "launches_per_step": per_step[tag],
            "launches_per_step_expected": want,
            "runner_launches_expected": warm, "n_params": n_params,
            "replayed": {"calls_per_step": calls, "first_window": first
                         and first[1], "replays": len(spans),
                         "replay_ms_per_step": _spans_ms(spans) / 3,
                         "device_busy_ms_per_step": busy_ms / 3,
                         "wall_ms_per_step": wall_ms / 3},
            **runs}
        check(max(rel) <= PP_LOSS_RTOL,
              f"pp_train {tag}: losses {runs['eager_a']['losses']} vs "
              f"NoShard {noshard}")
        check(sorted(norms) == sorted(ref_norms)
              and max(norm_err.values()) <= PP_GRAD_NORM_RTOL,
              f"pp_train {tag}: gradient norms {norms} vs NoShard "
              f"{ref_norms}")
        for run in ("eager_a", "eager_b"):
            check(runs[run]["launches"] == {
                **{k: v * PP_TRAIN_STEPS for k, v in want.items()},
                **{k: 0 for k in MASKED_KEYS}},
                f"pp_train {tag} {run}: launches {runs[run]['launches']}, "
                f"{want} a step expected")
        check(all(runs["runner"]["launches"][k] == warm[k]
                  for k in CAUSAL_KEYS),
              f"pp_train {tag}: runner launches {runs['runner']['launches']}"
              f", expected {warm}")
        check(len(spans) == 3 and calls == expect_calls,
              f"pp_train {tag}: replayed calls {calls}, expected "
              f"{expect_calls}")
        del runner, trainer, state, runs
        torch.cuda.empty_cache()
    # dropout: the card generator's masks, captured with the step
    druns, dspread, dgot = _runner_runs(
        lambda: _pp_card_trainer(mesh, True, dropout=DROPOUT_RATE),
        batches, "pp_train dropout")
    runner = druns["runner"].pop("_runner")[0]
    line["dropout"] = {
        "rate": DROPOUT_RATE, "remat": True, "captured": runner.graphs,
        "eager_spread": dspread, "runner_vs_eager": dgot,
        "losses": druns["runner"]["losses"],
        "runner_step_s": druns["runner"]["step_s"],
        "eager_step_s": druns["eager_a"]["step_s"]}
    del runner, druns
    torch.cuda.empty_cache()
    emit(line)
    check(line["dropout"]["captured"],
          "pp_train dropout: the step with dropout was not captured")
    check(all(a != b for a, b in zip(line["dropout"]["losses"],
                                     line["remat"]["eager_a"]["losses"])),
          "pp_train dropout: the losses are those without dropout")
    return per_step


def _pp_steps(trainer, state, batches):
    out = {"losses": [], "step_s": [], "launches": []}
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:
            comm.reset_counts()
            stage_links.reset_counts()
        _reset_flash_counts()
        # graftlint: disable-next-line=host-sync-in-hot-loop -- opens the timed step: step_s is each step's latency
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        # graftlint: disable-next-line=host-sync-in-hot-loop -- the loss read closes the timed step
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({k: fa.launches[k] for k in CAUSAL_KEYS})
    out["links"] = dict(stage_links.counts)
    out["counts"] = dict(comm.counts)
    return state, out


def _exec_blocks(device):
    """The executor's model: GPT-2 125M's first PP_EXEC_LAYERS blocks
    (fp32, flash attention on its CUDA-core kernels), seed 5."""
    return GPT2(GPT2Config(n_layer=PP_EXEC_LAYERS,
                           attn_impl=fa.flash_attention),
                device=device, seed=5).h


def _exec_data(device):
    g = torch.Generator(device="cpu").manual_seed(17)
    shape = (*PP_EXEC_ROWS, GPT2Config().n_embd)
    mbs = [torch.randn(shape, generator=g).to(device)
           for _ in range(PP_EXEC_MICRO)]
    tgts = [torch.randn(shape, generator=g).to(device)
            for _ in range(PP_EXEC_MICRO)]
    return mbs, tgts


def _exec_loss(y, t):
    return ((y.float() - t) ** 2).mean()


def _exec_stages(schedule, n_chunks, rank):
    """The virtual stages rank ``rank`` hosts, by chunk, and the blocks of
    each (every virtual stage runs PP_EXEC_LAYERS / virtual stages)."""
    n_virtual = PP_RANKS * n_chunks
    if schedule in ("zbv", "dualpipev"):
        vs = [rank, 2 * PP_RANKS - 1 - rank]
    else:
        vs = [c * PP_RANKS + rank for c in range(n_chunks)]
    per = PP_EXEC_LAYERS // n_virtual
    return vs, [list(range(v * per, (v + 1) * per)) for v in vs]


def _pp_exec_rank(rank, device, ref_path):
    """Every schedule twice on the four ranks: the loss on the rank of the
    last virtual stage, each hosted block's gradients against the
    parent's plain autograd (``ref_path``: the worst error over the
    gradient's largest element, and how many were held), whether the two
    runs agree bit for bit, the second run's time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)
    blocks = _exec_blocks(device)
    mbs, tgts = _exec_data(device)
    out = {}
    for schedule, n_chunks in PP_SCHEDULES:
        vs, layers = _exec_stages(schedule, n_chunks, rank)
        chunks = [[p for i in ls for p in blocks[i].parameters()]
                  for ls in layers]
        by_first = {id(c[0]): [blocks[i] for i in ls]
                    for c, ls in zip(chunks, layers)}

        def stage_fn(params, x):
            for block in by_first[id(params[0])]:
                x = block(x)
            return x

        last = PP_RANKS * n_chunks - 1
        ex = EagerPipelineExecutor(
            stage_fn, chunks if n_chunks > 1 else chunks[0],
            dist.group.WORLD, loss_fn=_exec_loss if last in vs else None,
            schedule=schedule, n_chunks=n_chunks)
        kwargs = {}
        if 0 in vs:
            kwargs["microbatches"] = mbs
        if last in vs:
            kwargs["targets"] = tgts
        if not kwargs:
            kwargs["n_microbatches"] = PP_EXEC_MICRO
        runs = []
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = ex.run(**kwargs)
            torch.cuda.synchronize()
            runs.append((loss, grads, time.perf_counter() - t0))
        (loss, grads, _), (loss2, grads2, step_s) = runs
        grads = grads if n_chunks > 1 else [grads]
        grads2 = grads2 if n_chunks > 1 else [grads2]
        names = [[f"h.{i}.{n}" for i in ls for n, _ in
                  blocks[i].named_parameters()] for ls in layers]
        errs = [float((g.detach().cpu() - ref[n]).abs().max())
                / float(ref[n].abs().max())
                for ns, gs in zip(names, grads) for n, g in zip(ns, gs)]
        out[schedule] = {
            "stages": vs, "step_s": step_s,
            "loss": None if loss is None else float(loss),
            "repeat_equal": (loss is None or float(loss) == float(loss2))
            and all(torch.equal(a, b) for c1, c2 in zip(grads, grads2)
                    for a, b in zip(c1, c2)),
            "worst_grad_err_of_max": max(errs), "grads_held": len(errs)}
    return out


def _pp_rank(rank, out_dir, batches, device, grid_in, ep_in):
    """One of PP_RANKS ranks sharing the card over gloo: first ep_ranks'
    work (``_ep_rank``); each PP_JOBS
    mesh, PP_RANKS_STEPS eager steps of GPT2Pipe (PP_CKPT_JOB saves after
    2 steps and a fresh trainer restored from it takes the third again);
    then every executor schedule, held against the reference the parent
    wrote to ``exec_ref.pt``; then grid_ranks' work (``_grid_rank``: the
    same four processes, so no second start). ``timing_s``: seconds from
    the start of the rank's work to each part."""
    result = {"rank": rank, "timing_s": {}}
    t0 = time.perf_counter()
    try:
        _build.load_all(LIBRARIES)
        result["ep"] = _ep_rank(rank, out_dir, ep_in["batches"], device)
        result["timing_s"]["after_ep"] = time.perf_counter() - t0
        for tag, shape in PP_JOBS.items():
            result["timing_s"][f"before_{tag}"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            mesh = init_device_mesh(shape, ("dp", "pp"))
            trainer, state = _pp_card_trainer(mesh, True, dp_axis="dp",
                                              capturable=False)
            norms = _record_grad_norms(trainer)
            model, opt = trainer.model, trainer.optimizer
            r = {"stage": trainer.strategy.stage_index,
                 "dp": trainer.strategy.data_shard_index,
                 "layers": list(model.layers),
                 "param_bytes": sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
                 "opt_bytes": sum(v.numel() * v.element_size()
                                  for st in opt.state.values()
                                  for v in st.values())}
            if tag == PP_CKPT_JOB:
                state, first = _pp_steps(trainer, state, batches[:2])
                ckpt = f"{out_dir}/ckpt"
                ts = time.perf_counter()
                with CheckpointManager(ckpt) as mgr:
                    mgr.save(state.step, get_state_dict(trainer, state))
                r["save_s"] = time.perf_counter() - ts
                state, last = _pp_steps(trainer, state, batches[2:])
                steps = {k: first[k] + last[k] if isinstance(first[k], list)
                         else last[k] for k in first}
                fresh, fstate = _pp_card_trainer(mesh, True, seed=8,
                                                 dp_axis="dp",
                                                 capturable=False)
                ts = time.perf_counter()
                with CheckpointManager(ckpt) as mgr:
                    fstate = set_state_dict(fresh, fstate, mgr.restore(
                        get_state_dict(fresh, fstate)))
                r["restore_s"] = time.perf_counter() - ts
                fstate, again = _pp_steps(fresh, fstate, batches[2:])
                r["resumed_losses"] = again["losses"]
                r["resumed_hash"] = _param_hash(fresh.model.parameters())
                del fresh, fstate
                # the state after the steps moved to (dp 2, pp 2) without a
                # checkpoint, against a DCP round of it
                ts = time.perf_counter()
                dst = init_device_mesh(PP_RESHARD_DST, ("dp", "pp"))
                r["reshard"] = _reshard_round(
                    trainer, state, placed_state(trainer, state),
                    PipelineParallel(dst, dp_axis="dp"),
                    lambda seed: _pp_card_trainer(dst, True, seed=seed,
                                                  dp_axis="dp",
                                                  capturable=False),
                    batches[-1], device, f"{out_dir}/ckpt_rs")
                r["reshard"]["wall_s"] = time.perf_counter() - ts
            else:
                state, steps = _pp_steps(trainer, state, batches)
            r.update(steps)
            r["grad_norms"] = {k: float(v) for k, v in norms.items()}
            r["hash"] = _param_hash(model.parameters())
            r["table_hash"] = _param_hash(
                p for n, p in model.named_parameters()
                if not n.startswith("h."))
            r["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
                device)
            result[tag] = r
            del trainer, state, model, opt
        torch.cuda.empty_cache()
        result["timing_s"]["before_executor"] = time.perf_counter() - t0
        result["executor"] = _pp_exec_rank(rank, device,
                                           f"{out_dir}/exec_ref.pt")
        result["timing_s"]["before_grid"] = time.perf_counter() - t0
        result["grid"] = _grid_rank(rank, device, out_dir, grid_in)
        result["timing_s"]["end"] = time.perf_counter() - t0
    finally:
        torch.save(result, f"{out_dir}/pp_rank{rank}.pt")


def _pp_exec_reference(device):
    """Plain autograd of the same blocks: the mean over the microbatches
    of the loss, its gradient by parameter name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = _exec_blocks(device)
    mbs, tgts = _exec_data(device)
    total = 0.0
    for x, t in zip(mbs, tgts):
        for block in blocks:
            x = block(x)
        total = total + _exec_loss(x, t)
    loss = total / len(mbs)
    loss.backward()
    grads = {f"h.{i}.{n}": p.grad.detach().cpu()
             for i, b in enumerate(blocks) for n, p in b.named_parameters()}
    return float(loss), grads


def pp_ranks_phase(pool, smi):
    """PP_RANKS spawned ranks on the one card over gloo (see ``_pp_rank``),
    against NoShard in this process on the same global batches (losses
    within PP_LOSS_RTOL) and plain autograd of the executor's blocks (the
    loss within PP_EXEC_LOSS_RTOL, each gradient within PP_EXEC_GRAD_TOL of
    its largest element): each rank's layers and the replicated tables
    (parameter bytes against the design's), the tables bit for bit on
    every rank, the host-staged link bytes and messages a step and
    B1-B3's launches a step against the shapes' count, the checkpoint
    resumed bit for bit, step time and peak memory a rank. Then, from the
    same ranks, grid_ranks' line (``_grid_ranks_report``)."""
    import tempfile

    device = torch.device("cuda", 0)
    ep_in = _ep_reference()
    grid_in = _grid_reference(device)
    batches = _lm_batches(PP_RANKS_STEPS, 8, 1024, seed=71)
    trainer, state = _trainer(seed=2, dtype=torch.bfloat16,
                              attn_impl=fa.flash_attention)
    norms = _record_grad_norms(trainer)
    noshard = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        noshard.append(float(m["loss"]))
    ref_norms = {k: float(v) for k, v in norms.items()}
    del trainer, state
    ref_loss, ref_grads = _pp_exec_reference(device)
    torch.cuda.empty_cache()
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        torch.save(ref_grads, f"{out_dir}/exec_ref.pt")
        wall_s = pool.run(_pp_rank, (out_dir, batches, device, grid_in,
                                     ep_in), 560, "pp_ranks")
        ranks = [torch.load(f"{out_dir}/pp_rank{r}.pt", weights_only=False)
                 for r in range(PP_RANKS)]
    _ep_ranks_report([r["ep"] for r in ranks], ep_in)
    cfg = GPT2Config()
    C, T = cfg.n_embd, 1024
    block = 12 * C * C + 13 * C
    tables = cfg.vocab_size * C + cfg.n_positions * C + 2 * C
    line = {"phase": "pp_ranks", "ranks": PP_RANKS, "backend": "gloo",
            "wall_s": wall_s, "model": "gpt2-125m", "dtype": "bfloat16",
            "global_batch": 8, "seq_len": T, "n_microbatches": PP_MICRO,
            "remat": True, "steps": PP_RANKS_STEPS, "loss_rtol": PP_LOSS_RTOL,
            "noshard_losses": noshard, "grad_norm_rtol": PP_GRAD_NORM_RTOL,
            "noshard_grad_norms": ref_norms}
    for tag, (dp, pp) in PP_JOBS.items():
        rs = [r[tag] for r in ranks]
        per = cfg.n_layer // pp
        act = (8 // dp // PP_MICRO) * T * C * 2          # bf16 [mb, T, C]
        mean = [float(np.mean([rs[d * pp]["losses"][i] for d in range(dp)]))
                for i in range(PP_RANKS_STEPS)]
        rel = [abs(a - b) / abs(b) for a, b in zip(mean, noshard)]
        design = []
        for r in rs:
            s = r["stage"]
            msgs = PP_MICRO * ((2 if s < pp - 1 else 0) + (2 if s > 0 else 0))
            design.append({"messages": msgs, "host_staged_bytes": msgs * act,
                           "launches": _pp_launches(per, True)})
        got = [{"messages": r["links"]["sends"] + r["links"]["recvs"],
                "host_staged_bytes": r["links"]["host_staged_bytes"],
                "launches": r["launches"][-1]} for r in rs]
        # each rank's groups: its stage's blocks and the tables (the same
        # on every rank after the reduction)
        norm_err = [_grad_norm_errs(r["grad_norms"], ref_norms) for r in rs]
        line[tag] = {
            "mean_losses": mean, "loss_rel_err": rel,
            "grad_norm_rel_err": norm_err,
            "groups_seen": sorted({k for r in rs for k in r["grad_norms"]}),
            "layers": [r["layers"] for r in rs],
            "param_bytes_a_rank": [r["param_bytes"] for r in rs],
            "design_param_bytes": (per * block + tables) * 4,
            "opt_bytes_a_rank": [r["opt_bytes"] for r in rs],
            "link_bytes_each_way": PP_MICRO * act,
            "bubble": (pp - 1) / (PP_MICRO + pp - 1),
            "per_step": got, "design": design,
            "collectives_last_step": rs[0]["counts"],
            "tables_equal": len({r["table_hash"] for r in rs}) == 1,
            "step_s": [r["step_s"] for r in rs],
            "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                           for r in rs]}
        if tag == PP_CKPT_JOB:
            line[tag].update(
                save_s=[r["save_s"] for r in rs],
                restore_s=[r["restore_s"] for r in rs],
                resumed_losses=[r["resumed_losses"] for r in rs],
                resume_bit_equal=all(
                    r["resumed_losses"] == r["losses"][2:]
                    and r["resumed_hash"] == r["hash"] for r in rs))
    execs = {}
    for schedule, n_chunks in PP_SCHEDULES:
        got = [r["executor"][schedule] for r in ranks]
        losses = [g["loss"] for g in got if g["loss"] is not None]
        execs[schedule] = {
            "n_chunks": n_chunks, "stages": [g["stages"] for g in got],
            "loss": losses, "loss_rel_err": [abs(x - ref_loss) / abs(ref_loss)
                                             for x in losses],
            "worst_grad_err_of_max": max(g["worst_grad_err_of_max"]
                                         for g in got),
            "grads_seen": sum(g["grads_held"] for g in got),
            "repeat_equal": all(g["repeat_equal"] for g in got),
            "step_s": [g["step_s"] for g in got]}
    line["rank_timing_s"] = [r["timing_s"] for r in ranks]
    line["executor"] = {"layers": PP_EXEC_LAYERS, "dtype": "float32",
                        "tf32": False, "microbatches": PP_EXEC_MICRO,
                        "rows": PP_EXEC_ROWS, "reference_loss": ref_loss,
                        "loss_rtol": PP_EXEC_LOSS_RTOL,
                        "grad_tol": PP_EXEC_GRAD_TOL, **execs}
    emit(line)
    for tag, (dp, pp) in PP_JOBS.items():
        r = line[tag]
        check(max(r["loss_rel_err"]) <= PP_LOSS_RTOL,
              f"pp_ranks {tag}: losses {r['mean_losses']} vs NoShard "
              f"{noshard}")
        check(r["groups_seen"] == sorted(ref_norms)
              and max(max(e.values()) for e in r["grad_norm_rel_err"])
              <= PP_GRAD_NORM_RTOL,
              f"pp_ranks {tag}: gradient norms' errors "
              f"{r['grad_norm_rel_err']} (groups {r['groups_seen']})")
        check(all(b == r["design_param_bytes"]
                  for b in r["param_bytes_a_rank"]),
              f"pp_ranks {tag}: parameter bytes {r['param_bytes_a_rank']}, "
              f"the design's {r['design_param_bytes']}")
        check(r["per_step"] == r["design"],
              f"pp_ranks {tag}: links and launches a step {r['per_step']}, "
              f"the design's {r['design']}")
        check(r["tables_equal"], f"pp_ranks {tag}: tables differ")
    check(line[PP_CKPT_JOB]["resume_bit_equal"],
          f"pp_ranks: resumed {line[PP_CKPT_JOB]['resumed_losses']}")
    _reshard_report("pp_reshard", [r[PP_CKPT_JOB]["reshard"] for r in ranks],
                    smi, PP_JOBS[PP_CKPT_JOB], PP_RESHARD_DST, _pp_launches(
                        cfg.n_layer // PP_RESHARD_DST[1], True))
    for schedule, e in execs.items():
        check(len(e["loss"]) == 1 and e["loss_rel_err"][0]
              <= PP_EXEC_LOSS_RTOL,
              f"pp_ranks executor {schedule}: loss {e['loss']} vs "
              f"{ref_loss}")
        check(e["grads_seen"] == len(ref_grads)
              and e["worst_grad_err_of_max"] <= PP_EXEC_GRAD_TOL
              and e["repeat_equal"],
              f"pp_ranks executor {schedule}: {e['grads_seen']} gradients, "
              f"worst {e['worst_grad_err_of_max']}, repeat "
              f"{e['repeat_equal']}")
    _grid_ranks_report(smi, ranks, grid_in)
    return line


# -- observability: the profiler, the memory breakdown, the flight recorder --
OBS_WARMUP, OBS_STEPS = 2, 3     # StepProfiler's warm-up and captured steps
FR_STALL_TIMEOUT_S = 1.0         # the watchdog's timeout in the stall
FR_STALL_JOIN_S = 2.5            # the other ranks join rank 0 this late


def observability_phase(smi):
    """On the one-rank NCCL group: ``StepProfiler`` (warm-up OBS_WARMUP,
    OBS_STEPS captured) over replayed steps of the train
    cell's trainer (runner_train's) through ``AsyncRunner``, one replay
    and one sync a step: its ``trace_op_breakdown`` must count B1-B3
    n_layer times each a captured step, and its ``total_ms`` must lie
    between half the CUDA-event span of those replays and the span;
    ``memory_breakdown`` of one eager step (the batch's card tensors as
    the arguments): ``argument_size`` exactly their bytes and a positive
    ``temp_size``; the process group's eager collectives on NCCL in the
    flight recorder (which must have loaded), completed with their bytes;
    ``nan_check`` raising on a card tensor holding an inf."""
    import tempfile

    t_phase = time.perf_counter()
    n_layer = GPT2Config().n_layer
    batches = _lm_batches(OBS_WARMUP + OBS_STEPS + 1, 8, 1024, seed=43)
    trainer, state = _gpt2_runner_trainer()
    runner = AsyncRunner(trainer, depth=2, drain_every=len(batches))
    runner.start(state, batches[0])
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as log_dir:
        sp = observability.StepProfiler(log_dir, n_steps=OBS_STEPS,
                                        warmup=OBS_WARMUP)
        with replay_spans() as spans:
            for batch in batches[1:]:
                with sp.step():
                    runner.submit(batch)
                    runner.sync()
        summary = sp.summary()
    state, _ = runner.finish()
    span_ms = _spans_ms(spans[OBS_WARMUP:OBS_WARMUP + OBS_STEPS])
    calls = {name: sum(n for k, n in summary.get("calls", {}).items()
                       if name in k) / OBS_STEPS for name in SM90_KERNELS}
    x, y = (torch.from_numpy(a).cuda() for a in batches[0])
    mem = observability.memory_breakdown(
        lambda xb, yb: trainer.step(state, (xb, yb))[1]["loss"], x, y)
    del runner, trainer, state
    torch.cuda.empty_cache()

    pg = pdist.get_default_group()
    fr = observability.get_flight_recorder()
    t = torch.ones(1024, device="cuda")
    pg.all_reduce(t).result()
    pg.broadcast(t, 0).result()
    pg.all_gather(t).result()
    pg.barrier().result()
    torch.cuda.synchronize()
    entries = [e for e in fr.dump() if e["group"] == pg.group_name][-4:]
    bad = torch.ones(4, device="cuda")
    bad[2] = float("inf")
    try:
        observability.nan_check({"w": bad}, name="grads")
        nan_error = None
    except FloatingPointError as e:
        nan_error = str(e)
    observability.nan_check({"w": torch.ones(4, device="cuda")})
    line = {"phase": "observability", "nvidia_smi": smi,
            "step_profiler": {
                "warmup": OBS_WARMUP, "n_steps": OBS_STEPS,
                "steps_captured": summary.get("steps_captured"),
                "error": summary.get("error"),
                "total_ms": summary.get("total_ms"),
                "replay_span_ms": span_ms, "replays": len(spans),
                "flash_calls_per_step": calls,
                "top_ops_ms": summary.get("top_ops_ms", [])[:6]},
            "memory_breakdown": mem,
            "batch_bytes": x.nbytes + y.nbytes,
            "flight_recorder": {"loaded": pg._fr is not None,
                                "group": pg.group_name, "entries": entries},
            "nan_check": nan_error,
            "phase_s": time.perf_counter() - t_phase}
    emit(line)
    sp_line = line["step_profiler"]
    check(sp_line["steps_captured"] == OBS_STEPS and len(spans) == len(
        batches) - 1, f"observability: captured {sp_line['steps_captured']} "
          f"steps ({sp_line['error']}), {len(spans)} replays")
    check(calls == {name: n_layer for name in SM90_KERNELS},
          f"observability: B1-B3 per captured step {calls}, want {n_layer}")
    check(0.5 * span_ms <= sp_line["total_ms"] <= span_ms,
          f"observability: kernels {sp_line['total_ms']} ms against the "
          f"replays' span {span_ms} ms")
    check(mem["argument_size"] == line["batch_bytes"]
          and mem["temp_size"] > 0,
          f"observability: memory_breakdown {mem}")
    check(line["flight_recorder"]["loaded"] and fr is pg._fr
          and [(e["op"], e["bytes"], e["status"]) for e in entries] == [
              ("all_reduce", 4096, "completed"),
              ("broadcast", 4096, "completed"),
              ("all_gather", 4096, "completed"),
              ("barrier", 0, "completed")],
          f"observability: flight recorder {line['flight_recorder']}")
    check(nan_error == "non-finite values in grads[w]",
          f"observability: nan_check on a card inf: {nan_error}")
    return line


def _fr_stall_rank(rank, out_dir):
    """A stalled collective on the pool's gloo group: rank 0 issues an
    eager ``all_reduce`` under the flight recorder's watchdog
    (FR_STALL_TIMEOUT_S), the other ranks join FR_STALL_JOIN_S later."""
    pg = pdist.get_default_group()
    fr = observability.get_flight_recorder()
    dist.barrier()
    r = {"inflight_before": fr.oldest_inflight_age(),
         "loaded": pg._fr is fr}
    dump = f"{out_dir}/fr_stall.json"
    t = torch.ones(256, device="cuda")
    if rank == 0:
        fr.start_watchdog(FR_STALL_TIMEOUT_S, dump, poll_interval_s=0.1)
        t0 = time.perf_counter()
        out = pg.all_reduce(t).result()
        r["wait_s"] = time.perf_counter() - t0
        r["stalled"] = fr.stalled()
        fr.stop_watchdog()
        r["dump_exists"] = os.path.exists(dump)
        r["report"] = observability.fr_trace(dump) if r["dump_exists"] \
            else None
        r["sum"] = float(out[0])
        r["last"] = fr.dump()[-1]
    else:
        time.sleep(FR_STALL_JOIN_S)
        pg.all_reduce(t).result()
    torch.save(r, f"{out_dir}/fr_stall{rank}.pt")


def fr_stall_phase(pool, smi):
    """``_fr_stall_rank`` on the pool's ranks: the dump exists, the
    watchdog set ``stalled``, ``fr_trace`` of the dump names the
    all_reduce (its group and bytes) as the hang suspect, and the
    all_reduce then completed with every rank's sum."""
    import tempfile

    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as out_dir:
        wall_s = pool.run(_fr_stall_rank, (out_dir,), 60, "fr_stall")
        ranks = [torch.load(f"{out_dir}/fr_stall{r}.pt", weights_only=False)
                 for r in range(FSDP_RANKS)]
    r0 = ranks[0]
    suspect = (r0["report"] or {}).get("hang_suspect") or {}
    line = {"phase": "fr_stall", "nvidia_smi": smi, "backend": "gloo",
            "ranks": FSDP_RANKS, "timeout_s": FR_STALL_TIMEOUT_S,
            "join_after_s": FR_STALL_JOIN_S, "wait_s": r0.get("wait_s"),
            "stalled": r0.get("stalled"), "dump_exists": r0.get("dump_exists"),
            "hang_suspect": suspect, "completed": r0.get("last"),
            "sum": r0.get("sum"),
            "inflight_before": [r["inflight_before"] for r in ranks],
            "phase_s": wall_s}
    emit(line)
    check(all(r["loaded"] and r["inflight_before"] is None for r in ranks),
          f"fr_stall: the recorder held collectives in flight already "
          f"{line['inflight_before']}")
    check(r0["stalled"] and r0["dump_exists"]
          and suspect.get("op") == "all_reduce" and suspect.get(
              "bytes") == 1024 and suspect.get("status") == "scheduled",
          f"fr_stall: watchdog {r0['stalled']}, dump {r0['dump_exists']}, "
          f"suspect {suspect}")
    check(r0["last"]["id"] == suspect["id"]
          and r0["last"]["status"] == "completed"
          and r0["sum"] == float(FSDP_RANKS)
          and r0["wait_s"] >= FR_STALL_TIMEOUT_S,
          f"fr_stall: the all_reduce did not complete after the stall: "
          f"{r0['last']}, sum {r0['sum']}")
    return line


# -- TP x MoE, CP x MoE, the dry-run grid and the EP reshard -----------------
TP_MOE_LOSS_RTOL = 1e-2      # bf16, as the rank phases' limit: the EP
#                              route combines with fp32 gates where NoShard
#                              rounds them to bf16 (2^-8 relative), and the
#                              repeated batch's steps grow the difference
CP_MOE_LOSS_RTOL = 1e-2      # train_bf16_parity's limit: the ring (B4-B6)
#                              against the causal route (B1-B3), bf16
GRID_TP_JOBS = {"dp2_tp2": (2, 2), "dp1_tp4": (1, 4)}
GRID_TP_STEPS = 3
GRID_TP_ROWS = 2 * EP_ROW    # global batch: 4 x 1024, one routing group a
#                              dp row at (2, 2), two at (1, 4)
GRID_TP_LOSS_RTOL = 1e-4     # fp32, TF32 off: sums in another order, and
#                              AdamW's noise-driven elements after step 1
GRID_NORM_RTOL = 1e-4        # each named gradient's first-step norm (fp32)
GRID_NORMS = ("h.1.moe.router.weight", "h.1.moe.experts_up", "wte")
GRID_RESHARD = {"src": (1, 4), "dst": (2, 2)}


def _tp_moe_plan(cut: bool) -> dict:
    """GPT-2's Megatron plan, with ``ExpertParallel`` on the expert stacks
    (``cut``: E split over tp) or without (the stacks whole)."""
    plan = gpt2_tp_plan()
    return {r"moe\.experts_": ExpertParallel(), **plan} if cut else plan


def _tp_moe_trainer(cut: bool):
    """moe_train's NoShard run (GPT-2 125M with MOE_CFG, bf16, flash
    attention, capturable AdamW, seed 2) under ``TensorParallel`` on the
    ``(dp 1, tp n)`` mesh of the process group."""
    n = pdist.get_world_size()
    strategy = TensorParallel(init_device_mesh((1, n), ("dp", "tp")),
                              _tp_moe_plan(cut))
    model = gpt2_125m(device=MOE_DEVICE, seed=2, dtype=torch.bfloat16,
                      attn_impl=fa.flash_attention, **MOE_CFG)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss, policy="bf16")
    return trainer, trainer.init()


def _moe_tokens_rate(step_s: float, bf16_peak: float, counts: dict) -> dict:
    tokens_per_s = MOE_BATCH * MOE_SEQ / step_s
    return {"step_s": step_s, "tokens_per_s": tokens_per_s,
            "mfu_active": 6 * counts["active_params"] * tokens_per_s
            / bf16_peak}


def tp_moe_phase(moe_line):
    """TP x MoE on the one-rank NCCL group (``(dp 1, tp 1)``): moe_train's
    repeated-batch run (GPT-2 125M, E = 8, top-2, B = 8 x 1024, bf16, B1-B3)
    under ``TensorParallel`` with ``ExpertParallel`` in the plan (the MoE
    blocks' f and g over tp), the eager loop twice and ``Trainer.run`` (one
    replay a step), against moe_train's NoShard eager losses (within
    TP_MOE_LOSS_RTOL: the EP route sums the combine in fp32); the stacks
    left whole (the dense route of the MoE, bit for bit NoShard's); B1-B3
    n_layer a step from the wrappers (eager) and in a device trace of 3
    replays; step time, tokens/s, MFU over the active parameters and peak
    memory; the collectives a step."""
    t_phase = time.perf_counter()
    bf16_peak, _, _ = peaks()
    cfg = GPT2Config(**MOE_CFG)
    counts = _moe_counts(cfg)
    n_layer = cfg.n_layer
    steps = MOE_FIXED_STEPS
    batches = _lm_batches(1, MOE_BATCH, MOE_SEQ, seed=51) * steps
    noshard = moe_line["fixed_batch"]["eager_a"]["losses"]
    # the stacks whole: every MoE block the NoShard one
    trainer, state = _tp_moe_trainer(False)
    whole = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        whole.append(float(m["loss"]))
    del trainer, state
    torch.cuda.empty_cache()
    comm.reset_counts()
    runs, spread, got = _runner_runs(lambda: _tp_moe_trainer(True), batches,
                                     "tp_moe")
    collectives = dict(comm.counts)
    runner, trainer, state = runs["runner"].pop("_runner")
    held = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()
            if "moe" in n and n.startswith("h.1.")}
    ep_kind = type(trainer.model.h[1].moe.ep).__name__
    expect_calls = {name: n_layer for name in SM90_KERNELS}
    expect_calls.update({name: 0 for name in MASKED_SM90_KERNELS})
    (device, calls, spans, wall_ms, _), first = recounted(
        lambda: _replay_window(runner, state, batches, 3, expect_calls),
        lambda r: r[1] == expect_calls)
    del runner, trainer, state
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["eager_a"]["losses"],
                                               noshard)]
    line = {"phase": "tp_moe", "model": "gpt2-125m-moe", **MOE_CFG,
            "dtype": "bfloat16", "global_batch": MOE_BATCH,
            "seq_len": MOE_SEQ, "steps": steps, "mesh": {"dp": 1, "tp":
                                                       pdist.get_world_size()},
            "plan": "gpt2_tp_plan + ExpertParallel on moe.experts_*",
            "moe_context": ep_kind, "held_h1_moe": held,
            "active_params": counts["active_params"],
            "noshard_losses": noshard, "loss_rtol": TP_MOE_LOSS_RTOL,
            "loss_rel_err": rel,
            "whole_stacks_losses": whole,
            "whole_stacks_equal_noshard": whole == noshard,
            "eager_spread": spread, "runner_vs_eager": got,
            "collectives_eager_warmup_replays": collectives,
            "launches_per_step_eager": {
                k: runs["eager_a"]["launches"][k] / steps
                for k in CAUSAL_KEYS + MASKED_KEYS},
            "replayed": {"calls_per_step": calls, "first_window":
                         first and first[1], "replays": len(spans),
                         "replay_ms_per_step": _spans_ms(spans) / 3,
                         "device_busy_ms_per_step": sum(
                             e.self_device_time_total for e in device)
                         / 1e3 / 3, "wall_ms_per_step": wall_ms / 3},
            "phase_s": time.perf_counter() - t_phase}
    for run in runs.values():
        run.update(_moe_tokens_rate(run["step_s"], bf16_peak, counts))
    line.update(runs)
    emit(line)
    check(line["whole_stacks_equal_noshard"],
          f"tp_moe: the stacks whole give {whole}, not NoShard's {noshard}")
    check(max(rel) <= TP_MOE_LOSS_RTOL,
          f"tp_moe: losses {runs['eager_a']['losses']} vs NoShard {noshard}")
    check(ep_kind == "EPContext"
          and held["h.1.moe.experts_up"][0] == MOE_CFG["moe_experts"]
          // pdist.get_world_size(),
          f"tp_moe: the MoE layer's context {ep_kind}, stacks {held}")
    for run in ("eager_a", "eager_b"):
        check(runs[run]["launches"] == {
            **{k: n_layer * steps for k in CAUSAL_KEYS},
            **{k: 0 for k in MASKED_KEYS}},
            f"tp_moe {run}: launches {runs[run]['launches']}")
    warm = n_layer * (AsyncRunner.warmup_steps + 1)
    check(all(runs["runner"]["launches"][k] == warm for k in CAUSAL_KEYS),
          f"tp_moe: runner wrapper launches {runs['runner']['launches']}")
    check(len(spans) == 3 and calls == expect_calls,
          f"tp_moe: replayed calls {calls}, expected {expect_calls}")
    return line


def cp_moe_phase(mesh, moe_line):
    """CP x MoE on the one-rank NCCL group: the same model and batches as
    tp_moe under ``CPStrategy`` with ring flash attention at cp 1 (every
    block's attention the diagonal hop through B4-B6), eager, against
    moe_train's NoShard losses (the causal route, B1-B3) within
    CP_MOE_LOSS_RTOL; B4-B6 n_layer a step and no B1-B3; step time, tokens/s
    and peak memory."""
    bf16_peak, _, _ = peaks()
    cfg = GPT2Config(**MOE_CFG)
    counts = _moe_counts(cfg)
    steps = MOE_FIXED_STEPS
    batches = _lm_batches(1, MOE_BATCH, MOE_SEQ, seed=51) * steps
    noshard = moe_line["fixed_batch"]["eager_a"]["losses"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = gpt2_125m(device=MOE_DEVICE, seed=2, dtype=torch.bfloat16,
                      attn_impl=make_ring_attention(mesh, "cp"), **MOE_CFG)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8, capturable=True)
    trainer = Trainer(model, opt, CPStrategy(mesh), loss_fn=lm_loss,
                      policy="bf16")
    state = trainer.init()
    _reset_flash_counts()
    losses = []
    for i, batch in enumerate(batches):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    launches = dict(fa.launches)
    del trainer, state, model, opt
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, noshard)]
    n_layer = cfg.n_layer
    line = {"phase": "cp_moe", "model": "gpt2-125m-moe", **MOE_CFG,
            "dtype": "bfloat16", "attn": "ring flash (B4-B6)",
            "cp": mesh.size("cp"), "global_batch": MOE_BATCH,
            "seq_len": MOE_SEQ, "steps": steps, "losses": losses,
            "noshard_losses": noshard, "loss_rtol": CP_MOE_LOSS_RTOL,
            "loss_rel_err": rel, "launches": launches,
            "launches_per_step": {k: launches[k] / steps
                                  for k in CAUSAL_KEYS + MASKED_KEYS},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            **_moe_tokens_rate(step_s, bf16_peak, counts)}
    emit(line)
    check(all(np.isfinite(losses)) and max(rel) <= CP_MOE_LOSS_RTOL,
          f"cp_moe: losses {losses} vs the causal route's {noshard}")
    check(all(launches[k] == n_layer * steps for k in MASKED_KEYS)
          and not any(launches[k] for k in CAUSAL_KEYS),
          f"cp_moe: launches {launches}, n_layer x steps of B4-B6 and none "
          "of B1-B3 expected")
    return line


def _record_param_norms(trainer, names) -> dict:
    """Make ``trainer``'s next step record, into the dict returned, the
    whole norm of each named parameter's reduced gradient (a tp block's
    squares summed over tp); later steps record nothing."""
    params = [(n, p) for n, p in trainer.model.named_parameters()
              if p.requires_grad]
    strategy = trainer.strategy
    reduce = strategy.reduce_grads
    out = {}

    def recording(grads):
        grads = reduce(grads)
        del strategy.reduce_grads          # the class's method again
        for (name, p), g in zip(params, grads):
            if name not in names:
                continue
            sq = (g.float() ** 2).sum()
            spec = getattr(p, "tp", None)
            if spec is not None and spec.size > 1:
                dist.all_reduce(sq, group=spec.group)
            out[name] = float(sq.sqrt())
        return grads

    strategy.reduce_grads = recording
    return out


def _grid_tp_trainer(mesh, device, sp=False):
    """ep_ranks' model in fp32 (TF32 off) under ``TensorParallel`` with
    ``ExpertParallel`` in the plan on ``mesh`` (NoShard without one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = gpt2_125m(device=device, seed=7, attn_impl=fa.flash_attention,
                      n_layer=EP_RANKS_LAYERS,
                      moe_group_size=EP_ROW * MOE_SEQ, **MOE_CFG)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    strategy = (TensorParallel(mesh, _tp_moe_plan(True),
                               sequence_parallel=sp)
                if mesh is not None else NoShard(device))
    trainer = Trainer(model, opt, strategy, loss_fn=lm_loss)
    return trainer, trainer.init()


def _grid_reference(device):
    """NoShard in this process for the grid ranks' TP x MoE jobs:
    GRID_TP_STEPS losses on the global batches and the first step's
    GRID_NORMS gradient norms."""
    batches = _lm_batches(GRID_TP_STEPS, GRID_TP_ROWS, MOE_SEQ, seed=81)
    trainer, state = _grid_tp_trainer(None, device)
    norms = _record_param_norms(trainer, GRID_NORMS)
    losses = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    del trainer, state
    torch.cuda.empty_cache()
    return {"batches": batches, "losses": losses, "norms": dict(norms)}


def _grid_tp_rank(device, batches) -> dict:
    """GRID_TP_JOBS, sequence parallelism off and on: ep_ranks' model in
    fp32 under ``TensorParallel`` with ``ExpertParallel`` in the plan,
    GRID_TP_STEPS eager steps: losses, the first step's GRID_NORMS norms,
    the stacks a rank holds, the collectives of the last step, step time,
    peak."""
    out = {}
    for tag, shape in GRID_TP_JOBS.items():
        for sp in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            mesh = init_device_mesh(shape, ("dp", "tp"))
            trainer, state = _grid_tp_trainer(mesh, device, sp)
            norms = _record_param_norms(trainer, GRID_NORMS)
            state, steps = _ep_steps(trainer, state, batches)
            steps.update(
                norms=dict(norms), dp=trainer.strategy.data_shard_index,
                held=tuple(trainer.model.h[1].moe.experts_up.shape),
                moe_context=type(trainer.model.h[1].moe.ep).__name__,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                    device))
            out[f"{tag}_sp{int(sp)}"] = steps
            del trainer, state
    return out


def _grid_reshard_rank(device, out_dir, batches) -> dict:
    """The EP reshard: ep_ranks' model, one step under
    ``ExpertDataParallel`` at (dp 1, ep 4), its state saved and moved by
    ``reshard_state`` onto ``state_shardings`` at (dp 2, ep 2) (the card's
    peak measured a leaf), loaded into a trainer there; against
    ``resume_from_checkpoint`` of the saved state at (dp 2, ep 2): the
    state bit for bit, and the next step's loss."""
    src = init_device_mesh(GRID_RESHARD["src"], ("dp", "ep"))
    dst = init_device_mesh(GRID_RESHARD["dst"], ("dp", "ep"))
    trainer, state = _ep_trainer(src, device)
    state, first = _ep_steps(trainer, state, batches[:1])
    sd = get_state_dict(trainer, state)
    ckpt = f"{out_dir}/grid_ckpt"
    with CheckpointManager(ckpt) as mgr:
        mgr.save(state.step, sd)
    shardings = state_shardings(sd, ExpertDataParallel(dst))
    rdx.reset_counts()
    rdx.measure_peaks = True
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    moved = reshard_state(sd, shardings, max_staging_bytes=REDIST_STAGING)
    torch.cuda.synchronize(device)
    move_s = time.perf_counter() - t0
    rdx.measure_peaks = False
    nbytes = {k: (_to_local(v).numel() * _to_local(v).element_size(),
                  moved[k].numel() * moved[k].element_size())
              for k, v in sd.items() if "experts" in k and v.dim() == 3}
    peaks_ = {p["name"]: p["measured_peak_bytes"] for p in rdx.leaf_peaks
              if p["name"] in nbytes}
    requested = {p["name"]: p["requested_peak_bytes"]
                 for p in rdx.leaf_peaks if p["name"] in nbytes}
    counts = dict(rdx.counts)
    del trainer, state, sd
    torch.cuda.empty_cache()
    resized, rstate = _ep_trainer(dst, device, seed=8)
    rstate = set_state_dict(resized, rstate, moved)
    del moved
    resumed, qstate = _ep_trainer(dst, device, seed=9)
    qstate = resume_from_checkpoint(ckpt, resumed, qstate)
    live = {k: _to_local(v) for k, v in
            get_state_dict(resized, rstate).items()}
    ref = {k: _to_local(v) for k, v in
           get_state_dict(resumed, qstate).items()}
    equal = live.keys() == ref.keys() and all(
        torch.equal(live[k], ref[k]) for k in ref)
    held = tuple(resized.model.h[1].moe.experts_up.shape)
    del live, ref
    _, a = _ep_steps(resized, rstate, batches[1:2])
    _, b = _ep_steps(resumed, qstate, batches[1:2])
    return {"move_s": move_s, "counts": counts, "leaf_bytes": nbytes,
            "measured_peak_bytes": peaks_,
            "requested_peak_bytes": requested, "state_equal": equal,
            "held": held, "first_loss": first["losses"],
            "next_losses": (a["losses"], b["losses"])}


def _grid_rank(rank, device, out_dir, grid_in) -> dict:
    """The grid_ranks work on one of the four gloo ranks (inside pp_ranks'
    spawn): ``dryrun.run_grid(4)``, the TP x MoE jobs, the EP reshard;
    ``timing_s`` the seconds each took."""
    out, timing = {}, {}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out["grid"] = dryrun.run_grid(PP_RANKS, verbose=False)
    timing["run_grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tp_moe"] = _grid_tp_rank(device, grid_in["batches"])
    timing["tp_moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["reshard"] = _grid_reshard_rank(device, out_dir, grid_in["batches"])
    timing["reshard"] = time.perf_counter() - t0
    out["timing_s"] = timing
    return out


def _grid_ranks_report(smi, ranks, grid_in) -> dict:
    """grid_ranks' line from the ranks' results, and its checks."""
    cfg = GPT2Config(n_layer=EP_RANKS_LAYERS, **MOE_CFG)
    E = cfg.moe_experts
    grids = [r["grid"]["grid"] for r in ranks]
    modes = {}
    for i, res in enumerate(grids[0]):
        every = [g[i] for g in grids]
        modes[res["mode"]] = {
            "mesh": res["mesh"], "loss": res["loss"],
            "losses_equal_on_every_rank": len({g["loss"] for g in every})
            == 1, "collectives": res["collectives"],
            "parity_delta": max(g["parity_delta"] for g in every)}
    tp = {}
    for tag, (dp, tpn) in GRID_TP_JOBS.items():
        for sp in (0, 1):
            key = f"{tag}_sp{sp}"
            rs = [r["grid"]["tp_moe"][key] for r in ranks]
            mean = [float(np.mean([rs[d * tpn]["losses"][i]
                                   for d in range(dp)]))
                    for i in range(GRID_TP_STEPS)]
            tp[key] = {
                "mean_losses": mean,
                "loss_rel_err": [abs(a - b) / abs(b) for a, b in
                                 zip(mean, grid_in["losses"])],
                "norm_rel_err": [{k: abs(r["norms"][k] - v) / v for k, v in
                                  grid_in["norms"].items()} for r in rs],
                "held": [r["held"] for r in rs],
                "moe_context": rs[0]["moe_context"],
                "collectives_last_step": rs[0]["counts"],
                "wire_last_step": rs[0]["wire"],
                "step_s": [r["step_s"] for r in rs],
                "max_memory_allocated_bytes": [
                    r["max_memory_allocated_bytes"] for r in rs]}
    rsh = [r["grid"]["reshard"] for r in ranks]
    excess = [max((peak - sum(r["leaf_bytes"][k]) for k, peak in
                   r["measured_peak_bytes"].items()), default=0)
              for r in rsh]
    line = {"phase": "grid_ranks", "nvidia_smi": smi, "ranks": PP_RANKS,
            "backend": "gloo", "spawn": "pp_ranks' ranks",
            "run_grid": modes,
            "tp_moe": {"model": "gpt2-125m-moe", "n_layer": EP_RANKS_LAYERS,
                       **MOE_CFG, "dtype": "float32", "tf32": False,
                       "global_batch": GRID_TP_ROWS, "seq_len": MOE_SEQ,
                       "steps": GRID_TP_STEPS, "noshard_losses":
                       grid_in["losses"], "noshard_norms": grid_in["norms"],
                       "loss_rtol": GRID_TP_LOSS_RTOL,
                       "norm_rtol": GRID_NORM_RTOL, **tp},
            "reshard": {"src": GRID_RESHARD["src"],
                        "dst": GRID_RESHARD["dst"],
                        "move_s": [r["move_s"] for r in rsh],
                        "counts": [r["counts"] for r in rsh],
                        "expert_leaves": len(rsh[0]["leaf_bytes"]),
                        "leaf_bytes": rsh[0]["leaf_bytes"],
                        "measured_peak_bytes": [r["measured_peak_bytes"]
                                                for r in rsh],
                        "requested_peak_bytes": [r["requested_peak_bytes"]
                                                 for r in rsh],
                        "peak_over_src_plus_dst_bytes": excess,
                        "staging_bound_bytes": REDIST_STAGING,
                        "state_equal_to_resume": [r["state_equal"]
                                                  for r in rsh],
                        "held": [r["held"] for r in rsh],
                        "next_losses": [r["next_losses"] for r in rsh]},
            "rank_timing_s": [r["grid"]["timing_s"] for r in ranks]}
    emit(line)
    check(sorted(modes) == sorted(dryrun.MODES)
          and all(m["losses_equal_on_every_rank"]
                  and m["parity_delta"] < dryrun.PARITY_TOL
                  for m in modes.values()),
          f"grid_ranks: run_grid {modes}")
    for key, r in tp.items():
        tpn = GRID_TP_JOBS[key.rsplit("_", 1)[0]][1]
        check(max(r["loss_rel_err"]) <= GRID_TP_LOSS_RTOL,
              f"grid_ranks {key}: losses {r['mean_losses']} vs NoShard "
              f"{grid_in['losses']}")
        check(max(max(e.values()) for e in r["norm_rel_err"])
              <= GRID_NORM_RTOL,
              f"grid_ranks {key}: gradient norms' errors {r['norm_rel_err']}")
        check(all(h[0] == E // tpn for h in r["held"])
              and r["moe_context"] == ("SequenceEPContext" if key.endswith(
                  "sp1") else "EPContext"),
              f"grid_ranks {key}: stacks {r['held']}, {r['moe_context']}")
    check(all(r["state_equal"] for r in rsh)
          and all(a == b for a, b in (r["next_losses"] for r in rsh)),
          "grid_ranks: the resharded EP state is not the checkpoint's "
          f"resume ({[r['next_losses'] for r in rsh]})")
    check(all(r["held"][0] == E // GRID_RESHARD["dst"][1] for r in rsh)
          and all(len(r["measured_peak_bytes"]) == len(r["leaf_bytes"]) > 0
                  for r in rsh)
          and max(excess) <= REDIST_STAGING,
          f"grid_ranks: reshard peaks over a source plus a destination "
          f"block {excess}, experts held {[r['held'] for r in rsh]}")
    return line


def kernel_resources():
    """Registers, stack bytes and HGMMA (wgmma) instructions of each
    Hopper-route kernel, read from the built B1-B3 and B4-B6 libraries with
    ``cuobjdump -res-usage`` and ``cuobjdump -sass``, keyed by kernel name,
    dtype, D and (B4) output type; each must run on the tensor cores
    (HGMMA > 0) with no stack. Expected: B1-B3 in bf16/fp16 at D = 64 and
    128 (12), B4 in bf16/fp16 at D = 64 and 128 with its output in the
    input dtype or fp32 (8), B5 and B6 in bf16/fp16 at D = 64 and 128
    (8)."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out = {}
    for lib_name in ("flash_attention_causal", "flash_attention_masked"):
        lib = str(_build._target(lib_name)[1])
        usage = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                               text=True, check=True).stdout
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        hgmma = {}   # function: (HGMMA count, the first one as disassembled)
        for part in sass.split("Function : ")[1:]:
            first = re.search(r"HGMMA\.[^;]*;", part)
            hgmma[part.split(None, 1)[0]] = (part.count("HGMMA."),
                                             first.group(0) if first else None)
        for fn, reg, stack in re.findall(
                r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+)", usage):
            kernel = next((k for k in SM90_KERNELS + MASKED_SM90_KERNELS
                           if k in fn), None)
            if kernel is None:
                continue
            # template arguments: <T, D>, or B4's <T, OutT, D>; OutT = T
            # mangles as a back-reference, float as "f"
            targs, d = re.search(rf"{kernel}I(.*?)Li(\d+)E", fn).groups()
            dtype = "bf16" if "bfloat16" in targs else "f16"
            if kernel == "flash_masked_fwd_kernel_sm90":
                dtype += ",f32" if targs.endswith("f") else f",{dtype}"
            count, first = hgmma.get(fn, (0, None))
            out[f"{kernel}<{dtype},{d}>"] = {
                "registers": int(reg), "stack_bytes": int(stack),
                "hgmma": count, "first_hgmma": first}
    n_causal = sum(k.startswith("flash_causal") for k in out)
    check(n_causal == 12 and len(out) == 28
          and all(r["hgmma"] > 0 and r["stack_bytes"] == 0
                  for r in out.values()),
          f"Hopper-route kernels missing, without HGMMA or with a stack: "
          f"{out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_all(LIBRARIES)
    build_s = time.perf_counter() - t0
    resources = kernel_resources()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "sm90_kernels": resources})

    profiler_edges_phase()
    kres = kernel_phase()
    fres = flash_kernel_phase()
    mres = masked_kernel_phase(resources)
    bres = bn_kernel_phase()
    cp_hops_phase()
    parity_phase()
    spec_parity_phase()
    torch.cuda.empty_cache()
    launches, engine, serve_streams, serve_latency = serve_phase()
    n_layer = GPT2Config().n_layer
    profile_phase(engine, n_layer)
    spec_launches, spec_engine = serve_spec_phase(engine.model, serve_streams)
    profile_phase(spec_engine, DRAFT_LAYERS * SPEC_K + n_layer,
                  phase="spec_profile", new_tokens=SERVE_NEW_TOKENS)
    del engine, spec_engine
    serve_example_phase()
    torch.cuda.empty_cache()
    parity_batches, dense = train_parity_phase()
    train_launches, train_result, train_out = train_phase()
    fsdp_train_phase(train_out)
    train_split = train_profile_phase(*train_fixed_batch_phase(),
                                      expect_calls=SM90_KERNELS)
    torch.cuda.empty_cache()
    head_phase(train_result)
    noshard_runs, noshard_final = runner_train_phase()
    moe_line = moe_train_phase()
    moe_parity_phase()
    remat_dropout_phase()
    torch.cuda.empty_cache()

    # context parallelism and the sharded strategies' runner over a
    # one-rank NCCL group: one card, cp = dp = fsdp = 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pdist.init_process_group(init_method=f"tcp://localhost:{port}", rank=0,
                             world_size=1)
    try:
        mesh = init_device_mesh((1,), ("cp",))
        train_cp_parity_phase(mesh, parity_batches, dense)
        del dense
        train_bf16_parity_phase(mesh)
        cp_launches, cp_split = train_cp_phase(mesh)
        torch.cuda.empty_cache()
        sharded = sharded_runner_phase(noshard_runs)
        analysis_phase(sharded, smi)
        powersgd_phase(sharded["DataParallel"]["step_s"]["runner"])
        tp_train_phase(noshard_runs, noshard_final)
        del noshard_final
        torch.cuda.empty_cache()
        pp_per_step = pp_train_phase(noshard_runs)
        torch.cuda.empty_cache()
        tp_moe = tp_moe_phase(moe_line)
        cp_moe = cp_moe_phase(mesh, moe_line)
        torch.cuda.empty_cache()
        tp_serve_phase(serve_streams, serve_latency)
        redistribute_phase(smi)
        observability_phase(smi)
    finally:
        pdist.destroy_process_group()
    torch.cuda.empty_cache()
    ckpt_gpt2_phase(smi)
    # one start of the four rank processes for every four-rank phase
    pool = _RankPool(torch.device("cuda", 0))
    try:
        fsdp = fsdp_ranks_phase(pool)
        hooks_ranks_phase(pool, fsdp["noshard"]["losses"])
        bn_group = bn_group_phase(pool)
        tp_ranks_phase(pool, smi)
        pp_ranks_phase(pool, smi)
        fr_stall_phase(pool, smi)
    finally:
        pool.close()
    multihost_phase()
    multihost_example_phase()

    torch.cuda.empty_cache()
    resnet_parity_phase()
    resnet_amp_accum_phase()
    resnet_example = resnet_example_phase()
    disk_data_phase(train_result, resnet_example)
    elastic_resnet_phase(smi)
    comm_hooks_phase()
    bench_out = resnet_train_phase(smi)   # cuDNN's algorithm search on
    resnet_runner_phase(bench_out)
    resnet_profile_phase()

    main_dtype = kres["ragged"]["bfloat16"]  # the serve phase runs in bf16
    serve_set = kres["serve"]["bfloat16"]
    verify_set = kres["verify"]["bfloat16"]
    summary = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": main_dtype["max_abs_err"],
        "ms": main_dtype["ms"],
        "plain_ms": main_dtype["plain_ms"],
        "bound_ms": main_dtype["bound_ms"],
        "bound_by": main_dtype["bound_by"],
        "library_ms": main_dtype["library_ms"],
        "library_call": "F.scaled_dot_product_attention on a dense view "
                        "gathered beforehand",
        "path": "CUDA cores: split across CTAs, merged by lse",
        "device_ms": main_dtype["device_ms"],
        "serve_lengths_ms": serve_set["ms"],
        "serve_lengths_device_ms": serve_set["device_ms"],
        "serve_lengths_bound_ms": serve_set["bound_ms"],
        "serve_lengths_library_ms": serve_set["library_ms"],
        "spec_launches": spec_launches,
        "verify_rows": kres["verify"]["rows"],
        "verify_max_abs_err": verify_set["max_abs_err"],
        "verify_ms": verify_set["ms"],
        "verify_device_ms": verify_set["device_ms"],
        "verify_plain_ms": verify_set["plain_ms"],
        "verify_bound_ms": verify_set["bound_ms"],
        "verify_library_ms": verify_set["library_ms"],
        "verify_fp32_ms": kres["verify"]["float32"]["ms"],
    }]
    for name, key, replaces in FLASH_KERNELS:
        r = fres["bfloat16"][key]  # the train phase runs in bf16
        summary.append({
            "name": name,
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": train_launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": "F.scaled_dot_product_attention(is_causal=True) "
                            + ("forward" if key == "fwd" else
                               "autograd backward (dq, dk, dv together)")
                            + f", {r['library_backend']} backend",
            "path": path(key),
            "device_ms": r["device_ms"],
            "train_profile_ms_per_launch": train_split[key] / n_layer,
            "tflops": r["tflops"],
            "pp_train_launches_per_step": {
                tag: {run: counts[key] for run, counts in launches.items()}
                for tag, launches in pp_per_step.items()},
            "tp_moe_launches_per_step": {
                "eager": tp_moe["launches_per_step_eager"][key],
                "replayed": tp_moe["replayed"]["calls_per_step"][
                    SM90_KERNELS[CAUSAL_KEYS.index(key)]]},
        })
    for name, key, replaces in MASKED_KERNELS:
        r = mres["bfloat16"][key]  # the train_cp phase runs in bf16
        summary.append({
            "name": name,
            "route": "cuda",
            "source": MASKED_SOURCE,
            "replaces": replaces,
            "launches": cp_launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": "F.scaled_dot_product_attention(attn_mask=q_pos "
                            ">= kv_pos) " + ("forward" if key == "mfwd" else
                                             "autograd backward (dq, dk, dv "
                                             "together)")
                            + f", {r['library_backend']} backend",
            "path": path(key),
            "device_ms": r["device_ms"],
            "train_cp_profile_ms_per_launch": cp_split[key] / n_layer,
            "tflops": r["tflops"],
            "cp_moe_launches_per_step": cp_moe["launches_per_step"][key],
        })
    group = bn_group["launches"][0]   # rank 0's ResNet-50 steps
    for name in bnk.KERNELS:
        summary.append({
            "name": name,
            "route": "cuda",
            "source": BN_SOURCE,
            "replaces": None,
            "launches": {"per_step": [c[name] for c in group["steps"]]}
            if "steps" in group else
            {"start": group["start"][name],
             "start_steps": group["start_steps"],
             "replays": group["replays"][name]},
            "launches_step": f"ResNet-50, {bn_group['ranks']} ranks over "
                             f"{bn_group['backend']}, {bn_group['step']}",
            "max_abs_err": bres["max_abs_err"][name],
            "worst_share_of_tol": bres["worst_share_of_tol"][name],
            # summed over the 53 BatchNorms of a ResNet-50 step at 224 px
            # and 256 images a rank
            **bres["per_step"][name],
            "library_call": BN_LIBRARY_CALLS[name],
            "path": "CUDA cores: 16-byte loads, fixed-order reductions",
        })
    emit({"phase": "total", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
