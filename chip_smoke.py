#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. probe   — torch/CUDA versions, the card and its power limit; requires
             compute capability 9.0; turns TF32 off for f32 matmuls.
2. build   — compiles ``ops/csrc/flash_attn.cu``, ``ops/csrc/image.cu``,
             ``ops/csrc/jpeg_decode.cu``, ``ops/csrc/token_pack.cu`` and
             ``ops/csrc/ring_attn.cu`` for sm_90a, the native JPEG
             decoder and the coefficient extractor (``native/ldt_coeffs.cpp``,
             g++ alone), all at once, and prints the build times and, from
             the ``-Xptxas -v`` reports, registers, spills and shared memory
             of all six flash kernel builds (three kernels, head dims 64 and
             128), of K1's two routes, of K2, of K3's two kernels and of K5's
             three; fails on any spill of any of the three flash kernels at
             head dim 64, of K1, K2, K3 or K5, and when the extractor does
             not build.
3. kernels — runs the fwd, bwd_dq and bwd_dkv kernels at the BERT-base
             shapes [32, 12, 512, 64] bf16, (a) non-causal with padding
             segments and (b) causal, against their plain PyTorch versions
             in f32 on the same inputs, checks that a second launch on the
             same inputs gives the same bits; then (c) causal with packed
             segments from a real first-fit-decreasing plan of the
             causal-LM corpus, at [rows, 12, 1024, 64] and at S = 64, the
             same way (before each check, a line says whether q, k, v and
             dO are finite and counts the non-finite elements of the plain
             and the kernels' outputs); and times them (mode a) beside the
             plain versions and ``scaled_dot_product_attention``; the
             backward's sum (dQ + dK/dV + the plain di op) is printed beside
             SDPA's backward alone (its fwd+bwd less its fwd, one call),
             which the dQ and dK/dV rows also carry as ``library_bwd_ms``
             beside ``pair_ms``, the two kernels' sum: the one call
             computes both rows' work.
4. slice   — trains BERT-base masked-LM (768/12/12/3072, S = 512, batch 32)
             for 20 steps through ``cli train --flash_attention`` on a seeded
             token dataset, after checking flash attention against the dense
             attention path on a small model.
5. trainer — the trainer beyond the main path on the slice phase's corpus
             (its first 12 batches): BERT-base masked-LM through ``cli train
             --flash_attention --grad_accum 4`` (micro-batch 32, 128 rows an
             update, AdamW lr 1e-4 on a cosine schedule over 3 updates,
             ``--log_grad_norm``): first 12 micro-steps untraced with one
             progress line (the timed run); then, with ``--log_every 1`` and
             the step trace on, three runs in one checkpoint directory on
             the machine's disk: a control of 12 micro-steps with
             ``--profile_dir``; a run with
             ``--checkpoint_every_steps 4`` drained at micro-step 6
             (``LDT_CHAOS=drain@6``, mid-window: the emergency checkpoint
             holds a half-full accumulator); and the same flags again, which
             resumes. Checks that the resumed run starts at absolute step 7
             and ends at 12, that its losses and batch digests equal the
             control's for steps 7-12 and its final parameters the
             control's, bit for bit (and the timed run's losses too), that
             each run applied its updates
             (AdamW's step 3 at the end of both), that flash launched 12
             fwd, 12 dQ and 12 dK/dV a micro-step and K5 never, that every
             progress line has a finite ``grad_norm`` and the schedule's
             ``lr`` in updates, and that the profiler's trace names the
             three flash kernels; prints the timed run's micro-step median
             (steps 2-12) beside the slice phase's step, each run's
             micro-steps, the accumulator fold's time, each save's
             time on the training thread and its write, the checkpoint's
             bytes, the restore time and the peak memory.
6. image_kernels — K1 (``ops/csrc/image.cu``) against its plain PyTorch
             version on the card, bit for bit, on every uint8 value, at
             [512, 224, 224, 3] (classification and CLIP), at
             [256, 224, 224, 3] (ViT) and at other shapes of both routes (W = 16,
             17, 48, 224, 2048, 4096 and 8192, batches 1 byte off 16-byte
             alignment), with no, a random and an all-set flip mask; times
             it (CUDA events around 20 launches back to back, median of 5)
             beside the plain version and a device-to-device copy of the
             same bytes; the bound takes the card's published memory rate.
7. jpeg_kernels — K2 (``ops/csrc/jpeg_decode.cu``) against its plain
             PyTorch version on the card, bit for bit: at the path's shape
             (pages ``int16 [512, 28, 28, 64]`` and ``[512, 14, 14, 64]``
             extracted here from the seeded classification set →
             ``uint8 [512, 224, 224, 3]``), at the vit phase's (the first
             256 rows) and at ragged cases (odd sizes,
             grayscale, progressive, re-encoded 4:4:4, a zero-geometry
             row; out sizes 224, 32 and 40), and on a repeat launch; times
             its one launch (between CUDA events, median of 20, and 20
             launches back to back, median of 5) beside the plain version;
             the bound is the larger of its bytes over 3.35 TB/s and its
             integer operations that this data needs (the even/odd IDCT of
             each block that holds a sampled pixel, the colour conversion
             of each sampled source pixel, each mix whose weight is not 0)
             over 33.45 T/s, the card's 32-bit integer rate (64 lanes
             an SM to the f32 rate's 128, at the 1.98 GHz boost clock that
             the published 67 TFLOP/s of f32 implies). Prints
             the extractor's time for the 512 images and its threads.
8. classification — trains ResNet-50 (224 px, 101 classes, global batch
             512, SGD lr 0.05 momentum 0.9, flips, eval at the end) for 20
             steps through ``cli train`` on a seeded FOOD-101-shaped JPEG
             dataset (``create_synthetic_classification_dataset``, 20
             batches of rows; each row labelled by its image, so that
             there is something to learn), host-decoded by the native
             decoder or PIL; the eval pass covers every row once.
9. device_decode — the same run through ``cli train --device_decode``:
             the host extracts coefficient pages, K2 decodes them on the
             card for each of the 20 train and 20 eval batches; checks the
             decoder arm, K2's 40 launches, the falling loss and the eval
             over every row, and prints the step, the rates, the stall and
             the entropy and K2 times.
10. token_kernels — K3 (``ops/csrc/token_pack.cu``, pack and unpack)
             against its plain PyTorch version on the card, bit for bit: at
             the path's shape (a batch of 64 sequences of the causal-LM
             corpus, pack_len 1024), at the contrastive phase's (its two
             distinct batches of 512 captions, bucket mode, one caption a
             row, pack_len 64 or 77), at ragged cases (empty sequences, one
             sequence, sequences truncated at pack_len, a values tail past
             offsets[n], padding rows from rows_multiple, bucket mode), on
             a repeat launch, and the round trip unpack(pack(x)) == x; and
             plans made by hand (600 sequences, runs across a row's end,
             destinations below, past and partly past the grid, a nonzero
             offsets[0]); times both beside the plain versions: device
             time, CUDA events around 20 launches queued behind a spin of
             the card (median of 5; the host takes longer per launch than
             the card), with the host's queueing time a call, and back to
             back as a caller meets them, beside the launch floor (an
             empty launch timed the same way); the bound is their bytes
             over 3.35 TB/s.
11. causal_lm — trains GPT-2 124M's shape (``gpt_base``: 768/12/12/3072,
             vocab 50257, context 1024) for 20 steps through ``cli train
             --task_type causal_lm --token_pack --flash_attention`` (64
             sequences a batch, pack_rows_multiple 8, AdamW lr 1e-4, eval
             at the end) on a seeded corpus of lognormal lengths (mean
             parameter 256, sigma 0.7, 1-1024) and Zipf(1.2) ids, then the
             same run with ``--no_token_pack`` (the padded arm); checks K3's
             20 launches, the flash launches, the falling loss, the eval
             over every row and finite losses, and prints each arm's step,
             grid and valid tokens/s and pad_waste_pct (steps 5-20, from
             each step's own payload), pack_device_ms and peak memory.
12. ring_kernels — K5 (``ops/csrc/ring_attn.cu``: the fold, dQ and dK/dV)
             over a whole in-process ring as the path launches it (each
             kernel once over all four ring steps) against the plain
             versions on the card (flash's
             tolerances: out 0.02 and 4e-3, lse 1e-3, gradients 2% of the
             largest; rows with no valid key 0, with 0 gradients) and
             against four one-step launches of the same kernels, bit for
             bit: at [32, 12, 512, 64] bf16 in four positions with key
             masks from the slice corpus's lengths (fully masked blocks
             among them), and at ragged cases (empty rows, blocks of 50 and
             of 256, one position); then a repeat that must give the same
             bits. Times each kernel as the path launches it (one launch
             between CUDA events, and 20 back to back) and the one ring
             step of each that a process ring launches
             beside the plain versions, the whole
             ring forward and forward + backward beside SDPA over the whole
             sequence with the same key mask (a yardstick, never called by
             the port, also timed back to back; its backward beside the
             dQ + dK/dV pair); the bound
             is the larger of each launch's bytes over 3.35 TB/s and its
             products over the bf16 peak.
13. ring_lm — trains BERT-base masked-LM through ``cli train
             --seq_parallelism 4`` (every ring position on the card) for 20
             steps on the slice phase's corpus, with the eval at the end;
             checks 12 forward, 12 dQ and 12 dK/dV launches a step (one a
             layer) and 12 forward launches an eval batch,
             no flash launch, the falling loss and the eval over every row,
             and prints the step beside the slice phase's flash step,
             tokens/s and peak memory.
14. map_style — ResNet-50 as in the classification phase through ``cli
             train --loader_style map --filter "label < 48" --val_fraction
             0.1 --eval_every 1 --epochs 1 --device_decode`` on a learnable
             set of 15,360 rows (label = image index mod 64): the filter
             keeps 11,520 rows, the seeded split holds out 1,152 and leaves
             10,368, 20 steps of 512 gathered by ``take`` from a new
             permutation; the eval at the epoch's end and at the end each
             cover the val split (3 padded batches). The counts come from
             the pools (``Dataset.filter_indices``, the trainer's
             ``_split_val_pool``). Checks the 20 finite, falling losses,
             both evals' rows, that no val row is a train row, the coeff
             arm and K1 and K2 launched once a train step and once an eval
             batch; prints the step, images/s, stall, entropy and K2 times
             beside the device_decode phase's (range reads against
             random-access gathers).
15. folder  — the file-based control arm: ResNet-50 through ``cli train
             --data_format folder --loader_style map`` over an image-folder
             tree of 64 class directories, each holding 160 hard links to
             one seeded 224 px noise JPEG (the classification set's image
             of that label), host-decoded, eval at the end over the 10,240
             files. Checks the 20 finite, falling losses, the eval's rows,
             K1 once a train step and an eval batch and K2 never; prints
             the same figures beside the classification phase's (files
             against the columnar store).

16. pretrained_placement — the JAX package's default way from host to
             card, on the reference's fine-tuning task: the port's ResNet-50
             with 1000 classes from a seeded generator is written as a
             torchvision checkpoint (``{"state_dict": {"module." + k: v}}``
             with zero ``num_batches_tracked`` entries); imported with
             ``load_torchvision_resnet`` into a 101-class ResNet-50 on the
             card, every backbone tensor must equal the file's bit for bit
             and the head a same-seed model's fresh ``[101, 2048]`` one.
             Then, on one authored set (the classification phase's recipe,
             10,240 rows), in each decoder arm (PIL on the host, and the
             coefficient pages with K2): the first 20 batches of the
             iterable loader through the placement plane (a ring of 2, 4
             producers, page-locked pool pages), each followed by K1 (after
             K2) and a ResNet-50 forward and backward so that the copies of
             the next batches overlap its kernels, must equal the
             synchronous arm's batches and K1 outputs bit for bit (int64
             digests taken on the card); and four runs of ``cli train
             --pretrained`` (224 px, batch 512, 20 steps, eval at the end):
             each decoder arm at the defaults and with ``--no_global_batch
             --producer_threads 1 --no_buffer_pool``. Checks the falling
             losses, K1's 40 launches a run and K2's 40 (coeff) or 0 (PIL),
             the eval over every row, that the decoders leased pool pages
             under the defaults and that no ``ldt-placement`` or
             ``ldt-producer-*`` thread outlives ``cli.main``; prints each
             run's median step, images/s over steps 6-20, stall,
             ``h2d_pct``, placement ms a batch (median and the first three),
             pool hits, misses and the time spent allocating missed pages,
             peak memory and the host's CPU count.

17. workers_caches — the worker pool, the cache plane and the autotuner
             on the classification phases' corpus with 97 distinct images
             and labels in place of 64, so that its WC_STEPS (6) batches of
             512 at 224 px differ from one another (no eval); the phase
             fails unless they do, since equal batches would hide a
             reordered or wrongly replayed one. First, no training: the
             first 6 batches of the
             iterable loader in process, through a ``WorkerPool`` of 4
             spawned workers over shared-memory slots and over pickles, in
             both decoder arms; the batches, K2's images and K1's outputs
             (a fixed flip mask) must be equal bit for bit (digests on the
             card), no worker may hold a ``/dev/nvidia*`` file nor
             ``nvidia-smi`` list more than the trainer, the shm runs may
             fall back to pickles 0 times, and after ``shutdown()`` no
             worker and no ``ldtshm_*`` segment of the pool may remain;
             prints ``/dev/shm``'s size, the import time of a worker and of
             torch, and the decode threads a worker runs. Then five ``cli
             train`` runs of ResNet-50: PIL with ``--num_workers 4
             --batch_cache --cache_dir`` (on the machine's own disk where
             there is one) ``--epochs 2`` and the tuner recording
             ``LDT_AUTOTUNE_TRACE``, and its control ``--num_workers 0
             --no_batch_cache --no_autotune``; coeff with ``--num_workers
             4`` (tuner traced) and its control; coeff with
             ``--device_cache --data_echo 2 --epochs 2`` (tuner traced),
             its step trace's digests taken on the card. Checks: epoch 2 of
             the PIL run hits the cache 6 times of 6 and the pool decodes
             nothing; zero shm fallbacks; the three tuner traces verify;
             the fill epoch's 6 batches are distinct, each echo trains on
             its host batch, and the replayed epoch's 6 batches equal the
             fill epoch's in order; 24 steps; K1 and K2
             launches 12/0, 12/0, 6/6, 6/6 and 24/6; the replay run's
             peak 0.65-1.62 times the cached bytes (0.46 GB) above the
             streaming run's; no loader, tuner or
             pool thread, child process or segment of this process's
             rings after ``cli.main``. Prints each run's images/s an epoch
             and a progress window, stall, ``h2d_pct``, the p50 and p95 of
             ``workers_result_wait_ms``, ``shm_slot_wait_ms``,
             ``pipeline_decode_ms`` and ``cache_lookup_ms``, pool hits and
             misses, the cache's RAM/disk split, the tuner's decisions
             (knob, from, to, reason) and bottlenecks, and the replay
             epoch's images/s, step and the card's idle share between its
             steps' events.
18. contrastive — the BASELINE's fifth configuration: CLIP
             (``clip_resnet50_bert``: a ResNet-50 image tower projecting to
             512, a 512/6/8/2048 text tower over a 30522-token vocabulary)
             through ``cli train --task_type contrastive`` at 224 px,
             captions of up to 77 tokens, global batch 512, AdamW lr 1e-4,
             20 steps and the eval, on a seeded corpus of 10,240 rows: 1,024
             distinct 224 px JPEGs (an 8 x 8 grid of random colours scaled
             up, plus pixel noise), each with its own caption stored as a
             variable-length ``list<int32>`` of lognormal length (5-77
             tokens), PIL on the host. Twice: with ``--token_pack`` (the
             captions ride as ragged pages with a bucket plan, one caption
             a row, which K3 turns into the grid on the card; the caption
             pages and plans of both distinct batches, as the trainer's
             decoder makes them, are checked to be bucket mode and equal,
             bit for bit, to the token_kernels phase's cases) and without (padded
             to 77). Checks K1 once a train step and an eval batch (40), K3
             20 launches in the packed run and 0 in the padded one, the 20
             finite losses (the last five averaging below the first and
             below the first five) and the eval (``retrieval_top1``) over
             every row; prints the step, images/s, stall, K3's time, the
             captions' payload and grid tokens and peak memory.
19. vit     — ViT-B/16 (``vit_base``: 768/12/12/3072, patch 16, 196
             tokens) through ``cli train --model_name vit_base
             --device_decode`` at 224 px, 101 classes, batch 256, AdamW lr
             3e-4, 20 steps and the eval, on the classification phases'
             learnable set (10,240 rows, 40 eval batches). Checks K1 and K2
             once a train step and an eval batch (60 each), no flash
             launch, the falling loss and the eval over every row; prints
             the step, images/s and peak memory beside ResNet-50's from the
             device_decode phase (else the classification phase).
20. moe     — BERT-base masked-LM with switch-MoE blocks (``--num_experts
             8 --moe_every 2``: blocks 1, 3, ..., 11, each expert a
             768-3072-768 MLP, capacity 2,560 of the 16,384 tokens a step;
             the queues gathered by index, not by a dense dispatch tensor)
             through ``cli train --flash_attention`` at sequence 512, batch
             32, AdamW lr 1e-4, 20 steps on the slice phase's corpus, no
             eval. Checks flash's 12 fwd, 12 dQ and 12 dK/dV launches a
             step, the last step's six load-balance terms finite and above
             0, and the falling loss; prints the step beside the slice
             phase's dense step, tokens/s and peak memory.

21. graph   — the loader graph (``data/graph.py``): each in-process
             shape of ``canonical_graphs()`` (train-iterable, train-map-style,
             train-folder) plus eval, device-decode pages and token-pack,
             over a learnable classification set of 6 batches of 512 at 224
             px (97 distinct images), a 64-class folder tree of the same
             size and 384 documents of the causal-LM corpus (6 batches of
             64, FFD-packed at 1024), each built as a ``LoaderGraph`` and
             by the engine's own constructor, both placed by a placement
             plane (ring of 2, 4 producers, page-locked pool pages). Checks
             that the two streams' batch digests (taken on the card) are
             equal, that a cursor taken after 2 batches and restored into a
             fresh graph streams the rest, and that every stream's batches
             differ; then, the launch counts set to 0 just before and read
             just after, streams every graph again with the iterable
             batches training ResNet-50 (SGD, lr 0.05, a fixed flip mask;
             K1 once a step), the coefficient pages through K2 and the
             ragged token pages through K3 (6 launches each), and holds K1,
             K2 and K3 against their plain versions on the first batch of
             each, bit for bit. Then the scheduled arm: a set of 32
             batches of 512 rows where one batch in each quarter of the
             plan (at a seeded offset) holds an oversized JPEG (1,536-2,048
             px wide) in one row of 2 (1 row in 16 overall);
             a second unscheduled in-process epoch, on one producer so
             that each batch's decode time is its own, writes
             ``LDT_COST_PATH`` (the first pays the loader's start-up), and
             a ``WorkerPool`` of 4 streams the epoch with
             ``Decode(schedule={"lookahead": 16, "heavy_share": 25})`` (its
             cost model warm-started from that file) once to spawn its
             workers and its heavy lane, then unscheduled, scheduled,
             again scheduled and again unscheduled; every
             run's batches must equal the
             in-process epoch's bit for bit and each scheduled run must
             reorder its dispatch; each scheduled run's heavy lane is held
             to the scheduler's rule (JAX ``data/schedule.py``), read from
             a trace of every dispatch: a batch dispatched past the
             four-prediction warm-up with a prediction above twice the
             running mean of the earlier ones goes to the heavy lane, and
             every other batch does not, every batch of the plan
             dispatched once and ``sched_heavy_lane_batches_total``
             counting the trace's heavy-lane dispatches (a run may route
             none: heaviest-first dispatch can spend the stragglers inside
             the warm-up); prints each run's images/s, the
             consumer's p50/p95 wait a batch, the reorders, heavy-lane
             routes and the p95 of ``sched_predicted_error_ms``, and each
             run's reading of the rule; a run off the rule first prints
             each straggler batch's predicted ms, the lane's threshold at
             its dispatch and its measured ms, beside the light batches'
             medians.
22. remat   — BERT-base masked-LM (768/12/12/3072, sequence 512, batch
             32, AdamW lr 1e-4, 20 steps, no eval) through ``cli train
             --flash_attention`` without and with ``--remat`` from one seed,
             then through ``--seq_parallelism 4`` (the in-process ring)
             without and with it. Checks the losses and the final
             parameters equal bit for bit, and the launches: the flash
             forward 24 a step with ``--remat`` against 12 without, dQ and
             dK/dV 12 a step each way; K5's fold likewise on the ring arm;
             prints each run's median step, peak memory and losses.
23. service — the classification phases' ResNet-50 run behind the
             data service: ``cli serve-data`` in a subprocess of its own on
             127.0.0.1 serves the classification set (64 JPEGs over 10,240
             rows, 224 px) and ``cli train --data_service HOST:PORT
             --metrics_port 0`` trains at the classification phase's
             width and flags (20 steps and the eval, which reads the rows
             here), in two arms: PIL pixels, and ``--device_decode`` on
             server and trainer (coefficient pages cross the wire; K2, then
             K1, on the card). Before each run the port's local loader
             decodes the same 20 batches here; every batch the trainer
             received (digests on the card of the placed batch, before K2)
             and every batch a step trained on (after K2) must equal the
             local ones bit for bit. Checks K1's 40 launches and K2's 40
             (coeff) or 0, the falling loss, the eval over every row, K1
             and K2 against their plain versions on the first batch, that
             the trainer's exporter served ``svc_*`` and ``lineage_*``
             series and a ``/healthz`` of role ``trainer``, and that the
             server holds no CUDA context (no ``/dev/nvidia*`` file, not
             in ``nvidia-smi --query-compute-apps``); prints images/s,
             step, stall and the wire MB a batch (the server's bytes sent
             over its batches) beside the classification and
             device_decode phases'.
24. fleet   — the causal_lm phase's packed GPT-2 124M run behind a fleet:
             ``cli coordinator`` and two ``cli serve-data --coordinator``
             members (``--token_pack``, context 1024) in subprocesses, and
             ``cli train --coordinator HOST:PORT --job_id smoke`` (batch
             64, 20 steps, no eval). Member 0 SIGKILLs itself before its
             4th batch frame (its sender's chaos hook, ``fleet/chaos.py``'s
             seam, as JAX's ``kill_after`` does in process), so batches of
             its stripe are left unsent; the loader fails over to the
             survivor at the cursor. Every batch before K3 and
             every packed batch a step trained on must equal the local
             loader's (decoded here first) bit for bit. Checks K3's 20
             launches and flash's 12 a step, K3 against its plain version
             on the first batch, the falling loss, that ``cli fleet
             recommend --json`` shows the survivor alone once the dead
             member's lease expires and ``cli jobs list --json`` the
             job and its cursor, at least one failover, and that no server and not
             the coordinator holds a CUDA context; prints valid tokens/s
             beside the causal_lm phase's packed arm.
25. parallel — the layouts beyond data parallelism, BERT-base masked-LM at
             full width (768/12/12/3072, vocabulary 30522, sequence 512,
             global batch 32, the slice phase's first 96 rows, 3 steps,
             the eval over them at the end) through ``cli train`` as two
             ranks
             sharing the one card: ``tp`` (``--model_parallelism 2 --flash_attention``),
             ``fsdp`` (``--fsdp --flash_attention``), ``zero2`` (``--zero 2
             --grad_accum 2 --flash_attention``), ``ep`` (``--num_experts 8
             --model_parallelism 2 --flash_attention``) and ``pp``
             (``--pipeline_parallelism 2 --pp_microbatches 4``); and
             ``tp8`` (``--model_parallelism 8 --flash_attention``: 8 does
             not divide the 12 heads, so the heads stay whole on every
             rank and only the attention's ``out`` is split, JAX's plan)
             as eight ranks at global batch 16 over its first 32 rows,
             2 steps (PARALLEL_DEPTH)
             (PARALLEL_BATCH: eight at batch 32 exceed the card), held
             against a reference at batch 16. First a
             probe, each collective in a pair of processes of its own
             (restarted past one that aborts): which of ``all_reduce``,
             ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
             ``all_to_all_single`` and ``batch_isend_irecv`` gloo runs on
             CUDA tensors on the card, and whether NCCL takes two ranks on
             one card. Then flash at the tensor-parallel shard's shape
             [32, 6, 512, 64] and at tp8's [16, 12, 512, 64] against its
             plain version. Before each rank count's runs this process
             frees its cached blocks and prints its bytes and the card's
             free bytes. Each rank starts
             from the same seeded weights and runs with
             ``--log_grad_norm``; a rank's first train step first gathers
             the whole parameters (rank 0 keeps them), and it records its
             first three micro-batches and masks, its first micro-step's
             global gradient norm and the whole parameters after the first
             update. A rank that fails prints its errors beside every
             other failed rank's. The reference is a data-parallel step in
             this
             process: the whole model on those weights, AdamW as the
             trainer builds it, the global batches and masks (the data
             shares' rows in order). Checks, per layout: the transport the
             trainer chose (``gloo-host-staged``: the ranks share a card),
             the falling loss, the same losses on both ranks, the eval over
             every row, the first loss and the loss after the first update
             (``losses[grad_accum]``) within PARALLEL_LOSS_TOL relative of
             the reference's, the first micro-step's global gradient norm
             within PARALLEL_NORM_TOL relative, the first update of each
             parameter of PARALLEL_COS_NUMEL elements or more at a cosine
             of at least PARALLEL_COS_MIN with the reference's (the
             smaller ones printed), flash's launches on each rank (12
             fwd, 12 dQ and 12 dK/dV a micro-step, at 6 heads under tp and
             ep, at 12 under tp8; plus 12 eval forwards for each global
             eval batch on every
             rank, since every rank evaluates its data share's slice of
             each; none under pp) and each rank's bytes of parameters,
             optimizer moments and accumulator equal to its plan's, below
             the replicated state's. The eval runs on both ranks under the
             layout: both report the dataset's rows and the same accuracy,
             within PARALLEL_EVAL_TOL relative of this process's eval of
             the whole model on the layout's weights at the eval (gathered
             there, collectively, by both ranks). Under ``fsdp`` each
             rank's peaks of gathered parameters and of whole gradients
             (``ShardedState.peaks``) are printed beside its peak memory
             and held to the root unit plus two units. Every layout is
             printed before any is checked. Prints the step (the median of
             the later half of the steps, rank 0's and each rank's), the
             valid tokens/s and each rank's peak memory: times of two (or
             eight) ranks on one card over gloo, not of the layouts.
             Checkpoints (PARALLEL_SAVES, PARALLEL_RESUMES): ``fsdp`` and
             ``zero2`` save a sharded step every PARALLEL_CKPT_STEP (2)
             micro-steps, and at that step each rank first takes the
             parent's path on the same state (the whole state gathered
             leaf by leaf to rank 0's host, written there as one file);
             three runs resume step 2 and train 3 steps (the epoch's last
             batch, the next epoch's first two), their reference
             continuing the saved optimizer state and step counts, with
             the same checks as every layout: ``tp_from_fsdp``
             (``--model_parallelism 2``, two ranks: another layout at the
             same world size), ``dp1_from_fsdp`` (one process, data
             parallel: two ranks to one) and ``tp2x2_from_zero2`` (four
             ranks, ``--model_parallelism 2`` over data 2 x model 2,
             ``--grad_accum 2``: two ranks to four). Every layout's masks
             are the draws, over its global batches, of the run's one
             generator (``trainer.draw_mlm_mask`` sliced by data share):
             from the seed for a fresh run, from the saved cursor's state
             for a resumed one, bit for bit, the ranks of one data share
             alike; a resumed run's global batches are, bit for bit, the
             ones the saving run trains next (its third, then its first
             two: the unshuffled plan repeats in epoch 1). Each rank of a
             resume reads its held bytes plus the whole leaves no layout
             holds in parts (0-d counters, buffers), no more. Each rank prints, beside the card's name and
             power limit, each save's time on the training thread (and
             the part awaiting the previous write), its write, its bytes
             against its held bytes, the host's anonymous and mapped-file
             bytes added over the save and its write, the restore's time,
             bytes read and largest block, and the parent's gather, write
             and whole-file read with their host bytes. Checks: the saved
             step read whole equals the gathered state, and the state a
             resumed run restored, read back whole, equals the saved step,
             bit for bit, leaf by leaf.

26. analysis — the port's static checker and its runtime witnesses. In
             the background while the rest runs: ``cli check`` over the
             port (its own ``analysis/ldt-check.toml``, the empty baseline:
             exit 0) and ``cli graph --mesh --loader`` (the launch sites,
             the topology's axis keys, the five loader graphs). Then one
             subprocess under ``LDT_COMPILE_SANITIZER=1``,
             ``LDT_LOCK_SANITIZER=1`` and ``LDT_LEAK_SANITIZER=1`` (the
             witnesses written to a temporary directory) trains BERT-base
             masked-LM (768/12/12/3072, sequence 512, batch 32,
             ``--flash_attention``) and ResNet-50 with ``--device_decode``
             (224 px, batch 128) for ANALYSIS_STEPS (8) steps each, eval
             on; and ``check --compile-witness --lock-witness
             --leak-witness --json`` over the three witnesses must exit 0.
             Checks: every site of flash's forward, dQ and dK/dV, K1 and
             K2 exercised in the training loop with no signature after its
             first call, nor at the model forwards (the cuDNN autotune
             site); every D2H event at a declared sync funnel (the
             trainer's drain points); the launches. Prints the eval loop's
             sites on a line of their own, the D2H events a step, the
             receipts, and each part's seconds.

Every phase but 17 trains with ``--no_autotune`` (``FIXED``): each
compares its runs with another arm's, another phase's or an earlier
tree's at a fixed layout and fixed queue depths, while the tuner moves
depths and, in the packed causal-LM arm, re-plans the packed batches.
Only phase 17 runs the tuner, the trainer's default, and it records and
verifies every such run's trace.

Every check that fails raises, so the script exits non-zero. After the
phases a ``done`` line gives the seconds since the script's ``main`` began
(the phases run, the kernels built). The last three lines are the card's ``nvidia-smi`` name and power limit, the kernel table
as JSON (the three flash kernels, K1 and K2, each with its launches on its
path; K3's pack and unpack with their launches on the causal-LM path; K5's
three kernels with theirs on the seq-parallel path; K1 and K2 add their
launches under the map_style and folder loaders as
``launches_map_style`` and ``launches_folder``, and their sums over the four
runs of the pretrained_placement phase as
``launches_pretrained_placement`` and over the five runs of the
workers_caches phase as ``launches_workers_caches``; K1 and K3's pack add
the contrastive phase's packed run as ``launches_contrastive``, K1 and K2
the vit phase's as ``launches_vit``, and the three flash kernels the moe
phase's as ``launches_moe``; K1, K2 and K3's pack add the graph phase's as
``launches_graph``, the flash kernels and K5 the remat phase's
``--remat`` runs as ``launches_remat``, K1 and K2 the service phase's
two runs as ``launches_service``, and K3's pack and the flash kernels
the fleet phase's run as ``launches_fleet``, the flash kernels, K1 and
K2 the analysis phase's two sanitized runs as ``launches_analysis``; the
flash kernels add each
layout's rank 0 of the parallel phase as ``launches_parallel_<layout>``
and their largest error at the model-parallel shapes, tp's shard and
tp8's whole heads, as ``max_abs_err_tp_shard``),
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PHASES = ("probe", "build", "kernels", "slice", "trainer", "image_kernels",
          "jpeg_kernels", "classification", "device_decode", "token_kernels",
          "causal_lm", "ring_kernels", "ring_lm", "map_style", "folder",
          "pretrained_placement", "workers_caches", "contrastive", "vit",
          "moe", "graph", "remat", "service", "fleet", "parallel",
          "analysis")
SHAPE = (32, 12, 512, 64)  # B, H, S, D at BERT-base, seq 512
STEPS = 20
LAYERS = 12
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_O, TOL_LSE, TOL_GRAD_REL = 2e-2, 1e-3, 2e-2
SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/flash_attn.cu"
IMAGE_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/image.cu"
IMAGE_REPLACES = "lance_distributed_training_tpu/ops/image.py:24,37"
IMAGE_SHAPE = (512, 224, 224, 3)  # B, H, W, C of the classification path
VIT_BATCH = 256
IMAGE_OPS = 3  # f32 operations a K1 element takes: divide, subtract, divide
IMAGE_CASES = (IMAGE_SHAPE, (VIT_BATCH, 224, 224, 3), (1, 224, 224, 3),
               (3, 5, 16, 3), (1, 33, 17, 3),
               (3, 33, 17, 3), (2, 7, 48, 3), (2, 3, 2048, 3),
               (1, 3, 4096, 3), (1, 2, 8192, 3))
IMAGE_UNALIGNED_CASES = ((4, 224, 224, 3), (2, 9, 16, 3))
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# 32-bit integer operations (a multiply-add counts 2): 132 SMs x 64 INT32
# lanes x 2 at the 1.98 GHz boost clock, half the f32 rate's 128 lanes (the
# Hopper white paper; the CUDA programming guide's throughput table, 9.0).
PEAK_INT32_OPS = 132 * 64 * 2 * 1.98e9
IMAGE_BATCH, IMAGE_CLASSES = 512, 101
JPEG_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/jpeg_decode.cu"
JPEG_REPLACES = "lance_distributed_training_tpu/ops/jpeg_device.py:180"
UNIQUE_IMAGES = 64  # distinct images (and labels) of the classification set
FIXED = ["--no_autotune"]  # every phase but 17 (the module's docstring)
TOKEN_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/token_pack.cu"
TOKEN_REPLACES = {
    "token_pack": "lance_distributed_training_tpu/ops/token_device.py:67",
    "token_unpack": "lance_distributed_training_tpu/ops/token_device.py:117",
}
GPT_VOCAB, GPT_CONTEXT, GPT_BATCH = 50257, 1024, 64  # GPT-2 small's n_ctx
RING_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/ring_attn.cu"
RING_REPLACES = "lance_distributed_training_tpu/parallel/ring_attention.py:37,62"
RING_SP = 4  # ring positions of the seq-parallel path (one card)
# K5 rounds where the plain fold does, so their outputs agree to a bf16 ulp
# or two (flash's 0.02 alone would pass a kernel that rounds elsewhere).
RING_TOL_O_CLOSE = 4e-3
RING_KERNELS = ("ring_fwd", "ring_bwd_dq", "ring_bwd_dkv")
GPT_MEAN_LEN, GPT_SIGMA = 256.0, 0.7  # lognormal lengths of the corpus
PACK_ROWS_MULTIPLE = 8
TRAINER_STEPS, TRAINER_ACCUM, TRAINER_DRAIN = 12, 4, 6  # micro-steps
UPSTREAM = "jax/experimental/pallas/ops/tpu/flash_attention.py"
REPLACES = {
    "fwd": f"{UPSTREAM}:758",
    "bwd_dq": f"{UPSTREAM}:1456",
    "bwd_dkv": f"{UPSTREAM}:1121",
}


_STARTED = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One JSON line of ``phase``, with the seconds since the script
    started (``at_s``: the phases' spans in a whole run)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.monotonic() - _STARTED, 2)}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median over ``iters`` runs of ``fn``, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
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


def time_back_to_back_ms(fn, launches: int = 20, reps: int = 5,
                         warmup: int = 3) -> float:
    """Per-launch time of ``fn``: CUDA events around ``launches`` calls made
    back to back, divided by ``launches``; the median over ``reps``. The
    card's queue stays full, so a wrapper's host work between launches does
    not count as the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def time_queued_ms(fn, launches: int = 20, reps: int = 5,
                   warmup: int = 3) -> dict:
    """Device time per launch of ``fn`` where the host, not the card, would
    set the pace back to back: the card first spins (``torch.cuda._sleep``)
    while the host queues ``launches`` calls, then runs them between two
    CUDA events; the median over ``reps``. A rep whose queueing outlasted
    the spin (the card waited on the host) is run again with a spin twice
    as long. Also returns the host's longest queueing time and the
    shortest spin; ``host_queue_ms_per_call`` is that longest queueing
    time over ``launches``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host, spin = [], [], []
    cycles = 40_000_000
    while len(times) < reps:
        before = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        queued = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        spun = before.elapsed_time(start)
        if queued >= spun:
            if cycles >= 640_000_000:
                raise RuntimeError(f"queueing {launches} launches took "
                                   f"{queued} ms, longer than a {spun} ms "
                                   "spin of the card")
            cycles *= 2
            continue
        host.append(queued)
        spin.append(spun)
        times.append(start.elapsed_time(end) / launches)
    return {"ms": statistics.median(times), "host_queue_ms": max(host),
            "host_queue_ms_per_call": max(host) / launches,
            "spin_ms": min(spin)}


def probe() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("probe", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, capability=list(cap), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need compute capability 9.0 (Hopper), got {cap}")
    return {"name": name, "smi": smi}


KERNEL_IDS = {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 2}  # ldt_flash_smem_bytes


def _ptxas_kernels(report: str, pattern: str = r"flash_(fwd|bwd_dq|bwd_dkv)"
                   r"_kernelILi(\d+)E") -> list:
    """Per kernel build in a ``-Xptxas -v`` report whose mangled name
    matches ``pattern`` (group 1 the kernel, group 2, if any, the head
    dim): registers, spill bytes and static shared memory."""
    rows, row = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(pattern, entry.group(1))
            row = None
            if name:
                row = {"kernel": name.group(1)}
                if name.lastindex and name.lastindex >= 2:
                    row["head_dim"] = int(name.group(2))
                rows.append(row)
            continue
        if row is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            row["spill_stores"] = int(spill.group(1))
            row["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            row["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            row["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def _spilled(row: dict) -> bool:
    return bool(row.get("spill_stores", 0) or row.get("spill_loads", 0))


def build() -> dict:
    """Build the two kernel libraries and the native decoder at once (one
    compiler process each), then check their reports."""
    from concurrent.futures import ThreadPoolExecutor

    from lance_distributed_training_tpu_torch.native import coeffs, jpeg
    from lance_distributed_training_tpu_torch.ops import (
        _build,
        flash,
        image,
        jpeg_device,
        ring_attention,
        token_device,
    )

    t0 = time.monotonic()
    with ThreadPoolExecutor(7) as pool:
        futures = [pool.submit(_build.build_library, stem)
                   for stem in ("flash_attn", "image", "jpeg_decode",
                                "token_pack", "ring_attn")]
        native = pool.submit(jpeg.native_available)
        extractor = pool.submit(coeffs.default_threads)
        for future in futures:
            future.result()
        native_ok = native.result()
        extractor_threads = extractor.result()  # raises if it did not build
    lib = flash._library()
    image._library()
    jpeg_device._library()
    token_device._library()
    ring_attention._library()
    report = _build.build_report("flash_attn")
    kernels = _ptxas_kernels(report["ptxas"])
    for row in kernels:
        row["dynamic_smem_bytes"] = lib.ldt_flash_smem_bytes(
            KERNEL_IDS[row["kernel"]], row["head_dim"])
    image_report = _build.build_report("image")
    image_rows = _ptxas_kernels(image_report["ptxas"],
                                r"image_normalize_(rows|groups)_kernel")
    jpeg_report = _build.build_report("jpeg_decode")
    jpeg_rows = _ptxas_kernels(jpeg_report["ptxas"],
                               r"(jpeg_decode)_kernel")
    token_report = _build.build_report("token_pack")
    token_rows = _ptxas_kernels(token_report["ptxas"],
                                r"(token_pack|token_unpack)_kernel")
    ring_report = _build.build_report("ring_attn")
    ring_rows = _ptxas_kernels(
        ring_report["ptxas"],
        r"(ring_fold_fwd|ring_fold_bwd_dq|ring_fold_bwd_dkv)_kernel")
    emit("build", seconds=time.monotonic() - t0,
         nvcc_seconds=report["seconds"], cached=report["cached"],
         kernels=kernels, image_nvcc_seconds=image_report["seconds"],
         image_kernels=image_rows,
         jpeg_nvcc_seconds=jpeg_report["seconds"], jpeg_kernels=jpeg_rows,
         token_nvcc_seconds=token_report["seconds"], token_kernels=token_rows,
         ring_nvcc_seconds=ring_report["seconds"], ring_kernels=ring_rows,
         native_decoder=native_ok, native_decoder_error=jpeg.build_error(),
         coefficient_extractor_threads=extractor_threads)
    builds = {(r["kernel"], r["head_dim"]) for r in kernels}
    want = {(k, d) for k in KERNEL_IDS for d in flash.HEAD_DIMS}
    if builds != want or not all("registers" in r for r in kernels):
        raise RuntimeError(f"ptxas report covers {sorted(builds)}, "
                           f"expected {sorted(want)}")
    spills = [r for r in kernels if r["head_dim"] == 64 and _spilled(r)]
    if spills:
        raise RuntimeError(f"ptxas spills at head dim 64: {spills}")
    if (sorted(r["kernel"] for r in image_rows) != ["groups", "rows"]
            or not all("registers" in r for r in image_rows)):
        raise RuntimeError(f"ptxas report of image.cu: {image_rows}")
    if any(_spilled(r) for r in image_rows):
        raise RuntimeError(f"ptxas spills in K1: {image_rows}")
    if ([r["kernel"] for r in jpeg_rows] != ["jpeg_decode"]
            or not all("registers" in r for r in jpeg_rows)):
        raise RuntimeError(f"ptxas report of jpeg_decode.cu: {jpeg_rows}")
    if any(_spilled(r) for r in jpeg_rows):
        raise RuntimeError(f"ptxas spills in K2: {jpeg_rows}")
    if (sorted(r["kernel"] for r in token_rows)
            != ["token_pack", "token_unpack"]
            or not all("registers" in r for r in token_rows)):
        raise RuntimeError(f"ptxas report of token_pack.cu: {token_rows}")
    if any(_spilled(r) for r in token_rows):
        raise RuntimeError(f"ptxas spills in K3: {token_rows}")
    if (sorted(r["kernel"] for r in ring_rows)
            != ["ring_fold_bwd_dkv", "ring_fold_bwd_dq", "ring_fold_fwd"]
            or not all("registers" in r for r in ring_rows)):
        raise RuntimeError(f"ptxas report of ring_attn.cu: {ring_rows}")
    if any(_spilled(r) for r in ring_rows):
        raise RuntimeError(f"ptxas spills in K5: {ring_rows}")
    return {"image_ptxas": image_rows, "jpeg_ptxas": jpeg_rows,
            "token_ptxas": token_rows, "ring_ptxas": ring_rows}


def _bounds(b: int, h: int, s: int, d: int) -> dict:
    """Least time for each kernel at these shapes: the larger of its
    matrix-product operations over the bf16 peak and its compulsory bytes
    (each input read once, each output written once) over the HBM rate."""
    bhsd, bhs = b * h * s * d, b * h * s
    seg = b * s * 4
    work = {
        # fwd: S = QK^T, O = PV; reads q, k, v, seg; writes o (bf16), lse.
        "fwd": (4 * bhsd * s, 3 * bhsd * 2 + seg + bhsd * 2 + bhs * 4),
        # dq: S, dP = dO V^T, dQ = dS K; reads q, k, v, do, lse, di, seg.
        "bwd_dq": (6 * bhsd * s, 4 * bhsd * 2 + 2 * bhs * 4 + seg + bhsd * 2),
        # dkv: S^T, dP^T, dV = P^T dO, dK = dS^T Q; writes dk, dv.
        "bwd_dkv": (8 * bhsd * s,
                    4 * bhsd * 2 + 2 * bhs * 4 + seg + 2 * bhsd * 2),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = {
            "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def _check_flash_case(mode, q, k, v, do, seg, causal, scale, errors) -> None:
    """fwd, dQ and dK/dV on the card against their plain versions in f32
    (the tolerances of the kernels phase), then a repeat launch that must
    give the same bits; ``errors`` keeps each kernel's largest error."""
    import torch
    from lance_distributed_training_tpu_torch.ops import flash

    o, lse = flash.flash_attention_fwd(q, k, v, seg, causal, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = flash.flash_attention_reference(qf, kf, vf, seg,
                                                     causal, scale)
    di = (o_ref * dof).sum(-1)
    dq = flash.flash_attention_bwd_dq(q, k, v, seg, lse_ref, do, di,
                                      causal, scale)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, seg, lse_ref, do, di,
                                           causal, scale)
    dq_ref = flash.flash_attention_bwd_dq_reference(
        qf, kf, vf, seg, lse_ref, dof, di, causal, scale)
    dk_ref, dv_ref = flash.flash_attention_bwd_dkv_reference(
        qf, kf, vf, seg, lse_ref, dof, di, causal, scale)
    torch.cuda.synchronize()

    def nonfinite(t) -> int:
        return int((~torch.isfinite(t)).sum().item())

    # What a NaN comes from, on a line before the check: the inputs, the
    # plain outputs, the kernels' outputs.
    emit("kernels", mode=mode, finite_inputs={
        n: nonfinite(t) == 0 for n, t in (("q", q), ("k", k), ("v", v),
                                           ("do", do))},
        nonfinite_plain={n: nonfinite(t) for n, t in (
            ("o", o_ref), ("lse", lse_ref), ("dq", dq_ref), ("dk", dk_ref),
            ("dv", dv_ref))},
        nonfinite_kernel={n: nonfinite(t) for n, t in (
            ("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv))})
    err = {
        "o": (o.float() - o_ref).abs().max().item(),
        "lse": (lse - lse_ref).abs().max().item(),
    }
    tol = {"o": TOL_O, "lse": TOL_LSE}
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        err[name] = (got.float() - ref).abs().max().item()
        tol[name] = TOL_GRAD_REL * ref.abs().max().item()
    emit("kernels", mode=mode, causal=causal, max_abs_err=err,
         tolerance=tol)
    bad = [n for n in err if not err[n] <= tol[n]]
    if bad:
        raise RuntimeError(f"kernels {mode}: {bad} above tolerance")
    # The same inputs again must give the same bits (no atomics).
    o2, lse2 = flash.flash_attention_fwd(q, k, v, seg, causal, scale)
    dq2 = flash.flash_attention_bwd_dq(q, k, v, seg, lse_ref, do, di,
                                       causal, scale)
    dk2, dv2 = flash.flash_attention_bwd_dkv(q, k, v, seg, lse_ref, do,
                                             di, causal, scale)
    same = {
        "fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
        "bwd_dq": torch.equal(dq, dq2),
        "bwd_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2),
    }
    emit("kernels", mode=mode, bit_identical_on_repeat=same)
    if not all(same.values()):
        raise RuntimeError(f"kernels {mode}: a second launch differs: "
                           f"{same}")
    del o2, lse2, dq2, dk2, dv2
    errors["fwd"] = max(errors["fwd"], err["o"])
    errors["bwd_dq"] = max(errors["bwd_dq"], err["dq"])
    errors["bwd_dkv"] = max(errors["bwd_dkv"], err["dk"], err["dv"])
    del o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref


def kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.ops import flash

    b, h, s, d = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = randn(), randn(), randn(), randn()
    scale = 1.0 / d ** 0.5
    lengths = np.random.default_rng(0).integers(128, s + 1, b)
    valid = np.arange(s)[None, :] < lengths[:, None]
    seg_a = torch.from_numpy(valid.astype(np.int32)).to(dev)
    errors: dict = {"fwd": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    for mode, seg, causal in (("a_padded", seg_a, False),
                              ("b_causal", None, True)):
        _check_flash_case(mode, q, k, v, do, seg, causal, scale, errors)
    # (c): causal with packed segments, ids from real FFD plans of the
    # causal-LM corpus at pack_len 1024 and at 64.
    for pack_len in (GPT_CONTEXT, 64):
        seg_c = _corpus_segment_ids(pack_len).to(dev)
        shape_c = (seg_c.shape[0], h, seg_c.shape[1], d)

        def randn_c():
            return torch.randn(shape_c, generator=gen, device=dev).to(
                torch.bfloat16)

        qc, kc, vc, doc = randn_c(), randn_c(), randn_c(), randn_c()
        _check_flash_case(f"c_packed_causal_{pack_len}", qc, kc, vc, doc,
                          seg_c, True, scale, errors)
        del qc, kc, vc, doc

    # Timings at the main path's inputs (mode a: padding segments).
    _, lse = flash.flash_attention_fwd(q, k, v, seg_a, False, scale)
    o, _ = flash.flash_attention_fwd(q, k, v, seg_a, False, scale)
    di = (o.float() * do.float()).sum(-1)
    ms = {
        "fwd": time_ms(lambda: flash.flash_attention_fwd(
            q, k, v, seg_a, False, scale)),
        "bwd_dq": time_ms(lambda: flash.flash_attention_bwd_dq(
            q, k, v, seg_a, lse, do, di, False, scale)),
        "bwd_dkv": time_ms(lambda: flash.flash_attention_bwd_dkv(
            q, k, v, seg_a, lse, do, di, False, scale)),
    }
    plain_ms = {
        "fwd": time_ms(lambda: flash.flash_attention_reference(
            q, k, v, seg_a, False, scale)),
        "bwd_dq": time_ms(lambda: flash.flash_attention_bwd_dq_reference(
            q, k, v, seg_a, lse, do, di, False, scale)),
        "bwd_dkv": time_ms(lambda: flash.flash_attention_bwd_dkv_reference(
            q, k, v, seg_a, lse, do, di, False, scale)),
    }
    # Yardstick only: the library's fused attention with the same mask.
    attn_mask = (seg_a[:, None, :, None] == seg_a[:, None, None, :])
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=scale))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                             scale=scale)
        out.backward(do)

    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    di_ms = time_ms(lambda: (o.float() * do.float()).sum(-1))
    bounds = _bounds(b, h, s, d)
    library = {"fwd": sdpa_fwd, "bwd_dq": None, "bwd_dkv": None}
    table = {n: {
        "ms": ms[n], "plain_ms": plain_ms[n], "library_ms": library[n],
        "bound_ms": bounds[n]["bound_ms"], "bound_by": bounds[n]["bound_by"],
        "tflops": bounds[n]["flops"] / (ms[n] * 1e-3) / 1e12,
        "share_of_bound": bounds[n]["bound_ms"] / ms[n],
    } for n in ms}
    # No library call computes dQ or dK/dV alone; SDPA's backward (its
    # forward + backward less its forward, one call) computes both rows'
    # work, and stands beside the pair's kernel time on both rows.
    backward = {"dq_dkv_di_plain_op_ms": ms["bwd_dq"] + ms["bwd_dkv"] + di_ms,
                "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd}
    for n in ("bwd_dq", "bwd_dkv"):
        table[n].update(library_bwd_ms=backward["sdpa_bwd_ms"],
                        pair_ms=ms["bwd_dq"] + ms["bwd_dkv"])
    emit("kernels", timing="a_padded", table=table,
         library_ms={"sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd_ms},
         di_plain_op_ms=di_ms, backward=backward)
    return {"errors": errors, "table": table}


def _dense_vs_flash_check() -> None:
    """A small bf16 encoder with flash attention against the same weights
    with the dense attention path, at valid positions."""
    import torch
    from lance_distributed_training_tpu_torch.models.transformer import (
        TransformerEncoder,
    )
    from lance_distributed_training_tpu_torch.ops.flash import (
        make_flash_attention,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    bsz, seq, vocab = 4, 200, 1000
    ids = torch.from_numpy(rng.integers(2, vocab, (bsz, seq))).to(dev)
    lengths = np.array([200, 150, 77, 128])
    mask = torch.from_numpy(
        (np.arange(seq)[None] < lengths[:, None]).astype(np.int8)).to(dev)
    kwargs = dict(vocab_size=vocab, hidden_size=128, num_layers=2,
                  num_heads=2, mlp_dim=256, max_len=seq, device=dev)
    dense = TransformerEncoder(**kwargs)
    fast = TransformerEncoder(attention_fn=make_flash_attention(), **kwargs)
    fast.load_state_dict(dense.state_dict())
    with torch.no_grad():
        ref = dense(ids, mask)
        got = fast(ids, mask)
    keep = mask.bool()
    err = (got[keep] - ref[keep]).abs().max().item()
    tol = 2e-2 * ref[keep].abs().max().item()
    emit("slice", check="flash_vs_dense_logits", max_abs_err=err,
         tolerance=tol, finite=bool(torch.isfinite(got).all().item()))
    if not err <= tol or not torch.isfinite(got).all():
        raise RuntimeError("flash attention disagrees with dense attention")


def _slice_docs():
    """The BERT corpus: ``batch * STEPS`` seeded documents of 128-512
    tokens, Zipf(1.2) ranks folded onto ids 2..vocab-1 (0 is padding, 1
    the mask); returns ``(lengths, docs)``."""
    b, _, s, _ = SHAPE
    vocab = 30522
    rng = np.random.default_rng(0)
    lengths = rng.integers(128, s + 1, b * STEPS)
    docs = [2 + (rng.zipf(1.2, int(n)) - 1) % (vocab - 2) for n in lengths]
    return lengths, docs


def slice_run() -> dict:
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import flash

    _dense_vs_flash_check()
    b, _, s, _ = SHAPE
    lengths, docs = _slice_docs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        t0 = time.monotonic()
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--flash_attention", "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda", "--no_eval_at_end", *FIXED,
        ])
        launches = {k: ops.LAUNCHES[k] for k in flash.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        valid_tokens = int(sum(min(int(n), s) for n in lengths))
    losses = result["losses"]
    steps = result["steps"]
    step_ms = statistics.median(result["step_ms"][4:])
    fields = {
        "steps": steps, "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "tokens_per_sec": b * s / (step_ms / 1e3),
        "valid_tokens_per_sec": valid_tokens / steps / (step_ms / 1e3),
        "peak_memory_allocated_bytes": peak, "launches": launches,
        "dataset_seconds": author_s, "train_seconds": result["total_time"],
        "model_params": result["model_params"],
    }
    emit("slice", **fields)
    if steps != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"ran {steps} steps, expected {STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError("loss did not fall over the run")
    want = LAYERS * steps
    if any(launches[k] != want for k in launches):
        raise RuntimeError(f"launch counts {launches}, expected {want} each")
    return {"launches": launches, "step_ms": step_ms}


def _trainer_runs(path: str, tmp: str) -> dict:
    """The trainer phase's three ``cli train`` runs; for each, ``(result,
    step trace, progress records, launches, peak bytes)``."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.utils import chaos

    b, _, s, _ = SHAPE
    base = [
        "train", "--dataset_path", path, "--task_type", "masked_lm",
        "--model_name", "bert_base", "--seq_len", str(s),
        "--flash_attention", "--batch_size", str(b),
        "--grad_accum", str(TRAINER_ACCUM), "--optimizer", "adamw",
        "--lr", "1e-4", "--lr_schedule", "cosine",
        "--total_steps", str(TRAINER_STEPS), "--epochs", "1",
        "--log_every", "1", "--log_grad_norm", "--no_eval_at_end",
        "--device", "cuda", *FIXED,
    ]
    ckpt = ["--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--checkpoint_every_steps", str(TRAINER_ACCUM)]
    runs = {}
    for name, extra, spec in (
            # Untraced, one progress line: the host runs ahead of the card
            # as in the slice phase, so its micro-steps time like its steps.
            ("timed", ["--log_every", str(TRAINER_STEPS)], None),
            ("control", ["--profile_dir", os.path.join(tmp, "profile")],
             None),
            ("preempted", ckpt, f"drain@{TRAINER_DRAIN}"),
            ("resumed", ckpt, None)):
        trace = os.path.join(tmp, f"{name}.trace.jsonl")
        metrics = os.path.join(tmp, f"{name}.metrics.jsonl")
        os.environ["LDT_METRICS_PATH"] = metrics
        if name != "timed":
            os.environ[chaos.TRACE_ENV] = trace
        if spec:
            os.environ[chaos.CHAOS_ENV] = spec
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        try:
            result = cli.main(base + extra)
        finally:
            os.environ.pop(chaos.TRACE_ENV, None)
            os.environ.pop(chaos.CHAOS_ENV, None)
        launches = {k: ops.LAUNCHES[k] for k in ops.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(metrics, encoding="utf-8") as f:
            records = [r for r in map(json.loads, f) if "loss" in r]
        runs[name] = (result, chaos.read_trace(trace), records, launches,
                      peak)
        if name == "timed":
            del result["model"], result["optimizer"]  # free the card
    return runs


def _profile_kernels(events: list, top: int = 12) -> dict:
    """Device time in a profiler window's Chrome trace: the kernels' summed
    time, the window from the first kernel's start to the last one's end,
    the idle share between, and the ``top`` kernels by summed time (name
    cut to 120 characters, ms, launches)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler's trace holds no device kernel")
    busy = sum(e["dur"] for e in kernels) / 1e3
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels)) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernel_ms": busy, "window_ms": span,
            "idle_pct": 100.0 * (1.0 - busy / span),
            "top": [[name[:120], ms, n] for name, (ms, n) in ranked]}


def trainer_run(card: dict, slice_step_ms) -> dict:
    """BERT-base through the trainer beyond the main path: gradient
    accumulation, a drain mid-window, an emergency checkpoint and a resume
    that must equal the uninterrupted control bit for bit (module
    docstring, phase 5)."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.trainer import (
        TrainConfig,
        lr_schedule_fn,
    )
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    b, _, s, _ = SHAPE
    _, docs = _slice_docs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs[:b * TRAINER_STEPS], seq_len=s,
                                  pack=False)
        runs = _trainer_runs(path, tmp)
        timed, _, _, tlaunch, tpeak = runs["timed"]
        control, ctrace, crecords, claunch, cpeak = runs["control"]
        pre, ptrace, precords, plaunch, ppeak = runs["preempted"]
        res, rtrace, rrecords, rlaunch, rpeak = runs["resumed"]
        manager = CheckpointManager(os.path.join(tmp, "ckpt"))
        # The emergency checkpoint's accumulator count, read from its index
        # without loading a tensor.
        with manager.reader(TRAINER_DRAIN) as reader:
            emergency_micro = reader.tree()["train_step"]["micro_step"]
        ckpt_bytes = manager.step_bytes(TRAINER_DRAIN)
        profile = control["profile_trace"]
        with open(profile, encoding="utf-8") as f:
            text = f.read()
        profile_names = {k: text.count(f"flash_{k}_kernel")
                         for k in ("fwd", "bwd_dq", "bwd_dkv")}
        profile_bytes = len(text)
        window = _profile_kernels(json.loads(text)["traceEvents"])
        del text
    params = control["model_params"]
    fold_bytes = 3 * 4 * params  # read acc and g, write acc (f32)
    schedule = lr_schedule_fn(
        TrainConfig(dataset_path="-", lr=1e-4, lr_schedule="cosine",
                    grad_accum=TRAINER_ACCUM), TRAINER_STEPS)
    fields = {
        "nvidia_smi": card["smi"], "micro_steps": TRAINER_STEPS,
        "grad_accum": TRAINER_ACCUM, "rows_per_update": b * TRAINER_ACCUM,
        "micro_step_ms_median_2_12": statistics.median(
            timed["step_ms"][1:]),
        "micro_step_ms": timed["step_ms"],
        "slice_step_ms_median_5_20": slice_step_ms,
        # With the step trace and a progress line each micro-step, the host
        # syncs every step; the control's steps 2-12 are also profiled.
        "traced_micro_step_ms": {"control": control["step_ms"],
                                 "preempted": pre["step_ms"],
                                 "resumed": res["step_ms"]},
        "accum_fold_ms": {k: r["accum_fold_ms"] for k, r in
                          (("timed", timed), ("control", control),
                           ("preempted", pre), ("resumed", res))},
        "accum_fold_bytes": fold_bytes,
        "accum_fold_bound_ms": fold_bytes / PEAK_BYTES * 1e3,
        "ckpt_save_ms": {"preempted": pre["ckpt_save_ms"],
                         "resumed": res["ckpt_save_ms"]},
        "ckpt_write_ms": {"preempted": pre["ckpt_write_ms"],
                          "resumed": res["ckpt_write_ms"]},
        "ckpt_bytes": ckpt_bytes, "ckpt_restore_ms": res["ckpt_restore_ms"],
        "emergency_micro_step": emergency_micro,
        "peak_memory_allocated_bytes": {"timed": tpeak, "control": cpeak,
                                        "preempted": ppeak,
                                        "resumed": rpeak},
        "launches": {"timed": tlaunch, "control": claunch,
                     "preempted": plaunch, "resumed": rlaunch},
        "losses": {"timed": timed["losses"], "control": control["losses"],
                   "preempted": pre["losses"], "resumed": res["losses"]},
        "resumed_steps": [t["step"] for t in rtrace],
        "profile_kernel_mentions": profile_names,
        "profile_window": window,
        "profile_trace_bytes": profile_bytes, "model_params": params,
    }
    emit("trainer", **fields)
    runs_steps = {"timed": (timed, TRAINER_STEPS, 0),
                  "control": (control, TRAINER_STEPS, 0),
                  "preempted": (pre, TRAINER_DRAIN, 0),
                  "resumed": (res, TRAINER_STEPS - TRAINER_DRAIN,
                              TRAINER_DRAIN)}
    for name, (result, steps, start) in runs_steps.items():
        if result["steps"] != steps or result["global_step"] != start + steps:
            raise RuntimeError(f"{name}: ran {result['steps']} steps to "
                               f"{result['global_step']}, expected {steps} "
                               f"to {start + steps}")
        if not all(np.isfinite(result["losses"])):
            raise RuntimeError(f"{name}: non-finite loss")
        want = {k: LAYERS * steps for k in ("fwd", "bwd_dq", "bwd_dkv")}
        want.update(dict.fromkeys(RING_KERNELS, 0))
        got = runs[name][3]
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if wrong:
            raise RuntimeError(f"{name}: launches (got, expected) {wrong}")
        records = runs[name][2]
        logged = list(range(1, steps + 1)) if name != "timed" else [steps]
        if [r["step"] for r in records] != logged:
            raise RuntimeError(f"{name}: progress lines at "
                               f"{[r['step'] for r in records]}")
        for r in records:
            norm = r.get("grad_norm")
            if norm is None or not np.isfinite(norm) or norm <= 0:
                raise RuntimeError(f"{name}: grad_norm {norm} at {r['step']}")
            want_lr = schedule((start + r["step"]) // TRAINER_ACCUM)
            if abs(r["lr"] - want_lr) > 1e-12:
                raise RuntimeError(f"{name}: lr {r['lr']} at micro-step "
                                   f"{start + r['step']}, schedule {want_lr}")
        if name in ("control", "resumed"):
            adam = {float(v["step"]) for v in
                    result["optimizer"].state_dict()["state"].values()}
            if adam != {TRAINER_STEPS // TRAINER_ACCUM}:
                raise RuntimeError(f"{name}: AdamW steps {adam}")
    if not pre.get("preempted") or emergency_micro != (
            TRAINER_DRAIN % TRAINER_ACCUM):
        raise RuntimeError(f"the drained run's emergency checkpoint holds "
                           f"micro-step {emergency_micro}")
    if res["start_epoch"] != 0 or [t["step"] for t in rtrace] != list(
            range(TRAINER_DRAIN + 1, TRAINER_STEPS + 1)):
        raise RuntimeError(f"resumed at {[t['step'] for t in rtrace]}")
    by_step = {t["step"]: t for t in ctrace}
    for t in rtrace:
        ref = by_step[t["step"]]
        if (t["batch_sha256"], t["loss"]) != (ref["batch_sha256"],
                                              ref["loss"]):
            raise RuntimeError(f"step {t['step']}: resumed {t} != control "
                               f"{ref}")
    if res["losses"] != control["losses"][TRAINER_DRAIN:] or \
            pre["losses"] != control["losses"][:TRAINER_DRAIN] or \
            timed["losses"] != control["losses"]:
        raise RuntimeError("the losses differ from the control's")
    for (key, got), want in zip(res["model"].state_dict().items(),
                                control["model"].state_dict().values()):
        if not torch.equal(got, want):
            raise RuntimeError(f"final parameter {key} differs from the "
                               "control's")
    if min(profile_names.values()) < 1:
        raise RuntimeError(f"the profiler's trace names the flash kernels "
                           f"{profile_names} times")
    return {"micro_step_ms": fields["micro_step_ms_median_2_12"]}


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def image_kernels() -> dict:
    """K1 against its plain version, bit for bit, then timed."""
    import torch
    from lance_distributed_training_tpu_torch.ops import image

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def plain(x, mask):
        out = image.normalize_images_reference(x)
        return out if mask is None else image.random_flip_reference(out, mask)

    # Every uint8 value in every channel, then the path's shape and others:
    # W = 16, 48 and 224 (rows route), W = 17 (groups route, bytes), rows
    # that do not fill the last chunk (H = 7), rows too wide for a full
    # chunk (W = 2048: one row a chunk) or for any (W = 4096 and 8192:
    # groups route, 16-byte vectors), and batches sliced off a larger
    # buffer 1 byte in, so not 16-byte aligned (groups route, bytes); each
    # with no mask, a random mask and an all-set mask.
    every = torch.arange(256, dtype=torch.uint8, device=dev)
    every = every.repeat_interleave(3).reshape(1, 16, 16, 3)
    cases = [("every_value", every)]
    for shape in IMAGE_CASES:
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        cases.append(("x".join(map(str, shape)), x))
    for shape in IMAGE_UNALIGNED_CASES:
        flat = torch.randint(0, 256, (1 + int(np.prod(shape)),), generator=gen,
                             device=dev, dtype=torch.uint8)
        x = flat[1:].view(shape)
        assert x.data_ptr() % 16 != 0
        cases.append(("unaligned_" + "x".join(map(str, shape)), x))
    checked = []
    for label, x in cases:
        b = x.shape[0]
        masks = {"none": None,
                 "random": torch.rand(b, generator=gen, device=dev) < 0.5,
                 "all": torch.ones(b, dtype=torch.bool, device=dev)}
        for mask_name, mask in masks.items():
            got = image.normalize_flip(x, mask)
            want = plain(x, mask)
            torch.cuda.synchronize()
            same = _bits_equal(got, want)
            checked.append({"shape": label, "mask": mask_name,
                            "bit_identical": same})
            if not same:
                diff = (got.float() - want.float()).abs().max().item()
                emit("image_kernels", failed=checked[-1], max_abs_err=diff)
                raise RuntimeError(f"K1 differs from its plain version at "
                                   f"{label}, mask {mask_name}")
    emit("image_kernels", checks=checked, max_abs_err=0.0)

    x = cases[1][1]
    mask = torch.rand(x.shape[0], generator=gen, device=dev) < 0.5
    ms = time_back_to_back_ms(lambda: image.normalize_flip(x, mask))
    plain_ms = time_back_to_back_ms(lambda: plain(x, mask))
    # Bytes K1 must move: the input and the mask read once, the bf16 output
    # written once. The bound takes the card's published memory rate; a
    # device-to-device copy of as many bytes is measured beside it.
    moved = x.numel() * (1 + 2) + mask.numel()
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_back_to_back_ms(lambda: dst.copy_(src))
    t_bytes = moved / PEAK_BYTES
    t_ops = IMAGE_OPS * x.numel() / PEAK_F32_FLOPS
    fields = {
        "shape": list(x.shape), "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bytes": moved, "copy_ms": copy_ms,
        "measured_bytes_per_s": 2 * (moved // 2) / (copy_ms * 1e-3),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    fields["share_of_bound"] = fields["bound_ms"] / ms
    emit("image_kernels", timing="path_shape", **fields)
    del src, dst
    return fields


def _learnable_dataset(drawn: str, path: str, rows: int,
                       unique: int = UNIQUE_IMAGES) -> None:
    """The FOOD-101-shaped synthetic dataset (101 classes, 224 px JPEG,
    ``unique`` seeded noise images over ``rows`` rows), with each
    row's label replaced by the index of its image: the authoring function
    draws labels independently of the images, which leaves nothing to learn
    and the loss nothing to fall by."""
    import pyarrow as pa
    from lance_distributed_training_tpu_torch.data import (
        IMAGE_SCHEMA,
        Dataset,
        create_synthetic_classification_dataset,
        write_dataset,
    )

    create_synthetic_classification_dataset(
        drawn, rows=rows, num_classes=IMAGE_CLASSES, image_size=224,
        unique_images=unique)
    table = Dataset(drawn).take(np.arange(rows))
    labels = pa.array(np.arange(rows) % unique, pa.int64())
    table = table.set_column(1, "label", labels)
    write_dataset(table, path, schema=IMAGE_SCHEMA, mode="create")


def _resnet_run(source: str, flags: list, author_s: float,
                tmp: str, tuned: bool = False) -> tuple:
    """ResNet-50 classification through ``cli train`` for STEPS steps at
    the path's width over ``source`` with ``flags``, the tuner off unless
    ``tuned``: ``(result, launches, fields)``, the fields every ResNet
    phase prints."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = cli.main([
        "train", "--dataset_path", source, "--task_type", "classification",
        "--model_name", "resnet50", "--image_size", "224",
        "--num_classes", str(IMAGE_CLASSES), "--batch_size", str(IMAGE_BATCH),
        "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
        "--device", "cuda", *([] if tuned else FIXED), *flags,
    ])
    launches = dict(ops.LAUNCHES)
    losses = result["losses"]
    fields = {
        "batch": IMAGE_BATCH, "steps": result["steps"],
        "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": statistics.median(result["step_ms"][4:]),
        "images_per_sec_steps_6_20": result["images_per_sec"],
        "images_per_sec_whole_run": result["images_per_sec_whole_run"],
        "loader_stall_pct": result["loader_stall_pct"],
        "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "eval_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"),
        "decoder": result["decoder_arm"],
        "image_normalize_launches": launches["image_normalize"],
        "jpeg_decode_launches": launches["jpeg_decode"],
        "dataset_seconds": author_s, "train_seconds": result["train_time"],
        "total_seconds": result["total_time"],
        "model_params": result["model_params"],
        **{k: result.get(k) for k in ("decode_entropy_ms",
                                      "decode_device_ms", "decode_threads")},
    }
    return result, launches, fields


def _check_trained(phase: str, fields: dict, steps: int = STEPS) -> None:
    """``steps`` finite losses whose last five average below the first."""
    losses = fields["losses"]
    if fields["steps"] != steps or len(losses) != steps:
        raise RuntimeError(f"{phase}: ran {fields['steps']} steps, expected "
                           f"{steps}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{phase}: non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError(f"{phase}: loss did not fall over the run")


def classification_run(device_decode: bool = False) -> dict:
    """ResNet-50 classification through ``cli train`` for STEPS steps, fed
    pixels decoded on the host or, with ``device_decode``, coefficient
    pages that K2 decodes on the card."""
    phase = "device_decode" if device_decode else "classification"
    rows = IMAGE_BATCH * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        _, launches, fields = _resnet_run(
            path, ["--device_decode"] if device_decode else [], author_s,
            tmp)
    eval_batches = -(-rows // IMAGE_BATCH)
    fields.update(dataset_rows=rows, eval_batches=eval_batches)
    emit(phase, **fields)
    _check_trained(phase, fields)
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"eval covered {fields['eval_rows']} rows of "
                           f"{rows}")
    if launches["image_normalize"] != STEPS + eval_batches:
        raise RuntimeError(f"K1 launched {launches['image_normalize']} "
                           f"times, expected {STEPS + eval_batches}")
    k2_want = STEPS + eval_batches if device_decode else 0
    if launches["jpeg_decode"] != k2_want:
        raise RuntimeError(f"K2 launched {launches['jpeg_decode']} times, "
                           f"expected {k2_want}")
    if device_decode:
        if fields["decoder"] != "coeff":
            raise RuntimeError(f"decoder arm {fields['decoder']!r}, "
                               f"expected 'coeff'")
        missing = [k for k in ("decode_entropy_ms", "decode_device_ms",
                               "decode_threads") if not fields[k]]
        if missing:
            raise RuntimeError(f"device_decode run reported no {missing}")
        return {"launches": {"jpeg_decode": launches["jpeg_decode"]},
                "fields": fields}
    return {"launches": {"image_normalize": launches["image_normalize"]},
            "fields": fields}


# The figures the loader phases print beside their paired phase's.
PAIRED = ("step_ms_median_5_20", "images_per_sec_steps_6_20",
          "images_per_sec_whole_run", "loader_stall_pct",
          "peak_memory_allocated_bytes", "dataset_seconds", "train_seconds",
          "decode_entropy_ms", "decode_device_ms")
MAP_ROWS, MAP_FILTER, MAP_VAL_FRACTION = IMAGE_BATCH * 30, "label < 48", 0.1
FOLDER_FILES = 160  # hard links a class directory of the folder phase


def _learnable_tree(root: str, files: int = FOLDER_FILES) -> None:
    """An ImageFolder tree of ``UNIQUE_IMAGES`` class directories: class
    ``c`` holds ``files`` hard links to one 224 px noise JPEG, the
    image ``c`` of the classification set (the authoring pool's recipe and
    seed), so that the label can be learnt and the bytes are the columnar
    phases' bytes."""
    import io

    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(UNIQUE_IMAGES):
        arr = (rng.random((224, 224, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=85)
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir)
        first = os.path.join(cdir, "00000.jpg")
        with open(first, "wb") as f:
            f.write(buf.getvalue())
        for i in range(1, files):
            os.link(first, os.path.join(cdir, f"{i:05d}.jpg"))


def _read_ms(read, items) -> float:
    """Host time of ``read(item)``, median over ``items`` (ms)."""
    times = []
    for item in items:
        t0 = time.perf_counter()
        read(item)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _filesystem(path: str) -> str:
    """The type of the filesystem that holds ``path`` (/proc/mounts)."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if path.startswith(mount) and len(mount) > len(best):
                best, kind = mount, fstype
    return kind


def _emit_paired(phase: str, fields: dict, paired_phase: str,
                 paired) -> None:
    emit(phase, **fields, paired_phase=paired_phase,
         paired={k: paired.get(k) for k in PAIRED} if paired else None)


def map_style_run(paired) -> dict:
    """ResNet-50 through the map-style loader with a filter, a seeded val
    split and device decode (the module's docstring, phase 14)."""
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.data import Dataset

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, MAP_ROWS)
        author_s = time.monotonic() - t0
        dataset = Dataset(path)
        pool = dataset.filter_indices(MAP_FILTER)
        train_pool, val_pool = trainer._split_val_pool(
            trainer.TrainConfig(dataset_path=path, batch_size=IMAGE_BATCH,
                                val_fraction=MAP_VAL_FRACTION), dataset, pool)
        result, launches, fields = _resnet_run(
            path,
            ["--loader_style", "map", "--filter", MAP_FILTER,
             "--val_fraction", str(MAP_VAL_FRACTION), "--eval_every", "1",
             "--device_decode"], author_s, tmp)
        # The host's read of a batch, apart from its decode: a gather of
        # a permuted batch (record batch by record batch, as the loader
        # reads), the same gather over the whole chunked fragment (which
        # concatenates its chunks first), and a contiguous range read.
        columns = ["image", "label"]
        rng = np.random.default_rng(1)
        gathers = [rng.choice(train_pool, IMAGE_BATCH, replace=False)
                   for _ in range(5)]
        whole = dataset._reader(0).table().select(columns)
        fields.update(
            take_read_ms=_read_ms(
                lambda idx: dataset.take(idx, columns=columns), gathers),
            whole_fragment_take_ms=_read_ms(
                lambda idx: whole.take(idx), gathers),
            range_read_ms=_read_ms(
                lambda s: dataset.read_range(0, s, s + IMAGE_BATCH,
                                             columns=columns),
                [b * IMAGE_BATCH for b in range(5)]),
            fragments=len(dataset.fragment_rows()),
            tmp_filesystem=_filesystem(tmp))
    steps = len(train_pool) // IMAGE_BATCH
    eval_batches = -(-len(val_pool) // IMAGE_BATCH)
    evals = len([h for h in result["history"] if "val_rows" in h]) + (
        "eval_rows" in result)
    val_rows = [h.get("val_rows") for h in result["history"]]
    fields.update(dataset_rows=MAP_ROWS, filter_rows=len(pool),
                  train_rows=len(train_pool), val_rows=len(val_pool),
                  plan_steps=steps, eval_batches=eval_batches, evals=evals,
                  history_val_rows=val_rows)
    _emit_paired("map_style", fields, "device_decode", paired)
    _check_trained("map_style", fields)
    if steps != STEPS:
        raise RuntimeError(f"the train pool holds {steps} steps, expected "
                           f"{STEPS}")
    if np.intersect1d(train_pool, val_pool).size:
        raise RuntimeError("a val row is a train row")
    if val_rows != [len(val_pool)] or fields["eval_rows"] != len(val_pool):
        raise RuntimeError(f"the evals covered {val_rows} and "
                           f"{fields['eval_rows']} rows, expected "
                           f"{len(val_pool)} each")
    # The eval at the epoch's end (--eval_every 1) and the eval at the end
    # both run: K1 and K2 launch once a train step and once an eval batch.
    want = STEPS + 2 * eval_batches
    if evals != 2:
        raise RuntimeError(f"{evals} evals ran, expected 2")
    for name in ("image_normalize", "jpeg_decode"):
        if launches[name] != want:
            raise RuntimeError(f"{name} launched {launches[name]} times "
                               f"under the map-style loader, expected {want}")
    if fields["decoder"] != "coeff":
        raise RuntimeError(f"decoder arm {fields['decoder']!r}, expected "
                           f"'coeff'")
    return {"launches": {k: launches[k] for k in ("image_normalize",
                                                  "jpeg_decode")}}


def folder_run(paired) -> dict:
    """ResNet-50 through the folder arm, map style, host decode (the
    module's docstring, phase 15)."""
    from lance_distributed_training_tpu_torch.data import (
        distributed_index_batches,
        read_sample_batch,
    )
    from lance_distributed_training_tpu_torch.data.authoring import (
        _folder_samples,
    )

    files = UNIQUE_IMAGES * FOLDER_FILES
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tree")
        t0 = time.monotonic()
        _learnable_tree(root)
        author_s = time.monotonic() - t0
        result, launches, fields = _resnet_run(
            root, ["--data_format", "folder", "--loader_style", "map"],
            author_s, tmp)
        # The host's read of a batch of files, apart from its decode.
        samples = _folder_samples(root)[0]
        batches = distributed_index_batches(files, IMAGE_BATCH, 0, 1,
                                            seed=1)[:5]
        fields.update(
            file_read_ms=_read_ms(
                lambda idx: read_sample_batch(samples, idx), batches),
            tmp_filesystem=_filesystem(tmp))
    eval_batches = -(-files // IMAGE_BATCH)
    fields.update(tree_files=files, eval_batches=eval_batches)
    _emit_paired("folder", fields, "classification", paired)
    _check_trained("folder", fields)
    if fields["eval_rows"] != files:
        raise RuntimeError(f"eval covered {fields['eval_rows']} files of "
                           f"{files}")
    if launches["image_normalize"] != STEPS + eval_batches:
        raise RuntimeError(f"K1 launched {launches['image_normalize']} "
                           f"times, expected {STEPS + eval_batches}")
    if launches["jpeg_decode"]:
        raise RuntimeError(f"K2 launched {launches['jpeg_decode']} times "
                           f"under host decode")
    return {"launches": {k: launches[k] for k in ("image_normalize",
                                                  "jpeg_decode")}}


# The synchronous control arm of the placement phase: today's path.
PLACEMENT_CONTROL = ["--no_global_batch", "--producer_threads", "1",
                     "--no_buffer_pool"]
PRODUCERS, RING_DEPTH = 4, 2  # the JAX trainer's defaults
PRETRAINED_CLASSES = 1000  # the checkpoint's head, torchvision's


def _loader_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(("ldt-placement", "ldt-producer")))


def _write_pretrained(path: str) -> dict:
    """The port's ResNet-50 with 1000 classes from a seeded generator,
    written as a torchvision checkpoint behind a DDP wrapper:
    ``{"state_dict": {"module." + k: v}}`` with torchvision's zero
    ``num_batches_tracked`` entries. Returns the plain state_dict."""
    import torch
    from lance_distributed_training_tpu_torch.models.resnet import resnet50

    model = resnet50(num_classes=PRETRAINED_CLASSES,
                     generator=torch.Generator().manual_seed(13))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    saved = {}
    for key, value in state.items():
        saved["module." + key] = value
        if key.endswith("running_var"):
            saved["module." + key.replace("running_var",
                                          "num_batches_tracked")] = (
                torch.zeros((), dtype=torch.int64))
    torch.save({"state_dict": saved, "epoch": 90}, path)
    return state


def _import_check(path: str, state: dict) -> dict:
    """``load_torchvision_resnet`` into a 101-class ResNet-50 on the card:
    every backbone tensor equals the file's bit for bit, and the head is a
    same-seed model's fresh ``[101, 2048]`` one."""
    import torch
    from lance_distributed_training_tpu_torch.models.pretrained import (
        load_torch_state_dict,
        load_torchvision_resnet,
    )
    from lance_distributed_training_tpu_torch.models.resnet import resnet50

    seed = torch.Generator().manual_seed(14)
    model = resnet50(num_classes=IMAGE_CLASSES, device="cuda", generator=seed)
    fresh = resnet50(num_classes=IMAGE_CLASSES,
                     generator=torch.Generator().manual_seed(14))
    t0 = time.monotonic()
    load_torchvision_resnet(model, load_torch_state_dict(path), "resnet50")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    got = model.state_dict()
    backbone = [k for k in got if not k.startswith("fc.")]
    differ = [k for k in backbone if not torch.equal(got[k].cpu(), state[k])]
    head_fresh = (tuple(model.fc.weight.shape) == (IMAGE_CLASSES, 2048)
                  and torch.equal(got["fc.weight"].cpu(), fresh.fc.weight)
                  and torch.equal(got["fc.bias"].cpu(), fresh.fc.bias))
    fields = {"backbone_tensors": len(backbone), "differ": differ,
              "head_shape": list(model.fc.weight.shape),
              "head_fresh": head_fresh, "load_seconds": load_s,
              "channels_last": model.conv1.weight.is_contiguous(
                  memory_format=torch.channels_last)}
    emit("pretrained_placement", check="import", **fields)
    if differ or not head_fresh:
        raise RuntimeError(f"pretrained import: {len(differ)} backbone "
                           f"tensors differ, head fresh: {head_fresh}")
    return fields


def _digest(t, weights: dict):
    """An int64 digest of a tensor's bytes, on the card: the sum of its
    32-bit (or 16-bit, or 8-bit) words, each times a fixed odd weight,
    modulo 2^64 (integer sums do not depend on their order)."""
    import torch

    flat = t.contiguous().view(-1)
    nbytes = flat.numel() * flat.element_size()
    word = (torch.int32 if nbytes % 4 == 0 else
            torch.int16 if nbytes % 2 == 0 else torch.uint8)
    words = flat.view(torch.uint8).view(word)
    n = words.numel()
    if n not in weights:
        weights[n] = torch.arange(n, dtype=torch.int64,
                                  device=t.device) * 2654435761 + 1
    return (words.to(torch.int64) * weights[n]).sum()


def _overlap_run(path: str, device_decode: bool, placed: bool) -> dict:
    """The first STEPS batches of the iterable loader over ``path``: placed
    by the plane (depth 2, 4 producers, pooled page-locked pages), each
    followed by K1 (after K2 in the coeff arm) and a ResNet-50 forward and
    backward, so that the copies of batches n + 1 and n + 2 overlap batch
    n's kernels; or through the synchronous arm (one producer, no pool),
    K1 only. Each batch's leaves are digested after the step, K1's output
    before it."""
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        PlacementPlane,
        decoder_for_task,
        default_buffer_pool,
        make_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.models.resnet import resnet50
    from lance_distributed_training_tpu_torch.ops import image
    from lance_distributed_training_tpu_torch.ops.jpeg_device import (
        make_batch_transform,
    )

    dev = torch.device("cuda")
    pool = default_buffer_pool(pin_memory=True) if placed else None
    decode = decoder_for_task("classification", image_size=224,
                              device_decode=device_decode, buffer_pool=pool)
    loader = make_train_pipeline(
        Dataset(path), "batch", IMAGE_BATCH, 0, 1, decode,
        None if placed else dev, producers=PRODUCERS if placed else 1,
        buffer_pool=pool)
    plane = None
    if placed:
        plane = PlacementPlane(dev, depth=RING_DEPTH, buffer_pool=pool)
        loader = plane.wrap(loader)
    model = None
    if placed:
        model = resnet50(num_classes=IMAGE_CLASSES, device=dev,
                         generator=torch.Generator().manual_seed(15))
    transform = make_batch_transform(224)
    flips = torch.Generator().manual_seed(16)
    weights: dict = {}
    digests = []
    t0 = time.monotonic()
    it = iter(loader)
    try:
        for _ in range(STEPS):
            batch = next(it)
            flip = (torch.rand(IMAGE_BATCH, generator=flips) < 0.5).to(dev)
            images = transform(batch)["image"]
            x = image.normalize_flip(images, flip)
            out_digest = _digest(x, weights)
            if model is not None:
                logits = model(x.permute(0, 3, 1, 2))
                F.cross_entropy(logits.float(),
                                batch["label"].long()).backward()
                del logits
            digests.append(([_digest(v, weights) for k, v in
                             sorted(batch.items())
                             if isinstance(v, torch.Tensor)], out_digest))
            del batch, images, x
    finally:
        it.close()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    return {"digests": [([int(d) for d in leaves], int(out))
                        for leaves, out in digests],
            "seconds": seconds, "decoder": decode.arm,
            "placement_ms": plane.h2d_ms if plane is not None else None}


def _run_fields(result: dict, fields: dict, launches: dict) -> dict:
    """The figures each fine-tuning run prints."""
    placement = result.get("placement_ms") or []
    return {
        "decoder": fields["decoder"],
        "step_ms_median_5_20": fields["step_ms_median_5_20"],
        "images_per_sec_steps_6_20": fields["images_per_sec_steps_6_20"],
        "loader_stall_pct": fields["loader_stall_pct"],
        "h2d_pct": result.get("h2d_pct"),
        "placement_ms_median": (statistics.median(placement)
                                if placement else None),
        "placement_ms_first3": placement[:3],
        "bufpool_hits": result["bufpool_hits"],
        "bufpool_misses": result["bufpool_misses"],
        "bufpool_miss_ms": result["bufpool_miss_ms"],
        "peak_memory_allocated_bytes": fields["peak_memory_allocated_bytes"],
        "first_loss": fields["first_loss"],
        "last5_mean_loss": fields["last5_mean_loss"],
        "losses": fields["losses"], "steps": fields["steps"],
        "eval_accuracy": fields["eval_accuracy"],
        "eval_rows": fields["eval_rows"],
        "image_normalize_launches": launches["image_normalize"],
        "jpeg_decode_launches": launches["jpeg_decode"],
        "decode_entropy_ms": fields["decode_entropy_ms"],
        "decode_device_ms": fields["decode_device_ms"],
        "train_seconds": fields["train_seconds"],
        "total_seconds": fields["total_seconds"],
        "host_cpu_count": os.cpu_count(),
    }


def pretrained_placement_run() -> dict:
    """ResNet-50 fine-tuning from a seeded torchvision checkpoint through
    the placement plane and its synchronous control arm, in both decoder
    arms (the module's docstring, phase 16)."""
    rows = IMAGE_BATCH * STEPS
    eval_batches = -(-rows // IMAGE_BATCH)
    totals = {"image_normalize": 0, "jpeg_decode": 0}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "resnet50_torchvision.pt")
        state = _write_pretrained(ckpt)
        _import_check(ckpt, state)
        del state
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        for coeff in (False, True):
            arm = "coeff" if coeff else "pixel"
            placed = _overlap_run(path, coeff, placed=True)
            sync = _overlap_run(path, coeff, placed=False)
            same = placed["digests"] == sync["digests"]
            emit("pretrained_placement", check="overlap", arm=arm,
                 decoder=placed["decoder"], batches=len(placed["digests"]),
                 bit_identical=same, placed_seconds=placed["seconds"],
                 sync_seconds=sync["seconds"],
                 placement_ms=placed["placement_ms"])
            if not same:
                bad = [i for i, (a, b) in enumerate(zip(placed["digests"],
                                                        sync["digests"]))
                       if a != b]
                raise RuntimeError(f"{arm} arm: placed batches {bad} differ "
                                   f"from the synchronous arm's")
            if _loader_threads():
                raise RuntimeError(f"loader threads outlived the overlap "
                                   f"check: {_loader_threads()}")
        for coeff in (False, True):
            for control in (False, True):
                name = ("coeff" if coeff else "pixel") + (
                    "_control" if control else "_plane")
                flags = ["--pretrained", ckpt]
                flags += ["--device_decode"] if coeff else []
                flags += PLACEMENT_CONTROL if control else []
                result, launches, fields = _resnet_run(path, flags, author_s,
                                                       tmp)
                left = _loader_threads()
                run = _run_fields(result, fields, launches)
                run.update(flags=flags, loader_threads_after=left,
                           dataset_seconds=author_s)
                emit("pretrained_placement", run=name, **run)
                _check_trained(f"pretrained_placement {name}", fields)
                if left:
                    raise RuntimeError(f"{name}: loader threads outlived "
                                       f"train(): {left}")
                if fields["eval_rows"] != rows:
                    raise RuntimeError(f"{name}: eval covered "
                                       f"{fields['eval_rows']} rows of {rows}")
                want = {"image_normalize": STEPS + eval_batches,
                        "jpeg_decode": STEPS + eval_batches if coeff else 0}
                for kernel, count in want.items():
                    if launches[kernel] != count:
                        raise RuntimeError(
                            f"{name}: {kernel} launched {launches[kernel]} "
                            f"times, expected {count}")
                    totals[kernel] += launches[kernel]
                if not control and not (result["bufpool_hits"]
                                        + result["bufpool_misses"]):
                    raise RuntimeError(f"{name}: the decoders leased no page")
                runs[name] = run
    return {"launches": totals, "runs": runs}


WC_WORKERS = 4  # decode worker processes of the workers_caches phase
WC_EPOCHS = 2
# Batches of 512 an epoch of the workers_caches phase: enough to check
# each plane, few enough to leave the analysis phase its time.
WC_STEPS = 6
# The phase's distinct images (and labels): a prime, so that row i's image
# i % 97 makes each of the phase's batches of 512 start at another image
# and no two batches equal. With 64 (the other phases' corpus) every batch is the
# same, and a reordered, duplicated or wrongly replayed batch could not show.
WC_UNIQUE_IMAGES = 97


def _worker_fds(pids) -> dict:
    """Each worker's open ``/dev/nvidia*`` files: a CUDA context opens the
    card's device files, importing torch does not."""
    out = {}
    for pid in pids:
        fds = []
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    target = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if target.startswith("/dev/nvidia"):
                    fds.append(target)
        except OSError:
            pass
        out[pid] = sorted(fds)
    return out


def _compute_apps() -> list:
    """The processes that hold a CUDA context on the card, as
    ``nvidia-smi --query-compute-apps`` lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


_RING_SESSIONS: list = []  # every ShmRing session this process made


def _record_ring_sessions() -> None:
    """Record the session of every ``ShmRing`` this process makes (the
    trainer's pools' among them), so that the segment checks count this
    process's segments and no other process's on the machine."""
    from lance_distributed_training_tpu_torch.data import buffers

    init = buffers.ShmRing.__init__
    if getattr(init, "records_sessions", False):
        return

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        _RING_SESSIONS.append(self.session)

    recording.records_sessions = True
    buffers.ShmRing.__init__ = recording


def _shm_segments(sessions=None) -> list:
    """The ``ldtshm_<session>_<slot>`` segments of ``sessions`` (default:
    every ring this process made)."""
    import glob

    sessions = _RING_SESSIONS if sessions is None else sessions
    return sorted(f for f in glob.glob("/dev/shm/ldtshm_*")
                  if any(os.path.basename(f).startswith(f"ldtshm_{s}_")
                         for s in sessions))


def _local_dir(name: str) -> tuple:
    """A directory for the batch cache's spill on the machine's own disk:
    the first of the home directory's ``.cache`` (where the port's default
    cache directory lives), the checkout's ``build/`` and the temporary
    directory that is not a network mount. ``(path, filesystem type,
    {candidate: filesystem type})``."""
    remote = ("9p", "nfs", "nfs4", "fuse", "cifs", "smb3", "virtiofs")
    root = os.path.dirname(os.path.abspath(__file__))
    candidates = (os.path.join(os.path.expanduser("~"), ".cache"),
                  os.path.join(root, "build"), tempfile.gettempdir())
    kinds = {}
    for base in candidates:
        os.makedirs(base, exist_ok=True)
        kinds[base] = _filesystem(os.path.realpath(base))
    for base in candidates:
        if kinds[base] not in remote:
            return os.path.join(base, name), kinds[base], kinds
    base = candidates[1]
    return os.path.join(base, name), kinds[base], kinds


def _wc_loader(path: str, coeff: bool, transport) -> dict:
    """The first WC_STEPS batches of the iterable loader over ``path`` at
    the trainer's defaults (page-locked pool pages, the placement plane), read
    and decoded in process (``transport=None``, four producers) or by a
    ``WorkerPool`` of WC_WORKERS processes over ``transport``; each batch's
    leaves, K2's image (coeff arm) and K1's output with a fixed flip mask
    digested on the card. Checks, during the worker runs, that no worker
    holds a CUDA context, and after ``shutdown()`` that no worker process
    and no shared-memory segment of the pool is left."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        PlacementPlane,
        decoder_for_task,
        default_buffer_pool,
        make_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.data.workers import (
        WorkerPool,
        columnar_spec,
    )
    from lance_distributed_training_tpu_torch.obs.registry import (
        default_registry,
    )
    from lance_distributed_training_tpu_torch.ops import image
    from lance_distributed_training_tpu_torch.ops.jpeg_device import (
        make_batch_transform,
    )

    dev = torch.device("cuda")
    pinned = default_buffer_pool(pin_memory=True)
    decode = decoder_for_task("classification", image_size=224,
                              device_decode=coeff, buffer_pool=pinned)
    fallbacks = default_registry().counter("shm_fallback_total")
    fallbacks_before = fallbacks.value
    t0 = time.monotonic()
    pool = None
    if transport is not None:
        pool = WorkerPool(columnar_spec(path), decode, WC_WORKERS,
                          columns=decode.required_columns,
                          transport=transport, buffer_pool=pinned)
    loader = PlacementPlane(dev, depth=RING_DEPTH, buffer_pool=pinned).wrap(
        make_train_pipeline(
            Dataset(path), "batch", IMAGE_BATCH, 0, 1, decode, None,
            producers=1 if pool is not None else PRODUCERS,
            buffer_pool=pinned, workers=pool,
            columns=decode.required_columns))
    transform = make_batch_transform(224)
    flip = (torch.rand(IMAGE_BATCH, generator=torch.Generator().manual_seed(
        17)) < 0.5).to(dev)
    weights: dict = {}
    digests, first_s = [], None
    apps, fds = [], {}
    it = iter(loader)
    try:
        for i in range(WC_STEPS):
            batch = next(it)
            if first_s is None:
                first_s = time.monotonic() - t0
            decoded = transform(batch)
            x = image.normalize_flip(decoded["image"], flip)
            digests.append((
                [_digest(v, weights) for _, v in sorted(batch.items())
                 if isinstance(v, torch.Tensor)],
                _digest(decoded["image"], weights), _digest(x, weights)))
            if pool is not None and i == WC_STEPS // 2:
                apps = _compute_apps()
                fds = _worker_fds(list(pool._pool._processes))
            del batch, decoded, x
    finally:
        it.close()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    out = {"digests": [([int(d) for d in leaves], int(k2), int(k1))
                       for leaves, k2, k1 in digests],
           "seconds": seconds, "first_batch_seconds": first_s,
           "decoder": decode.arm}
    if pool is not None:
        session = pool._ring.session if pool._ring is not None else None
        procs = list(pool._pool._processes.values())
        out.update(transport=pool.transport,
                   shm_fallbacks=fallbacks.value - fallbacks_before,
                   compute_apps=apps, worker_pids=sorted(fds),
                   worker_nvidia_fds=fds)
        pool.shutdown()
        for p in procs:
            p.join(timeout=30)
        out.update(
            workers_alive_after_shutdown=sum(p.is_alive() for p in procs),
            segments_after_shutdown=_shm_segments(
                [session] if session is not None else []))
    return out


def _wc_equality(path: str) -> dict:
    """Loader equality across the in-process, shm and pickle settings in
    both decoder arms (the module's docstring, phase 17, step 1)."""
    import torch

    report = {}
    for coeff in (False, True):
        arm = "coeff" if coeff else "pixel"
        runs = {name: _wc_loader(path, coeff, transport)
                for name, transport in (("in_process", None),
                                        ("shm", "shm"), ("pickle", "pickle"))}
        ref = runs["in_process"]["digests"]
        distinct = len({str(d[0]) for d in ref})
        if distinct != WC_STEPS:
            raise RuntimeError(
                f"{arm} arm: {distinct} distinct batches of {WC_STEPS}: "
                "the "
                "comparison could not see a batch out of order")
        for name in ("shm", "pickle"):
            run = runs[name]
            same = run["digests"] == ref
            held = {pid: fds for pid, fds in run["worker_nvidia_fds"].items()
                    if fds}
            emit("workers_caches", check="loader_equality", arm=arm,
                 setting=name, decoder=run["decoder"],
                 batches=len(run["digests"]), distinct_batches=distinct,
                 bit_identical=same,
                 transport=run["transport"],
                 shm_fallbacks=run["shm_fallbacks"],
                 compute_apps=run["compute_apps"], trainer_pid=os.getpid(),
                 worker_pids=run["worker_pids"],
                 workers_with_nvidia_files=held,
                 workers_alive_after_shutdown=run[
                     "workers_alive_after_shutdown"],
                 segments_after_shutdown=run["segments_after_shutdown"],
                 seconds=run["seconds"],
                 first_batch_seconds=run["first_batch_seconds"],
                 in_process_seconds=runs["in_process"]["seconds"],
                 in_process_first_batch_seconds=runs["in_process"][
                     "first_batch_seconds"])
            if not same:
                bad = [i for i, (a, b) in enumerate(zip(run["digests"], ref))
                       if a != b]
                raise RuntimeError(f"{arm} arm, {name}: batches {bad} differ "
                                   f"from the in-process loader's")
            if run["transport"] != name:
                raise RuntimeError(f"{arm} arm: the pool took the "
                                   f"{run['transport']} transport, not {name}")
            if name == "shm" and run["shm_fallbacks"]:
                raise RuntimeError(f"{arm} arm: {run['shm_fallbacks']} shm "
                                   f"fallbacks")
            if held:
                raise RuntimeError(f"{arm} arm, {name}: workers hold the "
                                   f"card's device files: {held}")
            if len(run["compute_apps"]) > 1:
                raise RuntimeError(f"{arm} arm, {name}: "
                                   f"{run['compute_apps']} hold CUDA contexts")
            if run["workers_alive_after_shutdown"] or run[
                    "segments_after_shutdown"]:
                raise RuntimeError(
                    f"{arm} arm, {name}: "
                    f"{run['workers_alive_after_shutdown']} workers and "
                    f"{run['segments_after_shutdown']} segments outlived "
                    "shutdown()")
        report[arm] = runs["in_process"]["decoder"]
    torch.cuda.empty_cache()
    return report


def _left_behind(segments_before: list) -> dict:
    """What a run left: loader, tuner and pool threads, child processes and
    the shared-memory segments of this process's rings that were not there
    before it."""
    import multiprocessing
    import threading

    # The PIL arm's decode threads (ldt-torch-decode_*) are the process's
    # for its lifetime, as in the JAX package; every other ldt- thread
    # belongs to one run.
    return {
        "threads": sorted(t.name for t in threading.enumerate()
                          if t.name.startswith("ldt-")
                          and not t.name.startswith("ldt-torch-decode")),
        "children": [p.pid for p in multiprocessing.active_children()],
        "segments": [f for f in _shm_segments()
                     if f not in segments_before],
    }


def _progress_lines(tmp: str) -> list:
    """The progress records of the run that wrote ``tmp/metrics.jsonl``."""
    with open(os.path.join(tmp, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if "images_per_sec" in r and "loss" in r]


def _tuner_report(trace_path: str) -> dict:
    """The recorded tuner trace: its verification, the applied decisions
    (knob, from, to, reason) and the policy's bottleneck each tick (a
    replay of the trace through a fresh policy)."""
    from collections import Counter

    from lance_distributed_training_tpu_torch.tune import (
        BOTTLENECK_CODES,
        HillClimbPolicy,
        read_trace,
        verify_trace,
    )

    records = read_trace(trace_path)
    ok, mismatched = verify_trace(trace_path)
    policy = HillClimbPolicy()
    bottlenecks = Counter()
    for r in records:
        policy.decide(r["window"], {k: int(v) for k, v in r["knobs"].items()},
                      {k: (int(v[0]), int(v[1]))
                       for k, v in r["bounds"].items()})
        bottlenecks[policy.last_bottleneck] += 1
    decisions = [[knob, r["knobs"].get(knob), to, reason]
                 for r in records for knob, to, reason in r["applied"]]
    return {"ticks": len(records), "verified": ok, "mismatched": mismatched,
            "decisions": decisions,
            "bottlenecks": {str(k): [BOTTLENECK_CODES.get(k, 0), n]
                            for k, n in bottlenecks.items()}}


def _device_batch_digest(batch) -> str:
    """The step trace's batch digest taken on the card (the int64 digests
    of ``_digest``, one a tensor leaf, key-ordered): a host SHA-256 of a
    77 MB batch would cost the replay epoch more host time than its
    steps."""
    import torch

    weights = _DIGEST_WEIGHTS
    return "|".join(f"{k}:{int(_digest(v, weights))}"
                    for k, v in sorted(batch.items())
                    if isinstance(v, torch.Tensor))


_DIGEST_WEIGHTS: dict = {}


def _wc_run(name: str, path: str, flags: list, author_s: float, tmp: str,
            env: dict = None, device_digests: bool = False) -> tuple:
    """One ``cli train`` run of the phase: ResNet-50 at the path's width
    for WC_EPOCHS epochs (or as ``flags`` say), no eval; ``(result,
    launches, fields)`` with the figures it prints. With
    ``device_digests`` the step trace digests each batch on the card."""
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.obs.registry import (
        RegistryDelta,
        default_registry,
    )

    segments = _shm_segments()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    delta = RegistryDelta(default_registry())
    delta.delta()  # the baseline: the windows below are this run's
    digest_saved = None
    if device_digests:
        digest_saved = trainer.batch_digest
        trainer.batch_digest = _device_batch_digest
    try:
        result, launches, fields = _resnet_run(
            path, ["--max_steps", "0", "--no_eval_at_end", *flags],
            author_s, tmp, tuned=True)
    finally:
        if digest_saved is not None:
            trainer.batch_digest = digest_saved
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    window = delta.delta()
    left = _left_behind(segments)
    history = result["history"]
    fields = {
        "flags": flags, "steps": result["steps"], "decoder": fields["decoder"],
        "epochs": [{k: h.get(k) for k in (
            "epoch", "epoch_steps", "images_per_sec", "epoch_time",
            "train_loss", "replay", "worker_results", "cache_hits",
            "cache_disk_hits", "cache_misses", "autotune_decisions")}
            for h in history],
        "step_ms_median_5_20": fields["step_ms_median_5_20"],
        "images_per_sec_after_first_log": fields[
            "images_per_sec_steps_6_20"],
        "loader_stall_pct": fields["loader_stall_pct"],
        "h2d_pct": result.get("h2d_pct"),
        **{f"{series}_{q}": window.get(f"{series}_{q}")
           for series in ("workers_result_wait_ms", "shm_slot_wait_ms",
                          "pipeline_decode_ms", "cache_lookup_ms",
                          "trainer_h2d_ms")
           for q in ("p50", "p95")},
        "window_images_per_sec": [
            r["images_per_sec"] for r in _progress_lines(tmp)],
        "bufpool_hits": result["bufpool_hits"],
        "bufpool_misses": result["bufpool_misses"],
        "bufpool_miss_ms": result["bufpool_miss_ms"],
        "decode_entropy_ms": fields["decode_entropy_ms"],
        # This process's decodes only: a worker's land in its registry.
        "decode_entropy_ms_p50_in_process": window.get(
            "decode_entropy_ms_p50"),
        "decode_device_ms": fields["decode_device_ms"],
        "peak_memory_allocated_bytes": fields["peak_memory_allocated_bytes"],
        "first_loss": fields["first_loss"],
        "last5_mean_loss": fields["last5_mean_loss"],
        "image_normalize_launches": launches["image_normalize"],
        "jpeg_decode_launches": launches["jpeg_decode"],
        "train_seconds": fields["train_seconds"],
        "left_behind": left,
        **{k: result.get(k) for k in (
            "worker_transport", "shm_fallbacks", "cache_hits",
            "cache_disk_hits", "cache_misses", "cache_stats",
            "autotune_ticks", "autotune_decisions", "device_cache_batches",
            "device_cache_refused", "data_echo", "unique_images_per_sec")},
    }
    os.remove(os.path.join(tmp, "metrics.jsonl"))
    if any(left.values()):
        raise RuntimeError(f"{name}: left behind {left}")
    losses = result["losses"]
    if not all(np.isfinite(losses)) or not (
            statistics.fmean(losses[-5:]) < losses[0]):
        raise RuntimeError(f"{name}: losses {losses} did not fall")
    return result, launches, fields


def workers_caches_run() -> dict:
    """ResNet-50 through the worker pool, the batch cache, the autotuner,
    the HBM replay tier and data echoing (the module's docstring, phase
    17)."""
    import shutil

    import torch

    _record_ring_sessions()
    rows = IMAGE_BATCH * WC_STEPS
    totals = {"image_normalize": 0, "jpeg_decode": 0}
    cache_dir, cache_fs, candidates = _local_dir("ldt_workers_caches")
    shutil.rmtree(cache_dir, ignore_errors=True)
    from lance_distributed_training_tpu_torch.native import coeffs

    shm = os.statvfs("/dev/shm")
    imports = {}
    for label, module in (("worker", "lance_distributed_training_tpu_torch."
                                     "data.workers"), ("torch", "torch")):
        t_import = time.monotonic()
        subprocess.run([sys.executable, "-c", f"import {module}"], check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       timeout=300)
        imports[label] = time.monotonic() - t_import
    # A worker's decoder runs its own threads, as the JAX workers' do: the
    # PIL arm's pool, the extractor's one thread a hardware thread.
    threads = {"pil": max(4, (os.cpu_count() or 8) // 2),
               "coeff": coeffs.default_threads()}
    emit("workers_caches", check="host", host_cpu_count=os.cpu_count(),
         decode_threads_a_worker=threads,
         decode_threads_all_workers={k: v * WC_WORKERS
                                     for k, v in threads.items()},
         dev_shm_bytes=shm.f_blocks * shm.f_frsize,
         dev_shm_free_bytes=shm.f_bavail * shm.f_frsize,
         cache_dir=cache_dir, cache_dir_filesystem=cache_fs,
         cache_dir_candidates=candidates,
         tmp_filesystem=_filesystem(tempfile.gettempdir()),
         worker_import_seconds=imports["worker"],
         torch_import_seconds=imports["torch"])
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "food")
            t0 = time.monotonic()
            _learnable_dataset(os.path.join(tmp, "drawn"), path, rows,
                               WC_UNIQUE_IMAGES)
            author_s = time.monotonic() - t0
            _wc_equality(path)
            steps_trace = os.path.join(tmp, "steps.jsonl")
            plans = [
                ("pil_workers", ["--num_workers", str(WC_WORKERS),
                                 "--batch_cache", "--cache_dir", cache_dir,
                                 "--epochs", str(WC_EPOCHS)],
                 {"LDT_AUTOTUNE_TRACE": os.path.join(tmp, "at_pil.jsonl")}),
                ("pil_control", ["--num_workers", "0", "--no_batch_cache",
                                 "--no_autotune", "--epochs",
                                 str(WC_EPOCHS)], {}),
                ("coeff_workers", ["--device_decode", "--num_workers",
                                   str(WC_WORKERS), "--epochs", "1"],
                 {"LDT_AUTOTUNE_TRACE": os.path.join(tmp,
                                                     "at_coeff.jsonl")}),
                ("coeff_control", ["--device_decode", "--num_workers", "0",
                                   "--no_autotune", "--epochs", "1"], {}),
                ("coeff_replay", ["--device_decode", "--device_cache",
                                  "--data_echo", "2", "--epochs",
                                  str(WC_EPOCHS)],
                 {"LDT_STEP_TRACE_PATH": steps_trace,
                  "LDT_AUTOTUNE_TRACE": os.path.join(tmp,
                                                     "at_replay.jsonl")}),
            ]
            for name, flags, env in plans:
                result, launches, fields = _wc_run(
                    name, path, flags, author_s, tmp, env,
                    device_digests=name == "coeff_replay")
                if "LDT_AUTOTUNE_TRACE" in env:
                    fields["tuner"] = _tuner_report(env["LDT_AUTOTUNE_TRACE"])
                if name == "coeff_replay":
                    fields.update(_replay_report(result, steps_trace))
                emit("workers_caches", run=name, **fields)
                runs[name] = (result, launches, fields)
                for kernel in totals:
                    totals[kernel] += launches[kernel]
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    _wc_checks(runs)
    return {"launches": totals}


def _replay_report(result: dict, steps_trace: str) -> dict:
    """The replay epoch against the fill epoch: the step trace's digests
    (after the transform stage, one a host batch, each step of an echo),
    the replay epoch's rate, step and the card's idle share between its
    steps' events."""
    with open(steps_trace, encoding="utf-8") as f:
        steps = [json.loads(line) for line in f]
    fill = [s["batch_sha256"] for s in steps if s["epoch"] == 0]
    replay = [s["batch_sha256"] for s in steps if s["epoch"] == 1]
    history = result["history"]
    per_epoch = len(fill)
    replay_ms = result["step_ms"][per_epoch:]
    wall_ms = history[1]["epoch_time"] * 1e3 if len(history) > 1 else None
    return {
        "fill_digests": fill[::2], "replay_digests": replay[::2],
        "distinct_fill_batches": len(set(fill[::2])),
        "echoes_equal": fill[::2] == fill[1::2] and replay[::2] == replay[1::2],
        "replay_bit_identical": fill == replay,
        "replay_images_per_sec": history[1]["images_per_sec"]
        if len(history) > 1 else None,
        "replay_step_ms_median": (statistics.median(replay_ms)
                                  if replay_ms else None),
        "replay_device_idle_pct_events": (
            100.0 * (1.0 - sum(replay_ms) / wall_ms)
            if wall_ms and replay_ms else None),
        "schedule_horizon_steps": result["steps"],
    }


def _wc_checks(runs: dict) -> None:
    """The phase's checks over its five ``cli train`` runs."""
    n = WC_STEPS
    want = {"pil_workers": (2 * n, 0), "pil_control": (2 * n, 0),
            "coeff_workers": (n, n), "coeff_control": (n, n),
            "coeff_replay": (4 * n, n)}
    for name, (k1, k2) in want.items():
        result, launches, fields = runs[name]
        if (launches["image_normalize"], launches["jpeg_decode"]) != (k1, k2):
            raise RuntimeError(
                f"{name}: K1 {launches['image_normalize']} and K2 "
                f"{launches['jpeg_decode']} launches, expected {k1} and {k2}")
    result, _, fields = runs["pil_workers"]
    first, second = result["history"]
    if (first["worker_results"],
            second["worker_results"]) != (WC_STEPS, 0):
        raise RuntimeError(f"pil_workers: the pool decoded "
                           f"{first['worker_results']} and "
                           f"{second['worker_results']} batches")
    if (second["cache_hits"], second["cache_misses"]) != (WC_STEPS, 0):
        raise RuntimeError(f"pil_workers: epoch 2 hit "
                           f"{second['cache_hits']} of {WC_STEPS}")
    if result["worker_transport"] != "shm" or result["shm_fallbacks"]:
        raise RuntimeError(f"pil_workers: transport "
                           f"{result['worker_transport']}, "
                           f"{result['shm_fallbacks']} fallbacks")
    for name in ("pil_workers", "coeff_workers", "coeff_replay"):
        tuner = runs[name][2]["tuner"]
        if not tuner["verified"] or not tuner["ticks"]:
            raise RuntimeError(f"{name}: the tuner trace does not verify "
                               f"({tuner['ticks']} ticks, mismatched "
                               f"{tuner['mismatched']})")
    result, _, _ = runs["coeff_workers"]
    if result["worker_transport"] != "shm" or result["shm_fallbacks"]:
        raise RuntimeError("coeff_workers: shm fallbacks")
    result, _, fields = runs["coeff_replay"]
    if result["steps"] != 2 * WC_STEPS * WC_EPOCHS or [
            h["replay"] for h in result["history"]] != [False, True]:
        raise RuntimeError(f"coeff_replay: {result['steps']} steps, epochs "
                           f"{[h['replay'] for h in result['history']]}")
    if fields["distinct_fill_batches"] != WC_STEPS or not fields[
            "echoes_equal"]:
        raise RuntimeError(
            f"coeff_replay: {fields['distinct_fill_batches']} distinct fill "
            f"batches of {WC_STEPS}, echoes equal: "
            f"{fields['echoes_equal']}")
    if result["device_cache_batches"] != WC_STEPS or not fields[
            "replay_bit_identical"]:
        raise RuntimeError(f"coeff_replay: {result['device_cache_batches']} "
                           f"cached batches, the replay equal to the fill: "
                           f"{fields['replay_bit_identical']}")
    rise = (fields["peak_memory_allocated_bytes"]
            - runs["coeff_control"][2]["peak_memory_allocated_bytes"])
    fields["peak_rise_over_streaming_bytes"] = rise
    cached = WC_STEPS * IMAGE_BATCH * 224 * 224 * 3
    emit("workers_caches", check="replay_memory",
         peak_rise_over_streaming_bytes=rise, cached_bytes_expected=cached)
    # The replay tier holds the epoch's pixels plus the run's own working
    # set: about 1.2 times the cached bytes on the H100.
    if not 0.65 * cached < rise < 1.62 * cached:
        raise RuntimeError(f"coeff_replay: peak rose by {rise} bytes over "
                           f"the streaming run, not about the {cached} "
                           "bytes cached")


def _ragged_payloads() -> list:
    """JPEGs unlike the path's: odd sizes, grayscale, progressive,
    restart markers, 4:4:4 (which the decoder re-encodes) and bytes no
    decoder reads (a zeroed page with zero geometry)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(5)

    def jpeg(shape, **kw):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            buf, format="JPEG", **kw)
        return buf.getvalue()

    return [jpeg((97, 225, 3), quality=85), jpeg((33, 17, 3), quality=10),
            jpeg((40, 33), quality=90), jpeg((224, 224, 3), quality=95,
                                             progressive=True),
            jpeg((61, 80, 3), quality=85, restart_marker_blocks=3),
            jpeg((48, 40, 3), quality=85, subsampling=0),
            bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
            jpeg((300, 260, 3), quality=85)]


def _k2_ops(pages: dict, size: int) -> int:
    """Integer operations that K2's function needs on these pages (a
    multiply-add counts 2), counting only what this data samples:
    per 8x8 block that a sampled source pixel lies in (luma, and chroma of
    both planes) a dequantizing multiply for each of its 64 coefficients
    and two passes in the even/odd form, each of 8 rows by 4 output pairs
    of 8 multiply-adds and a sum and a difference; per sampled source pixel
    (the first index of each axis, and the second where its weight is not
    0) jdcolor's conversion, 22 operations (two offsets, four multiply-adds,
    three shifts, three adds and three clamps of two); and per channel each
    mix whose weight is not 0, 4 operations (a subtract, a multiply, a
    shift and an add): the vertical mix of both columns where the column's
    weight is not 0, of the first only where it is, then the horizontal."""
    import torch
    from lance_distributed_training_tpu_torch.ops import jpeg_device as jd

    geom = torch.from_numpy(pages["jpeg_geom"])
    yh, yw = (8 * n for n in pages["jpeg_coef_y"].shape[1:3])
    blocks = sampled = mixes = 0
    for n in range(geom.shape[0]):
        used, weighted = [], []
        for axis, extent in ((0, yw), (1, yh)):
            i0, i1, w = jd._axis_samples(geom[n:n + 1, axis], size)
            idx = torch.cat([i0[0], i1[0][w[0] != 0]])
            used.append(torch.unique(jd._gather_index(idx, extent)))
            weighted.append(int((w[0] != 0).sum()))
        sampled += len(used[0]) * len(used[1])
        blocks += len(torch.unique(used[0] >> 3)) * len(
            torch.unique(used[1] >> 3))
        blocks += 2 * len(torch.unique(used[0] >> 4)) * len(
            torch.unique(used[1] >> 4))
        nwx, nwy = weighted
        mixes += size * nwy + nwx * nwy + size * nwx
    return (blocks * (64 + 2 * 8 * 4 * (8 * 2 + 2)) + sampled * 22
            + mixes * 3 * 4)


def jpeg_kernels() -> dict:
    """K2 against its plain version, bit for bit, then timed, at pages
    extracted here from the classification set."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        CoeffImageDecoder,
        Dataset,
        create_synthetic_classification_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import jpeg_device

    dev = torch.device("cuda")

    def on_card(pages: dict) -> list:
        return [torch.from_numpy(pages[k]).to(dev)
                for k in jpeg_device.COEFF_KEYS]

    def kernel(args, size):
        return jpeg_device.decode_coeff_batch(*args, out_size=size)

    def plain(args, size):
        return jpeg_device.decode_coeff_batch_reference(*args, out_size=size)

    with tempfile.TemporaryDirectory() as tmp:
        create_synthetic_classification_dataset(
            os.path.join(tmp, "food"), rows=IMAGE_BATCH,
            num_classes=IMAGE_CLASSES, image_size=224,
            unique_images=UNIQUE_IMAGES)
        table = Dataset(os.path.join(tmp, "food")).take(
            np.arange(IMAGE_BATCH))
    decoder = CoeffImageDecoder(image_size=224)
    for _ in range(3):
        pages = decoder(table)
    entropy_ms = decoder.entropy_ms
    jpeg_bytes = sum(len(v) for v in table.column("image").to_pylist())
    cases = [("path", on_card(pages), 224),
             ("path_vit", on_card(CoeffImageDecoder(image_size=224)(
                 table.slice(0, VIT_BATCH))), 224)]
    ragged = CoeffImageDecoder(image_size=224).decode_payloads(
        _ragged_payloads())
    for size in (224, 32, 40):
        cases.append((f"ragged_{size}", on_card(ragged), size))
    checked = []
    for label, args, size in cases:
        got = kernel(args, size)
        want = plain(args, size)
        again = kernel(args, size)
        torch.cuda.synchronize()
        row = {"case": label, "pages": list(args[0].shape),
               "out": list(got.shape),
               "bit_identical": torch.equal(got, want),
               "bit_identical_on_repeat": torch.equal(got, again)}
        checked.append(row)
        if not (row["bit_identical"] and row["bit_identical_on_repeat"]):
            diff = (got.int() - want.int()).abs().max().item()
            emit("jpeg_kernels", failed=row, max_abs_err=diff)
            raise RuntimeError(f"K2 differs from its plain version at "
                               f"{label}")
    emit("jpeg_kernels", checks=checked, max_abs_err=0.0,
         ragged_geometry=ragged["jpeg_geom"].tolist())

    args = cases[0][1]
    if list(args[0].shape) != [IMAGE_BATCH, 28, 28, 64]:
        raise RuntimeError(f"path pages {list(args[0].shape)}, expected "
                           f"[{IMAGE_BATCH}, 28, 28, 64]")
    ms = time_ms(lambda: kernel(args, 224))
    back_to_back_ms = time_back_to_back_ms(lambda: kernel(args, 224))
    plain_ms = time_back_to_back_ms(lambda: plain(args, 224), launches=3,
                                    reps=3, warmup=1)
    moved = sum(t.numel() * t.element_size() for t in args)
    moved += IMAGE_BATCH * 224 * 224 * 3
    ops_count = _k2_ops(pages, 224)
    t_bytes = moved / PEAK_BYTES
    t_ops = ops_count / PEAK_INT32_OPS
    fields = {
        "pages": list(args[0].shape), "ms": ms,
        "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
        "library_ms": None, "bytes": moved, "int_ops": ops_count,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "entropy_ms_512": entropy_ms, "extractor_threads": decoder.threads,
        "jpeg_bytes_512": jpeg_bytes,
    }
    fields["share_of_bound"] = fields["bound_ms"] / ms
    emit("jpeg_kernels", timing="path_shape", **fields)
    return fields


# ------------------------------------------------------------ causal LM

CLIP_BATCH, CLIP_SEQ, CLIP_IMAGES = 512, 77, 1024
CLIP_VOCAB = 30522
# Caption lengths in tokens, lognormal: (log of the median, sigma, least).
# An assumption of short captions, not a measured LAION statistic;
# ``scripts/torch_slice_profile.py`` draws its captions from it too.
CAPTION_LENGTHS = (float(np.log(14.0)), 0.5, 5)


def caption_lengths(rng, n: int) -> np.ndarray:
    """``n`` caption lengths drawn from ``CAPTION_LENGTHS`` by ``rng``,
    clipped to ``CLIP_SEQ``."""
    log_median, sigma, least = CAPTION_LENGTHS
    return np.clip(rng.lognormal(log_median, sigma, n), least,
                   CLIP_SEQ).astype(np.int64)


def _caption_docs() -> list:
    """The contrastive corpus's ``CLIP_IMAGES`` captions, one an image:
    ``caption_lengths`` long, ids uniform in [2, ``CLIP_VOCAB``)."""
    if "captions" not in _CORPUS:
        rng = np.random.default_rng(16)
        _CORPUS["captions"] = [
            rng.integers(2, CLIP_VOCAB, int(m), dtype=np.int32)
            for m in caption_lengths(rng, CLIP_IMAGES)]
    return _CORPUS["captions"]


def _caption_batches() -> list:
    """The contrastive path's two distinct caption batches (rows cycle
    through the images in order), through TokenDecoder's bucket mode."""
    docs = _caption_docs()
    return [_decode_tokens(docs[i:i + CLIP_BATCH], CLIP_SEQ, mode="bucket")
            for i in range(0, CLIP_IMAGES, CLIP_BATCH)]


_CORPUS: dict = {}


def _corpus_docs() -> list:
    """The causal-LM corpus: ``GPT_BATCH * STEPS`` documents with seeded
    lognormal lengths (log-mean ``log(GPT_MEAN_LEN)``, sigma ``GPT_SIGMA``,
    clipped to 1-1024, as ``create_variable_length_token_dataset`` draws
    them) and Zipf(1.2) ids folded onto 2..vocab-1, as the slice phase's
    BERT corpus is (uniform ids would leave nothing to learn)."""
    if "docs" not in _CORPUS:
        rng = np.random.default_rng(6)
        n = GPT_BATCH * STEPS
        lengths = np.clip(
            rng.lognormal(np.log(GPT_MEAN_LEN), GPT_SIGMA, n).astype(np.int64),
            1, GPT_CONTEXT)
        _CORPUS["docs"] = [
            (2 + (rng.zipf(1.2, int(m)) - 1) % (GPT_VOCAB - 2)).astype(
                np.int32) for m in lengths]
    return _CORPUS["docs"]


def _token_table(docs):
    import pyarrow as pa

    return pa.table({"input_ids": pa.array(list(docs),
                                           type=pa.list_(pa.int32()))})


def _decode_tokens(docs, pack_len: int,
                   rows_multiple: int = PACK_ROWS_MULTIPLE,
                   mode: str = "pack") -> dict:
    """``docs`` through the port's TokenDecoder (an FFD or bucket plan)."""
    from lance_distributed_training_tpu_torch.data import (
        TokenDecoder,
        TokenPackConfig,
        TokenPackPlanner,
    )

    planner = TokenPackPlanner(TokenPackConfig(pack_len=pack_len,
                                               rows_multiple=rows_multiple))
    return TokenDecoder(mode=mode, seq_len=pack_len, planner=planner)(
        _token_table(docs))


def _pack_args(batch: dict, device) -> tuple:
    """``(values, offsets, slot, start)`` tensors and ``(rows, pack_len)``
    of a decoded ragged batch."""
    import torch

    args = tuple(torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                 for k in ("input_ids__values", "input_ids__offsets",
                           "_pack_slot", "_pack_start"))
    rows, pack_len = (int(x) for x in batch["_host_pack_meta"][:2])
    return args, rows, pack_len


def _corpus_segment_ids(pack_len: int):
    """The segment ids of the corpus's first batch packed at ``pack_len``
    (by the plain pack, on the CPU)."""
    from lance_distributed_training_tpu_torch.ops import token_device

    args, rows, pl = _pack_args(
        _decode_tokens(_corpus_docs()[:GPT_BATCH], pack_len), "cpu")
    return token_device.pack_token_batch_reference(
        *args, rows=rows, pack_len=pl)[1]


def _token_cases() -> list:
    """``(label, decoded batch, values tail, made by hand)`` for K3's
    checks: the path's batch, ragged ones and ``_hand_plans``."""
    rng = np.random.default_rng(7)

    def docs(lengths):
        return [rng.integers(2, GPT_VOCAB, int(m), dtype=np.int32)
                for m in lengths]

    path = _decode_tokens(_corpus_docs()[:GPT_BATCH], GPT_CONTEXT)
    cases = [("path", path, None)]
    cases += [(f"contrastive_path_{i}", batch, None)
              for i, batch in enumerate(_caption_batches())]
    cases.append(("empty_sequences", _decode_tokens(
        docs([0, 5, 0, 0, 40, 17, 0, 3, 64, 0]), 64), None))
    cases.append(("one_sequence", _decode_tokens(docs([37]), GPT_CONTEXT),
                  None))
    cases.append(("truncated_at_pack_len", _decode_tokens(
        docs(rng.integers(1, 300, 23)), 64), None))
    cases.append(("rows_multiple_padding", _decode_tokens(
        docs([9, 200, 31]), 256, rows_multiple=8), None))
    cases.append(("bucket_mode", _decode_tokens(
        docs(rng.integers(1, 90, 16)), 128, mode="bucket"), None))
    # A values tail past offsets[n] that holds nonzero tokens: the kernels
    # must leave it alone.
    cases.append(("values_tail", path, rng.integers(
        2, GPT_VOCAB, 4096, dtype=np.int32)))
    # More sequences than the pack's plan chunk (256) takes at once.
    cases.append(("many_sequences", _decode_tokens(
        docs(rng.integers(0, 6, 600)), 64, rows_multiple=1), None))
    return [case + (False,) for case in cases] + [
        (label, plan, None, True) for label, plan in _hand_plans(rng).items()]


def _hand_plans(rng) -> dict:
    """Plans no planner makes, as ragged batches: runs that cross a row's
    end, and destinations below 0 (counted from the grid's end), partly
    below the grid, past it and partly past it, and sequences before a
    nonzero offsets[0]."""

    def batch(lengths, slot, start, rows, pack_len, first=0):
        offsets = np.concatenate([[first], first + np.cumsum(lengths)])
        return {"input_ids__values": rng.integers(
                    2, GPT_VOCAB, int(offsets[-1]) + 5, dtype=np.int32),
                "input_ids__offsets": offsets.astype(np.int32),
                "_pack_slot": np.asarray(slot, np.int32),
                "_pack_start": np.asarray(start, np.int32),
                "_host_pack_meta": np.asarray([rows, pack_len])}

    return {
        # 4 x 64 cells: [50, 80), [138, 202), [210, 250), truncated at 64.
        "row_crossing": batch([30, 100, 40], [0, 2, 3], [50, 10, 18], 4, 64),
        # 4 x 32 = 128 cells: slot -1 wraps to cells [99, 119); slot -5
        # start 8 starts 24 cells below the grid's -128, so only its last 8
        # tokens wrap in, to [0, 8); slot 4 is past the grid; slot 3 start
        # 24 runs 12 cells past it.
        "negative_and_past_grid": batch(
            [20, 40, 10, 20, 12], [-1, -5, 4, 3, 1], [3, 8, 0, 24, 0], 4, 32),
        # offsets[0] = 6: positions 0-5 fall to sequence 0 with k < 0.
        "nonzero_first_offset": batch([10, 0, 7], [1, 0, 2], [7, 0, 30], 3,
                                      64, first=6),
    }


def token_kernels() -> dict:
    """K3 pack and unpack against their plain versions, bit for bit, then
    timed at the path's batch."""
    import torch
    from lance_distributed_training_tpu_torch.ops import token_device as td

    dev = torch.device("cuda")
    checked = []
    for label, batch, tail, hand in _token_cases():
        (values, offsets, slot, start), rows, pack_len = _pack_args(batch,
                                                                    dev)
        if tail is not None:
            values = torch.cat([values, torch.from_numpy(tail).to(dev)])
        got = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                  pack_len=pack_len)
        want = td.pack_token_batch_reference(values, offsets, slot, start,
                                             rows=rows, pack_len=pack_len)
        again = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                    pack_len=pack_len)
        cap = values.shape[0]
        back = td.unpack_token_batch(got[0], offsets, slot, start,
                                     capacity=cap)
        back_want = td.unpack_token_batch_reference(want[0], offsets, slot,
                                                    start, capacity=cap)
        back_again = td.unpack_token_batch(got[0], offsets, slot, start,
                                           capacity=cap)
        # The round trip returns every live token (where the unpacked
        # segment ids are nonzero) and zero elsewhere: the page itself
        # where nothing was truncated and the tail is zero. Hand-made plans
        # drop tokens past the grid, which the unpack cannot tell: for them
        # only the bits of each direction are checked.
        live = td.unpack_token_batch_reference(want[1], offsets, slot, start,
                                               capacity=cap) != 0
        expected = torch.where(live, values, torch.zeros_like(values))
        torch.cuda.synchronize()
        lengths = (offsets[1:] - offsets[:-1]).cpu()
        exact = bool((lengths <= pack_len).all()) and tail is None
        row = {
            "case": label, "n": int(slot.shape[0]), "capacity": cap,
            "grid": [rows, pack_len],
            "pack_bit_identical": all(torch.equal(g, w)
                                      for g, w in zip(got, want)),
            "pack_bit_identical_on_repeat": all(
                torch.equal(g, a) for g, a in zip(got, again)),
            "unpack_bit_identical": torch.equal(back, back_want),
            "unpack_bit_identical_on_repeat": torch.equal(back, back_again),
            "round_trip_exact": exact and not hand,
            "round_trip_ok": hand or torch.equal(back, expected) and (
                not exact or torch.equal(back, values)),
        }
        checked.append(row)
        if not all(v for k, v in row.items() if k.endswith(
                ("identical", "on_repeat", "_ok"))):
            emit("token_kernels", failed=row)
            raise RuntimeError(f"K3 differs from its plain version at "
                               f"{label}")
    emit("token_kernels", checks=checked, max_abs_err=0)

    (values, offsets, slot, start), rows, pack_len = _pack_args(
        _token_cases()[0][1], dev)
    cap, n = values.shape[0], slot.shape[0]
    cells = rows * pack_len
    grid = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                               pack_len=pack_len)[0]

    def pack():
        return td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                   pack_len=pack_len)

    def pack_plain():
        return td.pack_token_batch_reference(values, offsets, slot, start,
                                             rows=rows, pack_len=pack_len)

    def unpack():
        return td.unpack_token_batch(grid, offsets, slot, start,
                                     capacity=cap)

    def unpack_plain():
        return td.unpack_token_batch_reference(grid, offsets, slot, start,
                                               capacity=cap)

    before = dict(td.LAUNCHES)
    # The card runs each launch in microseconds, the wrapper takes longer
    # on the host: time the launches queued behind a spin (device time),
    # and back to back as a caller meets them (host-bound).
    queued = {"token_pack": time_queued_ms(pack),
              "token_unpack": time_queued_ms(unpack),
              "token_pack_plain": time_queued_ms(pack_plain),
              "token_unpack_plain": time_queued_ms(unpack_plain),
              # The least time any launch takes: an empty one, the same way.
              "launch_floor": time_queued_ms(lambda: torch.cuda._sleep(1))}
    ms = {k: queued[k]["ms"] for k in ("token_pack", "token_unpack")}
    plain_ms = {k: queued[k + "_plain"]["ms"] for k in ms}
    back_to_back = {"token_pack": time_back_to_back_ms(pack),
                    "token_unpack": time_back_to_back_ms(unpack)}
    # Bytes each must move: pack reads the live tokens it places (the
    # plain version's mask count; the page's tail past them is not read),
    # the offsets and the plan, and writes 13 bytes a cell; unpack reads
    # the grid cells holding those tokens, the offsets and the plan, and
    # writes the page.
    plan_bytes = 4 * (n + 1) + 8 * n
    payload = int(offsets[-1].item())
    live = int(torch.count_nonzero(pack_plain()[3]).item())
    moved = {"token_pack": 4 * live + plan_bytes + td.CELL_BYTES * cells,
             "token_unpack": 4 * live + plan_bytes + 4 * cap}
    table = {}
    for name in ms:
        bound = 1e3 * moved[name] / PEAK_BYTES
        table[name] = {"ms": ms[name], "plain_ms": plain_ms[name],
                       "ms_back_to_back": back_to_back[name],
                       "launch_floor_ms": queued["launch_floor"]["ms"],
                       "host_queue_ms_per_call":
                           queued[name]["host_queue_ms_per_call"],
                       "library_ms": None, "bytes": moved[name],
                       "bound_ms": bound, "bound_by": "bytes",
                       "share_of_bound": bound / ms[name]}
    check_launches = {k: td.LAUNCHES[k] for k in td.LAUNCHES}
    emit("token_kernels", timing="path_shape", n=n, capacity=cap,
         grid=[rows, pack_len], payload_tokens=payload, live_tokens=live,
         table=table,
         queued=queued, launches_in_this_phase=check_launches,
         timing_launches={k: td.LAUNCHES[k] - before[k] for k in before})
    return {"table": table, "check_launches": check_launches}


def _write_corpus(path: str, docs=None) -> None:
    """``docs`` (the causal-LM corpus by default) as a token dataset."""
    from lance_distributed_training_tpu_torch.data import write_dataset

    table = _token_table(_corpus_docs() if docs is None else docs)
    write_dataset(table, path, schema=table.schema, mode="create")


def causal_lm_run() -> dict:
    """GPT-2 124M's shape through ``cli train --task_type causal_lm``,
    packed (K3) and then padded, STEPS steps each with the eval."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    rows = GPT_BATCH * STEPS
    eval_batches = -(-rows // GPT_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        t0 = time.monotonic()
        _write_corpus(path)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        for arm in ("packed", "padded"):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            result = cli.main([
                "train", "--dataset_path", path, "--task_type", "causal_lm",
                "--model_name", "gpt_base", "--seq_len", str(GPT_CONTEXT),
                "--flash_attention", "--batch_size", str(GPT_BATCH),
                "--optimizer", "adamw", "--lr", "1e-4",
                "--max_steps", str(STEPS), "--epochs", "1",
                "--log_every", "5", "--device", "cuda",
                "--pack_rows_multiple", str(PACK_ROWS_MULTIPLE),
                "--token_pack" if arm == "packed" else "--no_token_pack",
                *FIXED,
            ])
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            losses = result["losses"]
            steps = result["steps"]
            # Steps 5-20: their grid and payload tokens over their CUDA-event
            # time.
            step_ms = result["step_ms"][4:]
            grid = sum(result["grid_tokens"][4:])
            payload = sum(result["payload_tokens"][4:])
            device_s = sum(step_ms) / 1e3
            fields = {
                "arm": arm, "steps": steps, "first_loss": losses[0],
                "last5_mean_loss": statistics.fmean(losses[-5:]),
                "losses": losses,
                "step_ms_median_5_20": statistics.median(step_ms),
                "grid_tokens_per_step": result["grid_tokens"],
                "payload_tokens_per_step": result["payload_tokens"],
                "grid_tokens_per_sec": grid / device_s,
                "valid_tokens_per_sec": payload / device_s,
                "pad_waste_pct": 100 * (1 - payload / grid),
                "grid_tokens_per_sec_wall": result["tokens_per_sec"],
                "valid_tokens_per_sec_wall": result["valid_tokens_per_sec"],
                "pad_waste_pct_wall": result["pad_waste_pct"],
                "pack_device_ms": result.get("pack_device_ms"),
                "pack_new_shapes_total": result.get("pack_new_shapes_total"),
                "counters": {k: result[k] for k in (
                    "pack_payload_tokens_total", "pack_grid_tokens_total",
                    "pack_sequences_total", "pack_truncated_tokens_total",
                    "pack_batches_total")},
                "peak_memory_allocated_bytes": peak,
                "eval_next_token_accuracy": result.get("eval_accuracy"),
                "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
                "launches": launches, "dataset_seconds": author_s,
                "train_seconds": result["train_time"],
                "total_seconds": result["total_time"],
                "model_params": result["model_params"],
            }
            emit("causal_lm", **fields)
            if steps != STEPS or len(losses) != STEPS:
                raise RuntimeError(f"{arm}: ran {steps} steps, expected "
                                   f"{STEPS}")
            if not all(np.isfinite(losses)):
                raise RuntimeError(f"{arm}: non-finite loss")
            if not fields["last5_mean_loss"] < losses[0]:
                raise RuntimeError(f"{arm}: loss did not fall over the run")
            if fields["eval_rows"] != rows:
                raise RuntimeError(f"{arm}: eval covered "
                                   f"{fields['eval_rows']} rows of {rows}")
            want = {
                "token_pack": STEPS if arm == "packed" else 0,
                "token_unpack": 0,
                "fwd": LAYERS * (STEPS + eval_batches),
                "bwd_dq": LAYERS * STEPS, "bwd_dkv": LAYERS * STEPS,
            }
            wrong = {k: (launches[k], v) for k, v in want.items()
                     if launches[k] != v}
            if wrong:
                raise RuntimeError(f"{arm}: launches (got, expected) {wrong}")
            out[arm] = fields
    return {"launches": {"token_pack": out["packed"]["launches"]["token_pack"],
                         "token_unpack": out["packed"]["launches"][
                             "token_unpack"]}, "arms": out}

# ------------------------------------------------------------ ring attention


def _ring_forward(fold, q, k, v, mask, sp: int, fused: bool):
    """The forward over an in-process ring of ``sp`` positions with
    ``fold`` (K5's forward or its plain version): one call over all ``sp``
    steps from fresh carries (``fused``, the path's launch), or ``sp``
    one-step calls on carries in memory; returns ``(out, m, l)``."""
    import torch

    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if fused:
        m = torch.empty((b, h, s), device=q.device)
        l = torch.empty_like(m)
        fold(q, k, v, mask, m, l, None, sp, 0, out=out, steps=sp)
        return out, m, l
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for t in range(sp):
        fold(q, k, v, mask, m, l, acc, sp, t,
             out=out if t == sp - 1 else None)
    return out, m, l


def _ring_backward(fold_dq, fold_dkv, q, k, v, mask, lse, delta, do,
                   sp: int, fused: bool):
    """dQ and dK/dV: one call each over all ``sp`` steps into q's type
    (``fused``, the path's launches), or ``sp`` one-step calls each on f32
    totals (a process ring's); returns ``(dq, dk, dv)``."""
    import torch

    if fused:
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        fold_dq(q, k, v, mask, lse, delta, do, None, sp, 0, steps=sp, out=dq)
        fold_dkv(q, k, v, mask, lse, delta, do, None, None, sp, 0, steps=sp,
                 out=(dk, dv))
        return dq, dk, dv
    dq, dk, dv = (torch.zeros(q.shape, device=q.device) for _ in range(3))
    for t in range(sp):
        fold_dq(q, k, v, mask, lse, delta, do, dq, sp, t)
        fold_dkv(q, k, v, mask, lse, delta, do, dk, dv, sp, t)
    return dq, dk, dv


def _ring_case(label, q, k, v, do, mask, sp, errors) -> dict:
    """K5 over a whole in-process ring as the path launches it (each kernel
    once over all ``sp`` steps) against the plain folds on the same inputs
    (flash's tolerances: out 0.02, lse 1e-3, gradients 2% of the largest;
    and out within ``RING_TOL_O_CLOSE``) and
    against ``sp`` one-step launches of the same kernels, bit for bit (and
    a fused dQ launch into f32 totals against the one-step totals); then a
    repeat that must give the same bits; rows with no valid key must come
    out 0 with 0 gradients."""
    import torch
    from lance_distributed_training_tpu_torch.ops import ring_attention as ra

    out, m, l = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, True)
    out_ref, m_ref, l_ref = _ring_forward(ra.ring_fold_fwd_reference, q, k,
                                          v, mask, sp, False)
    lse = ra.row_lse(m_ref, l_ref)
    delta = (do.float() * out_ref.float()).sum(-1)
    grads = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv, q, k,
                           v, mask, lse, delta, do, sp, True)
    grads_ref = _ring_backward(ra.ring_fold_bwd_dq_reference,
                               ra.ring_fold_bwd_dkv_reference, q, k, v, mask,
                               lse, delta, do, sp, False)
    torch.cuda.synchronize()
    err = {"out": (out.float() - out_ref.float()).abs().max().item(),
           "lse": (ra.row_lse(m, l) - lse).abs().max().item()}
    tol = {"out": TOL_O, "lse": TOL_LSE}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        err[name] = (got.float() - ref).abs().max().item()
        tol[name] = TOL_GRAD_REL * ref.abs().max().item()
    empty = ~mask.bool().any(dim=1)  # rows with no valid key
    zero_rows = bool((out[empty] == 0).all().item()
                     and all((g[empty] == 0).all().item() for g in grads))
    emit("ring_kernels", case=label, shape=list(q.shape), sp=sp,
         empty_rows=int(empty.sum().item()), max_abs_err=err, tolerance=tol,
         out_close_tolerance=RING_TOL_O_CLOSE, empty_rows_zero=zero_rows)
    bad = [n for n in err if not err[n] <= tol[n]]
    if not err["out"] <= RING_TOL_O_CLOSE:
        bad.append("out (close)")
    if bad or not zero_rows:
        raise RuntimeError(f"K5 {label}: {bad} above tolerance or nonzero "
                           f"empty rows ({zero_rows})")
    # The fused launches against sp one-step launches of the same kernels.
    out1, m1, l1 = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, False)
    dq1, dk1, dv1 = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv,
                                   q, k, v, mask, lse, delta, do, sp, False)
    dq3 = torch.zeros(q.shape, device=q.device)
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq3, sp, 0, steps=sp)
    same_steps = {
        "ring_fwd": torch.equal(out, out1) and torch.equal(m, m1)
        and torch.equal(l, l1),
        "ring_bwd_dq": torch.equal(grads[0], dq1.to(q.dtype))
        and torch.equal(dq3, dq1),
        "ring_bwd_dkv": torch.equal(grads[1], dk1.to(k.dtype))
        and torch.equal(grads[2], dv1.to(v.dtype)),
    }
    out2, m2, l2 = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, True)
    grads2 = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv, q, k,
                            v, mask, lse, delta, do, sp, True)
    same = {"ring_fwd": torch.equal(out, out2) and torch.equal(m, m2)
            and torch.equal(l, l2),
            "ring_bwd_dq": torch.equal(grads[0], grads2[0]),
            "ring_bwd_dkv": torch.equal(grads[1], grads2[1])
            and torch.equal(grads[2], grads2[2])}
    emit("ring_kernels", case=label, fused_equals_one_step=same_steps,
         bit_identical_on_repeat=same)
    if not all(same_steps.values()):
        raise RuntimeError(f"K5 {label}: the fused launch differs from "
                           f"{sp} one-step launches: {same_steps}")
    if not all(same.values()):
        raise RuntimeError(f"K5 {label}: a second launch differs: {same}")
    errors["ring_fwd"] = max(errors["ring_fwd"], err["out"])
    errors["ring_bwd_dq"] = max(errors["ring_bwd_dq"], err["dq"])
    errors["ring_bwd_dkv"] = max(errors["ring_bwd_dkv"], err["dk"],
                                 err["dv"])
    return {"lse": lse, "delta": delta}


def _ring_bounds(b: int, h: int, s: int, sb: int, d: int) -> dict:
    """Least time of K5's launches over all positions: the larger of each
    launch's products at the bf16 peak and its bytes over the HBM rate,
    each input read once and each output written once. ``fused``: the
    forward, dQ and dK/dV over the whole ring from fresh carries (q, k, v
    (and dO, lse, delta) in; out, m and l, a bf16 dq, or bf16 dk and dv
    out). ``step``: one
    ring step of each kernel, which also reads and writes its f32 carries
    or gradients."""
    bf16_in = b * h * s * d * 2  # one of q, k, v, dO
    rows = b * h * s * 4  # one f32 per row: m, l, lse or delta
    full = b * h * s * d * 4  # one f32 [B, H, S, D]: acc, dq, dk or dv
    mask = b * s
    macs = b * h * s * sb * d  # one product over one step's pairs
    ring = s // sb
    work = {
        "fused": {
            "ring_fwd": (4 * macs * ring, 4 * bf16_in + mask + 2 * rows),
            "ring_bwd_dq": (6 * macs * ring, 5 * bf16_in + mask + 2 * rows),
            "ring_bwd_dkv": (8 * macs * ring,
                             6 * bf16_in + mask + 2 * rows),
        },
        "step": {
            "ring_fwd": (4 * macs, 3 * bf16_in + mask + 4 * rows + 2 * full),
            "ring_bwd_dq": (6 * macs,
                            4 * bf16_in + mask + 2 * rows + 2 * full),
            "ring_bwd_dkv": (8 * macs,
                             4 * bf16_in + mask + 2 * rows + 4 * full),
        },
    }
    out = {}
    for mode, kernels in work.items():
        out[mode] = {}
        for name, (flops, nbytes) in kernels.items():
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            out[mode][name] = {
                "flops": flops, "bytes": nbytes,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def ring_kernels(ptxas: dict) -> dict:
    """K5 at the seq-parallel path's shape ([32, 12, 512, 64] bf16, four
    positions, key masks from the corpus lengths) and at ragged ones
    against the plain versions and against one-step launches, then timed:
    each kernel as the path launches it (once over the ring) and one ring
    step of each between CUDA events, the whole ring through
    ``ring_attention``, and
    SDPA with the same key mask (yardstick only)."""
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.ops import ring_attention as ra
    from lance_distributed_training_tpu_torch.parallel.ring_attention import (
        InProcessRing,
        ring_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errors = dict.fromkeys(RING_KERNELS, 0.0)
    b, h, s, d = SHAPE
    lengths = _slice_docs()[0][:b]
    mask = torch.from_numpy(
        (np.arange(s)[None] < np.minimum(lengths, s)[:, None]).astype(
            np.uint8)).to(dev)
    sb = s // RING_SP
    blocks = mask.bool().reshape(b, RING_SP, sb).any(-1).cpu().numpy()
    q, k, v, do = (randn(SHAPE) for _ in range(4))
    path = _ring_case("path", q, k, v, do, mask, RING_SP, errors)
    emit("ring_kernels", case="path", fully_masked_last_blocks=[
        int((~blocks[:, -n:]).all(-1).sum()) for n in (1, 2)])
    # Ragged: rows with no valid key, block lengths that are no multiple of
    # the tiles (50, 96) or longer than one (256), and one position a
    # launch (the process ring's layout).
    for label, shape, sp in (("empty_rows", (4, 2, 512, 64), 4),
                             ("ragged_block_50", (3, 2, 200, 64), 4),
                             ("block_256", (2, 3, 512, 64), 2),
                             ("one_position", (2, 3, 96, 64), 1)):
        keep = rng.random((shape[0], shape[2])) < 0.6
        keep[0] = False
        if label == "empty_rows":
            keep[2] = False
        elif sp > 1:
            keep[1, :shape[2] // sp] = False  # a fully masked first block
        m_case = torch.from_numpy(keep.astype(np.uint8)).to(dev)
        _ring_case(label, *(randn(shape) for _ in range(4)), m_case, sp,
                   errors)

    # Timing at the path's inputs: each kernel as the path launches it, and
    # one ring step (shift 1, carries or totals in memory) of each.
    lse, delta = path["lse"], path["delta"]
    f32 = dict(device=dev)
    m, l = torch.zeros((b, h, s), **f32), torch.zeros((b, h, s), **f32)
    acc, dq, dk, dv = (torch.zeros(SHAPE, **f32) for _ in range(4))
    out, dq_b, dk_b, dv_b = (torch.empty_like(t) for t in (q, q, k, v))
    ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP)),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b)),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b))),
    }
    # The same launches 20 back to back (median of 5): the card's queue
    # stays full, so the wrapper's host work before each launch, which a
    # single launch between events includes, does not count.
    back_to_back_ms = {
        "ring_fwd": time_back_to_back_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP)),
        "ring_bwd_dq": time_back_to_back_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b)),
        "ring_bwd_dkv": time_back_to_back_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b))),
    }
    one_step_ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, acc, RING_SP, 1)),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, dq, RING_SP, 1)),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, dk, dv, RING_SP, 1)),
    }
    plain_ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd_reference(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP),
            warmup=1, iters=5),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq_reference(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b), warmup=1, iters=5),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv_reference(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b)), warmup=1, iters=5),
    }
    # The whole ring (the launches and the plain ops around them) beside
    # the library's fused attention over the whole sequence with the same
    # key mask: the same work on both sides.
    key_mask = mask.bool()[:, None, None, :]
    ring = InProcessRing(RING_SP)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def ring_fwd_bwd():
        ring_attention(qg, kg, vg, key_mask, ring).backward(do)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=key_mask,
                                       scale=1.0 / d ** 0.5).backward(do)

    with torch.no_grad():
        ring_ms = time_ms(lambda: ring_attention(q, k, v, key_mask, ring))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=key_mask, scale=1.0 / d ** 0.5))
        sdpa_back_to_back_ms = time_back_to_back_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=key_mask, scale=1.0 / d ** 0.5))
    ring_fwd_bwd_ms = time_ms(ring_fwd_bwd)
    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    bounds = _ring_bounds(b, h, s, sb, d)
    registers = {r["kernel"].replace("_fold", ""): r["registers"]
                 for r in ptxas["ring_ptxas"]}
    # One library call computes dQ, dK and dV together: SDPA's backward
    # over the whole ring's work (its forward + backward less its forward),
    # beside the pair's kernel time over the ring (one dQ and one dK/dV
    # launch).
    library_bwd_ms = sdpa_fwd_bwd_ms - sdpa_ms
    pair_ms = ms["ring_bwd_dq"] + ms["ring_bwd_dkv"]
    table = {}
    for n in RING_KERNELS:
        bound = bounds["fused"][n]
        table[n] = {
            "ms": ms[n], "back_to_back_ms": back_to_back_ms[n],
            "plain_ms": plain_ms[n],
            "library_ms": sdpa_ms if n == "ring_fwd" else None,
            "library_back_to_back_ms": (sdpa_back_to_back_ms
                                        if n == "ring_fwd" else None),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bytes": bound["bytes"], "flops": bound["flops"],
            "share_of_bound": bound["bound_ms"] / ms[n],
            "ring_steps_a_launch": RING_SP,
            "registers": registers[n],
        }
        if n in one_step_ms:
            step = bounds["step"][n]
            table[n].update(one_step_ms=one_step_ms[n],
                            one_step_bound_ms=step["bound_ms"],
                            one_step_share_of_bound=step["bound_ms"]
                            / one_step_ms[n])
        if n != "ring_fwd":
            table[n].update(library_bwd_ms=library_bwd_ms,
                            pair_ms=pair_ms)
    emit("ring_kernels", timing="path_shape", sp=RING_SP, table=table,
         whole_ring={"ring_fwd_ms": ring_ms, "sdpa_fwd_ms": sdpa_ms,
                     "ring_fwd_bwd_ms": ring_fwd_bwd_ms,
                     "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
                     "sdpa_bwd_ms": library_bwd_ms,
                     "dq_dkv_pair_ms": pair_ms})
    return {"errors": errors, "table": table}


def ring_lm_run(slice_step_ms) -> dict:
    """BERT-base masked-LM through ``cli train --seq_parallelism 4`` (the
    in-process ring on one card, K5 in every attention) for STEPS steps on
    the slice phase's corpus, with the eval at the end."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )

    b, _, s, _ = SHAPE
    lengths, docs = _slice_docs()
    rows = len(docs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--seq_parallelism", str(RING_SP), "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda", *FIXED,
        ])
        launches = {k: ops.LAUNCHES[k] for k in ops.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    steps = result["steps"]
    step_ms = statistics.median(result["step_ms"][4:])
    valid_tokens = int(sum(min(int(n), s) for n in lengths))
    eval_batches = -(-rows // b)
    fields = {
        "sp": RING_SP, "steps": steps, "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "flash_slice_step_ms_median_5_20": slice_step_ms,
        "tokens_per_sec": b * s / (step_ms / 1e3),
        "valid_tokens_per_sec": valid_tokens / steps / (step_ms / 1e3),
        "peak_memory_allocated_bytes": peak,
        "eval_masked_token_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
        "launches": launches, "train_seconds": result["train_time"],
        "model_params": result["model_params"],
    }
    emit("ring_lm", **fields)
    if steps != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"ran {steps} steps, expected {STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError("loss did not fall over the run")
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"eval covered {fields['eval_rows']} rows of "
                           f"{rows}")
    # Each kernel folds the whole ring in one launch a layer.
    want = {"ring_fwd": LAYERS * (STEPS + eval_batches),
            "ring_bwd_dq": LAYERS * STEPS,
            "ring_bwd_dkv": LAYERS * STEPS,
            "fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if wrong:
        raise RuntimeError(f"launches (got, expected) {wrong}")
    return {"launches": {k: launches[k] for k in RING_KERNELS}}


# ------------------------------------------------ the remaining model families

MOE_EXPERTS, MOE_EVERY = 8, 2


def _caption_corpus(path: str) -> None:
    """The contrastive corpus, ``CLIP_BATCH * STEPS`` rows: ``CLIP_IMAGES``
    distinct seeded 224 px JPEGs (an 8 x 8 grid of random colours scaled up,
    plus pixel noise, so that a ResNet tells them apart), row i holding image
    i mod ``CLIP_IMAGES`` and that image's own caption from
    ``_caption_docs``, a variable-length ``list<int32>``. No mask column:
    the caption decoder makes it."""
    import io

    import pyarrow as pa
    from PIL import Image
    from lance_distributed_training_tpu_torch.data import write_dataset

    rng = np.random.default_rng(15)
    jpegs, captions = [], _caption_docs()
    for _ in range(CLIP_IMAGES):
        grid = rng.integers(0, 256, (8, 8, 3)).astype(np.float32)
        pixels = np.kron(grid, np.ones((28, 28, 1), np.float32))
        pixels += rng.normal(0.0, 24.0, pixels.shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=85)
        jpegs.append(buf.getvalue())
    rows = CLIP_BATCH * STEPS
    table = pa.table({
        "image": pa.array([jpegs[i % CLIP_IMAGES] for i in range(rows)],
                          pa.binary()),
        "input_ids": pa.array([captions[i % CLIP_IMAGES]
                               for i in range(rows)], pa.list_(pa.int32())),
    })
    write_dataset(table, path, schema=table.schema, mode="create")


def _caption_bucket_mode(path: str) -> dict:
    """The packed run's caption pages and plans, as the decoder the trainer
    builds makes them from the corpus's two distinct batches: bucket mode,
    one caption a row, and equal bit for bit to the token_kernels phase's
    ``contrastive_path`` cases, so that those cases hold K3 at this path's
    shapes."""
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        TokenPackConfig,
        decoder_for_task,
    )
    from lance_distributed_training_tpu_torch.data.token_pack import (
        PACK_MODE_BUCKET,
        pack_meta,
    )

    decode = decoder_for_task(
        "contrastive", seq_len=CLIP_SEQ, image_size=224,
        token_pack=TokenPackConfig(pack_len=CLIP_SEQ,
                                   rows_multiple=PACK_ROWS_MULTIPLE))
    keys = ("input_ids__values", "input_ids__offsets", "_pack_slot",
            "_pack_start", "_host_pack_meta")
    plans = []
    for i, want in enumerate(_caption_batches()):
        batch = decode(Dataset(path).take(
            np.arange(i * CLIP_BATCH, (i + 1) * CLIP_BATCH)))
        rows, pack_len, payload, mode = pack_meta(batch)
        if mode != PACK_MODE_BUCKET or rows != CLIP_BATCH:
            raise RuntimeError(f"contrastive: caption plan {i} mode {mode}, "
                               f"rows {rows}; expected bucket mode, "
                               f"{CLIP_BATCH}")
        differ = [k for k in keys if not np.array_equal(batch[k], want[k])]
        if differ:
            raise RuntimeError(f"contrastive: caption batch {i} differs from "
                               f"the token_kernels case at {differ}")
        plans.append({"rows": rows, "pack_len": pack_len,
                      "payload_tokens": payload})
    return plans


def _model_run_fields(result: dict, launches: dict, rows: int) -> dict:
    """The figures each run of the model phases prints."""
    import torch

    losses = result["losses"]
    step_ms = statistics.median(result["step_ms"][4:])
    return {
        "steps": result["steps"], "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "eval_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
        "launches": {k: launches[k] for k in launches if launches[k]},
        "train_seconds": result["train_time"],
        "total_seconds": result["total_time"],
        "model_params": result["model_params"],
    }


def contrastive_run() -> dict:
    """CLIP (``clip_resnet50_bert``) through ``cli train --task_type
    contrastive`` at 224 px, captions of up to 77 tokens, global batch 512,
    AdamW, STEPS steps and the eval, with ``--token_pack`` (K3 buckets the
    captions) and without."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    rows = CLIP_BATCH * STEPS
    eval_batches = -(-rows // CLIP_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "captions")
        t0 = time.monotonic()
        _caption_corpus(path)
        author_s = time.monotonic() - t0
        plan = _caption_bucket_mode(path)
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        for arm in ("packed", "padded"):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            result = cli.main([
                "train", "--dataset_path", path,
                "--task_type", "contrastive",
                "--model_name", "clip_resnet50_bert", "--image_size", "224",
                "--seq_len", str(CLIP_SEQ), "--batch_size", str(CLIP_BATCH),
                "--optimizer", "adamw", "--lr", "1e-4",
                "--max_steps", str(STEPS), "--epochs", "1",
                "--log_every", "5", "--device", "cuda",
                "--pack_rows_multiple", str(PACK_ROWS_MULTIPLE),
                "--token_pack" if arm == "packed" else "--no_token_pack",
                *FIXED,
            ])
            launches = dict(ops.LAUNCHES)
            fields = {"arm": arm, **_model_run_fields(result, launches, rows)}
            losses = fields["losses"]
            fields.update(first5_mean_loss=statistics.fmean(losses[:5]),
                          # A batch of unit rows all alike scores ln B.
                          ln_batch=float(np.log(CLIP_BATCH)))
            fields.update(
                images_per_sec_steps_6_20=result["images_per_sec"],
                images_per_sec_whole_run=result["images_per_sec_whole_run"],
                loader_stall_pct=result["loader_stall_pct"],
                decoder=result["decoder_arm"],
                pack_device_ms=result.get("pack_device_ms"),
                pack_new_shapes_total=result.get("pack_new_shapes_total"),
                caption_payload_tokens=result.get("pack_payload_tokens_total"),
                caption_grid_tokens=result.get("pack_grid_tokens_total"),
                eval_retrieval_top1=result.get("eval_accuracy"),
                dataset_seconds=author_s, caption_plans=plan)
            emit("contrastive", **fields)
            _check_trained(f"contrastive {arm}", fields)
            if not fields["last5_mean_loss"] < fields["first5_mean_loss"]:
                raise RuntimeError(f"contrastive {arm}: the last five "
                                   "losses average above the first five")
            if fields["eval_rows"] != rows:
                raise RuntimeError(f"contrastive {arm}: eval covered "
                                   f"{fields['eval_rows']} rows of {rows}")
            want = {"image_normalize": STEPS + eval_batches,
                    "token_pack": STEPS if arm == "packed" else 0,
                    "jpeg_decode": 0, "fwd": 0}
            wrong = {k: (launches[k], n) for k, n in want.items()
                     if launches[k] != n}
            if wrong:
                raise RuntimeError(f"contrastive {arm}: launches (got, "
                                   f"expected) {wrong}")
            out[arm] = fields
    return {"launches": {k: out["packed"]["launches"].get(k, 0)
                         for k in ("image_normalize", "token_pack")},
            "arms": out}


def vit_run(resnet_fields) -> dict:
    """ViT-B/16 (``vit_base``) classification through ``cli train
    --device_decode`` at 224 px, 101 classes, batch 256, AdamW, STEPS steps
    and the eval, on the classification phases' learnable set."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    rows = IMAGE_BATCH * STEPS
    eval_batches = -(-rows // VIT_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "classification",
            "--model_name", "vit_base", "--image_size", "224",
            "--num_classes", str(IMAGE_CLASSES),
            "--batch_size", str(VIT_BATCH), "--optimizer", "adamw",
            "--lr", "3e-4", "--max_steps", str(STEPS), "--epochs", "1",
            "--log_every", "5", "--device", "cuda", "--device_decode",
            *FIXED,
        ])
        launches = dict(ops.LAUNCHES)
    fields = _model_run_fields(result, launches, rows)
    fields.update(
        batch=VIT_BATCH,
        images_per_sec_steps_6_20=result["images_per_sec"],
        loader_stall_pct=result["loader_stall_pct"],
        decoder=result["decoder_arm"],
        decode_device_ms=result.get("decode_device_ms"),
        decode_entropy_ms=result.get("decode_entropy_ms"),
        dataset_seconds=author_s)
    if resnet_fields is not None:
        fields.update(
            resnet50_decoder=resnet_fields["decoder"],
            resnet50_step_ms_median_5_20=resnet_fields["step_ms_median_5_20"],
            resnet50_images_per_sec_steps_6_20=resnet_fields[
                "images_per_sec_steps_6_20"],
            resnet50_peak_memory_allocated_bytes=resnet_fields[
                "peak_memory_allocated_bytes"])
    emit("vit", **fields)
    _check_trained("vit", fields)
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"vit: eval covered {fields['eval_rows']} rows "
                           f"of {rows}")
    if fields["decoder"] != "coeff":
        raise RuntimeError(f"vit: decoder arm {fields['decoder']!r}")
    want = {"image_normalize": STEPS + eval_batches,
            "jpeg_decode": STEPS + eval_batches, "fwd": 0}
    wrong = {k: (launches[k], n) for k, n in want.items()
             if launches[k] != n}
    if wrong:
        raise RuntimeError(f"vit: launches (got, expected) {wrong}")
    return {"launches": {k: launches[k]
                         for k in ("image_normalize", "jpeg_decode")}}


def moe_run(slice_step_ms) -> dict:
    """BERT-base masked-LM with switch-MoE blocks (``--num_experts 8
    --moe_every 2``: six of the twelve blocks, the experts' queues gathered
    by index) through ``cli train --flash_attention`` on the slice phase's
    corpus, sequence 512, batch 32, STEPS steps."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.models.moe import MoEMLP
    from lance_distributed_training_tpu_torch.ops import flash

    b, _, s, _ = SHAPE
    lengths, docs = _slice_docs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--flash_attention", "--num_experts", str(MOE_EXPERTS),
            "--moe_every", str(MOE_EVERY), "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda", "--no_eval_at_end", *FIXED,
        ])
        launches = {k: ops.LAUNCHES[k] for k in flash.LAUNCHES}
    # The last step's load-balance term of each MoE layer.
    aux = [float(m.aux.detach()) for m in result["model"].modules()
           if isinstance(m, MoEMLP)]
    tokens = b * s
    fields = _model_run_fields(result, launches, len(docs))
    fields.update(
        num_experts=MOE_EXPERTS, moe_every=MOE_EVERY, moe_layers=len(aux),
        capacity=int(1.25 * tokens / MOE_EXPERTS), tokens_a_step=tokens,
        dispatch="index (gather of the queues, gather of the outputs)",
        last_step_aux=aux, dense_slice_step_ms_median_5_20=slice_step_ms,
        tokens_per_sec=tokens / (fields["step_ms_median_5_20"] / 1e3),
        valid_tokens_per_sec=int(sum(min(int(n), s) for n in lengths))
        / result["steps"] / (fields["step_ms_median_5_20"] / 1e3))
    emit("moe", **fields)
    _check_trained("moe", fields)
    if len(aux) != LAYERS // MOE_EVERY or not all(
            np.isfinite(a) and a > 0 for a in aux):
        raise RuntimeError(f"moe: load-balance terms {aux}")
    want = LAYERS * STEPS
    if any(launches[k] != want for k in launches):
        raise RuntimeError(f"moe: launch counts {launches}, expected {want} "
                           f"each")
    return {"launches": launches}


# ---------------------------------------- the loader graph, the scheduler

GRAPH_BATCHES = 6  # batches of 512 a shape of the graph phase streams
GRAPH_RESUME_AT = 2  # its cursor is taken after this many batches
SCHED_BATCHES = 32  # batches of 512 of the scheduled arm's corpus
# One straggler batch in each quarter of its plan, at a seeded offset: the
# epoch is 4x the pool's window, so dispatch can pull stragglers forward.
SCHED_STRAGGLERS = 4
SCHED_HEAVY_ROWS = 2  # in a straggler batch, one row in 2 is oversized: at
# one in 4 a straggler's decode cost about 2.75x a light batch's, the ratio
# at which the heavy lane's rule (twice the running mean of the submitted
# predictions, stragglers among them) decides, so routing was a coin toss
SCHED_OPTS = {"lookahead": 16, "heavy_share": 25}
# A first, scheduled epoch spawns the pool's workers and its heavy lane;
# then the two arms alternate.
SCHED_ORDER = ("warmup", "plain", "scheduled", "scheduled", "plain")


def _graph_shapes(paths: dict, pinned) -> dict:
    """``name -> (graph, engine)`` factories of each in-process shape of
    the graph phase, both placed on the card by a placement plane: the
    graph composes nodes; the engine is the constructor that the trainer
    and the factories called before the graph, wrapped by hand."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        PlacementPlane,
        TokenPackConfig,
        decoder_for_task,
    )
    from lance_distributed_training_tpu_torch.data import graph as G
    from lance_distributed_training_tpu_torch.data.folder import (
        FolderDataPipeline,
    )
    from lance_distributed_training_tpu_torch.data.pipeline import (
        EvalLoader,
        MapStylePipeline,
        TrainLoader,
    )
    from lance_distributed_training_tpu_torch.data.samplers import (
        make_plan,
        padded_eval_index_batches,
    )

    dev = torch.device("cuda")
    food, tokens = Dataset(paths["food"]), Dataset(paths["tokens"])
    pack = TokenPackConfig(pack_len=GPT_CONTEXT,
                           rows_multiple=PACK_ROWS_MULTIPLE)
    decoders = {
        "pixels": lambda: decoder_for_task(
            "classification", image_size=224, buffer_pool=pinned),
        "coeff": lambda: decoder_for_task(
            "classification", image_size=224, device_decode=True,
            buffer_pool=pinned),
        "tokens": lambda: decoder_for_task(
            "causal_lm", seq_len=GPT_CONTEXT, token_pack=pack,
            buffer_pool=pinned),
    }

    def plane():
        return PlacementPlane(dev, depth=RING_DEPTH, buffer_pool=pinned)

    def graph(source, decode):
        return G.LoaderGraph(
            source, G.Decode(decode,
                             columns=getattr(decode, "required_columns",
                                             None)),
            G.Cache(), G.Pool(), G.Buffers(pinned),
            G.Prefetch(2, producers=PRODUCERS), G.DevicePut(None),
            G.InProcess(), G.Place(plane()))

    def engine(loader):
        return plane().wrap(loader)

    def read(idx):
        return food.take(idx, columns=["image", "label"])

    def iterable(ds, dec, batch):
        def direct():
            decode = decoders[dec]()
            return engine(TrainLoader(
                ds, make_plan("batch", ds.fragment_rows(), batch, 0, 1),
                decode, None, producers=PRODUCERS, buffer_pool=pinned,
                columns=getattr(decode, "required_columns", None)))
        return (lambda: graph(G.LanceSource(ds, "batch", batch, 0, 1),
                              decoders[dec]()), direct)

    rows = food.count_rows()
    return {
        "train-iterable": iterable(food, "pixels", IMAGE_BATCH),
        "train-map-style": (
            lambda: graph(G.MapStyleSource(food, IMAGE_BATCH, 0, 1),
                          decoders["pixels"]()),
            lambda: engine(MapStylePipeline(
                food, IMAGE_BATCH, 0, 1, decoders["pixels"](), None,
                columns=["image", "label"], producers=PRODUCERS,
                buffer_pool=pinned))),
        "train-folder": (
            lambda: graph(G.FolderSource(paths["tree"], IMAGE_BATCH, 0, 1),
                          decoders["pixels"]()),
            lambda: engine(FolderDataPipeline(
                paths["tree"], IMAGE_BATCH, 0, 1, decoders["pixels"](), None,
                producers=PRODUCERS, buffer_pool=pinned))),
        "eval": (
            lambda: graph(G.EvalSource(read, rows, IMAGE_BATCH, 0, 1),
                          decoders["pixels"]()),
            lambda: engine(EvalLoader(
                read, padded_eval_index_batches(rows, IMAGE_BATCH, 0, 1),
                decoders["pixels"](), None, producers=PRODUCERS,
                buffer_pool=pinned))),
        "device-decode": iterable(food, "coeff", IMAGE_BATCH),
        "token-pack": iterable(tokens, "tokens", GPT_BATCH),
    }


def _stream(loader, on_batch=None) -> list:
    """Every batch's digest (taken on the card); ``on_batch(i, batch)``
    runs on each before the next is taken."""
    out = []
    for i, batch in enumerate(loader):
        out.append(_device_batch_digest(batch))
        if on_batch is not None:
            on_batch(i, batch)
        del batch
    return out


def _straggler_corpus(path: str, drawn: str) -> dict:
    """The scheduled arm's corpus: the classification phases' recipe
    (224 px noise JPEGs, 97 distinct images) over ``SCHED_BATCHES`` batches
    of rows, where one batch in each of ``SCHED_STRAGGLERS`` equal spans
    of the plan, at a seeded offset, holds an oversized JPEG (1,536-2,048
    px wide, 4:3, a colour grid scaled up plus noise) in one row of
    ``SCHED_HEAVY_ROWS``: 1 row in 16 over the corpus, and plan items that
    cost several times the mean's decode."""
    import io

    import pyarrow as pa
    from PIL import Image
    from lance_distributed_training_tpu_torch.data import (
        IMAGE_SCHEMA,
        Dataset,
        create_synthetic_classification_dataset,
        write_dataset,
    )

    rows = SCHED_BATCHES * IMAGE_BATCH
    create_synthetic_classification_dataset(
        drawn, rows=rows, num_classes=IMAGE_CLASSES, image_size=224,
        unique_images=WC_UNIQUE_IMAGES)
    table = Dataset(drawn).take(np.arange(rows))
    rng = np.random.default_rng(16)
    big = []
    for _ in range(8):
        w = int(rng.integers(1536, 2049))
        grid = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(grid).resize((w, w * 3 // 4),
                                                      Image.BILINEAR),
                         dtype=np.int16)
        img = np.clip(img + rng.integers(-24, 25, img.shape), 0, 255)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                                   quality=85)
        big.append(buf.getvalue())
    span = SCHED_BATCHES // SCHED_STRAGGLERS
    heavy = [q * span + int(rng.integers(span))
             for q in range(SCHED_STRAGGLERS)]
    images = table.column("image").to_pylist()
    oversized = {b * IMAGE_BATCH + i for b in heavy
                 for i in range(0, IMAGE_BATCH, SCHED_HEAVY_ROWS)}
    for k, row in enumerate(sorted(oversized)):
        images[row] = big[k % len(big)]
    table = table.set_column(0, "image", pa.array(images, pa.binary()))
    write_dataset(table, path, schema=IMAGE_SCHEMA, mode="create")
    return {"rows": rows, "heavy_batches": heavy,
            "oversized_rows": len(oversized),
            "oversized_bytes_mean": float(np.mean([len(b) for b in big])),
            "small_bytes_mean": float(np.mean(
                [len(b) for i, b in enumerate(images)
                 if i not in oversized])),
            "dataset_bytes": int(sum(len(b) for b in images))}


def _scheduled_arm(tmp: str) -> dict:
    """The straggler scheduler on its corpus: one unscheduled in-process
    epoch on one producer, after a first one, writes ``LDT_COST_PATH``;
    then a ``WorkerPool``
    of 4 streams the
    epoch unscheduled and with ``Decode(schedule=SCHED_OPTS)`` (the cost
    model warm-started from that file), in the order ``SCHED_ORDER`` (the
    warm-up scheduled, so that it spawns the heavy lane too).
    Every run's batches must equal the first's bit for bit, each
    scheduled run must reorder dispatch, and each scheduled run's lanes
    must be the scheduler's rule's (:func:`_heavy_lane_rule`)."""
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        decoder_for_task,
        make_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.data.schedule import (
        CostModel,
        DecodeScheduler,
    )
    from lance_distributed_training_tpu_torch.data.workers import (
        WorkerPool,
        columnar_spec,
    )
    from lance_distributed_training_tpu_torch.obs import costs
    from lance_distributed_training_tpu_torch.obs.registry import (
        MetricsRegistry,
    )
    from lance_distributed_training_tpu_torch.utils.chaos import (
        batch_digest,
    )

    base, fs, _ = _local_dir("ldt_graph_sched")
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, "food")
    t0 = time.monotonic()
    corpus = _straggler_corpus(path, os.path.join(base, "drawn"))
    author_s = time.monotonic() - t0
    ds = Dataset(path)
    decode = decoder_for_task("classification", image_size=224)
    cols = decode.required_columns
    ledger_path = os.path.join(tmp, "costs.jsonl")
    # The first in-process epoch pays the loader's start-up in its first
    # items' decode times, which would drown the stragglers in the priors:
    # stream one epoch before the ledger records one.
    os.environ.pop("LDT_COST_PATH", None)
    # The process ledger is made on first use and reads the variable then;
    # earlier phases made it, so make it again for each epoch.
    costs._DEFAULT = None
    for _ in make_train_pipeline(ds, "batch", IMAGE_BATCH, 0, 1, decode,
                                 None, producers=PRODUCERS, columns=cols):
        pass
    os.environ["LDT_COST_PATH"] = ledger_path
    costs._DEFAULT = None
    t0 = time.monotonic()
    # One producer: concurrent batches share the decoder's threads, which
    # stretches every batch's decode time to its neighbours' and hides the
    # stragglers; alone, each batch's time is its own work.
    ledger_digests = [batch_digest(b) for b in make_train_pipeline(
        ds, "batch", IMAGE_BATCH, 0, 1, decode, None, producers=1,
        columns=cols)]
    ledger_s = time.monotonic() - t0
    costs.default_ledger().close()
    with open(ledger_path) as f:
        ledger_lines = sum(1 for _ in f)

    runs, traces = [], []
    pool = WorkerPool(columnar_spec(path), decode, WC_WORKERS, columns=cols)
    submit_lane = pool.submit_lane
    try:
        for arm in SCHED_ORDER:
            reg = MetricsRegistry()
            sched = (DecodeScheduler(CostModel.from_env(), registry=reg,
                                     **SCHED_OPTS)
                     if arm != "plain" else None)
            pool.submit_lane = submit_lane
            if sched is not None:
                traces.append(_trace_schedule(sched, pool, submit_lane))
            loader = make_train_pipeline(ds, "batch", IMAGE_BATCH, 0, 1,
                                         decode, None, workers=pool,
                                         columns=cols, schedule=sched)
            waits, digests = [], []
            it = iter(loader)
            t0 = time.monotonic()
            while True:
                w0 = time.monotonic()
                batch = next(it, None)
                if batch is None:
                    break
                waits.append((time.monotonic() - w0) * 1e3)
                digests.append(batch_digest(batch))
                del batch
            seconds = time.monotonic() - t0
            runs.append({
                "arm": arm, "seconds": seconds,
                "images_per_sec": corpus["rows"] / seconds,
                "wait_ms_p50": float(np.percentile(waits, 50)),
                "wait_ms_p95": float(np.percentile(waits, 95)),
                "wait_ms_max": max(waits),
                "reorders": reg.counter(
                    "sched_dispatch_reorders_total").value,
                "heavy_lane_batches": reg.counter(
                    "sched_heavy_lane_batches_total").value,
                "predicted_error_ms_p95": reg.histogram(
                    "sched_predicted_error_ms").percentile(95)
                if sched is not None else None,
                "bit_identical": digests == ledger_digests,
            })
    finally:
        pool.submit_lane = submit_lane
        pool.shutdown()
        del os.environ["LDT_COST_PATH"]
        shutil.rmtree(base, ignore_errors=True)
    fields = dict(corpus, author_seconds=author_s, filesystem=fs,
                  ledger_epoch_seconds=ledger_s, ledger_lines=ledger_lines,
                  workers=WC_WORKERS, schedule=SCHED_OPTS, runs=runs)
    emit("graph", check="scheduled", **fields)
    bad = [r["arm"] for r in runs if not r["bit_identical"]]
    if bad:
        raise RuntimeError(f"graph: the {bad} runs' batches differ from the "
                           "unscheduled in-process epoch's")
    if ledger_lines < SCHED_BATCHES:
        raise RuntimeError(f"graph: the unscheduled epoch wrote "
                           f"{ledger_lines} cost records")
    if not all(r["reorders"] > 0 for r in runs if r["arm"] == "scheduled"):
        raise RuntimeError("graph: a scheduled run reordered no dispatch")
    # The heavy lane is held to the scheduler's own rule (JAX
    # data/schedule.py, DecodeScheduler.imap): a batch dispatched past the
    # warm-up whose prediction exceeds _HEAVY_RATIO times the running mean
    # of the predictions dispatched before it goes to the heavy lane, and
    # every other batch does not. Whether any batch clears that line
    # depends on the predictions (heaviest-first dispatch can spend the
    # stragglers inside the warm-up), so a run that routes none keeps the
    # rule as well as one that routes several.
    scheduled = [r for r in runs if r["arm"] != "plain"]
    rule = [_heavy_lane_rule(t, r["heavy_lane_batches"])
            for r, t in zip(scheduled, traces)]
    emit("graph", check="heavy_lane_rule", runs=rule)
    broken = [r for r in rule if r["off_rule"] or not r["counted"]
              or r["dispatched"] != SCHED_BATCHES]
    if broken:
        # Why: each scheduled run's predictions for the straggler batches
        # against the lane's threshold at their dispatch, and the decode
        # times measured.
        emit("graph", check="heavy_lane_off_rule", runs=[
            _heavy_lane_reading(t, corpus["heavy_batches"]) for t in traces])
        raise RuntimeError(
            "graph: a scheduled run's heavy lane broke the scheduler's rule "
            f"(dispatches off the rule, the counter against the trace, or "
            f"batches dispatched of {SCHED_BATCHES}): {broken}")
    return fields


def _trace_schedule(sched, pool, submit_lane) -> dict:
    """Records of one scheduled run, for :func:`_heavy_lane_reading` and
    :func:`_heavy_lane_rule`: each plan item's predicted cost (in plan
    order), the lane and the heavy-lane threshold at its dispatch
    (``_HEAVY_RATIO`` times the running mean of the predictions dispatched
    before it, ``None`` in the warm-up), the lane the scheduler's rule
    gives it there, and each item's measured decode ms. The running sum
    adds the predictions in dispatch order from 0.0, as the scheduler's
    ``_pred_sum`` does, so that the rule is evaluated on the same floats.
    Wraps the scheduler's cost model and ``pool.submit_lane``; the caller
    restores the pool's."""
    from lance_distributed_training_tpu_torch.data.cache import (
        item_fingerprint,
    )

    trace = {"keys": [], "pred": {}, "lane": {}, "threshold": {},
             "rule": {}, "ms": {}, "sum": 0.0, "n": 0,
             "warmup": sched._HEAVY_WARMUP}
    model = sched.model
    predict, observe = model.predict, model.observe

    def traced_predict(key, hints=None, row_ms=None):
        pred = predict(key, hints, row_ms)
        trace["keys"].append(key)
        trace["pred"][key] = pred
        return pred

    def traced_observe(key, ms, hints=None):
        trace["ms"][key] = ms
        return observe(key, ms, hints)

    def traced_submit(item, lane="default"):
        key = item_fingerprint(item)
        n = trace["n"]  # the predictions dispatched before this one
        pred = trace["pred"][key]
        threshold = (sched._HEAVY_RATIO * (trace["sum"] / n)
                     if n >= sched._HEAVY_WARMUP else None)
        trace["lane"][key] = lane
        trace["threshold"][key] = threshold
        trace["rule"][key] = ("heavy" if threshold is not None
                              and pred > threshold else "default")
        trace["sum"] += pred
        trace["n"] = n + 1
        return submit_lane(item, lane)

    model.predict, model.observe = traced_predict, traced_observe
    pool.submit_lane = traced_submit
    return trace


def _heavy_lane_rule(trace: dict, counted: int) -> dict:
    """One scheduled run against the scheduler's rule: the batches it
    dispatched, those past the warm-up, those the rule sends to the heavy
    lane and those the lane took, every dispatch whose lane is not the
    rule's (its plan position, predicted ms, threshold, lane), and whether
    the run's ``sched_heavy_lane_batches_total`` counts the trace's
    heavy-lane dispatches."""
    keys = trace["keys"]
    heavy = sum(lane == "heavy" for lane in trace["lane"].values())
    return {
        "dispatched": len(trace["lane"]),
        "past_warmup": max(0, len(trace["lane"]) - trace["warmup"]),
        "rule_heavy": sum(lane == "heavy" for lane in trace["rule"].values()),
        "heavy_lane": heavy, "heavy_lane_batches": counted,
        "counted": counted == heavy,
        "off_rule": [{
            "batch": i, "predicted_ms": trace["pred"][k],
            "threshold_ms": trace["threshold"][k],
            "lane": trace["lane"][k], "rule": trace["rule"][k]}
            for i, k in enumerate(keys)
            if k in trace["lane"] and trace["lane"][k] != trace["rule"][k]],
    }


def _heavy_lane_reading(trace: dict, heavy: list) -> dict:
    """One scheduled run's straggler batches (plan positions ``heavy``):
    predicted ms, threshold ms and lane at dispatch, measured ms; and the
    light batches' median predicted and measured ms."""
    keys = trace["keys"]
    light = [k for i, k in enumerate(keys) if i not in heavy]
    return {
        "stragglers": [{
            "batch": i, "predicted_ms": trace["pred"].get(keys[i]),
            "threshold_ms": trace["threshold"].get(keys[i]),
            "lane": trace["lane"].get(keys[i]),
            "measured_ms": trace["ms"].get(keys[i])}
            for i in heavy if i < len(keys)],
        "light_predicted_ms_median": float(np.median(
            [trace["pred"][k] for k in light])) if light else None,
        "light_measured_ms_median": float(np.median(
            [trace["ms"][k] for k in light if k in trace["ms"]]))
        if light else None,
    }


def graph_run() -> dict:
    """The loader graph on the card (the module's docstring, phase 21)."""
    import torch
    from lance_distributed_training_tpu_torch import ops, trainer
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
        default_buffer_pool,
    )
    from lance_distributed_training_tpu_torch.data import graph as G
    from lance_distributed_training_tpu_torch.models.tasks import get_task
    from lance_distributed_training_tpu_torch.ops import image, jpeg_device
    from lance_distributed_training_tpu_torch.ops import token_device

    dev = torch.device("cuda")
    pinned = default_buffer_pool(pin_memory=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"food": os.path.join(tmp, "food"),
                 "tree": os.path.join(tmp, "tree"),
                 "tokens": os.path.join(tmp, "tokens")}
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), paths["food"],
                           GRAPH_BATCHES * IMAGE_BATCH,
                           unique=WC_UNIQUE_IMAGES)
        _learnable_tree(paths["tree"], GRAPH_BATCHES * IMAGE_BATCH
                        // UNIQUE_IMAGES)
        _write_corpus(paths["tokens"],
                      _corpus_docs()[:GRAPH_BATCHES * GPT_BATCH])
        author_s = time.monotonic() - t0
        shapes = _graph_shapes(paths, pinned)
        engine, resumed, cursors = {}, {}, {}
        for name, (make_graph, make_engine) in shapes.items():
            engine[name] = _stream(make_engine())
            graph = make_graph()
            it = iter(graph)
            for _ in range(GRAPH_RESUME_AT):
                next(it)
            cursors[name] = graph.state_dict()
            it.close()
            graph = make_graph()
            graph.load_state_dict(cursors[name])
            resumed[name] = _stream(graph)

        # The main path: every shape's graph streamed and fed to its
        # kernels, the launch counts set to 0 just before and read just
        # after; the first batches kept for the comparisons after.
        task = get_task("classification", model_name="resnet50",
                        num_classes=IMAGE_CLASSES, device=dev,
                        generator=torch.Generator().manual_seed(0))
        optimizer, lr = trainer.make_optimizer(
            trainer.TrainConfig(dataset_path="-", lr=0.05), task.model
            .parameters())
        step = trainer.make_train_step(task, optimizer, lr)
        flip = (torch.rand(IMAGE_BATCH, generator=torch.Generator()
                           .manual_seed(17)) < 0.5).to(dev)
        decode_k2 = jpeg_device.make_batch_transform(224)
        pack_k3 = token_device.make_pack_transform()
        kept, losses, engines = {}, [], {}

        def feed(name):
            def on_batch(i, batch):
                if i == 0:
                    kept[name] = {k: v.clone() if isinstance(
                        v, torch.Tensor) else v for k, v in batch.items()}
                if name == "train-iterable":
                    losses.append(float(step(batch, flip_mask=flip)))
                elif name == "device-decode":
                    decode_k2(batch)
                elif name == "token-pack":
                    pack_k3(batch)
            return on_batch

        streamed = {}
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.monotonic()
        for name, (make_graph, _) in shapes.items():
            graph = make_graph()
            # Under the Place node's wrap: the engine the graph compiled to.
            engines[name] = type(graph.compile().inner).__name__
            streamed[name] = _stream(graph, feed(name))
        torch.cuda.synchronize()
        main_s = time.monotonic() - t0
        launches = {k: ops.LAUNCHES[k] for k in ("image_normalize",
                                                  "jpeg_decode",
                                                  "token_pack")}

        # Each kernel against its plain version on a batch of the path.
        x = kept["train-iterable"]["image"]
        got = image.normalize_flip(x, flip)
        want = image.random_flip_reference(
            image.normalize_images_reference(x), flip)
        k1_err = float((got.float() - want.float()).abs().max())
        c = kept["device-decode"]
        keys = ("jpeg_coef_y", "jpeg_coef_cb", "jpeg_coef_cr", "jpeg_quant",
                "jpeg_geom")
        got = jpeg_device.decode_coeff_batch(*(c[k] for k in keys),
                                             out_size=224)
        want = jpeg_device.decode_coeff_batch_reference(
            *(c[k] for k in keys), out_size=224)
        k2_err = float((got.int() - want.int()).abs().max())
        t = kept["token-pack"]
        args = tuple(t[k] for k in ("input_ids__values",
                                    "input_ids__offsets", "_pack_slot",
                                    "_pack_start"))
        rows, pack_len = (int(v) for v in t["_host_pack_meta"][:2])
        got = token_device.pack_token_batch(*args, rows=rows,
                                            pack_len=pack_len)
        want = token_device.pack_token_batch_reference(*args, rows=rows,
                                                       pack_len=pack_len)
        k3_err = max(float((g.long() - w.long()).abs().max())
                     for g, w in zip(got, want))
        del task, optimizer, step, kept, got, want
        torch.cuda.empty_cache()
        sched = _scheduled_arm(tmp)
    counts = {name: len(d) for name, d in streamed.items()}
    fields = {
        "shapes": list(shapes), "engines": engines, "batches": counts,
        "dataset_seconds": author_s, "main_path_seconds": main_s,
        "graph_equals_engine": {n: streamed[n] == engine[n]
                                for n in shapes},
        "cursors": cursors,
        "resumed_tail_equal": {n: resumed[n] == engine[n][GRAPH_RESUME_AT:]
                               for n in shapes},
        "distinct_batches": {n: len(set(d)) for n, d in streamed.items()},
        "resnet50_losses": losses, "launches": launches,
        "max_abs_err": {"image_normalize": k1_err, "jpeg_decode": k2_err,
                        "token_pack": k3_err},
        "canonical": {n: g.describe()["cursor_owner"]
                      for n, g in G.canonical_graphs().items()},
    }
    emit("graph", check="shapes", **fields)
    for name in shapes:
        if not fields["graph_equals_engine"][name]:
            raise RuntimeError(f"graph: {name} graph batches differ from "
                               "the direct engine's")
        if not fields["resumed_tail_equal"][name]:
            raise RuntimeError(f"graph: {name} resumed at "
                               f"{cursors[name]} differs from the tail")
        if counts[name] != GRAPH_BATCHES or len(engine[name]) != counts[name]:
            raise RuntimeError(f"graph: {name} streamed {counts[name]} "
                               f"batches, expected {GRAPH_BATCHES}")
        if fields["distinct_batches"][name] != counts[name]:
            raise RuntimeError(f"graph: {name} streamed equal batches: an "
                               "order fault could not show")
    want = {k: GRAPH_BATCHES for k in launches}
    if launches != want:
        raise RuntimeError(f"graph: launches {launches}, expected {want}")
    if any(fields["max_abs_err"].values()):
        raise RuntimeError(f"graph: kernels differ from their plain "
                           f"versions: {fields['max_abs_err']}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"graph: ResNet-50 losses {losses}")
    return {"launches": launches, "scheduled": sched}


# ------------------------------------------------------------------- remat

def _remat_runs(path: str, tmp: str, flags: list) -> dict:
    """BERT-base masked-LM through ``cli train`` with ``flags``, without and
    then with ``--remat``, each from the same seed, the launch counts set
    to 0 just before each run and read just after. Each run's model and
    optimizer are freed before the next starts, so that its peak memory is
    its own; its final parameters are kept on the host."""
    import gc

    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    b, _, s, _ = SHAPE
    out = {}
    for remat in (False, True):
        os.environ["LDT_METRICS_PATH"] = os.path.join(
            tmp, f"metrics_{remat}_{len(flags)}.jsonl")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s), *flags,
            "--batch_size", str(b), "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda", "--no_eval_at_end", *FIXED,
            *(["--remat"] if remat else [])])
        out[remat] = {
            "launches": {k: ops.LAUNCHES[k] for k in ops.LAUNCHES},
            "peak": torch.cuda.max_memory_allocated(),
            "params": {k: v.detach().cpu() for k, v in
                       result["model"].state_dict().items()},
            **{k: result[k] for k in ("losses", "steps", "step_ms")},
        }
        del result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_run() -> dict:
    """``--remat`` on the card (the module's docstring, phase 22)."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )

    b, _, s, _ = SHAPE
    _, docs = _slice_docs()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        for arm, flags, kernels in (
                ("flash", ["--flash_attention"], ("fwd", "bwd_dq",
                                                  "bwd_dkv")),
                ("ring", ["--seq_parallelism", str(RING_SP)],
                 RING_KERNELS)):
            runs = _remat_runs(path, tmp, flags)
            plain, remat = runs[False], runs[True]
            same_params = all(torch.equal(remat["params"][k], v)
                              for k, v in plain["params"].items())
            max_param_diff = max(
                float((remat["params"][k].float() - v.float()).abs().max())
                for k, v in plain["params"].items())
            fields = {"arm": arm}
            for name, run in (("plain", plain), ("remat", remat)):
                fields[name] = {
                    "step_ms_median_5_20": statistics.median(
                        run["step_ms"][4:]),
                    "peak_memory_allocated_bytes": run["peak"],
                    "losses": run["losses"], "steps": run["steps"],
                    "launches": {k: run["launches"][k] for k in kernels},
                }
            fields.update(
                losses_equal=plain["losses"] == remat["losses"],
                params_equal=same_params, max_param_abs_diff=max_param_diff,
                step_ratio=fields["remat"]["step_ms_median_5_20"]
                / fields["plain"]["step_ms_median_5_20"],
                peak_saved_bytes=plain["peak"] - remat["peak"])
            emit("remat", **fields)
            fwd = kernels[0]
            want_plain = {k: LAYERS * STEPS for k in kernels}
            want_remat = dict(want_plain, **{fwd: 2 * LAYERS * STEPS})
            if fields["plain"]["launches"] != want_plain:
                raise RuntimeError(f"remat {arm}: launches without remat "
                                   f"{fields['plain']['launches']}, "
                                   f"expected {want_plain}")
            if fields["remat"]["launches"] != want_remat:
                raise RuntimeError(f"remat {arm}: launches with remat "
                                   f"{fields['remat']['launches']}, "
                                   f"expected {want_remat}")
            if not (fields["losses_equal"] and same_params):
                raise RuntimeError(
                    f"remat {arm}: losses equal {fields['losses_equal']}, "
                    f"parameters equal {same_params} (largest difference "
                    f"{max_param_diff})")
            if not all(np.isfinite(fields["remat"]["losses"])):
                raise RuntimeError(f"remat {arm}: non-finite loss")
            report[arm] = fields["remat"]["launches"]
    return {"launches": {**report["flash"], **report["ring"]}}


# -------------------------------------------------- the remote input plane

SERVICE_ARMS = ("pil", "coeff")  # the pixel and the coefficient-page arm
FLEET_KILL_AFTER = 3  # batches member 0 sends before it SIGKILLs itself
FLEET_HEARTBEAT_S, FLEET_TTL_S = "0.5", "2"


_CLI_MAIN = """
from lance_distributed_training_tpu_torch.cli import main
main(sys.argv[1:])
"""

# The fleet's doomed member: ``cli serve-data`` whose sender SIGKILLs its
# own process before its (N+1)-th batch frame (the chaos hook of
# ``fleet/chaos.py``), so that the kill always leaves batches unsent, as
# JAX's ``kill_after`` does in process.
_KILL_AFTER = """
import os, signal, sys
from lance_distributed_training_tpu_torch.service import server
_sent = [0]


def _hook(event, peer, step):
    if event == "send":
        _sent[0] += 1
        if _sent[0] > {n}:
            os.kill(os.getpid(), signal.SIGKILL)


_start = server.DataService.start


def _start_armed(self):
    self.chaos = _hook
    return _start(self)


server.DataService.start = _start_armed
"""


class _HostProcess:
    """One host process of the port's CLI (``serve-data`` or
    ``coordinator``), its output drained by a thread; ``addr`` is the
    HOST:PORT it printed once listening."""

    def __init__(self, args: list, ready: str, preamble: str = ""):
        import threading

        self.args = args
        self.lines: list = []
        self.addr = None
        self._ready = threading.Event()
        self._pattern = re.compile(ready + r" on (\S+:\d+)")
        command = (["-c", preamble + _CLI_MAIN] if preamble else
                   ["-m", "lance_distributed_training_tpu_torch.cli"])
        self.proc = subprocess.Popen(
            [sys.executable, *command, *args], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            match = self._pattern.search(line)
            if match and self.addr is None:
                self.addr = match.group(1)
                self._ready.set()
        self._ready.set()  # the process ended: wait_ready stops waiting

    def wait_ready(self, timeout: float = 180.0) -> str:
        if not self._ready.wait(timeout) or self.addr is None:
            raise RuntimeError(f"{self.args[0]} did not start: "
                               f"{self.lines[-20:]}")
        return self.addr

    def stop(self) -> int:
        """SIGTERM and reap; SIGKILL after 60 s."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=60)


def _context_free(procs: dict) -> dict:
    """Each host process's ``/dev/nvidia*`` files and whether ``nvidia-smi``
    lists it among the processes holding a CUDA context; raises unless
    none holds one and ``nvidia-smi`` lists at most this trainer."""
    apps = _compute_apps()
    listed = {line.split(",")[0].strip() for line in apps}
    fds = _worker_fds([p.proc.pid for p in procs.values()])
    out = {"compute_apps": apps, "trainer_pid": os.getpid(),
           "processes": {name: {"pid": p.proc.pid,
                                "nvidia_files": fds[p.proc.pid],
                                "listed": str(p.proc.pid) in listed}
                         for name, p in procs.items()}}
    held = [name for name, row in out["processes"].items()
            if row["nvidia_files"] or row["listed"]]
    if held or len(apps) > 1:
        raise RuntimeError(f"host processes {held} (or more than the "
                           f"trainer) hold a CUDA context: {out}")
    return out


def _card():
    """This process's card."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _leaf_digests(batch: dict) -> list:
    """``(key, digest)`` of each leaf: the int64 digest on the card (a 0-d
    tensor, read later: no host sync) for a tensor, SHA-256 for a host
    leaf (the ``_host_*`` headers)."""
    import hashlib

    import torch

    out = []
    for key, value in sorted(batch.items()):
        if isinstance(value, torch.Tensor):
            out.append((key, _digest(value, _DIGEST_WEIGHTS)))
        else:
            out.append((key, hashlib.sha256(
                np.ascontiguousarray(value).tobytes()).hexdigest()))
    return out


def _read_digests(rows: list) -> list:
    return [[(k, d if isinstance(d, str) else int(d)) for k, d in row]
            for row in rows]


class _Recorded:
    """A callable of the trainer (its device stage, K2's or K3's transform,
    or its train step) recording the digests of the batch it takes."""

    def __init__(self, fn, sink: list):
        self._fn, self._sink = fn, sink

    def __call__(self, batch, *args, **kwargs):
        self._sink.append(_leaf_digests(batch))
        return self._fn(batch, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


class _TrainerHooks:
    """Within the block, the trainer records the digests of each batch its
    device stage takes (``inputs``: the placed host batch before K2 or
    K3; eval batches follow the train steps') and of each batch a train
    step takes (``steps``: after the stage), on the card and without a
    host sync; its ``/metrics`` exporter is scraped once before it
    stops."""

    def __init__(self):
        self.inputs, self.steps, self.scraped = [], [], {}

    def __enter__(self):
        import urllib.request

        from lance_distributed_training_tpu_torch import trainer
        from lance_distributed_training_tpu_torch.obs import http

        self._saved = (trainer.make_batch_transform,
                       trainer.make_pack_transform, trainer.make_train_step,
                       http.MetricsHTTPServer.stop)
        batch_t, pack_t, train_step, stop = self._saved

        def recorded(make, sink):
            return lambda *a, **k: _Recorded(make(*a, **k), sink)

        def scrape_then_stop(server):
            base = f"http://127.0.0.1:{server.port}"
            self.scraped["metrics"] = urllib.request.urlopen(
                base + "/metrics", timeout=30).read().decode()
            self.scraped["healthz"] = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=30).read())
            stop(server)

        trainer.make_batch_transform = recorded(batch_t, self.inputs)
        trainer.make_pack_transform = recorded(pack_t, self.inputs)
        trainer.make_train_step = recorded(train_step, self.steps)
        http.MetricsHTTPServer.stop = scrape_then_stop
        return self

    def __exit__(self, *exc):
        from lance_distributed_training_tpu_torch import trainer
        from lance_distributed_training_tpu_torch.obs import http

        (trainer.make_batch_transform, trainer.make_pack_transform,
         trainer.make_train_step, http.MetricsHTTPServer.stop) = self._saved
        return False


def _local_reference(path: str, decoder, batch_size: int, transform,
                     limit: int = STEPS) -> dict:
    """The first ``limit`` batches of the port's local iterable loader over
    ``path`` (4 producers), placed on the card: the digests of each before
    and after ``transform`` (K2 or K3; ``None``: the batch itself), their
    host bytes, and the first batch, placed, for the kernel checks."""
    import torch
    from lance_distributed_training_tpu_torch.data.format import Dataset
    from lance_distributed_training_tpu_torch.data.pipeline import (
        make_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.parallel.mesh import (
        make_global_batch,
    )

    device = _card()
    before, after, nbytes, first = [], [], [], None
    t0 = time.monotonic()
    for host in make_train_pipeline(Dataset(path), "batch", batch_size, 0,
                                    1, decoder, None, producers=4):
        nbytes.append(sum(np.asarray(v).nbytes for v in host.values()))
        placed = make_global_batch(host, device)
        before.append(_leaf_digests(placed))
        after.append(_leaf_digests(transform(placed)) if transform
                     else before[-1])
        first = first or placed
        if len(before) == limit:
            break
    return {"before": _read_digests(before), "after": _read_digests(after),
            "bytes": nbytes, "first": first,
            "seconds": time.monotonic() - t0}


def _final_counters(proc: _HostProcess) -> dict:
    """The ``final {...}`` counters a ``serve-data`` prints when it stops."""
    import ast

    for line in reversed(proc.lines):
        if "] final {" in line:
            return ast.literal_eval(line.split("] final ", 1)[1])
    raise RuntimeError(f"{proc.args[0]} printed no final counters: "
                       f"{proc.lines[-10:]}")


def _check_kernels_on(first: dict, coeff: bool) -> dict:
    """K1 (and K2) on the remote path's first batch against their plain
    versions, bit for bit (these launches are not the path's)."""
    import torch
    from lance_distributed_training_tpu_torch.ops import image, jpeg_device

    pixels = first["image"] if not coeff else None
    out = {}
    if coeff:
        pages = [first[k] for k in ("jpeg_coef_y", "jpeg_coef_cb",
                                    "jpeg_coef_cr", "jpeg_quant",
                                    "jpeg_geom")]
        pixels = jpeg_device.decode_coeff_batch(*pages, out_size=224)
        plain = jpeg_device.decode_coeff_batch_reference(*pages,
                                                         out_size=224)
        out["jpeg_decode_equal"] = bool(torch.equal(pixels, plain))
    flips = torch.arange(pixels.shape[0], device=pixels.device) % 3 == 0
    got = image.normalize_flip(pixels, flips)
    want = image.random_flip_reference(
        image.normalize_images_reference(pixels), flips)
    out["image_normalize_max_abs_err"] = float(
        (got.float() - want.float()).abs().max())
    out["image_normalize_equal"] = bool(torch.equal(got, want))
    torch.cuda.synchronize()
    if not all(v for k, v in out.items() if k.endswith("_equal")):
        raise RuntimeError(f"kernels disagree on the remote batch: {out}")
    return out


def service_run(paired: dict) -> dict:
    """ResNet-50 behind ``serve-data`` at full width (the module's
    docstring, phase 23): per arm a server subprocess on 127.0.0.1 and
    ``cli train --data_service``."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data.decode import (
        decoder_for_task,
    )
    from lance_distributed_training_tpu_torch.ops.jpeg_device import (
        make_batch_transform,
    )

    rows = IMAGE_BATCH * STEPS
    eval_batches = -(-rows // IMAGE_BATCH)
    launches_total = {"image_normalize": 0, "jpeg_decode": 0}
    arms = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        for arm in SERVICE_ARMS:
            coeff = arm == "coeff"
            dd = ["--device_decode"] if coeff else []
            server = _HostProcess(
                ["serve-data", "--dataset_path", path, "--host", "127.0.0.1",
                 "--port", "0", "--image_size", "224", "--log_every_s", "0",
                 *dd], ready=r"\[data-service\] serving \S+")
            try:
                ref = _local_reference(
                    path, decoder_for_task("classification", image_size=224,
                                           device_decode=coeff),
                    IMAGE_BATCH, make_batch_transform(224) if coeff else None)
                addr = server.wait_ready()
                hooks = _TrainerHooks()
                with hooks:
                    result, launches, fields = _resnet_run(
                        path, ["--data_service", addr, "--metrics_port", "0",
                               *dd], author_s, tmp)
                contexts = _context_free({"serve-data": server})
            finally:
                rc = server.stop()
            counters = _final_counters(server)
            got_in = _read_digests(hooks.inputs[:STEPS]) if coeff else None
            got_steps = _read_digests(hooks.steps)
            kernels_checked = _check_kernels_on(ref["first"], coeff)
            metrics, health = hooks.scraped.get("metrics", ""), \
                hooks.scraped.get("healthz", {})
            sent = counters.get("svc_batches_sent", 0)
            fields.update(
                arm=arm, server_exit=rc, dataset_rows=rows,
                eval_batches=eval_batches,
                host_batches_equal_local=(got_in == ref["before"]
                                          if coeff else
                                          got_steps == ref["before"]),
                step_batches_equal_local=got_steps == ref["after"],
                steps_recorded=len(got_steps),
                wire_mb_per_batch=(counters.get("svc_bytes_sent", 0) / sent
                                   / 1e6 if sent else None),
                host_mb_per_batch=statistics.fmean(ref["bytes"]) / 1e6,
                server_batches_sent=sent,
                local_reference_seconds=ref["seconds"],
                metrics_has=[s for s in ("svc_batches_received",
                                         "svc_client_stall_s",
                                         "lineage_batch_age_ms_bucket",
                                         "lineage_wire_ms_bucket")
                             if s in metrics],
                healthz={k: health.get(k) for k in ("status", "role",
                                                    "steps")},
                contexts=contexts, kernels_checked=kernels_checked)
            paired_fields = paired.get(arm) if paired else None
            _emit_paired("service", fields,
                         "device_decode" if coeff else "classification",
                         paired_fields)
            _check_trained(f"service {arm}", fields)
            problems = []
            if fields["eval_rows"] != rows:
                problems.append(f"eval covered {fields['eval_rows']} rows")
            if not fields["host_batches_equal_local"]:
                problems.append("a received batch differs from local decode")
            if not fields["step_batches_equal_local"]:
                problems.append("a trained batch differs from local decode's")
            want = {"image_normalize": STEPS + eval_batches,
                    "jpeg_decode": STEPS + eval_batches if coeff else 0}
            wrong = {k: (launches[k], v) for k, v in want.items()
                     if launches[k] != v}
            if wrong:
                problems.append(f"launches (got, expected) {wrong}")
            if coeff and fields["decoder"] != "coeff":
                problems.append(f"decoder arm {fields['decoder']!r}")
            if len(fields["metrics_has"]) != 4 or health.get(
                    "status") != "ok" or health.get("role") != "trainer":
                problems.append(f"exporter: {fields['metrics_has']}, "
                                f"{fields['healthz']}")
            if sent < STEPS:
                problems.append(f"server sent {sent} batches")
            if problems:
                raise RuntimeError(f"service {arm}: {problems}")
            for k in launches_total:
                launches_total[k] += launches[k]
            arms[arm] = fields
            torch.cuda.empty_cache()
    return {"launches": launches_total, "arms": arms}


def _fleet_json(addr: str, *argv) -> dict:
    """``cli fleet recommend --json`` or ``cli jobs list --json`` against
    the coordinator at ``addr``, in this process (no card)."""
    import contextlib
    import io

    from lance_distributed_training_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--coordinator", addr, "--json"])
    return {"rc": rc, "out": json.loads(buf.getvalue())}


def _fleet_marks() -> dict:
    """The process registry's fleet-loader counters, read now."""
    from lance_distributed_training_tpu_torch.obs.registry import (
        default_registry,
    )

    reg = default_registry()
    return {k: reg.counter(f"fleet_{k}").value for k in (
        "failovers_total", "batches_received", "resolves", "restripes")}


def _members_when(coord: str, count: int) -> dict:
    """``cli fleet recommend --json`` once it lists ``count`` members."""
    def poll():
        out = _fleet_json(coord, "fleet", "recommend")
        return out if len(out["out"]["members"]) == count else None
    return _until(poll, f"{count} fleet member(s)")


def _until(fn, what: str, timeout: float = 120.0):
    """``fn()`` once it returns a true value (polled every 0.2 s; a call
    that cannot reach its peer yet counts as not yet)."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < timeout:
        try:
            value = fn()
        except OSError as exc:  # timeouts and refused connections among them
            value, last = None, exc
        if value:
            return value
        time.sleep(0.2)
    raise RuntimeError(f"timed out waiting for {what} (last error: {last!r})")


def fleet_run(paired) -> dict:
    """GPT-2 124M behind a coordinator and two ``serve-data`` members at
    full width (the module's docstring, phase 24), one member SIGKILLed
    mid-run."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data.decode import (
        decoder_for_task,
    )
    from lance_distributed_training_tpu_torch.data.token_pack import (
        TokenPackConfig,
    )
    from lance_distributed_training_tpu_torch.ops import token_device

    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        t0 = time.monotonic()
        _write_corpus(path)
        author_s = time.monotonic() - t0
        try:
            procs["coordinator"] = _HostProcess(
                ["coordinator", "--host", "127.0.0.1", "--port", "0",
                 "--heartbeat_interval_s", FLEET_HEARTBEAT_S,
                 "--lease_ttl_s", FLEET_TTL_S, "--log_every_s", "0"],
                ready=r"\[coordinator\] coordinating")
            coord = procs["coordinator"].wait_ready()
            for i in range(2):
                procs[f"member{i}"] = _HostProcess(
                    ["serve-data", "--dataset_path", path, "--host",
                     "127.0.0.1", "--port", "0", "--task_type", "causal_lm",
                     "--seq_len", str(GPT_CONTEXT), "--token_pack",
                     "--pack_rows_multiple", str(PACK_ROWS_MULTIPLE),
                     "--coordinator", coord, "--log_every_s", "0"],
                    ready=r"\[data-service\] serving \S+",
                    preamble=(_KILL_AFTER.format(n=FLEET_KILL_AFTER)
                              if i == 0 else ""))
            ref = _local_reference(
                path, decoder_for_task(
                    "causal_lm", seq_len=GPT_CONTEXT,
                    token_pack=TokenPackConfig(
                        pack_len=GPT_CONTEXT,
                        rows_multiple=PACK_ROWS_MULTIPLE)),
                GPT_BATCH, token_device.make_pack_transform())
            addrs = {name: procs[name].wait_ready()
                     for name in ("member0", "member1")}
            before = _members_when(coord, 2)
            ids = {m["addr"]: m["server_id"] for m in before["out"]["members"]}
            hooks = _TrainerHooks()
            marks = _fleet_marks()
            with hooks:
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                os.environ["LDT_METRICS_PATH"] = os.path.join(
                    tmp, "metrics.jsonl")
                result = cli.main([
                    "train", "--dataset_path", path, "--task_type",
                    "causal_lm", "--model_name", "gpt_base", "--seq_len",
                    str(GPT_CONTEXT), "--flash_attention", "--batch_size",
                    str(GPT_BATCH), "--optimizer", "adamw", "--lr", "1e-4",
                    "--max_steps", str(STEPS), "--epochs", "1",
                    "--log_every", "5", "--device", "cuda",
                    "--pack_rows_multiple", str(PACK_ROWS_MULTIPLE),
                    "--token_pack", "--coordinator", coord, "--job_id",
                    "smoke", "--no_eval_at_end", *FIXED])
                launches = dict(ops.LAUNCHES)
            loader_counts = {k: v - marks[k]
                             for k, v in _fleet_marks().items()}
            peak = torch.cuda.max_memory_allocated()
            member0_exit = procs["member0"].proc.wait(timeout=60)
            after = _members_when(coord, 1)  # the dead lease expired

            seen = {}

            def job_cursor():
                # The cursor is the newest step a member read an ACK of
                # (the last ACKs may go unread as the sessions close).
                out = seen["jobs"] = _fleet_json(coord, "jobs", "list")
                return out if any(r.get("job_id") == "smoke"
                                  and r.get("cursor", -1) >= 0
                                  for r in out["out"]) else None
            try:
                jobs = _until(job_cursor, "the job's cursor on the "
                              "coordinator", timeout=30.0)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"{exc}: jobs {seen.get('jobs')}, loader "
                    f"{loader_counts}, members' last lines "
                    f"{ {n: p.lines[-8:] for n, p in procs.items()} }")
            contexts = _context_free(
                {k: v for k, v in procs.items() if k != "member0"})
        finally:
            exits = {name: p.stop() for name, p in procs.items()}
    got_in = _read_digests(hooks.inputs)
    got_steps = _read_digests(hooks.steps)
    step_ms = result["step_ms"][4:]
    device_s = sum(step_ms) / 1e3
    payload = sum(result["payload_tokens"][4:])
    grid = sum(result["grid_tokens"][4:])
    losses = result["losses"]
    survivor = after["out"]["members"][0]
    first = ref["first"]
    args = [first[k] for k in ("input_ids__values", "input_ids__offsets",
                               "_pack_slot", "_pack_start")]
    rows_, pack_len = (int(x) for x in first["_host_pack_meta"][:2])
    got_k3 = token_device.pack_token_batch(*args, rows=rows_,
                                           pack_len=pack_len)
    want_k3 = token_device.pack_token_batch_reference(
        *args, rows=rows_, pack_len=pack_len)
    k3_equal = all(torch.equal(a, b) for a, b in zip(got_k3, want_k3))
    fields = {
        "steps": result["steps"], "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "killed_member": ids.get(addrs["member0"]),
        "killed_after_sends": FLEET_KILL_AFTER,
        "member0_exit": member0_exit, "exits": exits,
        "batches_before_k3_equal_local": got_in == ref["before"],
        "packed_batches_equal_local": got_steps == ref["after"],
        "steps_recorded": len(got_steps),
        "survivor": {k: survivor.get(k) for k in ("server_id", "addr")},
        "survivor_expected": ids.get(addrs["member1"]),
        "fleet_recommend_rc": after["rc"],
        "jobs": [{k: r.get(k) for k in ("job_id", "priority", "cursor",
                                        "sessions", "batches_sent")}
                 for r in jobs["out"]],
        "step_ms_median_5_20": statistics.median(step_ms),
        "valid_tokens_per_sec": payload / device_s,
        "grid_tokens_per_sec": grid / device_s,
        "valid_tokens_per_sec_wall": result["valid_tokens_per_sec"],
        "loader_stall_pct": result["loader_stall_pct"],
        "peak_memory_allocated_bytes": peak,
        "loader": loader_counts,
        "launches": launches, "token_pack_equal_on_first_batch": k3_equal,
        "local_reference_seconds": ref["seconds"],
        "dataset_seconds": author_s, "train_seconds": result["train_time"],
        "contexts": contexts,
        "paired_phase": "causal_lm (packed)",
        "paired": {k: paired.get(k) for k in (
            "step_ms_median_5_20", "valid_tokens_per_sec",
            "grid_tokens_per_sec", "valid_tokens_per_sec_wall",
            "peak_memory_allocated_bytes")} if paired else None,
    }
    emit("fleet", **fields)
    problems = []
    if fields["steps"] != STEPS or not all(np.isfinite(losses)) or not (
            fields["last5_mean_loss"] < losses[0]):
        problems.append("the 20 losses are not finite and falling")
    if member0_exit != -9 or loader_counts["failovers_total"] < 1:
        problems.append(f"member 0 exited {member0_exit}, the loader failed "
                        f"over {loader_counts['failovers_total']} times")
    if not fields["batches_before_k3_equal_local"]:
        problems.append("a batch before K3 differs from local decode's")
    if not fields["packed_batches_equal_local"]:
        problems.append("a packed batch differs from local decode's")
    if fields["survivor"]["server_id"] != fields["survivor_expected"]:
        problems.append(f"fleet shows {fields['survivor']}")
    if not k3_equal:
        problems.append("K3 disagrees with its plain version")
    want = {"token_pack": STEPS, "token_unpack": 0,
            "fwd": LAYERS * STEPS, "bwd_dq": LAYERS * STEPS,
            "bwd_dkv": LAYERS * STEPS}
    wrong = {k: (launches[k], v) for k, v in want.items()
             if launches[k] != v}
    if wrong:
        problems.append(f"launches (got, expected) {wrong}")
    if problems:
        raise RuntimeError(f"fleet: {problems}")
    return {"launches": {k: launches[k] for k in (
        "token_pack", "fwd", "bwd_dq", "bwd_dkv")}, "fields": fields}


# ------------------------------------------ parallelism beyond data parallel

PARALLEL_LAYOUTS = {
    "tp": ["--model_parallelism", "2", "--flash_attention"],
    "fsdp": ["--fsdp", "--flash_attention"],
    "zero2": ["--zero", "2", "--grad_accum", "2", "--flash_attention"],
    "ep": ["--num_experts", str(MOE_EXPERTS), "--model_parallelism", "2",
           "--flash_attention"],
    "pp": ["--pipeline_parallelism", "2", "--pp_microbatches", "4"],
    # A degree that divides the width but not BERT-base's 12 heads: the
    # heads stay whole on every rank, only the attention's out is split.
    "tp8": ["--model_parallelism", "8", "--flash_attention"],
    # Resumed under tp from the newest step of another layout's checkpoint
    # (PARALLEL_RESUMES); the accumulation is the saving run's, so that the
    # state tree is the same.
    "tp_from_fsdp": ["--model_parallelism", "2", "--flash_attention"],
    # Resumed under another process count: fsdp's two-rank step by one
    # data-parallel process, zero2's by four ranks of data 2 x model 2.
    "dp1_from_fsdp": ["--flash_attention"],
    "tp2x2_from_zero2": ["--model_parallelism", "2", "--grad_accum", "2",
                         "--flash_attention"],
}
# The ranks of each layout, all sharing the one card (one: a process of
# its own, no process group).
PARALLEL_RANKS = {"tp": 2, "fsdp": 2, "zero2": 2, "ep": 2, "pp": 2, "tp8": 8,
                  "tp_from_fsdp": 2, "dp1_from_fsdp": 1,
                  "tp2x2_from_zero2": 4}
# The layouts that save a sharded checkpoint every PARALLEL_CKPT_STEP
# micro-steps (once in their PARALLEL_STEPS), and the runs that resume
# that step of one under another layout: they train the epoch's last
# batches, then the next epoch's (--epochs 2). At the save each rank of a
# saving run first takes the parent's path on the same state (the whole
# state gathered leaf by leaf to rank 0's host and written there as one
# file), for its figures beside the sharded save's; a resumed run's ranks
# then read that file whole, as the parent's restore did.
PARALLEL_SAVES = ("fsdp", "zero2")
PARALLEL_RESUMES = {"tp_from_fsdp": "fsdp", "dp1_from_fsdp": "fsdp",
                    "tp2x2_from_zero2": "zero2"}
PARALLEL_CKPT_STEP = 2
PARALLEL_MODEL, PARALLEL_DEVICE = "bert_base", "cuda"
PARALLEL_STEPS = 3  # micro-steps a layout; its times are the staging's
# A layout's micro-steps where they are fewer: tp8's eight ranks take
# 5.8-10.3 s a micro-step on the H100 (host staging), and two give its
# first loss and the loss after its first update.
PARALLEL_DEPTH = {"tp8": 2}
PARALLEL_FIRST = 3  # micro-batches recorded: up to one update and a step
# A layout's global batch where it is smaller than the others': tp8's
# eight ranks each hold the whole attention's activations and the whole
# vocabulary's logits, 5.54 GB a rank at batch 16 on the H100, which at
# batch 32 would be about 10.2 GB, 82 GB for the eight; its reference
# takes the same batch. Its eval reads its own steps' rows.
PARALLEL_BATCH = {"tp8": 16}
# Relative limits against the in-process data-parallel step (the module's
# docstring): the losses before and after the first update, the first
# micro-step's global gradient norm. On the H100 the layouts read at most
# 4.9e-5 (losses) and 8.1e-5 (norm): bf16 GEMMs round differently on
# another split of the work.
PARALLEL_LOSS_TOL = 2e-4
PARALLEL_NORM_TOL = 1e-3
# The least cosine, over the parameters of at least PARALLEL_COS_NUMEL
# elements, between a layout's first update and the data-parallel step's
# (_update_cosines). On the CPU (scripts/torch_parallel_mutations.py:
# bert_small, sequence 256) the layouts read 0.978 or more, and copies of
# the code broken on purpose read 0.17 (tp's backward all-reduce
# dropped), 0.71 (ZeRO's blocks not gathered after the update) and 0.010
# (each rank running the other rank's experts, which no loss or norm
# limit catches), each with its first loss inside the limit. On the H100
# the sound layouts read 0.930 or more (ep; the last layers' query and
# key weights, whose gradients at init are small beside bf16's rounding);
# a leaf whose update is half missing reads 1/sqrt(2) = 0.707. Smaller
# leaves (biases, LayerNorms, an expert's bias row fed by few tokens) read
# as low as 0.91 there, so they are printed, not held.
PARALLEL_COS_MIN = 0.8
# The largest relative distance between a layout's eval accuracy (both
# ranks') and this process's eval of the whole model on the same weights:
# bf16 GEMMs split another way may flip the argmax of a masked position
# whose two largest logits lie within rounding; one flip moves the
# accuracy (about 0.17 over 128 rows of 18-73 masked positions) by at most
# 4.3e-4, about 2.5e-3 of it, and the limit allows one or two (one over
# the 96 rows of three steps, about 3.4e-3; none over tp8's 32 or 64 rows,
# where one moves it by up to 5.2e-3 of it at 64). On the H100 the
# layouts read it within 1.2e-7 (the data shares' sums added in another
# order), tp8 exactly.
PARALLEL_EVAL_TOL = 5e-3
PARALLEL_COS_NUMEL = 16384  # JAX's fsdp_min_size
TP_SHAPE = (32, 6, 512, 64)  # flash's shape under --model_parallelism 2
TP8_SHAPE = (16, 12, 512, 64)  # under tp8: whole heads, tp8's batch
PROBE_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "batch_isend_irecv")

# Each collective on CUDA tensors of two ranks on the card, one after the
# other from the op named by argv[4]; "try <op>" before and "ok <op>" or
# "refused <op>: ..." after each, so that a process that aborts names the
# op in flight.
_PROBE_CHILD = r"""
import sys
import torch
import torch.distributed as dist
rank, port, backend, first = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
ops = sys.argv[5].split(",")
torch.cuda.set_device(0)
store = dist.TCPStore("127.0.0.1", port, 2, rank == 0)
dist.init_process_group(backend, store=store, world_size=2, rank=rank)
dev = "cuda"
peer = 1 - rank


def p2p():
    send, recv = torch.ones(4, device=dev), torch.empty(4, device=dev)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                        dist.P2POp(dist.irecv, recv, peer)]):
        work.wait()


run = {
    "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=dev)),
    "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(8, device=dev), torch.ones(4, device=dev)),
    "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
        torch.empty(2, device=dev), torch.ones(4, device=dev)),
    "all_to_all_single": lambda: dist.all_to_all_single(
        torch.empty(4, device=dev), torch.ones(4, device=dev)),
    "batch_isend_irecv": p2p,
}
for op in ops[ops.index(first):]:
    print("try", op, flush=True)
    try:
        run[op]()
        torch.cuda.synchronize()
        print("ok", op, flush=True)
    except Exception as exc:  # noqa: BLE001 - recorded, the probe's point
        print("refused", op + ":", str(exc).splitlines()[0][:200],
              flush=True)
    dist.barrier()
dist.destroy_process_group()
"""


def _start_pair(backend: str, first: str, ops: tuple) -> list:
    """A probe pair's two ranks, started (from op ``first``)."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _PROBE_CHILD, str(rank), str(port), backend,
         first, ",".join(ops)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]


def _collect_pair(procs: list) -> list:
    """Both ranks' ``(exit code, output lines)``; a rank still running
    after 60 s is killed."""
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        outs.append((proc.returncode, out.splitlines()))
    return outs


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def probe_collectives() -> dict:
    """Which collectives gloo runs on CUDA tensors of two ranks on this
    card (an op whose process aborts is recorded so, and the pair restarts
    at the next op), and what NCCL says to two ranks on one card (its
    pair runs beside the first gloo pair)."""
    nccl_pair = _start_pair("nccl", "all_reduce", ("all_reduce",))
    gloo: dict = {}
    remaining = list(PROBE_OPS)
    while remaining:
        outs = _collect_pair(_start_pair("gloo", remaining[0], PROBE_OPS))
        before = len(remaining)
        for op in list(remaining):
            lines = [line for _, out in outs for line in out
                     if line.split(":")[0].split(" ")[-1] == op
                     and line.split(" ")[0] in ("ok", "refused", "try")]
            if any(line.startswith("refused") for line in lines):
                gloo[op] = next(line for line in lines
                                if line.startswith("refused")).split(
                                    ": ", 1)[-1]
            elif sum(line.startswith("ok") for line in lines) == 2:
                gloo[op] = "ok"
            elif any(line.startswith("try") for line in lines):
                codes = [rc for rc, _ in outs]
                gloo[op] = f"process ended (exit {codes})"
            else:
                continue
            remaining.remove(op)
        if len(remaining) == before:  # the pair ended before its first op
            codes = [rc for rc, _ in outs]
            gloo[remaining.pop(0)] = f"process ended first (exit {codes})"
    outs = _collect_pair(nccl_pair)
    nccl = next((line.split(": ", 1)[-1] for _, out in outs for line in out
                 if line.startswith("refused")), None)
    if nccl is None:
        nccl = ("ok" if all(any(line == "ok all_reduce" for line in out)
                            for _, out in outs)
                else f"process ended (exit {[rc for rc, _ in outs]})")
    fields = {"gloo_on_cuda": gloo, "nccl_two_ranks_one_card": nccl}
    emit("parallel", probe=fields)
    return fields


_RANK_MAIN = r"""
import gc
import json
import os
import sys
import threading
import time
from functools import partial
import torch
import torch.distributed as dist
from lance_distributed_training_tpu_torch import cli, ops, trainer

rank = int(sys.argv[1])
# [[layout, dump path, argv, {"gather_to": path, "gather_at": step,
#   "restored_to": path, "gathered_from": path, "link_from": path,
#   "link_to": path, "link_step": step}], ...]
runs = json.loads(sys.argv[2])
keep = int(sys.argv[3])  # micro-batches and masks to record
first = {}
current = {}  # the checkpoint paths of the run under way
_draw = trainer.draw_mlm_mask


class HostMemory:
    # This process's resident bytes, sampled every 5 ms on a thread of
    # its own, for the host's peak over a window: anonymous (resident
    # less shared: what the process holds) and shared (mapped files, such
    # as a shard read through mmap, which the page cache can drop).
    def __init__(self):
        self.samples = []
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def rss(self):
        with open("/proc/self/statm") as f:
            _, resident, shared = map(int, f.read().split()[:3])
        return ((resident - shared) * self._page, shared * self._page)

    def _run(self):
        while not self._stop.wait(0.005):
            self.samples.append((time.monotonic(), self.rss()))

    def window(self, t0, t1, before):
        # The peaks over [t0, t1] against ``before`` (an rss() reading).
        inside = [m for t, m in list(self.samples) if t0 <= t <= t1]
        inside = inside or [self.rss()]
        anon, shared = (max(m[i] for m in inside) for i in (0, 1))
        return {"anon_before": before[0], "anon_peak": anon,
                "anon_added": anon - before[0],
                "shared_added": shared - before[1]}


memory = HostMemory()


def leaf_to_host(sharded, t, layout):
    # The parent's ShardedState._leaf_to_host over comm.gather_to_host: the
    # whole leaf whose block under layout is t, on rank 0's host (None
    # elsewhere), gathered over the group of rank 0 along the layout's
    # axis, or rank 0's own copy of a replicated leaf.
    me = dist.get_rank()
    if layout is None or sharded.topo.size[layout[0]] == 1:
        return t.detach().cpu() if me == 0 else None
    axis, dim = layout
    if 0 not in sharded.topo.ranks[axis]:
        return None
    group = sharded.topo.group[axis]
    src = t.detach().movedim(dim, 0).contiguous()
    if dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = ([torch.empty_like(src) for _ in range(dist.get_world_size(
        group))] if me == 0 else None)
    dist.gather(src, parts, dst=0, group=group)
    if me != 0:
        return None
    return torch.cat([part.cpu() for part in parts]).movedim(
        0, dim).contiguous()


def gather_path(sharded, optimizer, train_step, path):
    # The parent's save on the same state: ShardedState.host_state (the
    # whole state to rank 0's host, leaf by leaf), then rank 0 writes it
    # as one state.pt. Collective.
    t0, base = time.monotonic(), memory.rss()
    whole = sharded._whole(partial(leaf_to_host, sharded), optimizer,
                           train_step.accum)
    t1 = time.monotonic()
    out = {"gather_ms": (t1 - t0) * 1e3}
    if rank == 0:
        model_state, opt_state, accum = whole
        torch.save({"model": model_state, "optimizer": opt_state,
                    "train_step": dict(train_step.state_dict(),
                                       accum=accum)}, path)
        out.update(write_ms=(time.monotonic() - t1) * 1e3,
                   bytes=os.path.getsize(path))
    del whole
    dist.barrier()
    out["host"] = memory.window(t0, time.monotonic(), base)
    return out


def link_step(src, dst, step):
    # dst: a checkpoint directory holding src's step alone, each file a
    # hard link (no byte copied; the run's own saves write new files).
    for sub in (str(step), "cursors"):
        for root, _, files in os.walk(os.path.join(src, sub)):
            out = os.path.join(dst, os.path.relpath(root, src))
            os.makedirs(out, exist_ok=True)
            for f in files:
                if sub == str(step) or f == f"{step}.json":
                    os.link(os.path.join(root, f), os.path.join(out, f))


_save = trainer._save_checkpoint


def save_checkpoint(ckpt, journal, model, optimizer, train_step, *args,
                    **kwargs):
    if current.get("gather_at") == journal.abs_step:
        # First, so that neither's host window holds the other's bytes.
        first["gather"] = gather_path(kwargs["sharded"], optimizer,
                                      train_step, current["gather_to"])
    t0, base = time.monotonic(), memory.rss()
    _save(ckpt, journal, model, optimizer, train_step, *args, **kwargs)
    first["saves"].append({"step": journal.abs_step, "t0": t0,
                           "t1": time.monotonic(), "before": base})


_restore = trainer._restore_checkpoint


def restore_checkpoint(ckpt, model, optimizer, train_step, sharded, *args):
    t0, base = time.monotonic(), memory.rss()
    out = _restore(ckpt, model, optimizer, train_step, sharded, *args)
    first["restore"] = memory.window(t0, time.monotonic(), base)
    return out


def whole_params(step):
    # The whole model's state_dict: gathered under a layout (collective),
    # the model's own in a data-parallel process.
    if step.sharded is not None:
        return step.sharded.full_params()
    return getattr(step.task.model, "module", step.task.model).state_dict()


def dump_restored(step, path):
    # The restored state read back whole (collective), on rank 0's host.
    if step.sharded is not None:
        model_state, opt_state, accum = step.sharded.full_state(
            step.optimizer, step.accum)
    else:
        model_state, opt_state, accum = (whole_params(step),
                                         step.optimizer.state_dict(),
                                         step.accum)
    if rank == 0:
        torch.save({
            "model": {k: v.cpu() for k, v in model_state.items()},
            "optimizer": {i: {k: v.cpu() if torch.is_tensor(v) else v
                              for k, v in s.items()}
                          for i, s in opt_state["state"].items()},
            "accum": None if accum is None else [a.cpu() for a in accum]},
            path)


def draw(batch, generator, share=(0, 1)):
    mask = _draw(batch, generator, share)
    if len(first["masks"]) < keep:
        first["masks"].append(mask.cpu().clone())
    return mask


_call = trainer.TrainStep.__call__


def call(self, batch, *args, **kwargs):
    # Before the first step the whole parameters (collective: both ranks
    # take their first step together); the first micro-batches; the first
    # micro-step's global gradient norm (--log_grad_norm); after the first
    # update the whole parameters again.
    first["step"] = self
    if "updates0" not in first:
        first["updates0"] = self.updates  # a resumed run's count
        if current.get("restored_to"):
            dump_restored(self, current["restored_to"])
    if "state" not in first:
        state = whole_params(self)
        first["state"] = ({k: v.cpu().clone() for k, v in state.items()}
                          if rank == 0 else None)
        del state
    if len(first["batches"]) < keep:
        first["batches"].append({k: v.cpu().clone() for k, v in batch.items()
                                 if torch.is_tensor(v)})
    loss = _call(self, batch, *args, **kwargs)
    if "grad_norm" not in first:
        first["grad_norm"] = float(self.last_grad_norm)
    if self.updates == first["updates0"] + 1 and "updated" not in first:
        # The whole parameters after the first update (collective too).
        state = whole_params(self)
        first["updated"] = ({k: v.cpu().clone() for k, v in state.items()}
                            if rank == 0 else None)
        del state
    return loss


_evaluate = trainer.evaluate


def evaluate(*args, **kwargs):
    # The whole parameters the eval reads (collective: every rank
    # evaluates).
    state = whole_params(first["step"])
    first["final"] = ({k: v.cpu().clone() for k, v in state.items()}
                      if rank == 0 else None)
    del state
    return _evaluate(*args, **kwargs)


trainer.draw_mlm_mask = draw
trainer.TrainStep.__call__ = call
trainer.evaluate = evaluate
trainer._save_checkpoint = save_checkpoint
trainer._restore_checkpoint = restore_checkpoint
cuda = torch.cuda.is_available()
for name, dump, argv, paths in runs:
    first.clear()
    first.update(masks=[], batches=[], saves=[])
    current.clear()
    current.update(paths)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    if rank == 0 and paths.get("link_from"):
        # Before the run: its peers wait for rank 0 in the rendezvous.
        link_step(paths["link_from"], paths["link_to"], paths["link_step"])
    if "--num_processes" in argv:
        argv = argv + ["--process_id", str(rank)]
    result = cli.main(argv)
    seconds = time.monotonic() - t0
    launches = {k: ops.LAUNCHES[k] for k in ops.LAUNCHES}
    first.pop("step", None)
    if result.get("parallel") is None:
        # One data-parallel process: its state is whole, its mesh data 1.
        def size(t):
            return t.numel() * t.element_size()
        params = sum(size(p) for p in result["model"].parameters())
        moments = sum(size(v) for st in result["optimizer"].state.values()
                      for v in st.values()
                      if torch.is_tensor(v) and v.dim() > 0)
        held = {"params": params, "optimizer_state": moments,
                "accumulator": 0, "total": params + moments}
        result["parallel"] = {
            "mesh": {"data": 1}, "index": {"data": 0},
            "transport": "none (one process)", "held_bytes": held,
            "peak_bytes": {}, "plan_bytes": held, "replicated_bytes": held,
            "fsdp_unit_bytes": {"root": 0, "largest": 0, "units": 0}}
    fields = {k: result.get(k) for k in (
        "losses", "step_ms", "steps", "eval_accuracy", "eval_rows",
        "valid_tokens_per_sec", "tokens_per_sec", "parallel", "train_time",
        "world_size", "ckpt_save_ms", "ckpt_wait_ms", "ckpt_write_ms",
        "ckpt_bytes",
        "ckpt_step_bytes", "ckpt_restore_ms", "ckpt_restore_bytes",
        "ckpt_restore_largest_bytes", "ckpt_restore_scanned_bytes")}
    # The host's peak over each save: its call and its shard's write.
    writes = result.get("ckpt_write_ms") or []
    fields["ckpt_save_host"] = [
        dict(memory.window(sv["t0"], sv["t1"] + (
            writes[i] / 1e3 if i < len(writes) else 0) + 0.05,
            sv["before"]), step=sv["step"])
        for i, sv in enumerate(first.pop("saves"))]
    fields["ckpt_restore_host"] = first.pop("restore", None)
    fields["gather_path"] = first.pop("gather", None)
    if paths.get("gathered_from"):
        # The parent's restore on this rank: the whole file into its host.
        t0, base = time.monotonic(), memory.rss()
        whole = torch.load(paths["gathered_from"], map_location="cpu",
                           weights_only=True)
        t1 = time.monotonic()
        fields["gather_path_restore"] = {
            "read_ms": (t1 - t0) * 1e3,
            "bytes": os.path.getsize(paths["gathered_from"]),
            "host": memory.window(t0, t1, base)}
        del whole
    torch.save(first, dump)
    fields.update(layout=name, launches=launches, seconds=seconds,
                  grad_norm=first["grad_norm"],
                  peak=torch.cuda.max_memory_allocated() if cuda else None,
                  peak_reserved=(torch.cuda.max_memory_reserved() if cuda
                                 else None))
    print("RESULT " + json.dumps(fields), flush=True)
    del result
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
"""


def _layout_batch(name: str) -> int:
    return PARALLEL_BATCH.get(name, SHAPE[0])


def _layout_steps(name: str) -> int:
    return PARALLEL_DEPTH.get(name, PARALLEL_STEPS)


def _layout_data(tmp: str, name: str) -> str:
    """The corpus a layout trains on and evaluates (its first
    ``steps x batch`` rows): ``tmp/tokens``, or ``tmp/tokens_<layout>``
    for a layout of PARALLEL_BATCH or PARALLEL_DEPTH."""
    return os.path.join(tmp, f"tokens_{name}" if name in PARALLEL_BATCH
                        or name in PARALLEL_DEPTH else "tokens")


def _parallel_ranks(tmp: str) -> dict:
    """Every layout's ``cli train`` as its PARALLEL_RANKS ranks on the card:
    the layouts of one rank count one run after another in the same rank
    processes (each run its own process group), the counts one after the
    other; ``{layout: [each rank's result fields]}``; each rank's first
    step record is in ``tmp/<layout>.<rank>.pt``."""
    _, _, s, _ = SHAPE
    groups: dict = {}
    for name, flags in PARALLEL_LAYOUTS.items():
        world = PARALLEL_RANKS[name]
        epochs, ckpt, paths = 1, [], {}
        if name in PARALLEL_SAVES:
            ckpt = ["--checkpoint_dir", _ckpt_dir(tmp, name),
                    "--checkpoint_every_steps", str(PARALLEL_CKPT_STEP)]
            paths = {"gather_to": _gathered(tmp, name),
                     "gather_at": PARALLEL_CKPT_STEP}
        elif name in PARALLEL_RESUMES:
            # A checkpoint directory of its own, holding the saving run's
            # step alone (hard links), so that another resume's saves are
            # not the newest step there.
            source = PARALLEL_RESUMES[name]
            epochs, ckpt = 2, ["--checkpoint_dir", _ckpt_dir(tmp, name)]
            paths = {"restored_to": os.path.join(tmp, f"{name}.restored.pt"),
                     "gathered_from": _gathered(tmp, source),
                     "link_from": _ckpt_dir(tmp, source),
                     "link_to": _ckpt_dir(tmp, name),
                     "link_step": PARALLEL_CKPT_STEP}
        groups.setdefault(world, []).append([
            name, os.path.join(tmp, f"{name}.{{rank}}.pt"), [
                "train", "--dataset_path", _layout_data(tmp, name),
                "--task_type", "masked_lm",
                "--model_name", PARALLEL_MODEL, "--seq_len", str(s),
                "--batch_size", str(_layout_batch(name)), "--optimizer",
                "adamw", "--lr", "1e-4",
                "--max_steps", str(_layout_steps(name)),
                "--epochs", str(epochs),
                "--log_every", "4", "--log_grad_norm",
                "--device", PARALLEL_DEVICE, *FIXED, *flags, *ckpt,
                *(["--coordinator_address", f"127.0.0.1:{_free_port()}",
                   "--num_processes", str(world)] if world > 1 else [])],
            paths])
    env = dict(os.environ,
               LDT_METRICS_PATH=os.path.join(tmp, "parallel.jsonl"))
    results = {name: [] for name in PARALLEL_LAYOUTS}
    for world, runs in groups.items():
        _card_memory(f"before the {world}-rank runs")
        procs, failed = [], []
        try:
            for rank in range(world):
                mine = [[n, d.format(rank=rank), a, p]
                        for n, d, a, p in runs]
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK_MAIN, str(rank),
                     json.dumps(mine), str(PARALLEL_FIRST)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env))
            for rank, proc in enumerate(procs):
                out, _ = proc.communicate(timeout=1800)
                lines = out.splitlines()
                found = [json.loads(line[len("RESULT "):]) for line in lines
                         if line.startswith("RESULT ")]
                if proc.returncode or len(found) != len(runs):
                    # Every failed rank's errors: the first to fail takes
                    # the others' collectives down with it.
                    errors = [line for line in lines if "Error" in line]
                    failed.append(f"rank {rank} of {world} exited "
                                  f"{proc.returncode} after {len(found)} "
                                  f"runs: {errors[-3:] + lines[-4:]}")
                for fields in found:
                    results[fields["layout"]].append(fields)
            if failed:
                raise RuntimeError("parallel: " + "; ".join(failed))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return results


def _ckpt_dir(tmp: str, name: str) -> str:
    return os.path.join(tmp, f"ckpt_{name}")


def _gathered(tmp: str, name: str) -> str:
    """The parent's one-file checkpoint of a saving layout's last step."""
    return os.path.join(tmp, f"gathered_{name}.pt")


def _card_memory(when: str) -> None:
    """This process's cached blocks released, then its allocated and
    reserved bytes, the card's free bytes (every process's use) and the
    host's available bytes printed: the rank processes share the card
    and the host with this one."""
    import gc

    import torch

    if not torch.cuda.is_available():
        return
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    with open("/proc/meminfo") as f:
        host = {k: int(v.split()[0]) * 1024 for k, v in
                (line.split(":", 1) for line in f)
                if k in ("MemTotal", "MemAvailable")}
    emit("parallel", card_memory=when,
         allocated_bytes=torch.cuda.memory_allocated(),
         reserved_bytes=torch.cuda.memory_reserved(), free_bytes=free,
         total_bytes=total, host_available_bytes=host.get("MemAvailable"),
         host_total_bytes=host.get("MemTotal"))


def _grad_accum(name: str) -> int:
    flags = PARALLEL_LAYOUTS[name]
    return (int(flags[flags.index("--grad_accum") + 1])
            if "--grad_accum" in flags else 1)


def _share_ranks(ranks: list) -> list:
    """The lowest rank of each data share, in data-index order."""
    lowest: dict = {}
    for rank, r in enumerate(ranks):
        lowest.setdefault(r["parallel"]["index"]["data"], rank)
    return [lowest[d] for d in sorted(lowest)]


def _dp_reference(name: str, tmp: str, ranks: list) -> dict:
    """The data-parallel run of the layout's first update in this process:
    the whole model on rank 0's gathered weights, AdamW as the trainer
    builds it (``trainer.make_optimizer``, ``make_train_step``), the
    global micro-batches (the data shares' rows in order, one rank a
    share) and the ranks' masks; ``{"losses": the grad_accum + 1
    micro-steps' losses (the last after the update), "grad_norm": the
    first micro-step's global norm, "eval_accuracy" and "eval_rows": the
    whole model's eval on the layout's weights at its eval,
    "param_names": the model's parameters}``."""
    import torch
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.data import Dataset
    from lance_distributed_training_tpu_torch.models import tasks
    from lance_distributed_training_tpu_torch.ops.flash import (
        make_flash_attention,
    )
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    _, _, s, _ = SHAPE
    firsts = [torch.load(os.path.join(tmp, f"{name}.{r}.pt"))
              for r in _share_ranks(ranks)]
    flags = PARALLEL_LAYOUTS[name]
    accum = _grad_accum(name)
    shares = firsts
    dev = torch.device(PARALLEL_DEVICE)
    task = tasks.get_task(
        "masked_lm", model_name=PARALLEL_MODEL, seq_len=s,
        attention_fn=(make_flash_attention()
                      if "--flash_attention" in flags else None),
        num_experts=MOE_EXPERTS if name == "ep" else 0,
        pipeline_parallelism=2 if name == "pp" else 1, pp_microbatches=4,
        device=dev)
    task.model.load_state_dict(firsts[0]["state"])
    config = trainer.TrainConfig(dataset_path="", optimizer="adamw",
                                 lr=1e-4, grad_accum=accum)
    optimizer, lr = trainer.make_optimizer(config, task.model.parameters())
    step = trainer.make_train_step(task, optimizer, lr, grad_accum=accum,
                                   grad_norm=True)
    if name in PARALLEL_RESUMES:
        # A resumed layout's reference continues the saved state whole: the
        # optimizer's moments and counts, the accumulator, the updates.
        saved = CheckpointManager(
            _ckpt_dir(tmp, PARALLEL_RESUMES[name])).read_state(
                PARALLEL_CKPT_STEP)
        optimizer.load_state_dict(saved["optimizer"])
        step.load_state_dict(saved["train_step"])
        del saved
    start = step.updates
    losses, norm, cosines = [], None, None
    for i in range(accum + 1):
        batch = {k: torch.cat([f["batches"][i][k] for f in shares]).to(dev)
                 for k in shares[0]["batches"][i]}
        mask = torch.cat([f["masks"][i] for f in shares]).to(dev)
        losses.append(float(step(batch, mlm_mask=mask)))
        if norm is None:
            norm = float(step.last_grad_norm)
        if step.updates == start + 1 and cosines is None:
            cosines = _update_cosines(task.model, firsts[0]["state"],
                                      firsts[0]["updated"])
    del step, optimizer
    # The eval of the whole model on the layout's weights at its eval, over
    # every row in this process.
    task.model.load_state_dict(firsts[0]["final"])
    config = trainer.TrainConfig(
        dataset_path=_layout_data(tmp, name), task_type="masked_lm",
        model_name=PARALLEL_MODEL, seq_len=s, batch_size=_layout_batch(name),
        device=PARALLEL_DEVICE)
    decode = trainer._decoder_for(config, for_eval=True)
    dataset = Dataset(config.dataset_path)
    columns = getattr(decode, "required_columns", None)
    loader = trainer._build_eval_loader(
        config, dev, lambda idx: dataset.take(idx, columns=columns),
        dataset.count_rows(), decode)
    accuracy, rows = trainer.evaluate(loader, trainer.make_eval_step(task))
    param_names = sorted(n for n, _ in task.model.named_parameters())
    del task, firsts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norm": norm, "cosines": cosines,
            "eval_accuracy": accuracy, "eval_rows": rows,
            "param_names": param_names}


def _global_batches(name: str, ranks: list, tmp: str) -> tuple:
    """A layout's recorded micro-steps, whole: ``(batches, masks, alike)``,
    each data share's rows stacked in order (one rank a share), and
    whether every rank's masks equal those of its share's lowest rank.
    The record files are mapped, not read."""
    import torch

    records = [torch.load(os.path.join(tmp, f"{name}.{r}.pt"), mmap=True,
                          map_location="cpu") for r in range(len(ranks))]
    lowest = _share_ranks(ranks)  # by data index
    reps = [records[i] for i in lowest]
    steps = min(len(rec["masks"]) for rec in records)
    batches = [{k: torch.cat([rec["batches"][i][k] for rec in reps])
                for k in ("input_ids", "attention_mask")}
               for i in range(steps)]
    masks = [torch.cat([rec["masks"][i] for rec in reps])
             for i in range(steps)]
    alike = all(torch.equal(
        records[i]["masks"][j],
        records[lowest[r["parallel"]["index"]["data"]]]["masks"][j])
        for i, r in enumerate(ranks) for j in range(steps))
    return batches, masks, alike


def _batch_sha(batch: dict) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for key in sorted(batch):
        h.update(batch[key].contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _draw_fields(name: str, every: dict, tmp: str) -> dict:
    """A layout's recorded masks against the run's one generator: each
    micro-step's global mask drawn here, on the card, over the global
    batch (``trainer.draw_mlm_mask``) from the generator the run starts
    with (the seed's, or for a resumed run the saved cursor's state); and
    for a resumed run whether its global batches are the ones the saving
    run trains after the saved step (the saving run's batch
    ``(PARALLEL_CKPT_STEP + j) % its steps``: its corpus is one epoch of
    its steps, the unshuffled plan the same in every epoch)."""
    import torch
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        unpack_rng_key,
    )

    dev = torch.device(PARALLEL_DEVICE)
    batches, masks, alike = _global_batches(name, every[name], tmp)
    gen = torch.Generator(device=dev)
    source = PARALLEL_RESUMES.get(name)
    if source is None:
        gen.manual_seed(trainer.TrainConfig(dataset_path="").seed + 1)
    else:
        unpack_rng_key(CheckpointManager(_ckpt_dir(tmp, source)).cursor(
            PARALLEL_CKPT_STEP)["rng"], gen)
    drawn = [trainer.draw_mlm_mask({k: v.to(dev) for k, v in b.items()},
                                   gen).cpu() for b in batches]
    out = {"mask_steps": len(masks),
           "mask_generator": ("seed" if source is None else
                              f"{source} step {PARALLEL_CKPT_STEP} cursor"),
           "masks_equal_draws": all(torch.equal(a, b)
                                    for a, b in zip(masks, drawn)),
           "share_ranks_draw_alike": alike,
           "masked_positions": [int(m.sum()) for m in masks],
           "batch_sha256": [_batch_sha(b)[:16] for b in batches]}
    if source is not None:
        theirs, _, _ = _global_batches(source, every[source], tmp)
        steps = _layout_steps(source)
        want = [theirs[(PARALLEL_CKPT_STEP + j) % steps]
                for j in range(len(batches))]
        out.update(
            saving_run_next_sha256=[_batch_sha(b)[:16] for b in want],
            batches_equal_saving_runs_next=all(
                _batch_sha(a) == _batch_sha(b)
                for a, b in zip(batches, want)))
    return out


def _update_cosines(model, before: dict, layout_after: dict) -> dict:
    """Per parameter, ``(cosine, elements)``: the cosine between the
    layout's first update (its
    gathered parameters after it less before it) and ``model``'s own
    (``model`` has just taken it from the same weights). An update that
    is zero on both sides counts 1; zero on one side only, 0. The first
    AdamW update moves each element by about lr·sign(gradient), so a
    leaf fed the wrong gradient (another expert's tokens, a dropped
    collective, a block left stale) reads far below 1. The key biases are
    left out: a key bias adds the same q·b to every score of a row, which
    the softmax cancels, so their gradient is rounding noise and its
    signs agree by chance."""
    import torch

    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("key.bias"):
                continue
            start = before[name].to(p.device)
            ours = (p.detach() - start).double().flatten()
            theirs = (layout_after[name].to(p.device) - start).double(
            ).flatten()
            norms = float(ours.norm()) * float(theirs.norm())
            if norms == 0:
                cosine = 1.0 if not (ours.any() or theirs.any()) else 0.0
            else:
                cosine = float(ours @ theirs) / norms
            out[name] = (cosine, p.numel())
    return out


def _cosine_fields(cosines: dict) -> dict:
    """The least update cosines, of the large leaves (held) and the small
    (printed), with their leaves."""
    out = {}
    for key, large in (("update_cosine_min", True),
                       ("update_cosine_min_small", False)):
        part = {n: c for n, (c, size) in cosines.items()
                if (size >= PARALLEL_COS_NUMEL) == large}
        leaf = min(part, key=part.get)
        out[key], out[key + "_leaf"] = part[leaf], leaf
    low = sorted((c, n) for n, (c, size) in cosines.items()
                 if size >= PARALLEL_COS_NUMEL)[:5]
    out["update_cosine_lowest_large"] = [[n, c] for c, n in low]
    return out


_SAVED: dict = {}  # a saving layout's newest step, read whole, by layout


def _saved_state(tmp: str, name: str):
    """The step PARALLEL_CKPT_STEP of saving layout ``name``'s checkpoint,
    every leaf whole on this host (read once)."""
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    if name not in _SAVED:
        _SAVED[name] = CheckpointManager(_ckpt_dir(tmp, name)).read_state(
            PARALLEL_CKPT_STEP)
    return _SAVED[name]


def _tree_differences(got, want, where: str = "") -> list:
    """The leaves where two state trees differ: keys, shape, dtype or any
    bit."""
    import torch

    if torch.is_tensor(want):
        same = (torch.is_tensor(got) and got.dtype == want.dtype
                and got.shape == want.shape and torch.equal(
                    got.contiguous().view(-1).view(torch.uint8),
                    want.contiguous().view(-1).view(torch.uint8)))
        return [] if same else [where]
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{where}: keys"]
        return [d for k in want
                for d in _tree_differences(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{where}: length"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _tree_differences(g, w, f"{where}/{i}")]
    return [] if got == want else [where]


def _unsplit_bytes(index: dict, params) -> int:
    """The bytes of a step's leaves that ``held_bytes`` leaves out and
    every rank reads whole: 0-d leaves (the optimizer's step counters)
    and the model's buffers."""
    import torch

    total = 0
    for name, leaf in index["leaves"].items():
        buffer = (name.startswith("model/")
                  and name[len("model/"):] not in params)
        if not leaf["shape"] or buffer:
            total += int(np.prod(leaf["shape"])) * torch.empty(
                (), dtype=getattr(torch, leaf["dtype"])).element_size()
    return total


def _checkpoint_fields(name: str, ranks: list, tmp: str,
                       params=()) -> dict:
    """A saving layout's per-rank save figures beside the parent's gather
    path's on the same state, and whether its newest step read whole
    equals the gathered state; a resumed layout's per-rank restore figures
    beside the parent's whole-file read, whether the state it restored
    under its own layout, read back whole, equals the saved step, and
    whether each rank read its held bytes plus the step's unsplit leaves
    (:func:`_unsplit_bytes`; ``params``: the model's parameter names)."""
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )
    import torch

    # Each rank's saves (a resumed run's: its epoch's end, under its own
    # layout).
    out = {"nvidia_smi": nvidia_smi(), "ckpt_step": PARALLEL_CKPT_STEP,
           "step_bytes": ranks[0]["ckpt_step_bytes"],
           "save": [{"rank": i, "ckpt_save_ms": r["ckpt_save_ms"],
                     "ckpt_wait_ms": r["ckpt_wait_ms"],
                     "ckpt_write_ms": r["ckpt_write_ms"],
                     "bytes_written": r["ckpt_bytes"],
                     "held_bytes": r["parallel"]["held_bytes"]["total"],
                     "host": r["ckpt_save_host"]}
                    for i, r in enumerate(ranks)]}
    if name in PARALLEL_SAVES:
        saved = _saved_state(tmp, name)
        gathered = torch.load(_gathered(tmp, name), map_location="cpu",
                              weights_only=True)
        out.update(
            gather_path=[dict(r["gather_path"], rank=i)
                         for i, r in enumerate(ranks)],
            differing_leaves=_tree_differences(
                {k: saved[k] for k in gathered}, gathered))
        out["saved_equals_gathered"] = not out["differing_leaves"]
        del gathered
        return out
    saved = _saved_state(tmp, PARALLEL_RESUMES[name])
    unsplit = _unsplit_bytes(CheckpointManager(_ckpt_dir(
        tmp, PARALLEL_RESUMES[name])).index(PARALLEL_CKPT_STEP), set(params))
    restored = torch.load(os.path.join(tmp, f"{name}.restored.pt"),
                          map_location="cpu", weights_only=True)
    differing = (_tree_differences(restored["model"], saved["model"],
                                   "model")
                 + _tree_differences(restored["optimizer"],
                                     saved["optimizer"]["state"],
                                     "optimizer")
                 + _tree_differences(restored["accum"],
                                     saved["train_step"]["accum"], "accum"))
    out.update(
        resumed_from=PARALLEL_RESUMES[name],
        restore=[{
            "rank": i, "ckpt_restore_ms": r["ckpt_restore_ms"],
            "bytes_read": r["ckpt_restore_bytes"],
            "bytes_scanned": r["ckpt_restore_scanned_bytes"],
            "largest_read": r["ckpt_restore_largest_bytes"],
            "held_bytes": r["parallel"]["held_bytes"]["total"],
            "held_and_unsplit_bytes": r["parallel"]["held_bytes"]["total"]
            + unsplit,
            "host": r["ckpt_restore_host"]}
            for i, r in enumerate(ranks)],
        unsplit_bytes=unsplit, processes_saved=PARALLEL_RANKS[
            PARALLEL_RESUMES[name]], processes_restored=len(ranks),
        gather_path_restore=[dict(r["gather_path_restore"], rank=i)
                             for i, r in enumerate(ranks)],
        leaves=len(restored["model"]), differing_leaves=differing,
        restored_equals_saved=not differing)
    out["reads_held_bytes"] = all(
        e["bytes_read"] == e["held_and_unsplit_bytes"]
        for e in out["restore"])
    del restored
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _tp_shard_flash() -> dict:
    """fwd, dQ and dK/dV at the shapes the model-parallel layouts give
    them (tp's shard of 6 of the 12 heads; tp8's whole heads at its
    batch) against their plain versions, as the kernels phase checks the
    whole shape; each kernel's largest error over the two."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    errors = {"fwd": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    for mode, shape in (("tp_shard_6_heads", TP_SHAPE),
                        ("tp8_whole_heads", TP8_SHAPE)):
        b, h, s, d = shape

        def randn():
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)

        lengths = np.random.default_rng(6).integers(128, s + 1, b)
        valid = np.arange(s)[None, :] < lengths[:, None]
        seg = torch.from_numpy(valid.astype(np.int32)).to(dev)
        q, k, v, do = randn(), randn(), randn(), randn()
        _check_flash_case(mode, q, k, v, do, seg, False, 1.0 / d ** 0.5,
                          errors)
        del q, k, v, do
    return errors


def parallel_run() -> dict:
    """The layouts beyond data parallelism (the module's docstring, phase
    25)."""
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import flash

    start = time.monotonic()
    probed = probe_collectives()
    tp_errors = _tp_shard_flash()
    _, _, s, _ = SHAPE
    launches, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # Each layout's corpus: the slice corpus's first batches, one a
        # step, the rows the runs train on and those their eval reads
        # (every rank evaluates).
        lengths, docs = _slice_docs()
        corpus = {}
        for name in PARALLEL_LAYOUTS:
            path = _layout_data(tmp, name)
            rows = _layout_steps(name) * _layout_batch(name)
            if path not in corpus:
                create_text_token_dataset(path, docs[:rows], seq_len=s,
                                          pack=False)
                corpus[path] = (rows, int(sum(
                    min(int(n), s) for n in lengths[:rows])))
        every = _parallel_ranks(tmp)
        for name in PARALLEL_LAYOUTS:
            ranks = every[name]
            ref = _dp_reference(name, tmp, ranks)
            r0 = ranks[0]
            losses = r0["losses"]
            after = _grad_accum(name)  # the first loss after an update
            rows, valid_tokens = corpus[_layout_data(tmp, name)]
            steps = _layout_steps(name)
            timed = steps // 2  # timed: the later half
            step_ms = statistics.median(r0["step_ms"][timed:])
            fields = {
                "layout": name, "flags": PARALLEL_LAYOUTS[name],
                "ranks": PARALLEL_RANKS[name],
                "batch": _layout_batch(name),
                "timing": (f"{PARALLEL_RANKS[name]} ranks on one card over "
                           "gloo (host-staged)" if len(ranks) > 1 else
                           "one process on the card"),
                "transport": [r["parallel"]["transport"] for r in ranks],
                "mesh": r0["parallel"]["mesh"], "steps": r0["steps"],
                "first_loss": losses[0], "dp_first_loss": ref["losses"][0],
                "first_loss_rel_diff": _rel(losses[0], ref["losses"][0]),
                "updated_loss": losses[after],
                "dp_updated_loss": ref["losses"][after],
                "updated_loss_rel_diff": _rel(losses[after],
                                              ref["losses"][after]),
                "grad_norm": [r["grad_norm"] for r in ranks],
                "dp_grad_norm": ref["grad_norm"],
                "grad_norm_rel_diff": max(_rel(r["grad_norm"],
                                               ref["grad_norm"])
                                          for r in ranks),
                **_cosine_fields(ref["cosines"]),
                "last5_mean_loss": statistics.fmean(losses[-5:]),
                "losses": losses,
                "step_ms_median_later_half": step_ms,
                "step_ms_median_each_rank": [
                    statistics.median(r["step_ms"][timed:]) for r in ranks],
                "valid_tokens_per_sec": valid_tokens / steps
                / (step_ms / 1e3),
                "eval_masked_token_accuracy": [r["eval_accuracy"]
                                               for r in ranks],
                "dp_eval_masked_token_accuracy": ref["eval_accuracy"],
                "eval_rel_diff": max(_rel(r["eval_accuracy"],
                                          ref["eval_accuracy"])
                                     for r in ranks),
                "eval_rows": [r["eval_rows"] for r in ranks],
                "dp_eval_rows": ref["eval_rows"], "dataset_rows": rows,
                "eval_batches": -(-rows // _layout_batch(name)),
                "launches": [{k: v for k, v in r["launches"].items() if v}
                             for r in ranks],
                "peak_memory_allocated_bytes": [r["peak"] for r in ranks],
                "peak_memory_reserved_bytes": [r["peak_reserved"]
                                               for r in ranks],
                "held_bytes": [r["parallel"]["held_bytes"] for r in ranks],
                "peak_bytes": [r["parallel"]["peak_bytes"] for r in ranks],
                "fsdp_unit_bytes": r0["parallel"]["fsdp_unit_bytes"],
                "plan_bytes": [r["parallel"]["plan_bytes"] for r in ranks],
                "replicated_bytes": r0["parallel"]["replicated_bytes"],
                "seconds": r0["seconds"],
            }
            fields["draws"] = _draw_fields(name, every, tmp)
            if name in PARALLEL_SAVES or name in PARALLEL_RESUMES:
                fields["checkpoint"] = _checkpoint_fields(
                    name, ranks, tmp, ref["param_names"])
            emit("parallel", **fields)
            launches[f"parallel_{name}"] = {
                k: r0["launches"][k] for k in flash.LAUNCHES}
            report[name] = fields
    # Every layout is printed before any is checked, so that a failure
    # leaves the others' readings.
    problems = []
    for name, fields in report.items():
        try:
            _check_parallel(name, every[name], fields)
        except RuntimeError as exc:
            problems.append(str(exc))
    _SAVED.clear()
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"launches": launches, "tp_errors": tp_errors, "probe": probed,
            "layouts": report, "seconds": time.monotonic() - start}


def _check_parallel(name: str, ranks: list, fields: dict) -> None:
    """The phase's checks of one layout (the module's docstring)."""
    phase = f"parallel {name}"
    ckpt = fields.get("checkpoint")
    if ckpt is not None and ckpt["differing_leaves"]:
        what = ("its newest step read whole differs from the gathered state"
                if name in PARALLEL_SAVES else
                f"the state restored from {ckpt['resumed_from']}'s step "
                "differs from the saved one")
        raise RuntimeError(f"{phase}: {what} at "
                           f"{ckpt['differing_leaves'][:5]}")
    if name in PARALLEL_RESUMES and not ckpt["reads_held_bytes"]:
        raise RuntimeError(
            f"{phase}: a rank read other than its held bytes and the "
            f"step's {ckpt['unsplit_bytes']} unsplit bytes: "
            f"{[(e['bytes_read'], e['held_and_unsplit_bytes']) for e in ckpt['restore']]}")
    draws = fields["draws"]
    if not (draws["masks_equal_draws"] and draws["share_ranks_draw_alike"]):
        raise RuntimeError(
            f"{phase}: the masks are not the one generator's global draws "
            f"from the {draws['mask_generator']} (equal: "
            f"{draws['masks_equal_draws']}; the ranks of a share alike: "
            f"{draws['share_ranks_draw_alike']})")
    if name in PARALLEL_RESUMES and not draws[
            "batches_equal_saving_runs_next"]:
        raise RuntimeError(
            f"{phase}: global batches {draws['batch_sha256']}, the saving "
            f"run's next {draws['saving_run_next_sha256']}")
    if len(ranks) > 1 and any(t != "gloo-host-staged"
                              for t in fields["transport"]):
        raise RuntimeError(f"{phase}: transport {fields['transport']}")
    if len(ranks) != PARALLEL_RANKS[name]:
        raise RuntimeError(f"{phase}: {len(ranks)} ranks reported")
    _check_trained(phase, fields, _layout_steps(name))
    if any(r["losses"] != fields["losses"] for r in ranks):
        raise RuntimeError(f"{phase}: the ranks logged different losses")
    if any(n != fields["dataset_rows"] for n in fields["eval_rows"]
           + [fields["dp_eval_rows"]]):
        raise RuntimeError(f"{phase}: eval covered {fields['eval_rows']} "
                           f"(whole model: {fields['dp_eval_rows']}) of "
                           f"{fields['dataset_rows']} rows")
    accuracy = fields["eval_masked_token_accuracy"]
    if len(set(accuracy)) != 1:
        raise RuntimeError(f"{phase}: the ranks' eval accuracies differ: "
                           f"{accuracy}")
    if not fields["eval_rel_diff"] <= PARALLEL_EVAL_TOL:
        raise RuntimeError(f"{phase}: eval accuracy {accuracy[0]} vs the "
                           f"whole model's "
                           f"{fields['dp_eval_masked_token_accuracy']} "
                           f"(limit {PARALLEL_EVAL_TOL} relative)")
    if "--fsdp" in PARALLEL_LAYOUTS[name]:
        units = fields["fsdp_unit_bytes"]
        bound = units["root"] + 2 * units["largest"]
        for rank, peaks in enumerate(fields["peak_bytes"]):
            for key in ("gathered_params", "whole_grads"):
                if not 0 < peaks[key] <= bound:
                    raise RuntimeError(
                        f"{phase}: rank {rank} {key} peak {peaks[key]} "
                        f"bytes, bound {bound} (root {units['root']} + 2 x "
                        f"unit {units['largest']})")
    for key, tol in (("first_loss", PARALLEL_LOSS_TOL),
                     ("updated_loss", PARALLEL_LOSS_TOL),
                     ("grad_norm", PARALLEL_NORM_TOL)):
        if not fields[f"{key}_rel_diff"] <= tol:
            raise RuntimeError(f"{phase}: {key} {fields[key]} vs the "
                               f"data-parallel step's {fields['dp_' + key]}"
                               f" (limit {tol} relative)")
    if not fields["update_cosine_min"] >= PARALLEL_COS_MIN:
        raise RuntimeError(f"{phase}: the first update of "
                           f"{fields['update_cosine_min_leaf']} has cosine "
                           f"{fields['update_cosine_min']} with the "
                           f"data-parallel step's (limit {PARALLEL_COS_MIN})")
    flash_on = "--flash_attention" in PARALLEL_LAYOUTS[name]
    per_step = LAYERS * _layout_steps(name) if flash_on else 0
    for rank, r in enumerate(ranks):
        # Every rank evaluates its data share's slice of each global eval
        # batch: LAYERS forwards a batch on each.
        evals = LAYERS * fields["eval_batches"] if flash_on else 0
        want = {"fwd": per_step + evals, "bwd_dq": per_step,
                "bwd_dkv": per_step}
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise RuntimeError(f"{phase}: rank {rank} flash launches {got}, "
                               f"expected {want}")
        if PARALLEL_RANKS[name] == 1:
            continue  # one data-parallel process: no plan, the state whole
        held, plan = r["parallel"]["held_bytes"], r["parallel"]["plan_bytes"]
        if held != plan:
            raise RuntimeError(f"{phase}: rank {rank} holds {held}, its plan "
                               f"{plan}")
        if not held["total"] < fields["replicated_bytes"]["total"]:
            raise RuntimeError(f"{phase}: rank {rank} holds no less than the "
                               f"replicated state")


ANALYSIS_STEPS = 8  # steps of each sanitized run of the analysis phase
ANALYSIS_IMAGE_BATCH = 128
SANITIZER_FLAGS = ("LDT_COMPILE_SANITIZER", "LDT_LOCK_SANITIZER",
                   "LDT_LEAK_SANITIZER", "LDT_WIRE_SANITIZER")
# The analysis phase's subprocess: both runs through ``cli train`` under
# the sanitizers, each run's launches read just after it; one JSON line.
ANALYSIS_DRIVER = r"""
import json, sys
from lance_distributed_training_tpu_torch import cli, ops
tokens, food, steps, batch = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
common = ["--max_steps", steps, "--epochs", "1", "--log_every", "4",
          "--device", "cuda", "--no_autotune"]
runs = {}
for name, argv in (
        ("masked_lm", ["train", "--dataset_path", tokens, "--task_type",
                       "masked_lm", "--model_name", "bert_base", "--seq_len",
                       "512", "--flash_attention", "--batch_size", "32",
                       "--optimizer", "adamw", "--lr", "1e-4", *common]),
        ("classification", ["train", "--dataset_path", food, "--task_type",
                            "classification", "--model_name", "resnet50",
                            "--image_size", "224", "--num_classes", "101",
                            "--batch_size", batch, "--device_decode",
                            *common])):
    ops.reset_launches()
    result = cli.main(argv)
    runs[name] = {"steps": result["steps"], "losses": result["losses"],
                  "eval_rows": result.get("eval_rows"),
                  "launches": dict(ops.LAUNCHES)}
print(json.dumps(runs), flush=True)
"""


def _port_cli(*argv, niceness: int = 19) -> subprocess.Popen:
    """The port's CLI in a subprocess of this checkout, no sanitizer on; by
    default at the lowest CPU priority, for the runs beside the sanitized
    training, whose decode threads they must not slow."""
    env = {k: v for k, v in os.environ.items() if k not in SANITIZER_FLAGS}
    return subprocess.Popen(
        [sys.executable, "-m", "lance_distributed_training_tpu_torch.cli",
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(niceness))


def _witness_sites(witness: dict, root: str) -> dict:
    """The compile witness's sites, relative to ``root``: ``{(path, line,
    phase): entry}``, phase "" for the training loop, "eval" for eval."""
    out = {}
    for site, entry in witness["compiles"].items():
        path, _, line = site.rpartition(":")
        line, _, phase = line.partition("@")
        out[(os.path.relpath(path, root), int(line), phase)] = entry
    return out


def analysis_run() -> dict:
    """The static checker over the port, a sanitized run of masked-LM
    with flash and of ResNet-50 with K1 and K2, and the checker over its
    witnesses (the module's docstring, phase 26)."""
    import torch
    from lance_distributed_training_tpu_torch.analysis.cli import (
        load_compile_witness,
    )
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import (
        flash,
        image,
        jpeg_device,
    )
    from lance_distributed_training_tpu_torch.utils import compiletrack

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    # The earlier phases' cached blocks go back to the card: the sanitized
    # runs are another process.
    torch.cuda.empty_cache()
    background = {"check": _port_cli("check"),
                  "graph": _port_cli("graph", "--mesh", "--loader")}
    steps = ANALYSIS_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        tokens, food = os.path.join(tmp, "tokens"), os.path.join(tmp, "food")
        _, docs = _slice_docs()
        create_text_token_dataset(tokens, docs[:SHAPE[0] * steps],
                                  seq_len=SHAPE[2], pack=False)
        _learnable_dataset(os.path.join(tmp, "drawn"), food,
                           ANALYSIS_IMAGE_BATCH * steps)
        author_s = time.monotonic() - t0
        witness = {name: os.path.join(tmp, f"{name}-witness-torch.json")
                   for name in ("compile", "lock", "leak")}
        env = {k: v for k, v in os.environ.items()
               if k not in SANITIZER_FLAGS}
        env.update({"LDT_COMPILE_SANITIZER": "1", "LDT_LOCK_SANITIZER": "1",
                    "LDT_LEAK_SANITIZER": "1",
                    "LDT_COMPILE_WITNESS_PATH": witness["compile"],
                    "LDT_LOCK_WITNESS_PATH": witness["lock"],
                    "LDT_LEAK_WITNESS_PATH": witness["leak"],
                    "LDT_METRICS_PATH": os.path.join(tmp, "metrics.jsonl"),
                    "PYTHONPATH": root + os.pathsep
                    + os.environ.get("PYTHONPATH", "")})
        t_train = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-c", ANALYSIS_DRIVER, tokens, food, str(steps),
             str(ANALYSIS_IMAGE_BATCH)], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=600)
        train_s = time.monotonic() - t_train
        if proc.returncode != 0:
            raise RuntimeError(f"analysis: the sanitized runs failed "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        runs = json.loads(proc.stdout.strip().splitlines()[-1])
        missing = [n for n, p in witness.items() if not os.path.exists(p)]
        if missing:
            raise RuntimeError(f"analysis: no {missing} witness written")
        t_check = time.monotonic()
        # In a fresh interpreter: this process's heap, grown over the
        # earlier phases, slows the checker's many small allocations.
        checked = _port_cli("check", "--compile-witness", witness["compile"],
                            "--lock-witness", witness["lock"],
                            "--leak-witness", witness["leak"], "--json",
                            niceness=0)
        out, err = checked.communicate(timeout=600)
        rc = checked.returncode
        witness_check_s = time.monotonic() - t_check
        try:
            report = json.loads(out)
        except ValueError:
            raise RuntimeError(f"analysis: check over the witnesses exited "
                               f"{rc}:\n{out[-2000:]}{err[-2000:]}")
        with open(witness["compile"], encoding="utf-8") as f:
            compiled = json.load(f)
        with open(witness["lock"], encoding="utf-8") as f:
            locks = json.load(f)
        loaded = load_compile_witness(witness["compile"], root)
    sites = _witness_sites(compiled, root)
    kernels = {
        "flash_attention_fwd": flash.flash_attention_fwd,
        "flash_attention_bwd_dq": flash.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": flash.flash_attention_bwd_dkv,
        "image_normalize": image.normalize_flip,
        "jpeg_decode": jpeg_device.decode_coeff_batch,
    }
    kernel_sites = {}
    for name, fn in kernels.items():
        path, _, line = compiletrack.def_site(fn).rpartition(":")
        key = (os.path.relpath(path, root), int(line), "")
        kernel_sites[name] = {"site": f"{key[0]}:{key[1]}",
                              **sites.get(key, {"calls": 0, "compiles": 0,
                                                "post_warmup": 0})}
    forwards = {f"{p}:{ln}": e for (p, ln, ph), e in sites.items()
                if not ph and p.startswith(
                    "lance_distributed_training_tpu_torch/models/")}
    evals = {f"{p}:{ln}@{ph}": e for (p, ln, ph), e in sites.items() if ph}
    receipt = report.get("compile_witness", {})
    d2h = sum(e["count"] for e in loaded["transfers"].get("d2h", {}).values())
    train_steps = sum(r["steps"] for r in runs.values())
    fields = {
        "findings": report["findings"], "files_checked": report[
            "files_checked"], "compile_witness": receipt,
        "leak_witness": report.get("leak_witness"),
        "lock_edges": len(locks["edges"]),
        "lock_sites": len(locks["acquired"]),
        "kernel_sites": kernel_sites, "forward_sites": forwards,
        "builds": compiled.get("builds"),
        "runs": {n: {k: r[k] for k in ("steps", "losses", "eval_rows")}
                 for n, r in runs.items()},
        "launches": {n: {k: v for k, v in r["launches"].items() if v}
                     for n, r in runs.items()},
        "dataset_seconds": author_s, "train_seconds": train_s,
        "witness_check_seconds": witness_check_s,
    }
    emit("analysis", check="witnesses", **fields)
    # The eval step's own site sees both runs' batches (one process), so
    # the second run's first batch is a new signature there.
    emit("analysis", check="eval_sites", eval_sites=evals,
         eval_post_warmup=sum(e["post_warmup"] for e in evals.values()))
    eval_batches = (-(-int(runs["masked_lm"]["eval_rows"]) // SHAPE[0])
                    - (-int(runs["classification"]["eval_rows"])
                       // ANALYSIS_IMAGE_BATCH))
    emit("analysis", check="d2h", d2h_events=d2h,
         d2h_at_funnels=receipt.get("d2h_at_funnels"),
         train_steps=train_steps, d2h_events_a_step=d2h / train_steps,
         h2d_events=receipt.get("h2d_events"),
         batches_placed=train_steps + eval_batches,
         h2d_events_a_batch=(receipt.get("h2d_events") or 0)
         / (train_steps + eval_batches))
    results = {}
    for name, p in background.items():
        stdout, stderr = p.communicate(timeout=600)
        results[name] = (p.returncode, stdout, stderr)
    check_rc, check_out, check_err = results["check"]
    graph_rc, graph_out, graph_err = results["graph"]
    graph_lines = graph_out.splitlines()
    emit("analysis", check="static", check_rc=check_rc,
         check_summary=check_out.strip().splitlines()[-1:],
         graph_rc=graph_rc,
         graph_summary=[ln for ln in graph_lines
                        if ln.startswith(("concurrency model", "  mesh model",
                                          "  torch forms", "  torch axis",
                                          "  loader graph model"))],
         seconds=time.monotonic() - t0)
    if check_rc != 0 or "ldt check: clean" not in check_out:
        raise RuntimeError(f"analysis: check over the port exited {check_rc}"
                           f":\n{check_out[-3000:]}{check_err[-2000:]}")
    if graph_rc != 0 or "  torch forms:" not in graph_out \
            or "  loader train-iterable:" not in graph_out:
        raise RuntimeError(f"analysis: graph --mesh --loader exited "
                           f"{graph_rc}:\n{graph_err[-2000:]}")
    if rc != 0 or not report["clean"]:
        raise RuntimeError(f"analysis: check over the witnesses exited {rc}"
                           f": {report['findings']}")
    for name, run in runs.items():
        losses = run["losses"]
        if run["steps"] != steps or len(losses) != steps \
                or not all(np.isfinite(losses)):
            raise RuntimeError(f"analysis: {name} ran {run['steps']} steps, "
                               f"losses {losses}")
    flash_want = LAYERS * steps
    lm = runs["masked_lm"]["launches"]
    if lm["bwd_dq"] != flash_want or lm["bwd_dkv"] != flash_want \
            or lm["fwd"] < flash_want:
        raise RuntimeError(f"analysis: flash launched {lm}, expected "
                           f"{flash_want} dQ and dK/dV and at least as "
                           f"many forwards")
    cls = runs["classification"]["launches"]
    if cls["image_normalize"] < steps or cls["jpeg_decode"] < steps:
        raise RuntimeError(f"analysis: K1 and K2 launched {cls}")
    unexercised = [n for n, e in kernel_sites.items() if not e["calls"]]
    if unexercised:
        raise RuntimeError(f"analysis: no witness of {unexercised}")
    retuned = {n: e for n, e in kernel_sites.items() if e["post_warmup"]}
    retuned.update({s: e for s, e in forwards.items() if e["post_warmup"]})
    if retuned or not forwards:
        raise RuntimeError(f"analysis: new signatures after warmup in the "
                           f"training loop {retuned}, forwards {forwards}")
    if receipt.get("d2h_at_funnels") != d2h or not d2h:
        raise RuntimeError(f"analysis: {d2h} D2H events, "
                           f"{receipt.get('d2h_at_funnels')} at the "
                           f"declared sync funnels")
    return {"launches": {
        k: lm.get(k, 0) + cls.get(k, 0)
        for k in ("fwd", "bwd_dq", "bwd_dkv", "image_normalize",
                  "jpeg_decode")},
        "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args(argv).phases.split(",")
    t0 = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import lance_distributed_training_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = probe()
    ptxas = build() if set(phases) - {"probe"} else None
    timing = kernels() if "kernels" in phases else None
    sliced = slice_run() if "slice" in phases else None
    if "trainer" in phases:
        trainer_run(card, sliced["step_ms"] if sliced else None)
    launches = sliced["launches"] if sliced else None
    k1 = image_kernels() if "image_kernels" in phases else None
    k2 = jpeg_kernels() if "jpeg_kernels" in phases else None
    pixel = coeff = None  # the classification phases' figures
    if "classification" in phases:
        pixel = classification_run()
        launches = {**(launches or {}), **pixel["launches"]}
    if "device_decode" in phases:
        coeff = classification_run(device_decode=True)
        launches = {**(launches or {}), **coeff["launches"]}
    k3 = token_kernels() if "token_kernels" in phases else None
    causal = None  # the causal_lm phase's figures
    if "causal_lm" in phases:
        causal = causal_lm_run()
        launches = {**(launches or {}), **causal["launches"]}
    k5 = ring_kernels(ptxas) if "ring_kernels" in phases else None
    if "ring_lm" in phases:
        ring = ring_lm_run(sliced["step_ms"] if sliced else None)
        launches = {**(launches or {}), **ring["launches"]}
    loaders = {}  # K1's and K2's launches under the loader phases
    if "map_style" in phases:
        loaders["map_style"] = map_style_run(
            coeff["fields"] if coeff else None)["launches"]
    if "folder" in phases:
        loaders["folder"] = folder_run(
            pixel["fields"] if pixel else None)["launches"]
    if "pretrained_placement" in phases:
        loaders["pretrained_placement"] = pretrained_placement_run()[
            "launches"]
    if "workers_caches" in phases:
        loaders["workers_caches"] = workers_caches_run()["launches"]
    if "contrastive" in phases:
        loaders["contrastive"] = contrastive_run()["launches"]
    if "vit" in phases:
        # ResNet-50 beside it, in the same decoder arm when that phase ran.
        resnet = coeff or pixel
        loaders["vit"] = vit_run(resnet["fields"] if resnet else None)[
            "launches"]
    if "moe" in phases:
        loaders["moe"] = moe_run(sliced["step_ms"] if sliced else None)[
            "launches"]
    if "graph" in phases:
        loaders["graph"] = graph_run()["launches"]
    if "remat" in phases:
        loaders["remat"] = remat_run()["launches"]
    if "service" in phases:
        loaders["service"] = service_run({
            "pil": pixel["fields"] if pixel else None,
            "coeff": coeff["fields"] if coeff else None})["launches"]
    if "fleet" in phases:
        loaders["fleet"] = fleet_run(
            causal["arms"]["packed"] if causal else None)["launches"]
    parallel = None
    if "parallel" in phases:
        parallel = parallel_run()
        loaders.update(parallel["launches"])
    analysis = None
    if "analysis" in phases:
        analysis = analysis_run()
        loaders["analysis"] = analysis["launches"]
    emit("done", phases=phases, seconds=time.monotonic() - t0,
         parallel_seconds=parallel["seconds"] if parallel else None,
         analysis_seconds=analysis["seconds"] if analysis else None)
    if set(phases) != set(PHASES):
        return 0  # a partial run prints no result
    print(card["smi"], flush=True)

    def phase_launches(name: str) -> dict:
        """``name``'s launches under the phases after the main paths."""
        return {f"launches_{phase}": counts[name]
                for phase, counts in loaders.items() if name in counts}

    table = [{
        "name": f"flash_attention_{name}", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name], **phase_launches(name),
        "max_abs_err": timing["errors"][name],
        "max_abs_err_tp_shard": parallel["tp_errors"][name],
        **timing["table"][name],
    } for name in ("fwd", "bwd_dq", "bwd_dkv")]
    table.append({
        "name": "image_normalize", "route": "cuda", "source": IMAGE_SOURCE,
        "replaces": IMAGE_REPLACES, "launches": launches["image_normalize"],
        **phase_launches("image_normalize"),
        "max_abs_err": 0.0, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None, "share_of_bound": k1["share_of_bound"],
        "copy_ms": k1["copy_ms"],
        "registers": {r["kernel"]: r["registers"]
                      for r in ptxas["image_ptxas"]},
    })
    table.append({
        "name": "jpeg_decode", "route": "cuda", "source": JPEG_SOURCE,
        "replaces": JPEG_REPLACES, "launches": launches["jpeg_decode"],
        **phase_launches("jpeg_decode"),
        "max_abs_err": 0.0, "ms": k2["ms"],
        "back_to_back_ms": k2["back_to_back_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "share_of_bound": k2["share_of_bound"],
        "registers": {r["kernel"]: r["registers"]
                      for r in ptxas["jpeg_ptxas"]},
    })
    for name in ("token_pack", "token_unpack"):
        row = k3["table"][name]
        table.append({
            "name": name, "route": "cuda", "source": TOKEN_SOURCE,
            "replaces": TOKEN_REPLACES[name], "launches": launches[name],
            **phase_launches(name),
            "check_launches": k3["check_launches"][name],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "share_of_bound": row["share_of_bound"],
            "launch_floor_ms": row["launch_floor_ms"],
            "registers": {r["kernel"]: r["registers"]
                          for r in ptxas["token_ptxas"]}[name],
        })
    for name in RING_KERNELS:
        table.append({
            "name": name, "route": "cuda", "source": RING_SOURCE,
            "replaces": RING_REPLACES, "launches": launches[name],
            **phase_launches(name),
            "max_abs_err": k5["errors"][name], **k5["table"][name],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
