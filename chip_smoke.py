#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``metaasr_tpu_torch``) on one NVIDIA
GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build   — compile every CUDA source of the port with nvcc (sm_90a), in
             parallel; print ``nvidia-smi`` name and power limit, and the
             registers and spills of each LSTM kernel.
2. kernel  — K1 (the log-mel fbank as a per-frame FFT) against its plain
             PyTorch version (the reference's folded matrix product) and
             the float64 numpy oracle on the card, at [16, 64000] ragged
             (401 samples = 1 frame ... 64000), [16, 64000] and [4, 64000]
             all valid, [1, 24000] and [3, 63999] (rows not 16-byte
             aligned: the cp.async staging), each at 40, 80 and 128 mel
             bins: max |diff| <= 1e-4 where the plain version is within
             1e-4 of the oracle, |diff| <= 1e-4 + 1e-4 |plain| everywhere
             (the reference's rtol = atol bar), max |diff| from the oracle
             <= 1e-5, exact frame lengths, zero padding; CMVN after both;
             beside them the plain version's and the fp32 cuFFT
             composite's distance from the oracle. At the first three
             shapes: CUDA-event medians of K1 (wrapper included), its
             device time per launch from the profiler's kernel spans over
             30 launches, the wrapper's host time (their difference), the
             launch's frames per block and blocks, the plain version, the
             cuFFT/cuBLAS composite and the bound.
3. serving — the config3-width model (d 256, 4 heads, d_ff 2048, 12+6
             layers, char vocab 30, bf16 compute, fp32 weights; weights
             from a numpy seed in the Flax layout, written as a bundle)
             serves four requests through ``ServingDecoder`` on bucket
             (16, 64000) with beam 10, ctc_weight 0.3, max_len 128: a full
             batch twice (the second is timed), a batch of 5, one utterance,
             and the full batch once more under torch.profiler (device busy
             time). K1's launch count, zeroed first, must grow by one per
             request.
4. parity  — a tiny fp32 model served on cuda and on cpu from one bundle
             gives identical texts and scores within 1e-4.
5. ctc_kernel — K2 (CTC alpha/beta) against its plain PyTorch version at
             [B, T, U, V] = [4, 63, 32, 30] (the run's first K2 launch:
             49,140 B of dynamic shared memory, under 48 KB but over it
             with the static part), [16, 99, 32, 30] (tasks fused),
             [4, 99, 32, 30] (per task), [3, 50, 7, 12], [8, 1000, 20, 30],
             [4, 99, 60, 30] (S = 121) and [2, 1100, 511, 30] (S = 1,023,
             the widest), with
             ragged T, an empty label and an infeasible row: loss within
             atol = rtol = 1e-5, gradient l2rel <= 1.9e-3, the infeasible
             row's loss and gradient 0 through the autograd Function; each
             shape's launch plan (layout, states per thread, warps, shared
             memory). At the first two shapes: CUDA-event medians of K2
             (wrapper included), its plain version and F.ctc_loss forward +
             backward, K2's device time per launch from the profiler's
             kernel spans over 30 launches, the wrapper's host time (their
             difference) and µs per dependent step (T of them).
6. meta_step — the config3-width FOMAML meta-step (maml_grads + Adam/Noam,
             clip 5) on bench.py's workload, 4 tasks x (4 + 4) and
             4 x (16 + 16) utterances of 64,000 samples, 32 tokens, 3 inner
             steps, bf16 grad_dtype, SpecAugment on: 1 warm-up, 5 timed and
             1 profiled step per shape; every loss finite, and exactly
             2*M K1 and M*(inner_steps+1) K2 launches per step.
7. train_entry — an 8-accent synthetic corpus; MetaASRTrainer.meta_train
             (through the CLI's make_trainer) for 2 steps at config3 width,
             checkpoints written and restored, meta_adapt on the held-out
             accent, the adapted npz hot-swapped into a ServingDecoder that
             serves one utterance; exact launch counts.

8. lstm_kernel — K3 (LSTM recurrence) and K3b (its BPTT from the saved
             gates, and the dU product) against their plain PyTorch versions,
             through the autograd Function, at [T, B, H] = [99, 16, 320]
             (config1), [64, 8, 128], an unaligned [37, 5, 96], a long
             [400, 4, 320], the reference's H [20, 3, 24] (an uneven split),
             [20, 4, 640] (U's slice partly streamed), [3, 5, 5280] (the
             widest H, almost all streamed) and [65, 64, 192] (the fusion
             LM of ``fusion_eval``, batch 64): forward and saved gates max
             |diff| <= 1e-5, dgx / dU l2rel <= 1e-3; each shape's cluster
             size, batch tile, shared memory per CTA and
             cudaOccupancyMaxActiveClusters. CUDA-event medians at the
             config1 and long shapes of K3 (with and without the gates), K3b,
             its recurrence and its dU product apart, the plain versions, µs
             per dependent step; sweeps of the batch tile and of the dU
             product's k splits; and as the
             library yardstick ``torch.nn.LSTM`` (cuDNN, +1 folded into the
             forget bias; it includes the input projection) forward, forward
             + backward and the backward alone at [99, 16, 640 -> 320] beside
             K3 + F.linear for the same layer.
9. mono_step — the config1-width VGG-BLSTM CTC step (VGG 64/128, 4 x BLSTM
             320, fp32, Adadelta lr 1.0, clip 5, SpecAugment on) through
             ``MonoASRTrainer.step``: batch 16 x 64,000 samples, 32 phone
             tokens; 2 warm-up, 5 timed, 1 profiled step; every loss finite,
             exactly 8 K3 + 8 K3b + 1 K1 + 1 K2 launches per step. Before
             it, a small model's loss and gradients on cuda against the cpu
             (loss rtol 1e-4, gradient leaves l2rel <= 1e-3).
10. mono_entry — a synthetic corpus with phone transcripts through the CLI's
             ``make_trainer`` (algo no, config1 width): 120 steps, a dev
             evaluation every 40 (greedy CTC, CER/WER), best checkpoint
             written and restored, a greedy bundle written and served by
             ``ServingDecoder`` (a full batch of 16 and one utterance);
             exact launch counts (serving: 8 K3 per request, 0 K3b).

11. ctc_hvp_kernel — K2b (the CTC Hessian-vector product) against its plain
             PyTorch version at K2's seven shapes, a seeded direction v: hv
             l2rel <= 1e-3 and max |diff| <= 1e-5 (1 + max |hv|); against
             the plain versions run in float64, hv l2rel <= 1e-3 and nll_dot
             within 1e-4 (1 + |<grad, v>|), both bars times T / 100 at
             T = 1000 (fp32 rounding); at T <= 100 nll_dot also within
             2e-4 (1 + |<g, v>|) of K2's own fp32 gradient dotted with v;
             the infeasible row exactly 0,
             no NaN; through the autograd Functions, grad(<grad(loss), v>)
             on cuda against the cpu with exactly one K2 and one K2b launch.
             CUDA-event medians of K2b, its plain version and, as the only
             yardstick there is (``F.ctc_loss`` is not twice
             differentiable), autograd-of-autograd through the port's scan
             recursion on the card; device and host time, chain length and
             plan as in phase 5.
12. maml_step — the config4-width second-order MAML meta-step (maml_grads
             with first_order false and remat_inner, config4's own setting,
             + Adam/Noam, clip 5) on bench.py's workload at config4's own
             shape, 4 x (16 + 16) utterances of 64,000 samples, 32 tokens,
             2 inner steps, bf16 grad_dtype, SpecAugment on: 1 warm-up
             without remat (it grows the allocator's cache to the larger
             peak; its launches are not counted), 3 timed, 1 profiled step
             with remat; every loss finite, exactly 2*M K1,
             M*(2*inner_steps+1) K2 (each inner step once more in its
             recompute) and M*inner_steps K2b launches per step. Then the
             same step at the same parameters and seed with and without
             remat_inner, each under deterministic algorithms with its own
             peak-memory window: outer gradients within 1e-6 worst leaf
             l2rel and the same meta loss, the peak with remat below the
             peak without, exact launches each side (M*(inner_steps+1) K2
             without); both peaks and their ratio, and each side's ms of
             one step (order-dependent, not the recompute's cost). Before
             it, a
             small fp32 model's second-order gradients (remat on) on cuda
             against the cpu (worst leaf l2rel <= 1e-3).
13. maml_entry — ``configs/config4_maml.yaml`` (remat_inner true) through
             the CLI's ``make_trainer`` on an 8-accent synthetic corpus: 2
             meta-steps at full width, the checkpoint restored exactly,
             meta_adapt on the held-out accent; then one MAML step of a
             small VGG-BLSTM
             (hidden 64, 2 layers) through the same trainer, whose
             recurrence runs in the autograd loop (0 K3/K3b launches);
             and one ``eval_heldout`` of the MAML state (1 support draw,
             4 test utterances, beam); exact launch counts (K2
             M*(2*inner_steps+1) a MAML step; the adaptation first order).
14. meta_test — the meta-test path through the CLI's ``main``, in this
             process, at config3 width (``configs/config3_fomaml.yaml``) on
             an 8-accent corpus of 16 utterances each, ``tango`` held out:
             ``--mode train`` 4 FOMAML steps with a held-out evaluation
             every 2 (2 support draws, 8 test utterances, beam 10), then
             ``adapt --use-best --decode-mode beam --dump-nbest 3``,
             ``test --avg-last 2``, ``export --export-buckets 4x96000`` and
             ``serve`` of that bundle without and with ``--config`` (the
             same transcripts); one ``eval_heldout`` of the best state
             under the profiler (busy share, kernels per decode batch);
             WER/CER of each evaluation, seconds per mode; exact K1/K2
             launch counts per mode.
15. mono_test — the baseline's meta-test modes through the CLI at
             config1 width: 4 ``--algo no`` steps, ``test`` (the held-out
             accent through ``MonoASRTrainer.evaluate``), ``transcribe``
             (every accent through a decode-only meta trainer) and
             ``transcribe`` of the same manifests without transcripts
             (hypotheses, no WER); exact K1/K3 launch counts (8 K3 per
             decode batch).

16. data_prep — data preparation on the acceptance drill's corpus (3
             accents x 48 utterances rendered at 22.05 kHz, 4 speakers
             each) through ``prepare_data.main`` in this process:
             ``commonvoice``, ``speaker-cmvn`` and ``features`` on the card
             (exactly one K1 launch per utterance each), ``features`` again
             under the profiler (K1's device ms per utterance), ``vocab``
             char / phone / bpe; every saved utterance against K1's plain
             version on the CPU and the float64 oracle by phase 2's bars,
             frame counts exact, ``cmvn_stats.json`` equal to a float64
             recompute from the saved arrays. Then, through ``cli.main``, 2
             FOMAML steps at config3 width (2 tasks: the corpus has 2
             training accents) on manifests that name only the features,
             with the BPE vocabulary prep wrote, and ``--mode test`` (beam)
             on the held-out accent: 0 K1 launches, exactly
             M*(inner_steps+1) K2 launches a step, losses finite. Seconds
             per subcommand, utterances/s of ``features`` beside the card's
             name and power limit.
17. acceptance — ``python -m metaasr_tpu_torch.scripts.acceptance --smoke
             --steps 6 --utts 10`` as a subprocess on the card, started
             before phase 23 and joined after it: rc 0, ``ACCEPTANCE
             GREEN``, 8 served records with text and score, a finite served
             WER; seconds per stage. The two share the card and the host,
             so the drill's stage seconds and phase 23's seconds are read
             beside the other workload (each phase's line says so).

18. lm_fusion — LM shallow fusion. ``scripts.train_lm.main`` in this
             process at its defaults (embed 128, hidden 256, 2 layers,
             batch 32, max_len 64) for 200 steps on an 8-accent text corpus
             (6-16 words a transcript, ``tango`` held out): exactly
             200 x 2 K3 and K3b launches, the logged NLL finite and falling,
             the npz's dims; one step's ms, kernels and busy share; K3 and
             K3b at the LM's shape [65, 32, 256] (plan, event and device
             time, plain versions, bound, ``nn.LSTM`` of one LM layer;
             phase 8's bars). Under strict fp32 there and for the trained
             LM: its sequence mode (K3) against its step mode on the card
             (1e-5, the reference's bar), ``lm_nll`` card against CPU
             (rtol 1e-5), one train step's gradients card against CPU
             (l2rel <= 1e-3). Phase 3's requests
             through a config3 bundle carrying the LM (lm_weight 0.3),
             beside phase 3's readings, then an adapted tree without
             ``__lm__`` hot-swapped (the bundle's LM serves it); a tiny fp32
             model with the LM served on cuda and cpu (phase 4's bars). The
             CLI at config3 width with ``--lm-ckpt``/``--lm-weight``: train
             (2 steps, one fused held-out evaluation), ``test`` (beam, and
             again with ``--lm-weight 0``), ``export`` (``has_lm``) and
             ``serve`` with ``--serve-params`` of an adapted npz; exact
             launch counts everywhere (K3/K3b 0 in the search).

19. conformer — ``model.encoder: conformer`` (depthwise kernel 15) at
             config3 width under the TF32 policy: the FOMAML step of the
             reference's conformer recipe (``meta.adapt_filter: decoder``,
             decoder-only inner steps) at phase 6's 4 x (16 + 16) on its
             batch, 1 warm-up, 5 timed, 1 profiled step, beside phase 6's
             cell of the same run (ratios of ms, kernels and busy ms); one
             full-body FOMAML step; one
             second-order MAML step at config4's shape (full body, 2 inner
             steps, remat_inner: gradients finite, the conformer's
             ``u_bias`` and depthwise leaves non-zero; its peak memory
             beside the 7.16 GB read without remat, a note);
             then the CLI with ``-o model.encoder=conformer`` on phase 14's
             corpus: train (2 steps, one held-out evaluation, beam),
             ``adapt --use-best``, ``test`` (beam), ``export`` and
             ``serve`` of the bundle without and with ``--config`` (the
             same transcripts); the bundle's weights at fp32 compute on
             cuda and on the cpu under strict fp32, two short requests
             (phase 4's bars); exact K1/K2/K2b launch counts everywhere.

20. bench   — the port's headline bench (``scripts/bench.py``), cut in
             depth (its readings are the bench's own runs at its
             defaults), in this process: (a) ``bench.main(["--steps",
             "1"], measure_fn=..., baseline_steps=1)``: ``bench.measure``
             at 1 warm-up step and at most 2 passes, each baseline at 1
             step a pass: exit 0, one record in the frozen unit
             with finite positive ``value``, ``mfu``, ``vs_baseline`` and
             ``vs_samechip_sequential``, the reference's ``workload``,
             ``device.name`` equal to ``nvidia-smi``'s; (b) the sweep's
             ``main(["--points", "4x4", "--steps", "1"])``, cut the same
             way: exit 0, one row and the summary. For each of the
             three ``bench.measure`` calls they make (4 x (16 + 16),
             4 x (4 + 4), the sweep's 4 x (4 + 4)): exactly 2*M K1 and
             M*(inner_steps+1) K2 launches for each of its ``steps_run``
             (warm-up and FLOP-count steps included), 0 K2b/K3/K3b, the
             loss finite, MFU in (0, 1], the passes' ms and seconds.

21. serving_benches — the serving benches at full width (d 256, 12 + 6
             layers, bf16, 400 feature frames, beam 10, 48 forced steps):
             ``decode_bench.measure`` at B 16, B 16 with the LM (weight
             0.3), B 16 at vocab 512 with 40 CTC candidates, and
             ``measure_pipelined(16, nbatches=2)``, one timed pass each
             (``passes=1``; the benches' default is the median of 3);
             ``serve_bench.measure`` cut to 2 batches of 16, one pass
             (two, so that one batch is in flight when the next is
             dispatched);
             ``batcher_bench.main`` at 0.5x serve_bench's pipelined rate,
             a 2 s leg, 2 lone requests at idle (``--idle-requests 2``),
             all in this process. Exactly
             0 K1/K2/K2b/K3/K3b launches in this process (features in, the
             LM's search step plain PyTorch), every hypothesis 48 tokens
             long, the packed read-back equal to the dict read-back (tokens
             and lengths exact, scores bit-equal), sync and pipelined
             serving texts equal batch for batch, every batcher request
             completed and exit 0; every row beside ``nvidia-smi``'s line,
             each call's seconds and the phase's (budget 150 s, printed,
             not gated).

22. quality_scripts — the quality scripts' path, in this process: (a)
             ``configs/config2_multitask_transformer.yaml`` at full width
             (d 256, 12 + 6 layers, bf16, batch 32, Noam warm-up 4,000)
             through ``cli.main --mode train`` for 8 steps on an 8-accent
             corpus of 24 utterances each: every logged loss finite,
             exactly one K1 and one K2 launch a step, 0 K2b/K3/K3b; step
             ms (the median of steps 3-8 from the logged rates), kernels
             and busy share of one more profiled step, peak memory; before
             it, one step at the tests' width on cuda against the cpu
             under strict fp32 (loss rtol 1e-4, grad_norm rtol 1e-3). (b)
             ``demo_meta_adaptation.main --steps 2 --utts-per-accent 24``
             at its own width (d 128, 4 + 2 layers, bf16) into a temporary
             corpus, workdir and output: both markdown rows, every WER
             finite, and the exact K1/K2 launches of each call of
             ``meta_train``, ``train``, ``meta_adapt`` and ``decode``. (c)
             ``kshot_curve.main --ks 0,5 --draws 2 --max-utts 16`` over a
             ``fomaml`` and a ``multi`` workdir trained 2 steps each under
             the flagship recipe at config3 width: both restore step 2,
             the reference's JSON layout, every WER finite, exact launches
             (K2 = adapt_steps x draws x nonzero ks x runs); then
             ``--tiny --ks 0`` over a workdir written on the cpu, run on
             the card, and one written on the card, run on the cpu: both
             restore. The phase's seconds beside its budget (150 s,
             printed, not gated).

23. flagship — ``flagship_results.main`` at config3 width (d 256, 12 + 6
             layers, bf16 compute, 4 tasks x (4 + 4), 3 inner steps) in
             this process on a fresh corpus of the hard profile (16
             accents x 16 utterances) and workdir, as a user runs it:
             (a) ``--algos fomaml,maml,reptile,multi --steps 2`` (Reptile's
             and second-order MAML's arms), (b) ``--algos fomaml
             --learn-inner-lr`` (Meta-SGD: its {model, inner_lr} tree
             trained, averaged and adapting at the learned rates), (c)
             ``--algos fomaml --eval-only`` over (a)'s FOMAML workdir
             (restores step 2). Per call of ``meta_train``, ``train``,
             ``meta_adapt`` and ``decode``, the exact K1/K2/K2b launches
             the code gives (per step: FOMAML and Meta-SGD 2*M K1,
             M*(inner+1) K2; MAML 2*M K1, M*(2*inner+1) K2 with remat_inner
             and M*inner K2b; Reptile 2*M K1,
             M*inner K2; multitask 1 and 1; an adaptation 1 K1 and 5 K2; a
             decode batch 1 K1; K3/K3b 0); the reference's JSON layout for
             every tag, ``adapt5_beam_avglast5`` exactly for the two
             FOMAML tags, every WER finite; the Meta-SGD checkpoint's
             ``inner_lr`` leaves finite and at least one moved off its
             initial rate. Each call's and arm's seconds beside the
             phase's budget (150 s, printed, not gated), read with phase
             17's drill running beside them.

24. fusion_profiling — ``fusion_eval.main`` at config3 width in this
             process as a user runs it (the multitask arm, 2 steps; the
             recipe's 2 x 192 LM, 10 steps at batch 64; weights 0 and 0.3)
             over a hard-profile corpus of 16 utterances an accent made
             first, which it reuses: per call of ``train_char_lm``,
             ``train``, ``meta_adapt`` and ``decode`` the exact launches
             the code gives (the LM K3 and K3b 2 a step; the arm 1 K1 and 1
             K2 a step; an adaptation 1 K1 and 5 K2; a decode batch 1 K1;
             K2b 0; K3/K3b 0 in the fused search); the reference's JSON
             layout, one printed line per weight, the ``--out`` file. The
             paired design on seed 0's adapted parameters and test split:
             the 0 column's hypotheses equal a decode with ``lm_ckpt``
             unset, the 0.3 column's scores differ from the 0 column's.
             Both of those decodes (one batch, weight 0.3 with and without
             the LM) under torch.profiler, each Chrome trace read by
             ``trace_summary.summarize``: the top rows, device-op ms and
             ops per batch, their ratios; K1's row present with a count of
             at least 1 and at most the wrapper's launches. Then
             ``matmul_roofline.main``: each of its seven rows in (0, 1.05 x
             989] TF/s. The phase's seconds beside its budget (100 s,
             printed, not gated).

25. resident_corpus — ``data.resident`` at config3 width and depth
             (``config3_train()`` through ``cli.make_trainer``, bf16
             meta-step, 4 x (4 + 4), 3 inner steps, caps 256,240 samples
             and 128 tokens) on an 8-accent corpus of 400 utterances each
             (2-4 words, ``tango`` held out: 2,800 training utterances),
             with 16-frame buckets 160 / 176 / 192 under config3's 256 (its
             own buckets put every draw of this corpus in one shape):
             ``auto`` under the 4 GB budget places the store, whose tensors
             hold exactly ``resident_store_bytes``' 2,871,344,000 bytes;
             steps 0-1's gathered batches equal ``to_device(sampler.sample(
             step))`` key for key (``torch.equal``, contiguous), in two
             bucket shapes; a 2-step resident ``meta_train`` and a 2-step
             ``resident: off`` one from the same seed each launch exactly
             16 K1 and 32 K2 (0 K2b), only the second opens a streaming
             feed, and their logged ``meta_loss`` agree within 1e-4
             relative; ``auto`` with ``resident_max_gb: 2`` builds no
             store, and the feed ``meta_train`` takes opens the streaming
             feed and gives the streaming batch. The two runs use
             deterministic algorithms: by default two runs of one feed
             part by up to 9.5e-4 at step 3. The corpus is written by a
             spawned process that starts before phase 1. Printed, not gated: the
             store's collate and copy seconds, ``memory_allocated`` with it
             and after it is freed, each feed's logged utts/s over its
             steady steps, the host-to-device copies (count, bytes) of
             each feed's next batch from the profiler's trace, the phase's
             seconds beside its budget (45 s). The phase frees its
             trainers and the store.
26. grain_loader — ``data.loader: grain`` at config1 width through
             ``make_trainer`` (2 workers, a checkpoint every 2 steps, 2
             kept, no evaluation) on 2 synthetic accents x 64 utterances:
             the first 6 batches of the 2-worker stream equal the 0-worker
             stream key for key, every batch [16, 256,240] samples and
             [16, 128] tokens; at the cap shapes, under strict fp32, K1 at
             [16, 256,240] (8 rows of 1,600 frames, 8 ragged; 80 bins) at
             phase 2's bars, K2 at [B, T, S] = [16, 400, 257] (the
             streamed layout) at phase 5's and K3/K3b at [400, 16, 320] at
             phase 8's, each timed beside its plain version and bound; a
             straight 4-step run and a 2 + 2 run resumed by a fresh trainer
             from its checkpoint and ``grain_state_2.bin`` give equal
             parameters (``torch.equal``, deterministic algorithms), the
             state files ``grain_state_{2,4}.bin`` exist, and each run
             launches exactly 1 K1, 1 K2, 8 K3 and 8 K3b a step. Printed,
             not gated: ms a step and utts/s at the caps beside phase 9's
             at 64,000 samples, the seconds each ``next`` of the stream
             blocks with 0 and 2 workers, peak memory, the phase's seconds
             beside its budget (25 s).
27. data_parallel — the task-axis data-parallel meta-step at config3
             width and depth through the CLI (``cli.main --mode train``
             on ``config3_train()`` recorded as a YAML file, 4 x (4 + 4),
             3 inner steps, bf16, SpecAugment on, the streaming feed) on 4
             synthetic accents x 16 utterances (``tango`` held out), 2
             steps a run under deterministic algorithms: (1)
             ``--mesh-tasks 1`` in a group of one over NCCL
             (``parallel.initialize(world_size=1, rank=0,
             backend="nccl")`` first, in this process) against no flag:
             equal parameters (``torch.equal``), equal logged
             ``meta_loss`` and ``grad_norm``, exactly 16 K1 and 32 K2 each
             and 2 gradient all-reduces; the one-process run is then
             resumed by 1 step in a second ``cli.main`` (8 K1, 16 K2);
             (2) ``--mesh-tasks 2`` on two gloo ranks on the one card,
             each a ``--dp-worker`` subprocess of this script running 2 of
             the 4 tasks, against the one-process run: step 1's
             ``meta_loss`` within 1e-6 and ``grad_norm`` within 1e-5
             relative, step 2's ``meta_loss`` within 1e-4, the ranks'
             parameters equal and within 1e-5 of one process's, exactly 8
             K1 and 16 K2 a rank; (3) a fresh gloo pair resumes rank 0's
             workdir by 1 step (no ``--config``: rank 0 reads the
             recorded one): each rank holds rank 0's step-2 checkpoint bit
             for bit right after its one ``broadcast_state``, step 3's
             ``meta_loss`` within 1e-4 of the resumed one process's, the
             ranks' parameters equal and within 1e-5 of its, exactly 4 K1
             and 8 K2 and 1 all-reduce a rank. Rank 1 has a workdir of its
             own in each pair, which it never creates; rank 0's holds
             ``config.yaml``, ``ckpts/`` and ``logs/``; no resident store.
             Both pairs start before phase 26, so that their start-up
             overlaps it, run one throwaway local meta-gradient (their
             first-call costs) and wait for their go. Printed, not gated:
             ms a step of each run from its logged rates, the
             all-reduce's bytes and ms (NCCL with one rank; gloo between
             the two), ``broadcast_state``'s bytes and ms (NCCL with one
             rank; each resumed gloo rank), peak memory a rank, each
             rank's stages in seconds from its go, the phase's seconds
             beside its budget (45 s).

Then a line of the held-out WERs of phases 13, 14 and 19 (random init: a
trend), a ``phase_seconds`` line with their sum, phase 21's B 16 decode
ms (the host's speed) and the target for such a host (950 s under a 3 s
decode, else 1,120 s; not gated), a ``{"kernels": [...]}`` line (time,
bound, launches on the main paths per kernel; K3/K3b also at the LM's
shape, all four also at the grain loader's caps) and the last line
``{"ok": true, "device": {...}}``.

Precision: the phases that time entry points run under the port's own
policy (``metaasr_tpu_torch/device.py``, printed on its own line); TF32 is
off only where the card is held against a plain version or the CPU
(phases 2, 4, 5, 8, 11, the small-model parity checks of phases 9 and
12, phase 18's kernels at the LM's shape, LM parity and cuda/cpu serving,
and phase 19's cuda/cpu serving), through ``strict_fp32``.

Five more modes, each needing one card (and ``--dp-worker RANK DIR
a|b``, phase 27's rank processes, which ``start_data_parallel`` starts):

    python3 chip_smoke.py --precision-ab    # phases 9, 10 under the policy,
                                            # then under strict fp32
    python3 chip_smoke.py --ctc-ab PARENT   # K2 / K2b event and device times
                                            # of PARENT's checkout and this
                                            # one: parent, this, this, parent
    python3 chip_smoke.py --fbank-ab PARENT # K1's, the same way, at phase
                                            # 2's three main shapes
    python3 chip_smoke.py --paths-ab PARENT # phases 3 and 6 (serving, the
                                            # FOMAML step) the same way
    python3 chip_smoke.py --phases-ab PARENT NAME,...
                                            # the named phases (``phase_``
                                            # NAME), each tree's own code,
                                            # the same way: their seconds
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"
SERVE_BUCKET = (16, 64000)
CHECK_LENS = [64000, 401, 63999, 560, 48000, 32001, 16000, 60160,
              400, 1234, 55555, 20000, 63840, 8000, 40400, 30000]
K1_TOL = 1e-4          # rtol = atol against the plain version: the bound
                       # tests/test_m3_pallas.py:21 holds the TPU kernel to
PARITY_TOL = 1e-4
NEG = -1.0e9
# (fp32 FLOP/s outside the tensor cores, HBM bytes/s), NVIDIA data sheets
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
         "H100 SXM": (67.0e12, 3.35e12)}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_median_ms(torch, fn, runs: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, runs: int = 30, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``runs`` calls captured in a CUDA
    graph and replayed between CUDA events, so neither the host's issue
    time nor the profiler enters; the median over ``replays``, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm-up off the capture, as it requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def device_ms_per_call(torch, fn, runs: int = 30) -> float:
    """Device time per call of ``fn``: the union of the CUDA kernel spans
    the profiler records over ``runs`` calls, over ``runs``."""
    fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(runs):
            fn()

    busy = device_busy(torch, many)[1]
    if busy is None:
        raise SystemExit("the profiler recorded no CUDA kernel")
    return busy / runs


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for cuBLAS and cuDNN inside, also for any device an entry
    point resolves there; the port's policy and the flags as they were
    after."""
    import torch

    from metaasr_tpu_torch import device

    before = (device.ALLOW_TF32, torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    device.ALLOW_TF32 = False
    device.apply_precision_policy()
    try:
        yield
    finally:
        device.ALLOW_TF32 = before[0]
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.backends.cudnn.allow_tf32 = before[2]


def precision_line(torch) -> dict:
    from metaasr_tpu_torch import device

    return {"precision": {
        "policy": ("tf32" if device.ALLOW_TF32 else "strict fp32")
        + " (metaasr_tpu_torch/device.py)",
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "strict_fp32_in": "phases 2, 4, 5, 8, 11; small-model parity of "
                          "phases 9 and 12; phase 18's K3/K3b at the LM's "
                          "shape, LM parity and cuda/cpu serving; phase "
                          "19's cuda/cpu serving"}}


def phase_build():
    from metaasr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    ptxas = [ln.strip() for out in logs.values() for ln in out.splitlines()
             if "registers" in ln or "bytes smem" in ln]
    lstm_ptxas = ptxas_report(logs.get("lstm", ""))
    log({"phase": "build", "sources": list(_build.SOURCES),
         "seconds": round(seconds, 3), "ptxas": ptxas,
         "lstm_kernels": lstm_ptxas})
    return smi, lstm_ptxas


def ptxas_report(out: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    ``-Xptxas -v`` output."""
    import re

    report, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)(?:ILi(\d+)EEv)?P", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            report[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            report[name].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def make_waves(rng, lens, width):
    audio = np.zeros((len(lens), width), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        f0 = 100.0 + 300.0 * rng.random()
        audio[i, :n] = (0.3 * np.sin(2 * np.pi * f0 * t)
                        + 0.1 * rng.standard_normal(n))
    return audio


K1_SHAPES = {             # name: (valid samples per utterance, width)
    "ragged_16x64000": (CHECK_LENS, 64000),     # the serving bucket, ragged
    "full_16x64000": ([64000] * 16, 64000),     # every frame valid
    "full_4x64000": ([64000] * 4, 64000),       # a meta-step task's batch
    "one_1x24000": ([24000], 24000),            # one served utterance
    "unaligned_3x63999": ([63999, 40001, 401], 63999),  # rows not 16-byte
}                                                       # aligned: cp.async
K1_MAIN = ("ragged_16x64000", "full_16x64000", "full_4x64000")
K1_MELS = (40, 80, 128)
K1_ORACLE_TOL = 1e-5     # max |diff| from the float64 oracle, every frame
# fp64 operations a valid frame costs K1 (csrc/fbank.cu): the front-end
# (mean 400, minus mean 400, preemphasis 800, window 400), the FFT's three
# passes (32 x 56, 32 x (7 x 6 + 56), 64 x (3 x 6 + 16)) and the real split
# with the power (256 x 16); fp32: 2 per mel weight, 2 per mel bin
K1_FP64_OPS = 2000 + 32 * 56 + 32 * 98 + 64 * 34 + 256 * 16
# fp64 FLOP/s on the tensor cores (DMMA), the card's highest fp64 rate,
# NVIDIA data sheets
FP64_PEAKS = {"H100 PCIe": 51.2e12, "H100 NVL": 60.0e12, "H100 SXM": 67.0e12}


def k1_inputs(torch, name):
    """(audio numpy, audio on the card, frame lengths on the card, valid
    sample counts) of a K1_SHAPES entry, from numpy seed = its index."""
    from metaasr_tpu_torch.frontend.fbank import frame_lengths

    lens, width = K1_SHAPES[name]
    audio_np = make_waves(np.random.default_rng(list(K1_SHAPES).index(name)),
                          lens, width)
    audio = torch.from_numpy(audio_np).to(DEVICE)
    flens = frame_lengths(torch.tensor(lens, dtype=torch.int32, device=DEVICE))
    return audio_np, audio, flens, lens


def k1_bound(audio, flens, params, part, peaks) -> dict:
    """K1's least time on these inputs: the samples its valid frames need
    read once, frame lengths and tables read once, the features written
    once, against the valid frames' operations; and, in brackets, the old
    bound of the matrix DFT (fp32 GEMM operations) on the same frames."""
    from metaasr_tpu_torch.frontend import fbank_kernel

    peak_flops, peak_bw = peaks
    bsz, width = audio.shape
    nf = max(0, 1 + (width - 400) // 160)
    n_mel = params.num_mel_bins
    fl = [min(int(f), nf) for f in flens.tolist()]
    bins = fbank_kernel.mel_ranges(params.mel_t)[0]
    nnz = int((bins[:, 1] - bins[:, 0]).sum())
    samples = sum((f - 1) * 160 + 400 for f in fl if f > 0)
    nbytes = (4 * samples + 4 * bsz + fbank_kernel.pack_tables(params).size
              + 4 * bsz * nf * n_mel)
    frames = sum(fl)
    t_ops = max(frames * K1_FP64_OPS / FP64_PEAKS[part],
                frames * (2 * nnz + 2 * n_mel) / peak_flops)
    t_bytes = nbytes / peak_bw
    gemm = frames * (2 * 400 * 256 * 2 + 2 * 256 * n_mel) / peak_flops
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "fp64_ops": frames * K1_FP64_OPS,
            "dft_gemm_bound_ms": 1e3 * max(gemm, t_bytes)}


def cufft_path(torch, audio, flens, params):
    """A reference point, not one library call: the front-end as tensor
    ops, ``torch.fft.rfft`` (cuFFT), the power, ``@ mel_t`` (cuBLAS) and
    the log, in fp32."""
    from metaasr_tpu_torch.frontend.oracle import EPS
    from metaasr_tpu_torch.utils.padding import make_non_pad_mask

    frames = audio.unfold(1, 400, 160)
    if params.remove_dc_offset:
        frames = frames - frames.mean(dim=2, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
    frames = (frames - params.preemphasis * prev) * torch.as_tensor(
        params.window, dtype=torch.float32, device=audio.device)
    spec = torch.fft.rfft(frames, n=512, dim=2)[..., :256]
    power = spec.real * spec.real + spec.imag * spec.imag
    mel_t = torch.as_tensor(params.mel_t, device=audio.device)
    feats = torch.log(torch.clamp_min(power @ mel_t, EPS))
    mask = make_non_pad_mask(flens, feats.shape[1])[..., None]
    return torch.where(mask, feats, 0.0)


def k1_check(torch, audio_np, audio, flens, lens, n_mel) -> tuple:
    """K1 against its plain version and the float64 oracle on one batch at
    ``n_mel`` bins -> (the check's readings, whether it meets phase 2's
    bars)."""
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import FbankParams, log_mel_fbank
    from metaasr_tpu_torch.frontend.oracle import fbank_oracle

    want_lens = [max(0, 1 + (n - 400) // 160) for n in lens]
    params = FbankParams.create(num_mel_bins=n_mel)
    mats = fbank_kernel._device_matrices(params, audio.device)
    got, got_lens = log_mel_fbank(audio, flens.new_tensor(lens), params,
                                  "none")
    plain = fbank_kernel.plain_log_mel(audio, flens, *mats)
    torch.cuda.synchronize()
    diff = (got - plain).abs()
    ratio = float((diff / (K1_TOL + K1_TOL * plain.abs())).max())
    # the fp32 FFT composite too: what fp32 costs at this bar
    others = {"plain": plain.cpu().numpy(),
              "cufft_path": cufft_path(torch, audio, flens,
                                       params).cpu().numpy()}
    k1_np = got.cpu().numpy()
    oracle_err = well_err = 0.0
    well_bins = 0
    other_err = dict.fromkeys(others, 0.0)
    padding_zero = True
    for i, n in enumerate(lens):
        ref = fbank_oracle(audio_np[i, :n], num_mel_bins=n_mel)
        f = len(ref)
        if f:
            oracle_err = max(oracle_err,
                             float(np.abs(k1_np[i, :f] - ref).max()))
            for k, v in others.items():
                other_err[k] = max(other_err[k], float(
                    np.abs(v[i, :f] - ref).max()))
            # the bins where the plain version itself is within K1_TOL of
            # the oracle: there K1 must be within K1_TOL of it
            well = np.abs(others["plain"][i, :f] - ref) <= K1_TOL
            well_bins += int(well.sum())
            if well.any():
                well_err = max(well_err, float(np.abs(
                    k1_np[i, :f] - others["plain"][i, :f])[well].max()))
        padding_zero = padding_zero and not k1_np[i, f:].any()
    check = {"max_abs_err": float(diff.max()), "tol_ratio": ratio,
             "max_abs_err_where_plain_within_tol": well_err,
             "bins_where_plain_within_tol": well_bins,
             "bins": sum(k1_np.shape[2] * int(1 + (n - 400) // 160)
                         for n in lens if n >= 400),
             "oracle_max_abs_err": oracle_err,
             "plain_oracle_max_abs_err": other_err["plain"],
             "cufft_path_oracle_max_abs_err": other_err["cufft_path"],
             "frame_lens_exact": got_lens.tolist() == want_lens,
             "padding_zero": padding_zero,
             "finite": bool(torch.isfinite(got).all())}
    ok = (well_err <= K1_TOL and ratio <= 1.0
          and oracle_err <= K1_ORACLE_TOL and check["frame_lens_exact"]
          and padding_zero and check["finite"])
    return check, ok


def phase_kernel(torch, peaks):
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import (
        FbankParams,
        apply_cmvn,
        log_mel_fbank,
    )

    part = card_peaks(torch.cuda.get_device_name(0))[0]
    res = {"phase": "kernel", "kernel": "fbank_log_mel",
           "tolerance": {"plain_where_plain_within_tol_of_oracle_max_abs":
                         K1_TOL, "plain": f"rtol = atol = {K1_TOL}",
                         "oracle_max_abs": K1_ORACLE_TOL},
           "checks": {}, "shapes": {}}
    ok = True
    for name in K1_SHAPES:
        audio_np, audio, flens, lens = k1_inputs(torch, name)
        for n_mel in K1_MELS:
            check, good = k1_check(torch, audio_np, audio, flens, lens, n_mel)
            res["checks"][f"{name}/{n_mel}"] = check
            ok = ok and good
    # CMVN after K1 at the serving bucket, against CMVN after the plain one
    params = FbankParams.create()
    mats = fbank_kernel._device_matrices(params, audio.device)
    _, audio, flens, lens = k1_inputs(torch, "ragged_16x64000")
    cmvn_ratio = {}
    for cmvn, nv in (("utterance", False), ("utterance", True)):
        got, _ = log_mel_fbank(audio, flens.new_tensor(lens), params, cmvn, nv)
        plain = apply_cmvn(fbank_kernel.plain_log_mel(audio, flens, *mats),
                           flens, nv)
        cmvn_ratio[f"{cmvn}{'+norm_var' if nv else ''}"] = float(
            ((got - plain).abs() / (K1_TOL + K1_TOL * plain.abs())).max())
    res["cmvn_tol_ratio"] = cmvn_ratio
    ok = ok and max(cmvn_ratio.values()) <= 1.0
    res["max_abs_err"] = max(c["max_abs_err"] for c in res["checks"].values())
    res["max_abs_err_where_plain_within_tol"] = max(
        c["max_abs_err_where_plain_within_tol"]
        for c in res["checks"].values())
    res["max_tol_ratio"] = max(c["tol_ratio"] for c in res["checks"].values())
    for key in ("oracle_max_abs_err", "plain_oracle_max_abs_err",
                "cufft_path_oracle_max_abs_err"):
        res[key] = max(c[key] for c in res["checks"].values())

    per_block = fbank_kernel._library()[0].metaasr_fbank_frames_per_block()
    for name in K1_MAIN:
        _, audio, flens, _ = k1_inputs(torch, name)
        mats = fbank_kernel._device_matrices(params, audio.device)
        k1 = lambda: fbank_kernel.fused_log_mel(  # noqa: E731
            audio, flens, params)
        ms = cuda_median_ms(torch, k1)
        device_ms = device_ms_per_call(torch, k1)
        nf = int(1 + (audio.shape[1] - 400) // 160)
        res["shapes"][name] = {
            "shape": list(audio.shape), "frames": audio.shape[0] * nf,
            "valid_frames": int(flens.sum()), "ms": ms,
            "device_ms": device_ms, "host_ms": ms - device_ms,
            "launch": {"frames_per_block": per_block,
                       "blocks": audio.shape[0] * -(-nf // per_block)},
            "plain_ms": cuda_median_ms(torch, lambda: fbank_kernel.plain_log_mel(
                audio, flens, *mats)),
            "cufft_path_ms": cuda_median_ms(
                torch, lambda: cufft_path(torch, audio, flens, params)),
            **k1_bound(audio, flens, params, part, peaks)}
    main = res["shapes"][K1_MAIN[0]]
    res.update({k: main[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                     "bound_ms", "bound_by")})
    log(res)
    if not ok:
        raise SystemExit("K1 disagrees with its plain version or the oracle")
    return res


def config3():
    from metaasr_tpu_torch.config import Config
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer

    # configs/config3_fomaml.yaml's model, decode and data settings
    cfg = Config()
    tok = CharTokenizer.ascii_default()
    m = cfg.model
    m.arch, m.d_model, m.num_heads, m.d_ff = "transformer", 256, 4, 2048
    m.num_encoder_layers, m.num_decoder_layers = 12, 6
    m.dtype, m.vocab_size = "bfloat16", tok.vocab_size
    cfg.data.vocab, cfg.data.max_tokens = "char", 128
    cfg.train.beam_size, cfg.train.decode_ctc_weight = 10, 0.3
    return cfg, tok


def seeded_bundle(cfg, tok, out_dir, buckets, seed, lm_params=None):
    """A bundle of ``cfg``'s model with weights from a numpy seed (and the
    Flax-layout LM ``lm_params``, fused when train.lm_weight is not 0) ->
    the model's Flax tree."""
    from metaasr_tpu_torch.serve.export import write_bundle
    from metaasr_tpu_torch.task import build_model
    from metaasr_tpu_torch.weights import random_state_dict, state_dict_to_flax

    sd = random_state_dict(build_model(cfg), seed)
    tree = state_dict_to_flax(sd, cfg.model.num_heads)
    write_bundle(out_dir, cfg, tree, tok, buckets, lm_params=lm_params)
    return tree


def check_results(results, n, tok):
    from metaasr_tpu_torch.data.tokenizer import PhoneTokenizer

    if len(results) != n:
        raise SystemExit(f"expected {n} results, got {len(results)}")
    symbols = set(tok.symbols)
    for r in results:
        units = (r["text"].split() if isinstance(tok, PhoneTokenizer)
                 else r["text"])
        if not (isinstance(r["text"], str) and set(units) <= symbols
                and math.isfinite(r["score"]) and r["score"] > NEG / 2):
            raise SystemExit(f"malformed result {r}")


def device_busy(torch, fn):
    """Run ``fn`` under torch.profiler; -> (host wall ms, device busy ms as
    the union of CUDA kernel spans, kernel count, top kernels by time,
    {kernel name: device ms}).
    Device numbers are None when the profiler records no CUDA events.

    Only device activity is traced, and the spans are read from the
    profiler's raw Kineto records: building ``prof.events()`` in Python
    takes tens of seconds for the ~100,000 kernels of one meta-step and
    yields the same spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    # kineto_results is not a public attribute: checked on PyTorch
    # 2.11.0+cu128; a version without it fails here with an AttributeError,
    # not silently. Busy shares are comparable only through this one reader.
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            t = s + e.duration_ns()
            spans.append((s, t))
            name = e.name()
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    if not spans:
        return wall, None, 0, [], {}
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (wall, busy / 1e6, len(spans), [[n[:60], ms] for n, ms in top],
            by_name)


def serving_waves():
    """Phase 3's 16 utterances of 24,000-64,000 samples."""
    bsz, width = SERVE_BUCKET
    rng = np.random.default_rng(1)
    full_lens = [width] + rng.integers(24000, width, bsz - 1).tolist()
    return [w[:n] for w, n in zip(make_waves(rng, full_lens, width),
                                  full_lens)]


def serve_requests(torch, dec, tok, params=None) -> dict:
    """Phase 3's four requests through ``dec`` (a full batch twice, the
    second timed, 5 utterances, one) and one more full batch under the
    profiler, the launch counts zeroed first -> readings."""
    waves = serving_waves()
    requests = [("full", waves), ("full", waves), ("five", waves[3:8]),
                ("one", waves[5:6])]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    timings = []
    for name, xs in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dec.transcribe(xs, params=params, nbest=2)
        torch.cuda.synchronize()
        timings.append((name, 1e3 * (time.perf_counter() - t0), res))
    # one more full batch under the profiler: how busy is the device?
    prof = device_busy(torch, lambda: dec.transcribe(waves, params=params,
                                                     nbest=2))
    counts = all_counts()
    for (name, _, res), (_, xs) in zip(timings, requests):
        check_results(res, len(xs), tok)
    full_ms = timings[1][1]
    return {"requests": [{"name": n, "utts": len(r), "ms": ms,
                          "max_hyp_chars": max(len(x["text"]) for x in r)}
                         for n, ms, r in timings],
            "ms_per_batch_full": full_ms,
            "utts_per_s_full": SERVE_BUCKET[0] / (full_ms / 1e3),
            "k1_launches": counts["k1"], "launches": counts,
            "profiled_full": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                              "cuda_kernels": prof[2],
                              "top_kernels_ms": prof[3]},
            "device_busy_share_of_timed_full": (
                None if prof[1] is None else prof[1] / full_ms),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample": timings[1][2][0]}


def phase_serving(torch):
    from metaasr_tpu_torch.serve.export import ServingDecoder

    cfg, tok = config3()
    with tempfile.TemporaryDirectory() as d:
        seeded_bundle(cfg, tok, d, [SERVE_BUCKET], seed=0)
        dec = ServingDecoder(d, cfg, device="cuda")
    out = {"phase": "serving", "bucket": list(SERVE_BUCKET),
           "model": {"d_model": 256, "heads": 4, "d_ff": 2048,
                     "layers": [12, 6], "vocab": tok.vocab_size,
                     "dtype": "bfloat16"},
           "beam": {"beam_size": 10, "ctc_weight": 0.3, "max_len": 128},
           **serve_requests(torch, dec, tok)}
    log(out)
    if out["k1_launches"] != 5:
        raise SystemExit(f"K1 launched {out['k1_launches']} times for 5 "
                         "requests")
    return out


def phase_parity(torch):
    from metaasr_tpu_torch.config import Config
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.serve.export import ServingDecoder

    cfg = Config()
    tok = CharTokenizer.ascii_default()
    m = cfg.model
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype, m.vocab_size = "float32", tok.vocab_size
    cfg.data.max_tokens, cfg.train.beam_size = 8, 3
    lens = [16000, 9000, 401, 12345]
    rng = np.random.default_rng(2)
    waves = [w[:n] for w, n in zip(make_waves(rng, lens, 16000), lens)]
    with tempfile.TemporaryDirectory() as d:
        seeded_bundle(cfg, tok, d, [(4, 16000)], seed=1)
        on_gpu = ServingDecoder(d, cfg, device="cuda")
        on_cpu = ServingDecoder(d, cfg, device="cpu")
    before = fused_log_mel.launches
    got = on_gpu.transcribe(waves, nbest=3)
    want = on_cpu.transcribe(waves, nbest=3)
    same_text = all(
        g["text"] == w["text"]
        and [x["hyp"] for x in g["nbest"]] == [x["hyp"] for x in w["nbest"]]
        for g, w in zip(got, want))
    score_err = max(abs(a["score"] - b["score"])
                    for g, w in zip(got, want)
                    for a, b in zip(g["nbest"], w["nbest"]))
    out = {"phase": "parity", "same_text": same_text,
           "max_score_diff": score_err, "tolerance": PARITY_TOL,
           "k1_launches": fused_log_mel.launches - before,
           "texts": [g["text"] for g in got]}
    log(out)
    if not same_text or not score_err <= PARITY_TOL:
        raise SystemExit("cuda and cpu serving disagree")
    return out


# ---------------------------------------------------------------- K2 ----

# edge_48k first: the run's first K2 launch, at a dynamic shared memory
# (49,140 B) under 48 KB that needs the opt-in with the static edge states
CTC_SHAPES = {"edge_48k": (4, 63, 32, 30),
              "fused": (16, 99, 32, 30), "per_task": (4, 99, 32, 30),
              "odd": (3, 50, 7, 12), "long_t": (8, 1000, 20, 30),
              "wide_s": (4, 99, 60, 30),     # S = 121: K2b's histories spill
              "max_s": (2, 1100, 511, 30)}   # S = 1,023: four warps a pass
CTC_LOSS_TOL = 1e-5      # atol = rtol, tests/test_m3_pallas.py:45
CTC_GRAD_L2REL = 1.9e-3  # docs/KERNEL_CHECK_TPU.md, T=1000 on the TPU


def ctc_inputs(torch, shape, seed):
    """log-probs [B, T, V] and ragged lens/labels on the card; row 1 has an
    empty label, the last row is infeasible (T too short for its labels)."""
    bsz, t_len, u_len, vocab = shape
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((bsz, t_len, vocab)).astype(np.float32)
    t_lens = rng.integers(min(max(2 * u_len + 1, t_len // 2), t_len),
                          t_len + 1, bsz)
    t_lens[0] = t_len
    labels = rng.integers(1, vocab, (bsz, u_len))
    u_lens = rng.integers(1, u_len + 1, bsz)
    u_lens[0] = u_len
    u_lens[1] = 0
    t_lens[-1], u_lens[-1] = max(1, u_len // 2), u_len
    lp = torch.log_softmax(torch.from_numpy(logits).to(DEVICE), -1)
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(DEVICE)  # noqa: E731
    return lp, as_i32(t_lens), as_i32(labels), as_i32(u_lens)


def chain_times(torch, event_ms, t_lens, fn) -> dict:
    """Device ms per launch (profiler spans over 30 launches), the wrapper's
    host ms (the CUDA-event time less the device time), the dependent steps
    of the longest row and device µs per step."""
    device_ms = device_ms_per_call(torch, fn)
    steps = int(t_lens.max())
    return {"device_ms": device_ms, "host_ms": event_ms - device_ms,
            "dependent_steps": steps,
            "us_per_dependent_step": 1e3 * device_ms / steps}


def ctc_check(torch, shape, seed) -> tuple:
    """K2 against its plain version on ``ctc_inputs(shape, seed)`` -> (the
    readings, whether they meet phase 5's bars, the kernel's inputs)."""
    from metaasr_tpu_torch.ops import ctc as ctc_ops
    from metaasr_tpu_torch.ops import ctc_kernel

    lp, t_lens, labels, u_lens = ctc_inputs(torch, shape, seed)
    z = ctc_ops.extend_labels(labels)
    logp_z = ctc_ops.gather_emissions(lp, z).contiguous()
    skip = ctc_ops.skip_bias(z).contiguous()
    end = (2 * u_lens).contiguous()
    nll, grad = ctc_kernel.ctc_alpha_beta(logp_z, skip, t_lens, end)
    p_nll, p_grad = ctc_kernel.plain_ctc_alpha_beta(logp_z, skip, t_lens, end)
    torch.cuda.synchronize()
    loss_abs = float((nll - p_nll).abs().max())
    loss_ok = bool(((nll - p_nll).abs()
                    <= CTC_LOSS_TOL * (1 + p_nll.abs())).all())
    l2rel = float(torch.linalg.norm(grad - p_grad) / torch.linalg.norm(p_grad))
    # the loss with autograd: the infeasible row is zeroed, gradient too
    x = lp.detach().clone().requires_grad_(True)
    loss = ctc_kernel.ctc_loss_kernel(x, t_lens, labels, u_lens)
    loss.sum().backward()
    infeasible_zero = (float(loss.detach()[-1]) == 0.0
                       and float(x.grad[-1].abs().max()) == 0.0)
    finite = bool(torch.isfinite(loss).all() and torch.isfinite(x.grad).all())
    entry = {"shape_btuv": list(shape), "loss_max_abs_diff": loss_abs,
             "loss_ok": loss_ok, "grad_l2rel": l2rel,
             "grad_max_abs_diff": float((grad - p_grad).abs().max()),
             "bit_equal": bool(torch.equal(nll, p_nll)
                               and torch.equal(grad, p_grad)),
             "infeasible_row_zero": infeasible_zero, "finite": finite,
             "plan": ctc_kernel.launch_plan(logp_z)}
    ok = loss_ok and l2rel <= CTC_GRAD_L2REL and infeasible_zero and finite
    return entry, ok, (lp, t_lens, labels, u_lens, logp_z, skip, end)


def ctc_kernel_times(torch, shape, inputs, peaks, runs=30, plain_runs=10,
                     device_times=True) -> dict:
    """CUDA-event medians of K2, its plain version and F.ctc_loss forward +
    backward on ``ctc_check``'s inputs, K2's bound and, with
    ``device_times``, its device and host time from the profiler (late in
    the whole run the profiler has recorded no kernel at all)."""
    import torch.nn.functional as F

    from metaasr_tpu_torch.ops import ctc_kernel

    lp, t_lens, labels, u_lens, logp_z, skip, end = inputs
    peak_flops, peak_bw = peaks
    bsz, t_len, _, _ = shape
    s_len = logp_z.shape[2]
    out = {"ms": cuda_median_ms(torch, lambda: ctc_kernel.ctc_alpha_beta(
        logp_z, skip, t_lens, end), runs=runs)}
    out["plain_ms"] = cuda_median_ms(
        torch, lambda: ctc_kernel.plain_ctc_alpha_beta(
            logp_z, skip, t_lens, end), runs=plain_runs, warmup=2)
    lp_tbv = lp.transpose(0, 1).contiguous()

    def library():
        y = lp_tbv.detach().requires_grad_(True)
        F.ctc_loss(y, labels, t_lens, u_lens, blank=0,
                   reduction="none", zero_infinity=True).sum().backward()

    out["library_ms"] = cuda_median_ms(torch, library, runs=runs)
    elems = bsz * t_len * s_len
    ops = 16 * elems           # 10 flops + 6 transcendentals
    nbytes = 4 * (2 * elems + bsz * s_len + 3 * bsz)
    t_ops, t_bytes = ops / peak_flops, nbytes / peak_bw
    out.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if device_times:
        out.update(chain_times(torch, out["ms"], t_lens, lambda: (
            ctc_kernel.ctc_alpha_beta(logp_z, skip, t_lens, end))))
    else:
        out["dependent_steps"] = int(t_lens.max())
        out["event_us_per_dependent_step"] = \
            1e3 * out["ms"] / out["dependent_steps"]
    return out


def phase_ctc_kernel(torch, peaks):
    res = {"phase": "ctc_kernel", "loss_tol": "atol=rtol=1e-5",
           "grad_l2rel_tol": CTC_GRAD_L2REL, "shapes": {}}
    ok = True
    for i, (name, shape) in enumerate(CTC_SHAPES.items()):
        entry, good, inputs = ctc_check(torch, shape, seed=10 + i)
        ok = ok and good
        if name in ("per_task", "fused"):
            entry.update(ctc_kernel_times(torch, shape, inputs, peaks))
        res["shapes"][name] = entry
    log(res)
    if not ok:
        raise SystemExit("K2 disagrees with its plain version")
    return res


# ------------------------------------------------------ training path ----

META_SHAPES = ((4, 4), (4, 16))   # (tasks, shots): bench.py's 4x4, 4x16


def config3_train():
    """configs/config3_fomaml.yaml at full width (its model, meta and
    optimizer sections), char vocab."""
    cfg, tok = config3()
    cfg.specaug.enabled = True
    m = cfg.meta
    m.algo, m.grad_dtype, m.inner_lr, m.inner_steps = \
        "fomaml", "bfloat16", 0.01, 3
    m.k_support = m.k_query = m.tasks_per_batch = 4
    m.adapt_steps = 5
    o = cfg.optimizer
    o.name, o.lr, o.schedule, o.warmup_steps = "adam", 0.5, "noam", 2000
    return cfg, tok


def bench_meta_batch(torch, m_tasks, k_shot, vocab):
    """bench.py's workload: audio 0.1 N(0,1) of 64,000 samples, 32 tokens,
    numpy seed 0."""
    rng = np.random.default_rng(0)

    def part():
        return {"audio": (0.1 * rng.standard_normal(
                    (m_tasks, k_shot, 64000))).astype(np.float32),
                "audio_lens": np.full((m_tasks, k_shot), 64000, np.int32),
                "tokens": rng.integers(1, vocab - 1, (m_tasks, k_shot, 32)
                                       ).astype(np.int32),
                "token_lens": np.full((m_tasks, k_shot), 32, np.int32)}

    return {s: {k: torch.from_numpy(v).to(DEVICE) for k, v in part().items()}
            for s in ("support", "query")}


def phase_meta_step(torch):
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.meta.maml import fold_in, maml_grads
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import algo_config
    from metaasr_tpu_torch.train.optimizer import apply_updates, make_optimizer

    cfg, tok = config3_train()
    task = ASRTask(cfg, tok.sos_eos_id, device=DEVICE)
    grad_fn = maml_grads(task.loss_fn, algo_config(cfg), task.preprocess)
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    inner = cfg.meta.inner_steps
    out = {"phase": "meta_step", "inner_steps": inner,
           "grad_dtype": cfg.meta.grad_dtype, "specaug": True,
           "optimizer": "adam, noam lr 0.5 warmup 2000, clip 5.0",
           "cells": []}
    warmup, timed = 1, 5
    for m_tasks, k_shot in META_SHAPES:
        st = {"params": task.init_params(0)}
        st["opt"] = opt.init(st["params"])
        mb = bench_meta_batch(torch, m_tasks, k_shot, tok.vocab_size)
        losses = []

        def one_step(i):
            grads, metrics = grad_fn(st["params"], mb, fold_in(0, i))
            updates, st["opt"] = opt.update(grads, st["opt"], st["params"])
            st["params"] = apply_updates(st["params"], updates)
            losses.append(metrics["meta_loss"])

        fused_log_mel.launches = 0
        ctc_alpha_beta.launches = 0
        for i in range(warmup):
            one_step(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup, warmup + timed):
            t0 = time.perf_counter()
            one_step(i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        prof = device_busy(torch, lambda: one_step(warmup + timed))
        k1, k2 = fused_log_mel.launches, ctc_alpha_beta.launches
        steps = warmup + timed + 1
        want_k1, want_k2 = steps * 2 * m_tasks, steps * m_tasks * (inner + 1)
        ms = statistics.median(times)
        loss_vals = [float(x) for x in losses]
        cell = {"tasks": m_tasks, "shots": k_shot, "steps": steps,
                "ms_per_step": ms, "ms_per_step_all": times,
                "unique_utts_per_s": m_tasks * 2 * k_shot / (ms / 1e3),
                "presentations_per_s":
                    m_tasks * (k_shot * inner + k_shot) / (ms / 1e3),
                "peak_mem_gb": peak / 1e9,
                "profiled_step": {"wall_ms": prof[0],
                                  "device_busy_ms": prof[1],
                                  "cuda_kernels": prof[2],
                                  "top_kernels_ms": prof[3]},
                "device_busy_share": (None if prof[1] is None
                                      else prof[1] / ms),
                "k1_launches": k1, "k1_expected": want_k1,
                "k2_launches": k2, "k2_expected": want_k2,
                "meta_loss": loss_vals}
        out["cells"].append(cell)
        if not all(math.isfinite(v) for v in loss_vals):
            log(out)
            raise SystemExit("non-finite meta loss")
        if (k1, k2) != (want_k1, want_k2):
            log(out)
            raise SystemExit(f"launch counts K1 {k1} (want {want_k1}), "
                             f"K2 {k2} (want {want_k2})")
        del st, mb
        torch.cuda.empty_cache()
    log(out)
    return out


def phase_train_entry(torch):
    """meta-train -> checkpoint -> adapt -> serve, through the entry points
    a user calls, on a synthetic 8-accent corpus at config3 width."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.data.audio_io import load_wav
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta
    from metaasr_tpu_torch.serve.export import (
        ServingDecoder,
        load_bundle_params,
        write_bundle,
    )
    from metaasr_tpu_torch.train.checkpoint import save_params_npz
    from metaasr_tpu_torch.weights import params_to_flax

    cfg, tok = config3_train()
    steps = 2
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        generate_dataset(data, utts_per_accent=8, words_per_utt=(2, 4),
                         seed=0)
        gen_s = time.perf_counter() - t0
        cfg.data.data_dir = data
        cfg.data.heldout_accents = ("tango",)
        cfg.train.log_every = 1
        cfg.train.ckpt_every = 1
        cfg.train.keep_ckpts = 2
        fused_log_mel.launches = 0
        ctc_alpha_beta.launches = 0
        t0 = time.perf_counter()
        trainer, tok = make_trainer(cfg, os.path.join(d, "wd"), DEVICE)
        state = trainer.meta_train(max_steps=steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(os.path.join(d, "wd", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ckpts = trainer.ckpt.all_steps()
        restored, at = trainer.ckpt.restore(map_location=DEVICE)
        restored_equal = at == steps and all(
            torch.equal(restored["params"][k], v)
            for k, v in state["params"].items())
        adapted, test_idx = trainer.meta_adapt(
            state["params"], trainer.heldout_datasets["tango"], seed=0)
        npz = os.path.join(d, "adapted.npz")
        save_params_npz(npz, adapted, cfg.model.num_heads)
        bundle = os.path.join(d, "bundle")
        write_bundle(bundle, cfg, params_to_flax(state["params"], 4), tok,
                     [(4, 96000)])
        dec = ServingDecoder(bundle, cfg, device=DEVICE)
        ds = trainer.heldout_datasets["tango"]
        wav = load_wav(os.path.join(ds.manifest.root,
                                    ds.manifest.utts[test_idx[0]].wav))
        served = dec.transcribe([wav], params=load_bundle_params(npz))
        torch.cuda.synchronize()
        k1, k2 = fused_log_mel.launches, ctc_alpha_beta.launches
    m = cfg.meta
    want_k1 = steps * 2 * m.tasks_per_batch + 1 + 1   # + adapt + serve
    want_k2 = steps * m.tasks_per_batch * (m.inner_steps + 1) + m.adapt_steps
    out = {"phase": "train_entry", "accents": 8, "heldout": "tango",
           "corpus_s": gen_s, "meta_train_s": train_s, "steps": state["step"],
           "meta_loss": [r["meta_loss"] for r in recs],
           "utts_per_sec_logged": [r["utts_per_sec"] for r in recs],
           "ckpt_steps": ckpts, "restored_equal": restored_equal,
           "adapted_leaves": len(adapted), "served": served[0],
           "k1_launches": k1, "k1_expected": want_k1,
           "k2_launches": k2, "k2_expected": want_k2}
    log(out)
    if not (state["step"] == steps and ckpts == [1, 2] and restored_equal
            and all(math.isfinite(r["meta_loss"]) for r in recs)):
        raise SystemExit("meta-train / checkpoint round trip failed")
    check_results(served, 1, tok)
    if (k1, k2) != (want_k1, want_k2):
        raise SystemExit(f"train entry launch counts K1 {k1} (want "
                         f"{want_k1}), K2 {k2} (want {want_k2})")
    return out


# ------------------------------------------------------------ K3 / K3b ----

LSTM_SHAPES = {"config1": (99, 16, 320), "chip_check": (64, 8, 128),
               "unaligned": (37, 5, 96), "long_t": (400, 4, 320),
               "reference_h": (20, 3, 24),     # tests/test_m3_pallas.py's H
               "streamed": (20, 4, 640),       # U's slice exceeds a CTA
               "widest": (3, 5, 5280),         # 16 rounds of pairs, streamed
               "fusion_lm": (65, 64, 192)}     # fusion_eval's LM, batch 64
LSTM_TILES = (4, 8, 16)  # the batch tiles swept at the config1 shape
LSTM_DU_SPLITS = (1, 2, 4, 8)  # the dU product's k splits, swept there too
LSTM_FWD_TOL = 1e-5      # max |diff| of h_seq
LSTM_GRAD_L2REL = 1e-3   # scripts/kernel_check.py's bar for the TPU kernel


def lstm_inputs(torch, shape, seed):
    """gx ~ N(0, 1), u with orthonormal rows (the model's init; above H =
    1,024, where the QR would take the host long, N(0, 1 / 4H): rows of
    norm ~1 as well), and a cotangent for h_seq, all on the card."""
    t_len, bsz, hidden = shape
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((t_len, bsz, 4 * hidden)).astype(np.float32)
    if hidden <= 1024:
        q, _ = np.linalg.qr(rng.standard_normal((4 * hidden, hidden)))
        u = q.T
    else:
        u = rng.standard_normal((hidden, 4 * hidden), dtype=np.float32)
        u *= np.float32(0.5 / np.sqrt(hidden))
    dout = rng.standard_normal((t_len, bsz, hidden)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    return to(gx), to(u), to(dout)


def l2rel(torch, a, b) -> float:
    return float(torch.linalg.norm(a - b)
                 / torch.linalg.norm(b).clamp_min(1e-30))


def lstm_bounds(shape, peaks) -> dict:
    """K3's and K3b's least time at [T, B, H]. Forward: the reference's
    operation count (lstm_pallas.py:155) and every array once, the gates
    written; backward from the saved gates: dgates @ U^T and h_prev^T @
    dgates, 2 products of 2*T*B*H*4H (the reference's 6 counts the
    recompute)."""
    t_len, bsz, hidden = shape
    cell = t_len * bsz * hidden
    out = {}
    for tag, flops, floats in (
            ("fwd", 2 * cell * 4 * hidden,
             cell * (4 + 2 + 4) + 4 * hidden * hidden),
            ("bwd", 4 * cell * 4 * hidden,
             cell * (4 + 3 + 4) + 2 * 4 * hidden * hidden)):
        t_ops, t_bytes = flops / peaks[0], 4 * floats / peaks[1]
        out[f"{tag}_gflop"] = flops / 1e9
        out[f"{tag}_bound_ms"] = 1e3 * max(t_ops, t_bytes)
        out[f"{tag}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def lstm_yardstick(torch, d_in, u, dout, seed) -> dict:
    """One LSTM layer, input d_in -> hidden, over dout's [T, B]: K3 +
    F.linear against torch.nn.LSTM (cuDNN, +1 folded into the forget
    bias), the largest |difference| of h and CUDA-event medians of the
    forward, forward + backward and the backward alone of each."""
    import torch.nn.functional as F

    from metaasr_tpu_torch.ops import lstm_kernel as lk

    t_len, bsz, hidden = dout.shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (t_len, bsz, d_in)).astype(np.float32)).to(DEVICE)
    w = torch.from_numpy((rng.standard_normal((4 * hidden, d_in))
                          / np.sqrt(d_in)).astype(np.float32)).to(DEVICE)
    b = torch.from_numpy((0.02 * rng.standard_normal(
        4 * hidden)).astype(np.float32)).to(DEVICE)
    u = u.clone()
    lib = torch.nn.LSTM(d_in, hidden).to(DEVICE)
    forget = torch.zeros(4 * hidden, device=DEVICE)
    forget[hidden: 2 * hidden] = 1.0
    with torch.no_grad():
        lib.weight_ih_l0.copy_(w)
        lib.weight_hh_l0.copy_(u.t())
        lib.bias_ih_l0.copy_(b + forget)
        lib.bias_hh_l0.zero_()
    params = [w, b, u]

    def ours(train):
        for p in params:
            p.requires_grad_(train)
            p.grad = None
        out = lk.lstm_recurrence(F.linear(x, w, b), u)
        if train:
            (out * dout).sum().backward()
        return out

    def library(train):
        for p in lib.parameters():
            p.requires_grad_(train)
            p.grad = None
        out, _ = lib(x)
        if train:
            (out * dout).sum().backward()
        return out

    with torch.no_grad():
        diff = float((ours(False) - library(False)).abs().max())
    out = {"max_abs_diff_to_kernel_layer": diff,
           "nn_lstm_fwd_ms": cuda_median_ms(torch, lambda: library(False)),
           "nn_lstm_fwd_bwd_ms": cuda_median_ms(torch, lambda: library(True)),
           "kernel_layer_fwd_ms": cuda_median_ms(torch, lambda: ours(False)),
           "kernel_layer_fwd_bwd_ms": cuda_median_ms(torch,
                                                     lambda: ours(True))}
    # the backward alone (K3b + the projection's backward against cuDNN's)
    out["nn_lstm_bwd_ms"] = out["nn_lstm_fwd_bwd_ms"] - out["nn_lstm_fwd_ms"]
    out["kernel_layer_bwd_ms"] = (out["kernel_layer_fwd_bwd_ms"]
                                  - out["kernel_layer_fwd_ms"])
    return out


def lstm_check(torch, shape, seed) -> tuple:
    """K3 and K3b against their plain versions on ``lstm_inputs(shape,
    seed)``, the backward through the autograd Function -> (the readings,
    whether they meet phase 8's bars, the tensors ``lstm_times`` takes)."""
    from metaasr_tpu_torch.ops import lstm_kernel as lk

    _, bsz, hidden = shape
    gx, u, dout = lstm_inputs(torch, shape, seed)
    gx_g = gx.clone().requires_grad_(True)
    u_g = u.clone().requires_grad_(True)
    before = (lk.lstm_recurrence.launches, lk.lstm_recurrence.bwd_launches)
    h = lk.lstm_recurrence(gx_g, u_g)          # the autograd Function
    (h * dout).sum().backward()
    torch.cuda.synchronize()
    counted = (lk.lstm_recurrence.launches - before[0],
               lk.lstm_recurrence.bwd_launches - before[1])
    h_seq, c_seq, gates = lk.lstm_forward(gx, u)
    p_h, p_c, p_g = lk.plain_lstm_forward(gx, u)
    p_dgx, p_du = lk.plain_lstm_backward(p_g, u, p_h, p_c, dout)
    entry = {"shape_tbh": list(shape),
             "plan": lk.plan(bsz, hidden, gx.device),
             "fwd_max_abs_diff": float((h.detach() - p_h).abs().max()),
             "gates_max_abs_diff": float((gates - p_g).abs().max()),
             "c_max_abs_diff": float((c_seq - p_c).abs().max()),
             "dgx_l2rel": l2rel(torch, gx_g.grad, p_dgx),
             "du_l2rel": l2rel(torch, u_g.grad, p_du),
             "dgx_max_abs_diff": float((gx_g.grad - p_dgx).abs().max()),
             "du_max_abs_diff": float((u_g.grad - p_du).abs().max()),
             "launches_counted": list(counted)}
    ok = (entry["fwd_max_abs_diff"] <= LSTM_FWD_TOL
          and entry["gates_max_abs_diff"] <= LSTM_FWD_TOL
          and entry["dgx_l2rel"] <= LSTM_GRAD_L2REL
          and entry["du_l2rel"] <= LSTM_GRAD_L2REL and counted == (1, 1))
    return entry, ok, (gx, u, dout, h_seq, c_seq, gates, p_h, p_c, p_g)


def lstm_times(torch, shape, tensors, peaks, runs=30, plain_runs=10) -> dict:
    """CUDA-event medians of K3 (with and without the gates), K3b (whole,
    its recurrence and its dU product) and their plain versions on
    ``lstm_check``'s tensors, with the bounds and µs per dependent step."""
    from metaasr_tpu_torch.ops import lstm_kernel as lk

    t_len, bsz, hidden = shape
    gx, u, dout, h_seq, c_seq, gates, p_h, p_c, p_g = tensors
    p = lk.plan(bsz, hidden, gx.device)
    dgx, du = torch.empty_like(gx), torch.empty_like(u)
    ms = functools.partial(cuda_median_ms, torch, runs=runs)
    out = {"fwd_ms": ms(lambda: lk.lstm_forward(gx, u)),
           "fwd_no_gates_ms": ms(lambda: lk.lstm_forward(gx, u, gates=False)),
           "bwd_ms": ms(lambda: lk.lstm_backward(gates, u, h_seq, c_seq,
                                                 dout)),
           "bptt_ms": ms(lambda: lk._launch_bptt(gates, u, c_seq, dout, dgx,
                                                 p)),
           "du_ms": ms(lambda: lk._launch_du(h_seq, dgx, du)),
           "du_splits": lk.du_splits(t_len, bsz, hidden, gx.device),
           "plain_fwd_ms": cuda_median_ms(
               torch, lambda: lk.plain_lstm_forward(gx, u), runs=plain_runs,
               warmup=2),
           "plain_bwd_ms": cuda_median_ms(
               torch, lambda: lk.plain_lstm_backward(p_g, u, p_h, p_c, dout),
               runs=plain_runs, warmup=2)}
    out.update(lstm_bounds(shape, peaks))
    out["fwd_us_per_dependent_step"] = 1e3 * out["fwd_ms"] / t_len
    out["bptt_us_per_dependent_step"] = 1e3 * out["bptt_ms"] / t_len
    out["dependent_steps"] = t_len
    return out


def phase_lstm_kernel(torch, peaks, ptxas):
    from metaasr_tpu_torch.ops import lstm_kernel as lk

    res = {"phase": "lstm_kernel", "fwd_tol": LSTM_FWD_TOL,
           "grad_l2rel_tol": LSTM_GRAD_L2REL, "ptxas": ptxas, "shapes": {}}
    ok = True
    for i, (name, shape) in enumerate(LSTM_SHAPES.items()):
        entry, good, tensors = lstm_check(torch, shape, seed=20 + i)
        ok = ok and good
        if name in ("config1", "long_t"):
            entry.update(lstm_times(torch, shape, tensors, peaks))
        res["shapes"][name] = entry

    # the batch tile, from measurement: K3 and K3b's recurrence at each
    t_len, bsz, hidden = LSTM_SHAPES["config1"]
    gx, u, dout = lstm_inputs(torch, LSTM_SHAPES["config1"], seed=20)
    h_seq, c_seq, gates, dgx = (torch.empty_like(x) for x in (
        dout, dout, gx, gx))
    res["tile_sweep"] = []
    for tile in LSTM_TILES:
        p = lk.plan(bsz, hidden, gx.device, tile)
        res["tile_sweep"].append({
            "tile": tile, "clusters": -(-bsz // tile), "cluster": p["cluster"],
            "fwd_ms": cuda_median_ms(torch, lambda: lk._launch_forward(
                gx, u, h_seq, c_seq, gates, p)),
            "bptt_ms": cuda_median_ms(torch, lambda: lk._launch_bptt(
                gates, u, c_seq, dout, dgx, p))})
    # and the dU product's k splits (a cluster of that many CTAs per tile)
    du = torch.empty_like(u)
    res["du_split_sweep"] = [
        {"splits": n, "du_ms": cuda_median_ms(
            torch, lambda: lk._launch_du(h_seq, dgx, du, n))}
        for n in LSTM_DU_SPLITS]

    # the library yardstick: one BLSTM direction of config1's layers 2-4,
    # [99, 16, 640 -> 320]; nn.LSTM (cuDNN) includes the input projection
    t_len, bsz, hidden = LSTM_SHAPES["config1"]
    _, u, dout = lstm_inputs(torch, LSTM_SHAPES["config1"], seed=31)
    res["library_yardstick"] = {
        "what": "torch.nn.LSTM (cuDNN), +1 folded into the forget bias; "
                "includes the input projection x @ W + b",
        "shape": [t_len, bsz, 2 * hidden, hidden],
        **lstm_yardstick(torch, 2 * hidden, u, dout, seed=30)}
    yard_diff = res["library_yardstick"]["max_abs_diff_to_kernel_layer"]
    log(res)
    if not ok:
        raise SystemExit("K3/K3b disagree with their plain versions")
    if not yard_diff <= 1e-4:
        raise SystemExit("the kernel layer disagrees with torch.nn.LSTM")
    return res


# -------------------------------------------------- the baseline path ----

def config1():
    """configs/config1_mono_vgg_ctc.yaml at full width: VGG 64/128, 4 x
    BLSTM 320, fp32, phone vocabulary, Adadelta lr 1.0, batch 16, algo no
    (SpecAugment on, as the config leaves the default)."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.arch, m.blstm_hidden, m.blstm_layers = "vgg_blstm", 320, 4
    m.vgg_channels, m.dtype = (64, 128), "float32"
    cfg.meta.algo = "no"
    cfg.data.vocab, cfg.data.batch_size = "phone", 16
    o = cfg.optimizer
    o.name, o.lr, o.schedule = "adadelta", 1.0, "constant"
    return cfg


def lstm_counts():
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta
    from metaasr_tpu_torch.ops.lstm_kernel import lstm_recurrence

    return {"k1": fused_log_mel.launches, "k2": ctc_alpha_beta.launches,
            "k3": lstm_recurrence.launches,
            "k3b": lstm_recurrence.bwd_launches}


def all_counts():
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_hvp

    return {**lstm_counts(), "k2b": ctc_hvp.launches}


def zero_counts():
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta, ctc_hvp
    from metaasr_tpu_torch.ops.lstm_kernel import lstm_recurrence

    fused_log_mel.launches = ctc_alpha_beta.launches = ctc_hvp.launches = 0
    lstm_recurrence.launches = lstm_recurrence.bwd_launches = 0


def small_model_parity(torch):
    """A small VGG-BLSTM's loss and gradients on cuda against the cpu (the
    kernels against the plain versions, through the whole loss)."""
    from metaasr_tpu_torch.task import ASRTask

    cfg = config1()
    m = cfg.model
    m.blstm_hidden, m.blstm_layers, m.vgg_channels = 32, 2, (8, 16)
    m.vocab_size = 12
    cfg.specaug.enabled = False
    rng = np.random.default_rng(40)
    lens = np.array([16000, 11000, 6000, 16000], np.int32)
    batch = {"audio": make_waves(rng, lens, 16000), "audio_lens": lens,
             "tokens": rng.integers(1, 11, (4, 6)).astype(np.int32),
             "token_lens": np.array([6, 4, 2, 5], np.int32)}
    out = {}
    for dev in ("cpu", DEVICE):
        with strict_fp32():
            task = ASRTask(cfg, device=dev)
            params = {k: v.requires_grad_(True)
                      for k, v in task.init_params(3).items()}
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss, _ = task.loss_fn(params, tb)
            grads = torch.autograd.grad(loss, list(params.values()))
        out[dev] = (float(loss.detach()),
                    {k: g.cpu() for k, g in zip(params, grads)})
    (want, want_g), (got, got_g) = out["cpu"], out[DEVICE]
    worst = max(l2rel(torch, got_g[k], want_g[k]) for k in want_g)
    res = {"loss_cpu": want, "loss_cuda": got,
           "worst_grad_leaf_l2rel": worst}
    if not (abs(got - want) <= 1e-4 * abs(want) and worst <= 1e-3):
        log({"phase": "mono_step", "parity_small": res})
        raise SystemExit("cuda and cpu disagree on the VGG-BLSTM loss")
    return res


def phase_mono_step(torch):
    from metaasr_tpu_torch.data.tokenizer import PhoneTokenizer
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.mono import MonoASRTrainer

    parity = small_model_parity(torch)
    cfg = config1()
    tok = PhoneTokenizer.arpabet_default()
    cfg.model.vocab_size = tok.vocab_size
    bsz, width, n_tok = cfg.data.batch_size, 64000, 32
    rng = np.random.default_rng(0)
    batch = {"audio": (0.1 * rng.standard_normal(
                 (bsz, width))).astype(np.float32),
             "audio_lens": np.full((bsz,), width, np.int32),
             "tokens": rng.integers(1, tok.vocab_size - 1,
                                    (bsz, n_tok)).astype(np.int32),
             "token_lens": np.full((bsz,), n_tok, np.int32)}
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    warmup, timed = 2, 5
    with tempfile.TemporaryDirectory() as d:
        task = ASRTask(cfg, tok.sos_eos_id, device=DEVICE)
        trainer = MonoASRTrainer(cfg, task, [], None, tok, d, device=DEVICE)
        st = {"state": trainer.init_state()}
        n_params = sum(v.numel() for v in st["state"]["params"].values())
        losses = []

        def one_step():
            st["state"], metrics = trainer.step(st["state"], batch)
            losses.append(metrics["loss"])

        zero_counts()
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        prof = device_busy(torch, one_step)
        counts = lstm_counts()
    lstm_ms = {}  # K3, K3b's recurrence and dU: device ms in the step
    for name, v in prof[4].items():
        k = name.split("(")[0].strip().rsplit(" ", 1)[-1]
        if k.startswith("lstm_"):
            lstm_ms[k] = lstm_ms.get(k, 0.0) + v
    steps = warmup + timed + 1
    layers = 2 * cfg.model.blstm_layers
    want = {"k1": steps, "k2": steps, "k3": steps * layers,
            "k3b": steps * layers}
    ms = statistics.median(times)
    loss_vals = [float(x) for x in losses]
    out = {"phase": "mono_step", "parity_small": parity,
           "model": {"arch": "vgg_blstm", "vgg_channels": [64, 128],
                     "blstm_hidden": 320, "blstm_layers": 4,
                     "vocab": tok.vocab_size, "dtype": "float32",
                     "parameters": n_params},
           "optimizer": "adadelta lr 1.0, clip 5.0", "specaug": True,
           "batch": [bsz, width], "tokens": n_tok,
           "lstm_shape_tbh": [99, bsz, 320], "steps": steps,
           "ms_per_step": ms, "ms_per_step_all": times,
           "utts_per_s": bsz / (ms / 1e3), "peak_mem_gb": peak / 1e9,
           "profiled_step": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                             "cuda_kernels": prof[2],
                             "top_kernels_ms": prof[3],
                             "lstm_kernels_ms": lstm_ms},
           "device_busy_share": None if prof[1] is None else prof[1] / ms,
           "launches": counts, "launches_expected": want, "loss": loss_vals}
    log(out)
    if not all(math.isfinite(v) for v in loss_vals):
        raise SystemExit("non-finite loss in the VGG-BLSTM step")
    if counts != want:
        raise SystemExit(f"mono step launch counts {counts}, want {want}")
    return out


def phase_mono_entry(torch):
    """train -> evaluate -> best checkpoint -> greedy bundle -> serve,
    through the entry points a user calls, at config1 width."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
    from metaasr_tpu_torch.weights import params_to_flax

    cfg = config1()
    steps, eval_every = 120, 40
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        generate_dataset(data, accents=("alpha",), utts_per_accent=96,
                         words_per_utt=(2, 4), seed=1)
        cfg.data.data_dir = data
        cfg.data.dev_fraction = 0.2
        cfg.train.log_every = 10
        cfg.train.eval_every, cfg.train.ckpt_every = eval_every, 1000
        zero_counts()
        t0 = time.perf_counter()
        trainer, tok = make_trainer(cfg, os.path.join(d, "wd"), DEVICE)
        state = trainer.train(max_steps=steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(os.path.join(d, "wd", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if "loss" in r]
        dev_recs = [r for r in recs if "dev_wer" in r]
        samples = [r["text"] for r in recs if "tag" in r][:2]
        trained = lstm_counts()
        restored, at = trainer.ckpt.restore(map_location=DEVICE)
        restored_equal = at == steps and all(
            torch.equal(restored["params"][k], v)
            for k, v in state["params"].items())
        best = trainer.ckpt.restore_best(map_location=DEVICE)
        with open(os.path.join(trainer.ckpt.ckpt_dir, "best",
                               "metrics.json")) as f:
            best_metrics = json.load(f)
        # the restored best state scores what its evaluation logged
        rescored = trainer.evaluate(best["params"], trainer.dev_dataset)
        evaluated = lstm_counts()
        bsz = cfg.data.batch_size
        bundle = os.path.join(d, "bundle")
        manifest = write_bundle(bundle, cfg, params_to_flax(state["params"], 1),
                                tok, [(bsz, 64000), (1, 64000)])
        dec = ServingDecoder(bundle, cfg, device=DEVICE)
        dev_set = trainer.dev_dataset
        waves = [dev_set[i]["audio"] for i in range(bsz)]
        refs = [dev_set.transcript(i) for i in range(bsz)]
        t0 = time.perf_counter()
        served = dec.transcribe(waves)
        torch.cuda.synchronize()
        serve_ms = 1e3 * (time.perf_counter() - t0)
        single = dec.transcribe(waves[3:4])
        torch.cuda.synchronize()
        final = lstm_counts()
        n_dev, n_train = len(dev_set), len(trainer.train_datasets[0])
        ckpt_steps = trainer.ckpt.all_steps()
    layers = 2 * cfg.model.blstm_layers
    evals = steps // eval_every
    eval_batches = -(-min(n_dev, 200) // bsz)
    want_train = {"k1": steps + evals * eval_batches, "k2": steps,
                  "k3": layers * (steps + evals * eval_batches),
                  "k3b": layers * steps}
    want_final = {"k1": want_train["k1"] + eval_batches + 2, "k2": steps,
                  "k3": want_train["k3"] + layers * (eval_batches + 2),
                  "k3b": layers * steps}
    dev_wers = [r["dev_wer"] for r in dev_recs]
    out = {"phase": "mono_entry", "train_utts": n_train, "dev_utts": n_dev,
           "vocab": tok.vocab_size, "steps": state["step"],
           "train_s": train_s, "loss": [r["loss"] for r in train_recs],
           "utts_per_sec_logged": [r["utts_per_sec"] for r in train_recs],
           "dev": [{"step": r["step"], "wer": r["dev_wer"],
                    "cer": r["dev_cer"]} for r in dev_recs],
           "text_samples": samples,
           "ckpt_steps": ckpt_steps,
           "restored_equal": restored_equal,
           "best": {"step": best["step"], "metric": best["best_metric"],
                    "metrics_file": best_metrics, "rescored": rescored},
           "bundle_mode": manifest["mode"], "serve_ms_full_batch": serve_ms,
           "served_sample": {"hyp": served[0]["text"], "ref": refs[0]},
           "served_single": single[0],
           "launches_after_train": trained, "launches_expected_after_train":
           want_train, "launches": final, "launches_expected": want_final}
    log(out)
    if not (state["step"] == steps and restored_equal
            and len(dev_recs) == evals
            and all(math.isfinite(r["loss"]) for r in train_recs)
            and all(0.0 <= w and math.isfinite(w) for w in dev_wers)):
        raise SystemExit("mono train / evaluate / checkpoint failed")
    if not (best["best_metric"] == min(dev_wers) == best_metrics["wer"]
            and rescored["wer"] == best_metrics["wer"]
            and rescored["cer"] == best_metrics["cer"]):
        raise SystemExit("the best checkpoint does not score its own metric")
    if manifest["mode"] != "greedy" or evaluated["k3b"] != layers * steps:
        raise SystemExit("greedy bundle or evaluation went wrong")
    check_results(served, bsz, tok)
    check_results(single, 1, tok)
    if single[0]["text"] != served[3]["text"]:
        raise SystemExit("single-utterance serving disagrees with the batch")
    if trained != want_train or final != want_final:
        raise SystemExit(f"mono entry launch counts {trained} / {final}, "
                         f"want {want_train} / {want_final}")
    return out


# ------------------------------------------------------------------ K2b ----

HVP_L2REL = 1e-3   # tests/test_m3_pallas.py:96-102: rtol 1e-3 ...
HVP_ATOL = 1e-5    # ... atol 1e-5, here times (1 + max |hv|)
# operations per element of [B, T, S]: K2's 16 for the primal recursion, 7
# per pass for the tangent (3 products, 3 sums, 1 division) and 3 for hv
HVP_OPS_PER_ELEMENT = 16 + 2 * 7 + 3
# K2b's <g, v> against K2's own fp32 gradient dotted with v, at T <= 100
# (the main path's shapes): both round over T steps, each to ~1e-4, so the
# bar is 1e-4 for each; a K2 / K2b inconsistency is orders above it
K2_K2B_DOT_TOL = 2e-4


def phase_ctc_hvp_kernel(torch, peaks):
    from metaasr_tpu_torch.ops import ctc as ctc_ops
    from metaasr_tpu_torch.ops import ctc_kernel

    peak_flops, peak_bw = peaks
    res = {"phase": "ctc_hvp_kernel", "hv_l2rel_tol": HVP_L2REL,
           "hv_abs_tol": "1e-5 * (1 + max|hv|)",
           "nll_dot_tol": "1e-4 * (1 + |<grad64, v>|) * max(1, T / 100)",
           "nll_dot_vs_k2_tol": f"{K2_K2B_DOT_TOL} * (1 + |<g_k2, v>|), "
                                "T <= 100",
           "hv_l2rel_to_float64_tol": "1e-3 * max(1, T / 100)",
           "shapes": {}}
    ok = True
    for i, (name, shape) in enumerate(CTC_SHAPES.items()):
        lp, t_lens, labels, u_lens = ctc_inputs(torch, shape, seed=10 + i)
        z = ctc_ops.extend_labels(labels)
        logp_z = ctc_ops.gather_emissions(lp, z).contiguous()
        skip = ctc_ops.skip_bias(z).contiguous()
        end = (2 * u_lens).contiguous()
        rng = np.random.default_rng(50 + i)
        v_full = torch.from_numpy(rng.standard_normal(
            tuple(lp.shape)).astype(np.float32)).to(DEVICE)
        v = ctc_ops.gather_emissions(v_full, z).contiguous()
        hv, nll_dot = ctc_kernel.ctc_hvp(logp_z, skip, t_lens, end, v)
        p_hv, p_dot = ctc_kernel.plain_ctc_hvp(logp_z, skip, t_lens, end, v)
        _, g = ctc_kernel.ctc_alpha_beta(logp_z, skip, t_lens, end)
        torch.cuda.synchronize()
        hv_l2rel = l2rel(torch, hv, p_hv)
        # the same recursion in float64: what fp32 costs, kernel and plain
        hv64 = ctc_kernel.plain_ctc_hvp(logp_z.double(), skip.double(),
                                        t_lens, end, v.double())[0]
        hv64_l2rel = l2rel(torch, hv.double(), hv64)
        hv_abs = float((hv - p_hv).abs().max())
        hv_max = float(p_hv.abs().max())
        # <grad, v> on the feasible rows: with the plain alpha/beta
        # gradient in float64 (the bar), and with K2's own fp32 gradient,
        # whose rounding over T steps the product inherits
        g64 = ctc_kernel.plain_ctc_alpha_beta(
            logp_z.double(), skip.double(), t_lens, end)[1]
        gv64 = (g64 * v.double()).sum((1, 2))[:-1]
        dot_err = float(((nll_dot[:-1].double() - gv64).abs()
                         / (1 + gv64.abs())).max())
        gv = (g * v).sum((1, 2))[:-1]
        dot_err_fp32 = float(((nll_dot[:-1] - gv).abs()
                              / (1 + gv.abs())).max())
        plain_dot_err = float((nll_dot - p_dot).abs().max())
        infeasible_zero = (float(hv[-1].abs().max()) == 0.0
                           and float(nll_dot[-1]) == 0.0)
        finite = bool(torch.isfinite(hv).all() and torch.isfinite(nll_dot).all())

        # through the Functions: grad(<grad(loss), v>) w.r.t. the log-probs,
        # the kernels on the card against the plain versions on the cpu
        def double_backward(dev, loss_fn=ctc_kernel.ctc_loss_kernel):
            x = lp.detach().to(dev).requires_grad_(True)
            loss = loss_fn(x, t_lens.to(dev), labels.to(dev), u_lens.to(dev))
            (g1,) = torch.autograd.grad(loss.sum(), x, create_graph=True)
            (h,) = torch.autograd.grad((g1 * v_full.to(dev)).sum(), x)
            return h

        before = (ctc_kernel.ctc_alpha_beta.launches,
                  ctc_kernel.ctc_hvp.launches)
        h_cuda = double_backward(DEVICE)
        torch.cuda.synchronize()
        counted = (ctc_kernel.ctc_alpha_beta.launches - before[0],
                   ctc_kernel.ctc_hvp.launches - before[1])
        h_cpu = double_backward("cpu")
        fn_l2rel = l2rel(torch, h_cuda.cpu(), h_cpu)
        fn_ok = (fn_l2rel <= HVP_L2REL and counted == (1, 1)
                 and float(h_cuda[-1].abs().max()) == 0.0
                 and bool(torch.isfinite(h_cuda).all()))
        entry = {"shape_btuv": list(shape), "hv_l2rel": hv_l2rel,
                 "hv_l2rel_to_float64": hv64_l2rel,
                 "hv_max_abs_diff": hv_abs, "hv_max_abs": hv_max,
                 "nll_dot_vs_grad64_dot_v": dot_err,
                 "nll_dot_vs_k2_grad_dot_v": dot_err_fp32,
                 "nll_dot_max_abs_diff_to_plain": plain_dot_err,
                 "infeasible_row_zero": infeasible_zero, "finite": finite,
                 "functions_cuda_vs_cpu_l2rel": fn_l2rel,
                 "functions_launches_k2_k2b": list(counted),
                 "bit_equal": bool(torch.equal(hv, p_hv)
                                   and torch.equal(nll_dot, p_dot)),
                 "plan": ctc_kernel.launch_plan(logp_z, tangent=True)}
        # against float64 the bars widen with T: fp32 rounds alpha and
        # beta, sums of T log-probs, to ~2^-24 of their size, and exp()
        # turns that absolute error into a relative one (K2's gradient has
        # the same loss, CTC_GRAD_L2REL at T = 1000)
        f64_scale = max(1.0, shape[1] / 100)
        ok = (ok and hv_l2rel <= HVP_L2REL
              and hv64_l2rel <= HVP_L2REL * f64_scale
              and hv_abs <= HVP_ATOL * (1 + hv_max)
              and dot_err <= 1e-4 * f64_scale
              and (shape[1] > 100 or dot_err_fp32 <= K2_K2B_DOT_TOL)
              and infeasible_zero and finite and fn_ok)
        if name in ("per_task", "fused"):
            bsz, t_len, _, _ = shape
            s_len = z.shape[1]
            entry["ms"] = cuda_median_ms(torch, lambda: ctc_kernel.ctc_hvp(
                logp_z, skip, t_lens, end, v))
            entry["plain_ms"] = cuda_median_ms(
                torch, lambda: ctc_kernel.plain_ctc_hvp(
                    logp_z, skip, t_lens, end, v), runs=6, warmup=1)
            entry["k2_ms"] = cuda_median_ms(
                torch, lambda: ctc_kernel.ctc_alpha_beta(
                    logp_z, skip, t_lens, end))
            # loss, gradient and its product by autograd through the scan:
            # what K2 + K2b (two launches) replace
            entry["scan_double_backward_ms"] = cuda_median_ms(
                torch, lambda: double_backward(DEVICE, ctc_ops.ctc_loss),
                runs=4, warmup=1)
            elems = bsz * t_len * s_len
            ops = HVP_OPS_PER_ELEMENT * elems
            # what the function must move: logp_z and v read, hv written
            # (and skip, lens, end, nll_dot)
            nbytes = 4 * (3 * elems + bsz * s_len + 3 * bsz)
            t_ops, t_bytes = ops / peak_flops, nbytes / peak_bw
            entry.update(
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                **chain_times(torch, entry["ms"], t_lens, lambda: (
                    ctc_kernel.ctc_hvp(logp_z, skip, t_lens, end, v))))
        res["shapes"][name] = entry
    log(res)
    if not ok:
        raise SystemExit("K2b disagrees with its plain version")
    return res


# ------------------------------------------------- second-order MAML ----

MAML_SHAPE = (4, 16)    # configs/config4_maml.yaml: 4 tasks x (16 + 16)


def config4():
    """configs/config4_maml.yaml at full width (config3's model; algo maml,
    2 inner steps at lr 0.01, 4 tasks x (16 + 16), bf16 meta-step)."""
    cfg, tok = config3_train()
    m = cfg.meta
    m.algo, m.inner_steps = "maml", 2
    m.tasks_per_batch, m.k_support, m.k_query = MAML_SHAPE[0], 16, 16
    return cfg, tok


def small_maml_parity(torch):
    """A small fp32 transformer's second-order MAML gradients on cuda (K1,
    K2, K2b) against the cpu (their plain versions), dropout 0 and
    SpecAugment off so that both draw nothing."""
    from metaasr_tpu_torch.meta.maml import MetaAlgoConfig, maml_grads
    from metaasr_tpu_torch.task import ASRTask

    cfg, tok = config3()
    m = cfg.model
    m.d_model, m.num_heads, m.d_ff, m.dtype = 32, 2, 64, "float32"
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dropout = 0.0
    cfg.specaug.enabled = False
    rng = np.random.default_rng(60)
    m_tasks, k_shot, width, n_tok = 2, 3, 16000, 6

    def part():
        lens = rng.integers(9000, width + 1, (m_tasks, k_shot)).astype(np.int32)
        audio = np.stack([make_waves(rng, row, width) for row in lens])
        tok_lens = rng.integers(2, n_tok + 1, (m_tasks, k_shot)).astype(np.int32)
        tokens = rng.integers(1, tok.vocab_size - 1,
                              (m_tasks, k_shot, n_tok)).astype(np.int32)
        tokens *= np.arange(n_tok)[None, None, :] < tok_lens[..., None]
        return {"audio": audio, "audio_lens": lens, "tokens": tokens,
                "token_lens": tok_lens}

    mb = {"support": part(), "query": part()}
    algo = MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False)
    out = {}
    for dev in ("cpu", DEVICE):
        with strict_fp32():
            task = ASRTask(cfg, tok.sos_eos_id, device=dev)
            batch = {s: {k: torch.from_numpy(v).to(dev)
                         for k, v in p.items()} for s, p in mb.items()}
            grads, metrics = maml_grads(task.loss_fn, algo, task.preprocess)(
                task.init_params(4), batch, 0)
        out[dev] = (float(metrics["meta_loss"]),
                    {k: g.cpu() for k, g in grads.items()})
    (want, want_g), (got, got_g) = out["cpu"], out[DEVICE]
    # leaves whose exact gradient is 0 (cross-attention key biases) hold
    # rounding noise on both sides: floor the norm as the CPU tests do
    worst = max(float(torch.linalg.norm(got_g[k] - want_g[k])
                      / torch.linalg.norm(want_g[k]).clamp_min(1e-4))
                for k in want_g)
    res = {"meta_loss_cpu": want, "meta_loss_cuda": got,
           "worst_grad_leaf_l2rel": worst}
    if not (abs(got - want) <= 1e-4 * abs(want) and worst <= 1e-3):
        log({"phase": "maml_step", "parity_small": res})
        raise SystemExit("cuda and cpu disagree on the second-order "
                         "MAML gradients")
    return res


def k2_per_task(inner: int, algo: str = "fomaml", remat: bool = True) -> int:
    """K2 launches a task makes in one meta-step, from the code: one an
    inner step and one for the query; under second-order MAML with
    ``meta.remat_inner``, one more an inner step (its recompute in the outer
    backward); Reptile runs its inner steps on support + query at once and
    no query loss."""
    if algo == "reptile":
        return inner
    return (2 if algo == "maml" and remat else 1) * inner + 1


def remat_pair(torch, grad_fns, params, mb, seed):
    """The second-order step's outer gradient at ``params`` and ``seed``
    through ``grad_fns[True]`` (remat) and then ``grad_fns[False]``, each
    under deterministic algorithms with its own peak-memory window ->
    (readings, the worst leaf l2rel between the sides, bit-equal?). The
    sides' gradients are moved to the host between them, so neither peak
    holds the other's. Each side's ms is one step's, read in this order
    after a profiled step: the order moves it (remat / none 0.86-0.88 with
    none first, 1.2-1.5 with remat first), so it is no measure of what the
    recompute costs; the medians of timed steps of two trees in ABBA order
    are."""
    sides, grads = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (True, False):
            fn = grad_fns[remat]
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g, metrics = fn(params, mb, seed)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            sides[remat] = {"ms_single_shot": ms,
                            "peak_mem_gb": torch.cuda.max_memory_allocated()
                            / 1e9,
                            "meta_loss": float(metrics["meta_loss"]),
                            "launches": all_counts()}
            grads[remat] = {k: v.float().cpu() for k, v in g.items()}
            del g, metrics
    finally:
        torch.use_deterministic_algorithms(False)
    off, on = grads[False], grads[True]
    worst = max(float(torch.linalg.norm(on[k] - off[k])
                      / torch.linalg.norm(off[k]).clamp_min(1e-4))
                for k in off)
    bit_equal = all(torch.equal(on[k], off[k]) for k in off)
    return sides, worst, bit_equal


REMAT_GRAD_L2REL = 1e-6   # tests/test_torch_remat.py: remat = no remat


def phase_maml_step(torch):
    import dataclasses

    from metaasr_tpu_torch.meta.maml import fold_in, maml_grads
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import algo_config
    from metaasr_tpu_torch.train.optimizer import apply_updates, make_optimizer

    parity = small_maml_parity(torch)
    cfg, tok = config4()
    task = ASRTask(cfg, tok.sos_eos_id, device=DEVICE)
    algo = algo_config(cfg)
    grad_fns = {remat: maml_grads(
        task.loss_fn, dataclasses.replace(algo, remat_inner=remat),
        task.preprocess) for remat in (False, True)}
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    inner = cfg.meta.inner_steps
    m_tasks, k_shot = MAML_SHAPE
    st = {"params": task.init_params(0)}
    st["opt"] = opt.init(st["params"])
    mb = bench_meta_batch(torch, m_tasks, k_shot, tok.vocab_size)
    losses = []

    def one_step(i, remat=algo.remat_inner):
        grads, metrics = grad_fns[remat](st["params"], mb, fold_in(0, i))
        updates, st["opt"] = opt.update(grads, st["opt"], st["params"])
        st["params"] = apply_updates(st["params"], updates)
        losses.append(metrics["meta_loss"])

    def want(steps, remat):
        return {"k1": steps * 2 * m_tasks,
                "k2": steps * m_tasks * k2_per_task(inner, "maml", remat),
                "k2b": steps * m_tasks * inner, "k3": 0, "k3b": 0}

    warmup, timed = 1, 3
    # the warm-up keeps its activations: it grows the allocator's cache to
    # the no-remat peak, which the no-remat side below would otherwise pay
    # for in its time. Its launches are not the main path's: the pair below
    # gates a step without remat on its own
    for i in range(warmup):
        one_step(i, remat=False)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup, warmup + timed):
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    prof = device_busy(torch, lambda: one_step(warmup + timed))
    counts = all_counts()
    steps = timed + 1
    want_counts = want(steps, True)
    # the same step with and without the recompute, at these parameters
    # and one seed
    sides, worst, bit_equal = remat_pair(torch, grad_fns, st["params"], mb,
                                         fold_in(0, warmup + steps))
    ms = statistics.median(times)
    loss_vals = [float(x) for x in losses]
    off, on = sides[False], sides[True]
    out = {"phase": "maml_step", "parity_small": parity,
           "algo": "maml (first_order false)", "inner_steps": inner,
           "grad_dtype": cfg.meta.grad_dtype, "specaug": True,
           "remat_inner": algo.remat_inner,
           "optimizer": "adam, noam lr 0.5 warmup 2000, clip 5.0",
           "tasks": m_tasks, "shots": k_shot, "warmup_no_remat": warmup,
           "steps": steps,
           "ms_per_step": ms, "ms_per_step_all": times,
           "unique_utts_per_s": m_tasks * 2 * k_shot / (ms / 1e3),
           "presentations_per_s":
               m_tasks * (k_shot * inner + k_shot) / (ms / 1e3),
           "peak_mem_gb": peak / 1e9,
           "profiled_step": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                             "cuda_kernels": prof[2],
                             "top_kernels_ms": prof[3]},
           "device_busy_share": None if prof[1] is None else prof[1] / ms,
           "launches": counts, "launches_expected": want_counts,
           "meta_loss": loss_vals,
           "remat_ab": {
               "deterministic": True, "no_remat": off, "remat": on,
               "no_remat_expected": want(1, False),
               "remat_expected": want(1, True),
               "peak_ratio": on["peak_mem_gb"] / off["peak_mem_gb"],
               "ms_single_shot_is": "one step a side, remat first, after "
                                    "the profiled step: order-dependent, "
                                    "not the recompute's cost",
               "worst_grad_leaf_l2rel": worst, "bit_equal": bit_equal,
               "bar": REMAT_GRAD_L2REL}}
    log(out)
    if not all(math.isfinite(v) for v in loss_vals):
        raise SystemExit("non-finite meta loss in the MAML step")
    if counts != want_counts:
        raise SystemExit(f"MAML step launch counts {counts}, want "
                         f"{want_counts}")
    if (off["launches"], on["launches"]) != (want(1, False), want(1, True)):
        raise SystemExit(f"MAML step launch counts without / with remat "
                         f"{off['launches']} / {on['launches']}, want "
                         f"{want(1, False)} / {want(1, True)}")
    if not (worst <= REMAT_GRAD_L2REL
            and on["meta_loss"] == off["meta_loss"]):
        raise SystemExit(f"remat changes the MAML step: worst leaf l2rel "
                         f"{worst}, meta loss {on['meta_loss']} against "
                         f"{off['meta_loss']}")
    if not on["peak_mem_gb"] < off["peak_mem_gb"]:
        raise SystemExit(f"remat saves no memory: peak {on['peak_mem_gb']} "
                         f"GB against {off['peak_mem_gb']} GB without it")
    del st, mb
    torch.cuda.empty_cache()
    return out


def phase_maml_entry(torch):
    """configs/config4_maml.yaml through the entry points a user calls:
    meta-train -> checkpoint -> adapt at full width, then one MAML step of a
    small VGG-BLSTM through the same trainer."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config4_maml.yaml")
    steps = 2
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        # 16 + 16 shots per task: 32 utterances per accent
        generate_dataset(data, utts_per_accent=32, words_per_utt=(2, 4),
                         seed=0)
        gen_s = time.perf_counter() - t0
        cfg = load_config(config_path, {
            "data.data_dir": data, "train.log_every": 1,
            "train.ckpt_every": steps, "train.keep_ckpts": 2})
        cfg.data.heldout_accents = ("tango",)
        zero_counts()
        t0 = time.perf_counter()
        trainer, tok = make_trainer(cfg, os.path.join(d, "wd"), DEVICE)
        state = trainer.meta_train(max_steps=steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(os.path.join(d, "wd", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ckpts = trainer.ckpt.all_steps()
        restored, at = trainer.ckpt.restore(map_location=DEVICE)
        restored_equal = at == steps and all(
            torch.equal(restored["params"][k], v)
            for k, v in state["params"].items())
        adapted, test_idx = trainer.meta_adapt(
            state["params"], trainer.heldout_datasets["tango"], seed=0)
        torch.cuda.synchronize()
        adapted_finite = all(bool(torch.isfinite(v).all())
                             for v in adapted.values())
        counts = all_counts()
        # the meta-test after MAML: one support draw, 4 test utterances,
        # beam (random init and two steps: a trend, not a result)
        zero_counts()
        t0 = time.perf_counter()
        heldout = trainer.eval_heldout(state["params"], max_utts=4,
                                       support_draws=1)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = all_counts()

        # a small VGG-BLSTM under MAML: the recurrence leaves K3/K3b for
        # the twice-differentiable autograd loop
        small = load_config(config_path, {
            "data.data_dir": data, "train.log_every": 1,
            "meta.tasks_per_batch": 2, "meta.k_support": 2,
            "meta.k_query": 2, "meta.grad_dtype": "float32"})
        small.data.heldout_accents = ("tango",)
        sm = small.model
        sm.arch, sm.blstm_hidden, sm.blstm_layers = "vgg_blstm", 64, 2
        sm.vgg_channels, sm.dtype = (16, 32), "float32"
        zero_counts()
        vgg_trainer, _ = make_trainer(small, os.path.join(d, "wd_vgg"),
                                      DEVICE)
        vgg_state = vgg_trainer.meta_train(max_steps=1)
        torch.cuda.synchronize()
        with open(os.path.join(d, "wd_vgg", "logs", "scalars.jsonl")) as f:
            vgg_recs = [json.loads(line) for line in f]
        vgg_counts = all_counts()
    m = cfg.meta
    want = {"k1": steps * 2 * m.tasks_per_batch + 1,          # + adapt
            "k2": steps * m.tasks_per_batch
            * k2_per_task(m.inner_steps, m.algo, m.remat_inner)
            + m.adapt_steps,
            "k2b": steps * m.tasks_per_batch * m.inner_steps,
            "k3": 0, "k3b": 0}
    # adaptation (first order: no K2b) + one decode batch
    eval_want = {"k1": 2, "k2": m.adapt_steps, "k2b": 0, "k3": 0, "k3b": 0}
    vm = small.meta
    vgg_want = {"k1": 2 * vm.tasks_per_batch,
                "k2": vm.tasks_per_batch
                * k2_per_task(vm.inner_steps, vm.algo, vm.remat_inner),
                "k2b": vm.tasks_per_batch * vm.inner_steps, "k3": 0, "k3b": 0}
    out = {"phase": "maml_entry", "config": "configs/config4_maml.yaml",
           "algo": m.algo, "inner_steps": m.inner_steps,
           "remat_inner": m.remat_inner,
           "tasks_x_shots": [m.tasks_per_batch, m.k_support, m.k_query],
           "accents": 8, "heldout": "tango", "corpus_s": gen_s,
           "meta_train_s": train_s, "steps": state["step"],
           "meta_loss": [r["meta_loss"] for r in recs],
           "utts_per_sec_logged": [r["utts_per_sec"] for r in recs],
           "ckpt_steps": ckpts, "restored_equal": restored_equal,
           "adapted_leaves": len(adapted), "adapt_test_utts": len(test_idx),
           "launches": counts, "launches_expected": want,
           "heldout_eval": {"decode_mode": cfg.train.eval_decode_mode,
                            "draws": 1, "max_utts": 4, "scores": heldout,
                            "seconds": eval_s, "launches": eval_counts,
                            "launches_expected": eval_want},
           "vgg_blstm_maml": {
               "model": {"blstm_hidden": 64, "blstm_layers": 2,
                         "vgg_channels": [16, 32], "dtype": "float32"},
               "lstm_impl": small.model.lstm_impl, "steps": vgg_state["step"],
               "meta_loss": [r["meta_loss"] for r in vgg_recs],
               "launches": vgg_counts, "launches_expected": vgg_want}}
    log(out)
    if not (state["step"] == steps and ckpts == [steps] and restored_equal
            and adapted_finite
            and all(math.isfinite(r["meta_loss"]) for r in recs)):
        raise SystemExit("MAML meta-train / checkpoint / adapt failed")
    if not (vgg_state["step"] == 1 and small.model.lstm_impl == "scan"
            and all(math.isfinite(r["meta_loss"]) for r in vgg_recs)):
        raise SystemExit("the VGG-BLSTM MAML step failed")
    if not (cfg.train.eval_decode_mode == "beam"
            and all(math.isfinite(v) and v >= 0 for v in heldout.values())):
        raise SystemExit(f"MAML held-out evaluation failed: {heldout}")
    if counts != want or vgg_counts != vgg_want or eval_counts != eval_want:
        raise SystemExit(f"MAML entry launch counts {counts} / {vgg_counts} "
                         f"/ {eval_counts}, want {want} / {vgg_want} / "
                         f"{eval_want}")
    return out


# ---------------------------------------------------- the meta-test ----

def run_cli(argv) -> tuple[str, float]:
    """``metaasr_tpu_torch.cli.main`` in this process (so the launch
    counters stay readable) -> (its standard output, seconds)."""
    import io

    import torch

    from metaasr_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"cli {argv[:2]} exited {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def phase_meta_test(torch):
    """train (held-out evaluation every 2 steps) -> adapt --use-best (beam,
    3-best dumps) -> test --avg-last 2 -> export -> serve the bundle without
    and with --config, through the CLI at config3 width; then one
    eval_heldout under the profiler."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config3_fomaml.yaml")
    steps, eval_every, draws, eval_utts, utts = 4, 2, 2, 8, 16
    seconds, counts = {}, {}

    def cli(path, argv):
        zero_counts()
        out, seconds[path] = run_cli(argv)
        counts[path] = all_counts()
        return out

    with tempfile.TemporaryDirectory() as d:
        data, wd = os.path.join(d, "data"), os.path.join(d, "wd")
        generate_dataset(data, utts_per_accent=utts, words_per_utt=(2, 4),
                         seed=0)
        cli("meta_test_train", [
            "--mode", "train", "--config", config_path, "--data-dir", data,
            "--workdir", wd, "--max-steps", str(steps),
            "-o", "data.heldout_accents=tango",
            "-o", f"train.eval_every={eval_every}",
            "-o", f"train.eval_support_draws={draws}",
            "-o", f"train.eval_max_utts={eval_utts}",
            "-o", "train.eval_decode_mode=beam", "-o", "train.log_every=1",
            "-o", "train.ckpt_every=1000"])
        with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        best_metrics_path = os.path.join(wd, "ckpts", "best", "metrics.json")
        with open(best_metrics_path) as f:
            best_metrics = json.load(f)
        cli("cli_adapt", ["--mode", "adapt", "--workdir", wd, "--use-best",
                          "--decode-mode", "beam", "--dump-nbest", "3"])
        with open(os.path.join(wd, "hyps_tango.jsonl")) as f:
            dumps = [json.loads(line) for line in f]
        with open(os.path.join(wd, "adapt_results.json")) as f:
            adapt_results = json.load(f)
        cli("cli_test", ["--mode", "test", "--workdir", wd,
                         "--avg-last", "2"])
        with open(os.path.join(wd, "test_results.json")) as f:
            test_results = json.load(f)
        bundle = os.path.join(d, "bundle")
        export = json.loads(cli("cli_export", [
            "--mode", "export", "--workdir", wd, "--export-dir", bundle,
            "--export-buckets", "4x96000"]))
        wavs = [os.path.join(data, "wav", "tango", f"tango_000{i}.wav")
                for i in range(4)]
        served = {}
        for path, extra in (("cli_serve_bundle", []),
                            ("cli_serve_bundle_config",
                             ["--config", os.path.join(wd, "config.yaml")])):
            served[path] = [json.loads(line) for line in cli(path, [
                "--mode", "serve", "--bundle", bundle, "--wav", *wavs,
                "--dump-nbest", "2", *extra]).splitlines()]

        # one held-out evaluation of the best state, profiled
        trainer, _ = make_trainer(
            load_config(os.path.join(wd, "config.yaml")), wd, DEVICE)
        params = trainer.ckpt.restore_best(map_location=DEVICE)["params"]
        zero_counts()
        res = {}
        prof = device_busy(torch, lambda: res.update(
            trainer.eval_heldout(params)))
        counts["heldout_eval"] = all_counts()
    cfg = trainer.cfg
    m, bsz = cfg.meta, cfg.data.batch_size
    evals = [r for r in recs if "heldout_wer_mean" in r]
    # per draw: adaptation (K1 once, K2 adapt_steps times) + decode batches
    eval_batches = draws * -(-min(eval_utts, utts - m.k_support) // bsz)
    per_eval = {"k1": draws + eval_batches, "k2": draws * m.adapt_steps}
    zero = {"k2b": 0, "k3": 0, "k3b": 0}
    want = {
        "meta_test_train": {
            "k1": steps * 2 * m.tasks_per_batch
            + steps // eval_every * per_eval["k1"],
            "k2": steps * m.tasks_per_batch * (m.inner_steps + 1)
            + steps // eval_every * per_eval["k2"], **zero},
        "cli_adapt": {"k1": 1 + -(-(utts - m.k_support) // bsz),
                      "k2": m.adapt_steps, **zero},
        "cli_test": {"k1": -(-utts // bsz), "k2": 0, **zero},
        "cli_export": {"k1": 0, "k2": 0, **zero},
        "cli_serve_bundle": {"k1": 1, "k2": 0, **zero},
        "cli_serve_bundle_config": {"k1": 1, "k2": 0, **zero},
        "heldout_eval": {**per_eval, **zero}}
    out = {"phase": "meta_test", "config": "configs/config3_fomaml.yaml",
           "accents": 8, "heldout": "tango", "utts_per_accent": utts,
           "steps": steps, "eval_every": eval_every,
           "eval_support_draws": draws, "eval_max_utts": eval_utts,
           "eval_decode_mode": "beam", "beam_size": cfg.train.beam_size,
           "evaluations": [{k: r[k] for k in ("step", "heldout_tango_wer",
                                              "heldout_tango_cer",
                                              "heldout_tango_wer_std")}
                           for r in evals],
           "best_metrics": best_metrics, "adapt": adapt_results,
           "adapt_hyp_sample": dumps[0], "test_avg_last_2": test_results,
           "export": export, "served": served["cli_serve_bundle"],
           "mode_seconds": seconds,
           "profiled_eval_heldout": {
               "scores": res, "decode_batches": eval_batches,
               "wall_ms": prof[0],
               "device_busy_ms": prof[1], "cuda_kernels": prof[2],
               "top_kernels_ms": prof[3],
               "device_busy_share": (None if prof[1] is None
                                     else prof[1] / prof[0]),
               "cuda_kernels_per_decode_batch": prof[2] / eval_batches,
               "k1_per_decode_batch": 1},
           "launches": counts, "launches_expected": want}
    log(out)
    if not (len(evals) == steps // eval_every and "heldout_wer_mean"
            in best_metrics and all(math.isfinite(r["heldout_wer_mean"])
                                    for r in evals)):
        raise SystemExit("meta-train with held-out evaluation failed")
    if not (len(dumps) == utts - m.k_support and all(
            len(r["nbest"]) == 3 and r["nbest"][0]["hyp"] == r["hyp"]
            and all(math.isfinite(h["score"]) for h in r["nbest"])
            for r in dumps)):
        raise SystemExit("adapt's 3-best hypothesis dump is malformed")
    if export["mode"] != "beam" or served["cli_serve_bundle"] != \
            served["cli_serve_bundle_config"]:
        raise SystemExit("the bundle served without --config disagrees "
                         "with the bundle served with it")
    check_results(served["cli_serve_bundle"], 4, CharTokenizer.ascii_default())
    if counts != want:
        raise SystemExit(f"meta-test launch counts {counts}, want {want}")
    return out


def phase_mono_test(torch):
    """The baseline's meta-test modes through the CLI at config1 width: a
    few --algo no steps, then test (MonoASRTrainer.evaluate on the held-out
    accent), transcribe (a decode-only meta trainer over every accent) and
    transcribe of manifests without transcripts (hypotheses, no WER)."""
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config1_mono_vgg_ctc.yaml")
    steps, utts = 4, 24
    seconds, counts, results = {}, {}, {}
    with tempfile.TemporaryDirectory() as d:
        data, wd = os.path.join(d, "data"), os.path.join(d, "wd")
        generate_dataset(data, accents=("alpha", "bravo"),
                         utts_per_accent=utts, words_per_utt=(2, 4), seed=2)
        bare = os.path.join(d, "bare")
        runs = (("mono_cli_train", ["--mode", "train", "--algo", "no",
                                "--config", config_path, "--data-dir", data,
                                "--max-steps", str(steps),
                                "-o", "data.heldout_accents=bravo",
                                "-o", "train.eval_every=0"]),
                ("mono_test", ["--mode", "test"]),
                ("mono_transcribe", ["--mode", "transcribe"]),
                ("mono_transcribe_bare", ["--mode", "transcribe",
                                          "--data-dir", bare]))
        for path, argv in runs:
            if path == "mono_transcribe_bare":
                # the same corpus with its transcripts removed (and the
                # run's phone vocabulary beside it)
                shutil.copytree(data, bare)
                for accent in ("alpha", "bravo"):
                    man = os.path.join(bare, f"{accent}.jsonl")
                    with open(man) as f:
                        recs = [json.loads(line) for line in f]
                    with open(man, "w") as f:
                        f.writelines(json.dumps({
                            k: v for k, v in r.items()
                            if k not in ("text", "phones")}) + "\n"
                            for r in recs)
            zero_counts()
            _, seconds[path] = run_cli([*argv, "--workdir", wd])
            counts[path] = lstm_counts()
            if path != "mono_cli_train":
                with open(os.path.join(
                        wd, f"{argv[1]}_results.json")) as f:
                    results[path] = json.load(f)
        with open(os.path.join(wd, "hyps_alpha.jsonl")) as f:
            bare_hyps = [json.loads(line) for line in f]
        cfg = load_config(os.path.join(wd, "config.yaml"))
    layers, bsz = 2 * cfg.model.blstm_layers, cfg.data.batch_size
    batches = -(-utts // bsz)     # per accent: both have 24 utterances
    want = {"mono_cli_train": {"k1": steps, "k2": steps, "k3": layers * steps,
                           "k3b": layers * steps},
            "mono_test": {"k1": batches, "k2": 0, "k3": layers * batches,
                          "k3b": 0},
            "mono_transcribe": {"k1": 2 * batches, "k2": 0,
                                "k3": layers * 2 * batches, "k3b": 0}}
    want["mono_transcribe_bare"] = want["mono_transcribe"]
    out = {"phase": "mono_test", "config": "configs/config1_mono_vgg_ctc.yaml",
           "train_accent": "alpha", "heldout": "bravo",
           "utts_per_accent": utts,
           "steps": steps, "results": results, "mode_seconds": seconds,
           "bare_hyp_sample": bare_hyps[0], "launches": counts,
           "launches_expected": want}
    log(out)
    test = results["mono_test"]
    if not (list(test) == ["bravo"] and math.isfinite(test["bravo"]["wer"])
            and set(results["mono_transcribe"]) == {"alpha", "bravo"}
            and all("wer" in r for r in results["mono_transcribe"].values())):
        raise SystemExit("the baseline's test / transcribe failed")
    bare_res = results["mono_transcribe_bare"]
    if not (set(bare_res) == {"alpha", "bravo"}
            and all(set(r) == {"utts", "dump"} for r in bare_res.values())
            and len(bare_hyps) == utts
            and all(h["ref"] == "" for h in bare_hyps)):
        raise SystemExit("transcribe without transcripts failed")
    if counts != want:
        raise SystemExit(f"baseline meta-test launch counts {counts}, "
                         f"want {want}")
    return out


# ----------------------------------- data preparation and the drill ----

DRILL_UTTS = 48        # the drill's corpus: 3 accents x 48 at 22.05 kHz


def run_prep(argv) -> float:
    """``prepare_data.main`` in this process (the launch counters stay
    readable) -> seconds."""
    from metaasr_tpu_torch.scripts import prepare_data

    import torch

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = prepare_data.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"prepare_data {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def check_prepared_features(torch, data, accents) -> dict:
    """Every utterance's saved features against K1's plain version on the
    CPU and the float64 oracle, by K1's bars (phase 2): <= 1e-5 from the
    oracle at every frame and rtol = atol = 1e-4 from the plain version
    gate. The third, max |diff| <= 1e-4 from the plain version where the
    plain version is within 1e-4 of the oracle, is printed with
    ``masked_bar_met``: at a bin where the plain version is just within
    1e-4 of the oracle, K1's own error (<= 1e-5 from the oracle, gated)
    on the other side can take it past 1e-4, so it measures the plain
    version's error there, not K1's. Frame counts exact; the global CMVN
    statistics against a float64 recompute from the saved arrays."""
    from metaasr_tpu_torch.data.audio_io import load_wav
    from metaasr_tpu_torch.frontend.fbank import log_mel_fbank
    from metaasr_tpu_torch.frontend.oracle import fbank_oracle

    worst = dict.fromkeys(("max_abs_err_where_plain_within_tol", "tol_ratio",
                           "oracle_max_abs_err", "plain_oracle_max_abs_err"),
                          0.0)
    frames, lens_exact, s1, s2 = 0, True, np.zeros(80), np.zeros(80)
    for accent in accents:
        with open(os.path.join(data, f"{accent}.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            got = np.load(os.path.join(data, r["feats"]))
            audio = load_wav(os.path.join(data, r["wav"]), 16000)
            with torch.no_grad():
                plain, plens = log_mel_fbank(
                    torch.from_numpy(audio)[None],
                    torch.tensor([len(audio)]), cmvn="none")
            plain = plain[0, : int(plens[0])].numpy()
            ref = fbank_oracle(audio)
            lens_exact = (lens_exact and got.dtype == np.float32
                          and got.shape == plain.shape == ref.shape)
            if not lens_exact:
                break
            d = np.abs(got - plain)
            well = np.abs(plain - ref) <= K1_TOL
            for key, val in (
                    ("max_abs_err_where_plain_within_tol",
                     float(d[well].max()) if well.any() else 0.0),
                    ("tol_ratio", float((d / (K1_TOL + K1_TOL
                                              * np.abs(plain))).max())),
                    ("oracle_max_abs_err", float(np.abs(got - ref).max())),
                    ("plain_oracle_max_abs_err",
                     float(np.abs(plain - ref).max()))):
                worst[key] = max(worst[key], val)
            a64 = got.astype(np.float64)
            s1 += a64.sum(0)
            s2 += (a64 ** 2).sum(0)
            frames += len(got)
    with open(os.path.join(data, "cmvn_stats.json")) as f:
        stats = json.load(f)
    mean = s1 / max(frames, 1)
    stats_equal = (stats["frames"] == frames
                   and np.array_equal(stats["mean"], mean)
                   and np.array_equal(stats["var"],
                                      s2 / max(frames, 1) - mean ** 2))
    ok = (lens_exact and stats_equal and worst["tol_ratio"] <= 1.0
          and worst["oracle_max_abs_err"] <= K1_ORACLE_TOL)
    return {"ok": ok, "frames": frames, "frame_lens_exact": lens_exact,
            "cmvn_stats_equal_float64_recompute": stats_equal, **worst,
            "masked_bar_met":
                worst["max_abs_err_where_plain_within_tol"] <= K1_TOL}


def phase_data_prep(torch, smi):
    """prepare_data commonvoice -> speaker-cmvn -> features (K1 on the card,
    one launch per utterance, every utterance held to K1's bars) -> vocab
    char / phone / bpe; then two FOMAML steps at config3 width on the
    prepared features with the BPE vocabulary, and --mode test (beam) on the
    held-out accent: no K1 launch on the feats path."""
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.scripts.acceptance import HELDOUT, make_cv_corpus

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config3_fomaml.yaml")
    steps, tasks = 2, 2
    seconds, counts = {}, {}
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        tsv, clips = make_cv_corpus(os.path.join(d, "cv"), DRILL_UTTS, 0)
        seconds["corpus"] = time.perf_counter() - t0
        seconds["commonvoice"] = run_prep([
            "commonvoice", "--tsv", tsv, "--clips-dir", clips, "--out", data,
            "--min-sec", "0.2", "--max-sec", "20"])
        accents = sorted(f[:-6] for f in os.listdir(data)
                         if f.endswith(".jsonl"))
        utts = 0
        for accent in accents:
            with open(os.path.join(data, f"{accent}.jsonl")) as f:
                utts += sum(1 for _ in f)
        # speaker-cmvn first: features rewrites the manifests without the
        # speaker field, as the reference does
        for cmd in ("speaker-cmvn", "features"):
            zero_counts()
            seconds[cmd] = run_prep([cmd, "--data-dir", data])
            counts[f"prep_{cmd.replace('-', '_')}"] = all_counts()
        with open(os.path.join(data, "speaker_cmvn.json")) as f:
            speakers = len(json.load(f))
        # K1's device time in features, from the profiler's kernel spans
        # over a second run (the manifests it reads now name the features
        # and still the WAVs)
        zero_counts()
        prof = device_busy(torch, lambda: run_prep(
            ["features", "--data-dir", data]))
        k1_ms = sum(ms for name, ms in prof[4].items() if "fbank" in name)
        profiled_k1 = all_counts()["k1"]
        vocab = {}
        for kind in ("char", "phone", "bpe"):
            seconds[f"vocab_{kind}"] = run_prep(
                ["vocab", "--data-dir", data, "--type", kind])
            with open(os.path.join(data, f"vocab_{kind}.json")) as f:
                vocab[kind] = json.load(f)
        check = check_prepared_features(torch, data, accents)

        # the feats path: manifests that name only the features (a record
        # that names a WAV loads the audio, in both packages)
        feats_data, wd = os.path.join(d, "feats_only"), os.path.join(d, "wd")
        shutil.copytree(data, feats_data)
        for accent in accents:
            man = os.path.join(feats_data, f"{accent}.jsonl")
            with open(man) as f:
                recs = [json.loads(line) for line in f]
            with open(man, "w") as f:
                f.writelines(json.dumps({k: v for k, v in r.items()
                                         if k != "wav"}) + "\n"
                             for r in recs)
        runs = (("prep_feats_train", [
            "--mode", "train", "--config", config_path, "--data-dir",
            feats_data, "--workdir", wd, "--max-steps", str(steps),
            "-o", "data.vocab=bpe", "-o", f"data.heldout_accents={HELDOUT}",
            "-o", f"meta.tasks_per_batch={tasks}", "-o", "train.log_every=1",
            "-o", "train.eval_every=0"]),
            ("prep_feats_test", ["--mode", "test", "--workdir", wd,
                                 "--decode-mode", "beam"]))
        for path, argv in runs:
            zero_counts()
            _, seconds[path] = run_cli(argv)
            counts[path] = all_counts()
        with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(wd, "test_results.json")) as f:
            test_results = json.load(f)
        cfg = load_config(os.path.join(wd, "config.yaml"))
    m = cfg.meta
    zero = {"k2b": 0, "k3": 0, "k3b": 0}
    want = {"prep_speaker_cmvn": {"k1": utts, "k2": 0, **zero},
            "prep_features": {"k1": utts, "k2": 0, **zero},
            "prep_feats_train": {"k1": 0,
                                 "k2": steps * tasks * (m.inner_steps + 1),
                                 **zero},
            "prep_feats_test": {"k1": 0, "k2": 0, **zero}}
    losses = [r["meta_loss"] for r in recs if "meta_loss" in r]
    out = {"phase": "data_prep", "card": smi,
           "corpus": {"accents": accents, "utts_per_accent": DRILL_UTTS,
                      "source_rate_hz": 22050, "utterances": utts,
                      "speakers": speakers},
           "features": {"utterances": utts, "frames": check["frames"],
                        "k1_launches": counts["prep_features"]["k1"],
                        "utts_per_s": utts / seconds["features"],
                        "profiled_k1_launches": profiled_k1,
                        "k1_device_ms_per_utt": k1_ms / utts,
                        "device_busy_ms_per_utt": (
                            None if prof[1] is None else prof[1] / utts),
                        "profiled_wall_ms_per_utt": prof[0] / utts},
           "k1_check": check,
           "vocab_sizes": {k: len(v["symbols"]) + 2 for k, v in vocab.items()},
           "bpe_merges": len(vocab["bpe"]["merges"]),
           "feats_path": {
               "config": "configs/config3_fomaml.yaml", "model": {
                   k: getattr(cfg.model, k) for k in (
                       "d_model", "num_heads", "d_ff", "num_encoder_layers",
                       "num_decoder_layers", "dtype")},
               "vocab": cfg.data.vocab,
               "cuts": {"tasks_per_batch": f"{tasks} (config3: 4; the "
                        "corpus has 2 training accents)",
                        "shots": f"{m.k_support} + {m.k_query} (config3's)",
                        "steps": f"{steps} (config3: 30,000)"},
               "inner_steps": m.inner_steps, "meta_losses": losses,
               "test": test_results},
           "seconds": {k: round(v, 3) for k, v in seconds.items()},
           "launches": counts, "launches_expected": want}
    log(out)
    if not check["ok"]:
        raise SystemExit("prepared features disagree with K1's plain "
                         "version or the oracle, or the statistics do")
    if not (profiled_k1 == utts and k1_ms > 0 and set(vocab) == {
            "char", "phone", "bpe"} and vocab["bpe"]["type"] == "BPETokenizer"
            and speakers == 4 * len(accents)):
        raise SystemExit("features (profiled) or vocab failed")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and list(test_results) == [HELDOUT]
            and math.isfinite(test_results[HELDOUT]["wer"])):
        raise SystemExit("training or testing on the feats manifests failed")
    if counts != want:
        raise SystemExit(f"data-prep launch counts {counts}, want {want}")
    return out


ACCEPTANCE_ARGV = ["--smoke", "--steps", "6", "--utts", "10"]
# what runs beside phase 23 and beside phase 17's drill in the whole smoke
FLAGSHIP_BESIDE = ("phase 17's acceptance drill, a subprocess on the same "
                   "card and host", "phase 23, the flagship table, in the "
                   "smoke's own process on the same card")


def start_acceptance():
    """Phase 17's drill, a subprocess of the port's entry points, started
    before phase 23 so that its process start-ups overlap the flagship's
    work -> (its TemporaryDirectory, the process, its log file, the start
    time). The two then share the card and the host: the drill's stage
    seconds and phase 23's seconds are each read beside the other
    workload, and their lines say so."""
    tmp = tempfile.TemporaryDirectory()
    log_f = open(os.path.join(tmp.name, "drill.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "metaasr_tpu_torch.scripts.acceptance",
         "--out", os.path.join(tmp.name, "acc"), *ACCEPTANCE_ARGV],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log_f, stderr=subprocess.STDOUT, text=True)
    return tmp, proc, log_f, time.perf_counter()


def phase_acceptance(torch, started=None):
    """The smoke drill as a user runs it, on the card. ``started``:
    ``start_acceptance()``'s result, else it starts here."""
    tmp, proc, log_f, t0 = started or start_acceptance()
    with tmp:
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise SystemExit("the acceptance drill ran over 600 s")
        finally:
            log_f.close()
        wall = time.perf_counter() - t0
        out_dir = os.path.join(tmp.name, "acc")
        with open(log_f.name) as f:
            text = f.read()
        summary, records = None, []
        if rc == 0:
            with open(os.path.join(out_dir, "acceptance.json")) as f:
                summary = json.load(f)
            with open(os.path.join(out_dir, "serve_out.jsonl")) as f:
                records = [json.loads(line) for line in f]
    out = {"phase": "acceptance", "argv": " ".join(ACCEPTANCE_ARGV),
           "rc": rc, "seconds_start_to_join": round(wall, 3),
           "read_beside": None if started is None else FLAGSHIP_BESIDE[1],
           "green": "ACCEPTANCE GREEN" in text}
    if summary is not None:
        out.update({"stage_seconds": {k: v.get("sec") for k, v in
                                      summary["stages"].items()},
                    "device": summary["device"],
                    "served_wer": summary["served_wer"],
                    "adapted_wer": summary["adapted_wer"],
                    "served_sample": records[:2]})
    log(out)
    if not (rc == 0 and out["green"] and len(records) == 8
            and all("text" in x and "score" in x for x in records)
            and math.isfinite(summary["served_wer"])):
        print(text[-6000:], file=sys.stderr)
        raise SystemExit("the acceptance drill failed")
    return out


# ------------------------------------------------ LM shallow fusion ----

LM_STEPS = 200          # train_lm at its defaults otherwise:
LM_DIMS = {"vocab_size": 30, "embed_dim": 128, "hidden": 256, "layers": 2}
LM_SHAPE = (65, 32, 256)  # [T, B, H] of train_lm: max_len 64 + sos, batch 32
LM_WEIGHT = 0.3
LM_SEQ_STEP_TOL = 1e-5   # rtol = atol, tests/test_lm_fusion.py:53
LM_NLL_RTOL = 1e-5


def lm_kernel_times(torch, peaks) -> dict:
    """K3 and K3b at the LM's training shape [65, 32, 256] against their
    plain versions (run it under strict fp32): plan, CUDA-event times of
    the wrappers, the kernels' device time from CUDA-graph replays of the
    raw launches (at the plan's tile and at tiles 4, 8, 16: 8, 4 and 2
    clusters), the plain versions', the bound, and torch.nn.LSTM (cuDNN) of
    one LM layer (input 256) beside K3 + F.linear."""
    from metaasr_tpu_torch.ops import lstm_kernel as lk

    _, bsz, hidden = LM_SHAPE
    gx, u, dout = lstm_inputs(torch, LM_SHAPE, seed=40)
    h_seq, c_seq, gates = lk.lstm_forward(gx, u)
    p_h, p_c, p_g = lk.plain_lstm_forward(gx, u)
    p_dgx, p_du = lk.plain_lstm_backward(p_g, u, p_h, p_c, dout)
    dgx, du = lk.lstm_backward(gates, u, h_seq, c_seq, dout)
    out = {"shape_tbh": list(LM_SHAPE), "plan": lk.plan(bsz, hidden,
                                                       gx.device),
           "tiles": -(-bsz // lk.plan(bsz, hidden, gx.device)["tile"]),
           "fwd_max_abs_diff": float((h_seq - p_h).abs().max()),
           "dgx_l2rel": l2rel(torch, dgx, p_dgx),
           "du_l2rel": l2rel(torch, du, p_du),
           "fwd_ms": cuda_median_ms(torch, lambda: lk.lstm_forward(gx, u)),
           "bwd_ms": cuda_median_ms(torch, lambda: lk.lstm_backward(
               gates, u, h_seq, c_seq, dout)),
           "plain_fwd_ms": cuda_median_ms(
               torch, lambda: lk.plain_lstm_forward(gx, u), runs=6, warmup=2),
           "plain_bwd_ms": cuda_median_ms(
               torch, lambda: lk.plain_lstm_backward(p_g, u, p_h, p_c, dout),
               runs=6, warmup=2)}
    p = out["plan"]
    out["fwd_device_ms"] = graph_ms(torch, lambda: lk._launch_forward(
        gx, u, h_seq, c_seq, gates, p))
    out["bwd_device_ms"] = graph_ms(torch, lambda: (
        lk._launch_bptt(gates, u, c_seq, dout, dgx, p),
        lk._launch_du(h_seq, dgx, du)))
    # 8 batch tiles of 4 rows against cudaOccupancyMaxActiveClusters: the
    # recurrences' device time at tiles 4, 8 and 16 (8, 4 and 2 clusters)
    out["tile_sweep_device_ms"] = []
    for tile in LSTM_TILES:
        p = lk.plan(bsz, hidden, gx.device, tile)
        out["tile_sweep_device_ms"].append({
            "tile": tile, "clusters": -(-bsz // tile),
            "fwd": graph_ms(torch, lambda: lk._launch_forward(
                gx, u, h_seq, c_seq, gates, p)),
            "bptt": graph_ms(torch, lambda: lk._launch_bptt(
                gates, u, c_seq, dout, dgx, p))})
    out.update(lstm_bounds(LM_SHAPE, peaks))
    # the library yardstick: one LM layer (input 256) in cuDNN
    out.update(lstm_yardstick(torch, hidden, u, dout, seed=41))
    return out


def lm_parity(torch, tree, batch) -> dict:
    """Under strict fp32: the trained LM's sequence mode (K3) against its
    step mode on the card, lm_nll on the card against the CPU, and one
    train step's gradients (K3b) on the card against the CPU."""
    from metaasr_tpu_torch.models.lm import (
        lm_from_flax,
        lm_nll,
        lm_optimizer,
        lm_train_step,
    )

    toks, lens, sos_eos = batch
    devices = {"card": DEVICE, "cpu": "cpu"}
    models = {k: lm_from_flax(tree, dev) for k, dev in devices.items()}
    with torch.no_grad():
        card = models["card"]
        tok_d = toks.to(DEVICE)
        seq = card(tok_d)
        state = card.init_state(toks.shape[0])
        steps = []
        for t in range(toks.shape[1]):
            logits, state = card.step(tok_d[:, t: t + 1], state)
            steps.append(logits)
        steps = torch.stack(steps, 1)
        excess = float(((seq - steps).abs() - LM_SEQ_STEP_TOL
                        * steps.abs()).max())
        nll = {k: float(lm_nll(m, None, toks.to(devices[k]),
                               lens.to(devices[k]), sos_eos))
               for k, m in models.items()}
    grads = {}
    for k, m in models.items():
        params = {name: v.detach().clone().requires_grad_()
                  for name, v in m.named_parameters()}
        opt = lm_optimizer(1e-3)
        grads[k] = lm_train_step(m, opt, params, opt.init(params),
                                 toks.to(devices[k]), lens.to(devices[k]),
                                 sos_eos)[3]
    grad_l2rel = {name: l2rel(torch, g.cpu(), grads["cpu"][name])
                  for name, g in grads["card"].items()}
    return {"seq_vs_step_max_abs_diff": float((seq - steps).abs().max()),
            "seq_vs_step_excess_over_bar": excess,
            "seq_vs_step_bar": f"|seq - step| <= {LM_SEQ_STEP_TOL} "
                               f"(1 + |step|)",
            "nll_card": nll["card"], "nll_cpu": nll["cpu"],
            "nll_rel_diff": abs(nll["card"] - nll["cpu"]) / abs(nll["cpu"]),
            "grad_l2rel": grad_l2rel,
            "ok": (excess <= LM_SEQ_STEP_TOL and abs(nll["card"] - nll["cpu"])
                   <= LM_NLL_RTOL * abs(nll["cpu"])
                   and max(grad_l2rel.values()) <= LSTM_GRAD_L2REL)}


def phase_lm_fusion(torch, peaks, serving, smi):
    """train_lm at its defaults (200 steps) through scripts.train_lm.main ->
    K3/K3b at the LM's shape -> the LM's parity on the card -> fused
    serving at config3 width with a hot-swapped adapted tree -> CUDA
    against CPU serving of a tiny fused bundle -> the CLI's train (fused
    held-out evaluation), test, export and serve with --lm-ckpt /
    --lm-weight at config3 width."""
    import io

    from metaasr_tpu_torch.cli import build_tokenizer, make_trainer
    from metaasr_tpu_torch.config import Config, load_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.models.lm import (
        lm_dims_from_params,
        lm_from_flax,
        lm_optimizer,
        lm_train_step,
    )
    from metaasr_tpu_torch.scripts import train_lm
    from metaasr_tpu_torch.serve.export import ServingDecoder
    from metaasr_tpu_torch.train.checkpoint import (
        load_params_npz,
        save_params_npz,
    )
    from metaasr_tpu_torch.weights import flatten_tree

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config3_fomaml.yaml")
    res = {"phase": "lm_fusion", "card": smi, "lm_weight": LM_WEIGHT}
    seconds, counts = {}, {}
    with tempfile.TemporaryDirectory() as d:
        # (a) train_lm on an 8-accent text corpus, tango held out; long
        # transcripts so the LM's sequences reach max_len 64 (T = 65)
        lm_data, npz = os.path.join(d, "lm_data"), os.path.join(d, "lm.npz")
        generate_dataset(lm_data, utts_per_accent=64, words_per_utt=(6, 16),
                         seed=1, write_wavs=False)
        buf = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_lm.main(["--config", config_path, "--out", npz,
                           "--steps", str(LM_STEPS), "-o",
                           f"data.data_dir={lm_data}", "-o",
                           "data.heldout_accents=tango"])
        torch.cuda.synchronize()
        seconds["train_lm"] = time.perf_counter() - t0
        counts["lm_train_lm"] = all_counts()
        nlls = [float(ln.split()[-1]) for ln in buf.getvalue().splitlines()
                if ln.startswith("lm step")]
        tree = load_params_npz(npz)
        dims = lm_dims_from_params(tree)
        # one training step of the same shapes, profiled
        lm_cfg = load_config(config_path, {"data.data_dir": lm_data})
        tok = build_tokenizer(lm_cfg)
        texts = train_lm.lm_corpus(lm_data, ("tango",))
        enc = [tok.encode(t)[:64] for t in texts[:LM_SHAPE[1]]]
        toks = torch.zeros((len(enc), max(map(len, enc))), dtype=torch.long)
        for i, e in enumerate(enc):
            toks[i, :len(e)] = torch.from_numpy(np.asarray(e))
        lens = torch.tensor([len(e) for e in enc])
        model = lm_from_flax(tree, DEVICE)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in model.named_parameters()}
        opt = lm_optimizer(1e-3)
        opt_state = opt.init(params)
        step_args = (toks.to(DEVICE), lens.to(DEVICE), tok.sos_eos_id)
        lm_train_step(model, opt, params, opt_state, *step_args)
        step_ms = cuda_median_ms(torch, lambda: lm_train_step(
            model, opt, params, opt_state, *step_args), runs=10, warmup=2)
        prof = device_busy(torch, lambda: lm_train_step(
            model, opt, params, opt_state, *step_args))
        res["train_lm"] = {
            "corpus": {"accents": 7, "transcripts": len(texts),
                       "max_chars": max(len(t) for t in texts)},
            "steps": LM_STEPS, "dims": dims, "batch_size": 32,
            "max_len": 64, "seconds": seconds["train_lm"],
            "ms_per_step_with_setup": 1e3 * seconds["train_lm"] / LM_STEPS,
            "logged_nll": nlls, "launches": counts["lm_train_lm"],
            "step_shape_tbh": [toks.shape[1] + 1, toks.shape[0],
                               dims["hidden"]],
            "ms_per_step": step_ms,
            "profiled_step": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                              "cuda_kernels": prof[2],
                              "top_kernels_ms": prof[3],
                              "lstm_kernels_ms": {
                                  n[:40]: ms for n, ms in prof[4].items()
                                  if "lstm" in n}}}
        # (b) K3/K3b at the LM's shape and the LM's parity, strict fp32
        # (the plain versions' and the step mode's cuBLAS products)
        with strict_fp32():
            res["kernels_at_lm_shape"] = lm_kernel_times(torch, peaks)
            res["parity"] = lm_parity(torch, tree, (toks, lens,
                                                    tok.sos_eos_id))

        # (c) fused serving at config3 width, phase 3's requests
        cfg, ctok = config3()
        cfg.train.lm_weight = LM_WEIGHT
        bundle = os.path.join(d, "bundle3")
        asr_tree = seeded_bundle(cfg, ctok, bundle, [SERVE_BUCKET], seed=0,
                                 lm_params=tree)
        dec = ServingDecoder(bundle, cfg, device=DEVICE)
        fused = serve_requests(torch, dec, ctok)
        adapted = {k: v + 0.01 for k, v in flatten_tree(asr_tree).items()}
        zero_counts()
        swapped = dec.transcribe(serving_waves()[:4], params=adapted)
        counts["lm_hot_swap"] = all_counts()
        check_results(swapped, 4, ctok)
        swap_lm = dec._resolve_params(adapted)[1]
        res["fused_serving"] = {
            **fused, "card": smi, "bucket": list(SERVE_BUCKET),
            "beam_size": 10,
            "ctc_weight": 0.3, "max_len": 128,
            "hot_swap_keeps_bundle_lm": swap_lm is dec.lm,
            "hot_swap_sample": swapped[0],
            "unfused_phase3": {
                "ms_per_batch_full": serving["ms_per_batch_full"],
                "cuda_kernels": serving["profiled_full"]["cuda_kernels"],
                "device_busy_ms": serving["profiled_full"]["device_busy_ms"],
                "device_busy_share_of_timed_full":
                    serving["device_busy_share_of_timed_full"],
                "max_hyp_chars": [r["max_hyp_chars"]
                                  for r in serving["requests"]]},
            "ratio_ms": fused["ms_per_batch_full"]
            / serving["ms_per_batch_full"],
            "ratio_kernels": fused["profiled_full"]["cuda_kernels"]
            / serving["profiled_full"]["cuda_kernels"]}
        counts["lm_fused_serving"] = fused["launches"]

        # (d) CUDA against CPU, a tiny fp32 model and the trained LM
        tcfg = Config()
        tm = tcfg.model
        tm.d_model, tm.num_heads, tm.d_ff = 32, 2, 64
        tm.num_encoder_layers = tm.num_decoder_layers = 2
        tm.dtype, tm.vocab_size = "float32", ctok.vocab_size
        tcfg.data.max_tokens, tcfg.train.beam_size = 8, 3
        tcfg.train.lm_weight = LM_WEIGHT
        plens = [16000, 9000, 401, 12345]
        prng = np.random.default_rng(2)
        pwaves = [w[:n] for w, n in zip(make_waves(prng, plens, 16000),
                                        plens)]
        tiny = os.path.join(d, "tiny")
        seeded_bundle(tcfg, ctok, tiny, [(4, 16000)], seed=1, lm_params=tree)
        with strict_fp32():
            got = ServingDecoder(tiny, tcfg, device=DEVICE).transcribe(
                pwaves, nbest=3)
            want = ServingDecoder(tiny, tcfg, device="cpu").transcribe(
                pwaves, nbest=3)
        res["cuda_vs_cpu"] = {
            "same_text": all([x["hyp"] for x in g["nbest"]]
                             == [x["hyp"] for x in w["nbest"]]
                             for g, w in zip(got, want)),
            "max_score_diff": max(abs(a["score"] - b["score"])
                                  for g, w in zip(got, want)
                                  for a, b in zip(g["nbest"], w["nbest"])),
            "tolerance": PARITY_TOL, "texts": [g["text"] for g in got]}

        # (e) the CLI at config3 width with --lm-ckpt / --lm-weight
        data, wd = os.path.join(d, "data"), os.path.join(d, "wd")
        utts, steps = 16, 2
        generate_dataset(data, utts_per_accent=utts, words_per_utt=(2, 4),
                         seed=0)
        lm_flags = ["--lm-ckpt", npz, "--lm-weight", str(LM_WEIGHT)]

        def cli(path, argv):
            zero_counts()
            out, seconds[path] = run_cli(argv)
            counts[path] = all_counts()
            return out

        cli("lm_cli_train", [
            "--mode", "train", "--config", config_path, "--data-dir", data,
            "--workdir", wd, "--max-steps", str(steps), *lm_flags,
            "-o", "data.heldout_accents=tango",
            "-o", f"train.eval_every={steps}",
            "-o", "train.eval_support_draws=1", "-o", "train.eval_max_utts=8",
            "-o", "train.eval_decode_mode=beam", "-o", "train.ckpt_every=1000"])
        with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
            evals = [json.loads(line) for line in f
                     if "heldout_wer_mean" in line]
        results = {}
        for path, extra in (("lm_cli_test", lm_flags),
                            ("lm_cli_test_weight_0", ["--lm-weight", "0"])):
            cli(path, ["--mode", "test", "--workdir", wd, "--decode-mode",
                       "beam", *extra])
            with open(os.path.join(wd, "test_results.json")) as f:
                results[path] = json.load(f)
        bundle = os.path.join(d, "bundle_cli")
        cli("lm_cli_export", ["--mode", "export", "--workdir", wd,
                              "--export-dir", bundle, "--export-buckets",
                              "4x96000", *lm_flags])
        with open(os.path.join(bundle, "meta.json")) as f:
            meta = json.load(f)
        run_cfg = load_config(os.path.join(wd, "config.yaml"))
        trainer, _ = make_trainer(run_cfg, wd, DEVICE)
        state, _ = trainer.ckpt.restore(map_location=DEVICE)
        adapted_p, _ = trainer.meta_adapt(
            state["params"], trainer.heldout_datasets["tango"], seed=0)
        adapted_npz = os.path.join(d, "adapted.npz")
        save_params_npz(adapted_npz, adapted_p, run_cfg.model.num_heads)
        wavs = [os.path.join(data, "wav", "tango", f"tango_000{i}.wav")
                for i in range(4)]
        served = [json.loads(line) for line in cli("lm_cli_serve", [
            "--mode", "serve", "--bundle", bundle, "--wav", *wavs,
            "--serve-params", adapted_npz]).splitlines()]

    m, bsz = run_cfg.meta, run_cfg.data.batch_size
    eval_batches = -(-min(8, utts - m.k_support) // bsz)
    zero = {"k2b": 0, "k3": 0, "k3b": 0}
    want = {
        "lm_train_lm": {"k1": 0, "k2": 0, "k2b": 0,
                        "k3": LM_STEPS * LM_DIMS["layers"],
                        "k3b": LM_STEPS * LM_DIMS["layers"]},
        "lm_fused_serving": {"k1": 5, "k2": 0, **zero},
        "lm_hot_swap": {"k1": 1, "k2": 0, **zero},
        "lm_cli_train": {
            "k1": steps * 2 * m.tasks_per_batch + 1 + eval_batches,
            "k2": steps * m.tasks_per_batch * (m.inner_steps + 1)
            + m.adapt_steps, **zero},
        "lm_cli_test": {"k1": -(-utts // bsz), "k2": 0, **zero},
        "lm_cli_test_weight_0": {"k1": -(-utts // bsz), "k2": 0, **zero},
        "lm_cli_export": {"k1": 0, "k2": 0, **zero},
        "lm_cli_serve": {"k1": 1, "k2": 0, **zero}}
    res["cli"] = {"config": "configs/config3_fomaml.yaml", "utts_per_accent":
                  utts, "heldout": "tango", "steps": steps,
                  "fused_evaluation": [{k: r[k] for k in (
                      "step", "heldout_tango_wer", "heldout_tango_cer")}
                      for r in evals],
                  "test_fused": results["lm_cli_test"],
                  "test_weight_0": results["lm_cli_test_weight_0"],
                  "export": {"has_lm": meta["has_lm"], "beam": meta["beam"]},
                  "served": served, "mode_seconds": {
                      k: v for k, v in seconds.items() if k != "train_lm"}}
    res["launches"] = counts
    res["launches_expected"] = want
    log(res)
    ok_train = (dims == LM_DIMS and len(nlls) == 10
                and all(map(math.isfinite, nlls)) and nlls[-1] < nlls[0])
    if not ok_train:
        raise SystemExit("train_lm failed: dims, logged NLL or its fall")
    k3 = res["kernels_at_lm_shape"]
    if not (k3["fwd_max_abs_diff"] <= LSTM_FWD_TOL
            and k3["dgx_l2rel"] <= LSTM_GRAD_L2REL
            and k3["du_l2rel"] <= LSTM_GRAD_L2REL
            and k3["max_abs_diff_to_kernel_layer"] <= 1e-4):
        raise SystemExit("K3/K3b disagree at the LM's shape")
    if not res["parity"]["ok"]:
        raise SystemExit("the LM's sequence/step or card/CPU parity failed")
    cvc = res["cuda_vs_cpu"]
    if not (cvc["same_text"] and cvc["max_score_diff"] <= PARITY_TOL):
        raise SystemExit("fused serving: cuda and cpu disagree")
    if not res["fused_serving"]["hot_swap_keeps_bundle_lm"]:
        raise SystemExit("a hot-swapped tree lost the bundle's LM")
    if not (meta["has_lm"] and meta["beam"]["lm_weight"] == LM_WEIGHT
            and len(evals) == 1 and math.isfinite(evals[0]["heldout_wer_mean"])
            and math.isfinite(results["lm_cli_test"]["tango"]["wer"])):
        raise SystemExit("the CLI's fused train / test / export failed")
    check_results(served, 4, CharTokenizer.ascii_default())
    if counts != want:
        raise SystemExit(f"LM fusion launch counts {counts}, want {want}")
    return res


# ------------------------------------------------------- the conformer ----

CONFORMER_SHAPE = (4, 16)   # phase 6's 4 x (16 + 16) cell
SHORT_SERVE_UTTS = 2        # the bundle's requests served on cuda and cpu


def config3_conformer():
    """config3 at full width with ``model.encoder: conformer`` (depthwise
    kernel 15) and the reference's conformer recipe, decoder-only inner
    adaptation (``meta.adapt_filter: decoder``)."""
    cfg, tok = config3_train()
    cfg.model.encoder, cfg.model.conformer_kernel = "conformer", 15
    cfg.meta.adapt_filter = "decoder"
    return cfg, tok


def conformer_step(torch, cfg, tok, mb, warmup, timed, profile=False):
    """``warmup`` + ``timed`` meta-steps (maml_grads + Adam/Noam) of
    ``cfg`` on ``mb`` from seeded weights, the launch counts zeroed first,
    and with ``profile`` one more step under the profiler -> readings
    (``grads``: the last step's gradients)."""
    from metaasr_tpu_torch.meta.maml import fold_in, maml_grads
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import algo_config
    from metaasr_tpu_torch.train.optimizer import apply_updates, make_optimizer

    task = ASRTask(cfg, tok.sos_eos_id, device=DEVICE)
    grad_fn = maml_grads(task.loss_fn, algo_config(cfg), task.preprocess)
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    st = {"params": task.init_params(0)}
    st["opt"] = opt.init(st["params"])
    losses = []

    def one_step(i):
        grads, metrics = grad_fn(st["params"], mb, fold_in(0, i))
        updates, st["opt"] = opt.update(grads, st["opt"], st["params"])
        st["params"] = apply_updates(st["params"], updates)
        losses.append(metrics["meta_loss"])
        st["grads"] = grads

    zero_counts()
    for i in range(warmup):
        one_step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup, warmup + timed):
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    prof = (device_busy(torch, lambda: one_step(warmup + timed))
            if profile else None)
    return {"steps": warmup + timed + int(profile), "times": times,
            "peak_mem_gb": peak / 1e9, "prof": prof,
            "meta_loss": [float(x) for x in losses], "grads": st["grads"],
            "launches": all_counts()}


def conformer_cli(torch):
    """The CLI at config3 width with ``-o model.encoder=conformer`` on phase
    14's corpus: train (2 steps, one held-out evaluation) -> adapt
    --use-best (beam) -> test (beam) -> export -> serve the bundle without
    and with --config; then the bundle's weights served at fp32 compute on
    cuda and on the cpu (strict fp32), two short requests."""
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.data.audio_io import load_wav
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.serve.export import ServingDecoder

    config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "config3_fomaml.yaml")
    steps, draws, eval_utts, utts = 2, 1, 8, 16
    seconds, counts = {}, {}

    def cli(path, argv):
        zero_counts()
        out, seconds[path] = run_cli(argv)
        counts[path] = all_counts()
        return out

    with tempfile.TemporaryDirectory() as d:
        data, wd = os.path.join(d, "data"), os.path.join(d, "wd")
        generate_dataset(data, utts_per_accent=utts, words_per_utt=(2, 4),
                         seed=0)
        cli("conformer_cli_train", [
            "--mode", "train", "--config", config_path, "--data-dir", data,
            "--workdir", wd, "--max-steps", str(steps),
            "-o", "model.encoder=conformer",
            "-o", "data.heldout_accents=tango",
            "-o", f"train.eval_every={steps}",
            "-o", f"train.eval_support_draws={draws}",
            "-o", f"train.eval_max_utts={eval_utts}",
            "-o", "train.eval_decode_mode=beam", "-o", "train.log_every=1",
            "-o", "train.ckpt_every=1000"])
        with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        cfg_run = load_config(os.path.join(wd, "config.yaml"))
        cli("conformer_cli_adapt", ["--mode", "adapt", "--workdir", wd,
                                    "--use-best", "--decode-mode", "beam"])
        with open(os.path.join(wd, "adapt_results.json")) as f:
            adapt_results = json.load(f)
        cli("conformer_cli_test", ["--mode", "test", "--workdir", wd,
                                   "--decode-mode", "beam"])
        with open(os.path.join(wd, "test_results.json")) as f:
            test_results = json.load(f)
        bundle = os.path.join(d, "bundle")
        export = json.loads(cli("conformer_cli_export", [
            "--mode", "export", "--workdir", wd, "--export-dir", bundle,
            "--export-buckets", "4x96000"]))
        with open(os.path.join(bundle, "meta.json")) as f:
            meta = json.load(f)
        wavs = [os.path.join(data, "wav", "tango", f"tango_000{i}.wav")
                for i in range(4)]
        served = {}
        for path, extra in (("conformer_cli_serve_bundle", []),
                            ("conformer_cli_serve_bundle_config",
                             ["--config", os.path.join(wd, "config.yaml")])):
            served[path] = [json.loads(line) for line in cli(path, [
                "--mode", "serve", "--bundle", bundle, "--wav", *wavs,
                "--dump-nbest", "2", *extra]).splitlines()]
        # the bundle's weights at fp32 compute on both devices: bf16 rounds
        # differently on the two, and 1e-4 is phase 4's fp32 bar
        fp32_bundle = os.path.join(d, "bundle_fp32")
        shutil.copytree(bundle, fp32_bundle)
        meta["model"]["dtype"] = "float32"
        with open(os.path.join(fp32_bundle, "meta.json"), "w") as f:
            json.dump(meta, f)
        short = [load_wav(w) for w in wavs[:SHORT_SERVE_UTTS]]
        with strict_fp32():
            on = {dev: ServingDecoder(fp32_bundle, device=dev)
                  for dev in (DEVICE, "cpu")}
            t0 = time.perf_counter()
            got = [on[DEVICE].transcribe([x], nbest=2)[0] for x in short]
            cuda_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = [on["cpu"].transcribe([x], nbest=2)[0] for x in short]
            cpu_s = time.perf_counter() - t0
    same_text = all(
        g["text"] == w["text"]
        and [x["hyp"] for x in g["nbest"]] == [x["hyp"] for x in w["nbest"]]
        for g, w in zip(got, want))
    score_err = max(abs(a["score"] - b["score"])
                    for g, w in zip(got, want)
                    for a, b in zip(g["nbest"], w["nbest"]))
    m, bsz = cfg_run.meta, cfg_run.data.batch_size
    eval_batches = draws * -(-min(eval_utts, utts - m.k_support) // bsz)
    zero = {"k2b": 0, "k3": 0, "k3b": 0}
    want_counts = {
        "conformer_cli_train": {
            "k1": steps * 2 * m.tasks_per_batch + draws + eval_batches,
            "k2": steps * m.tasks_per_batch * (m.inner_steps + 1)
            + draws * m.adapt_steps, **zero},
        "conformer_cli_adapt": {"k1": 1 + -(-(utts - m.k_support) // bsz),
                                "k2": m.adapt_steps, **zero},
        "conformer_cli_test": {"k1": -(-utts // bsz), "k2": 0, **zero},
        "conformer_cli_export": {"k1": 0, "k2": 0, **zero},
        "conformer_cli_serve_bundle": {"k1": 1, "k2": 0, **zero},
        "conformer_cli_serve_bundle_config": {"k1": 1, "k2": 0, **zero}}
    evals = [r for r in recs if "heldout_wer_mean" in r]
    out = {"encoder": meta["model"]["encoder"],
           "conformer_kernel": meta["model"]["conformer_kernel"],
           "recorded_encoder": cfg_run.model.encoder,
           "steps": steps, "meta_loss": [r.get("meta_loss") for r in recs
                                         if "meta_loss" in r],
           "heldout_wer": [r["heldout_wer_mean"] for r in evals],
           "adapt": adapt_results, "test": test_results, "export": export,
           "served": served["conformer_cli_serve_bundle"],
           "mode_seconds": seconds,
           "cuda_cpu_fp32": {"same_text": same_text,
                             "max_score_diff": score_err,
                             "tolerance": PARITY_TOL, "cuda_s": cuda_s,
                             "cpu_s": cpu_s,
                             "texts": [g["text"] for g in got]},
           "launches": counts, "launches_expected": want_counts}
    return out, served, evals


def phase_conformer(torch, meta):
    """The conformer encoder at config3 width: the timed FOMAML step of
    the reference's conformer recipe (decoder-only inner adaptation) at
    4 x (16 + 16) beside phase 6's transformer cell ``meta``, one
    full-body FOMAML step, one second-order MAML step at config4's shape,
    then the CLI chain and cuda/cpu serving of its bundle."""
    import copy

    res = {"phase": "conformer",
           "model": {"encoder": "conformer", "conformer_kernel": 15,
                     "d_model": 256, "heads": 4, "d_ff": 2048,
                     "layers": [12, 6], "dtype": "bfloat16"}}
    cfg, tok = config3_conformer()
    m_tasks, k_shot = CONFORMER_SHAPE
    mb = bench_meta_batch(torch, m_tasks, k_shot, tok.vocab_size)
    inner = cfg.meta.inner_steps

    def want(r, meta):
        n = r["steps"] * m_tasks
        return {"k1": n * 2,
                "k2": n * k2_per_task(meta.inner_steps, meta.algo,
                                      meta.remat_inner),
                "k2b": n * meta.inner_steps if meta.algo == "maml" else 0,
                "k3": 0, "k3b": 0}

    # (1) the timed step of the recipe, 1 warm-up, 5 timed, 1 profiled
    r = conformer_step(torch, cfg, tok, mb, 1, 5, profile=True)
    ms = statistics.median(r["times"])
    prof = r["prof"]
    cell6 = next(c for c in meta["cells"]
                 if (c["tasks"], c["shots"]) == CONFORMER_SHAPE)
    p6 = cell6["profiled_step"]
    res["fomaml_anil_decoder"] = {
        "adapt_filter": cfg.meta.adapt_filter, "inner_steps": inner,
        "grad_dtype": cfg.meta.grad_dtype, "specaug": True,
        "tasks": m_tasks, "shots": k_shot, "steps": r["steps"],
        "ms_per_step": ms, "ms_per_step_all": r["times"],
        "unique_utts_per_s": m_tasks * 2 * k_shot / (ms / 1e3),
        "presentations_per_s": m_tasks * (k_shot * inner + k_shot)
        / (ms / 1e3),
        "peak_mem_gb": r["peak_mem_gb"],
        "profiled_step": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                          "cuda_kernels": prof[2],
                          "top_kernels_ms": prof[3]},
        "device_busy_share": None if prof[1] is None else prof[1] / ms,
        "vs_phase6_transformer_4x16": {
            "ms_per_step": cell6["ms_per_step"],
            "cuda_kernels": p6["cuda_kernels"],
            "device_busy_ms": p6["device_busy_ms"],
            "ratio_ms": ms / cell6["ms_per_step"],
            "ratio_kernels": prof[2] / p6["cuda_kernels"],
            "ratio_busy_ms": (None if None in (prof[1], p6["device_busy_ms"])
                              else prof[1] / p6["device_busy_ms"])},
        "meta_loss": r["meta_loss"],
        "launches": r["launches"], "launches_expected": want(r, cfg.meta)}
    del r

    # (2) one untimed full-body FOMAML step: the inner backward runs
    # through the conformer
    full = copy.deepcopy(cfg)
    full.meta.adapt_filter = ""
    r = conformer_step(torch, full, tok, mb, 0, 1)
    res["fomaml_full_body"] = {
        "steps": r["steps"], "ms": r["times"][0], "meta_loss": r["meta_loss"],
        "launches": r["launches"], "launches_expected": want(r, full.meta)}
    del r

    # (3) one second-order MAML step at config4's shape (full body)
    maml = copy.deepcopy(full)
    maml.meta.algo, maml.meta.inner_steps = "maml", 2
    r = conformer_step(torch, maml, tok, mb, 0, 1)
    g = r["grads"]
    leaf_max = {k: float(g[k].abs().max()) for k in (
        "encoder.layers.0.self_attn.u_bias",
        "encoder.layers.0.conv.depthwise.weight")}
    res["maml_second_order"] = {
        "inner_steps": 2, "remat_inner": maml.meta.remat_inner,
        "steps": r["steps"], "ms": r["times"][0],
        "peak_mem_gb": r["peak_mem_gb"],
        # a note, not a gate: this step's peak without the recompute, read
        # in another run (NVIDIA H100 80GB HBM3, 700 W)
        "peak_mem_gb_no_remat_earlier": 7.16, "meta_loss": r["meta_loss"],
        "grads_finite": all(bool(torch.isfinite(v).all())
                            for v in g.values()),
        "conformer_leaf_grad_max": leaf_max,
        "launches": r["launches"], "launches_expected": want(r, maml.meta)}
    del r, g, mb
    torch.cuda.empty_cache()

    # (4) the CLI chain and cuda/cpu serving of its bundle
    cli, served, evals = conformer_cli(torch)
    res["cli"] = cli
    log(res)

    for name in ("fomaml_anil_decoder", "fomaml_full_body",
                 "maml_second_order"):
        part = res[name]
        if not all(math.isfinite(v) for v in part["meta_loss"]):
            raise SystemExit(f"conformer {name}: non-finite meta loss")
        if part["launches"] != part["launches_expected"]:
            raise SystemExit(f"conformer {name} launch counts "
                             f"{part['launches']}, want "
                             f"{part['launches_expected']}")
    mm = res["maml_second_order"]
    if not (mm["grads_finite"]
            and all(v > 0 for v in mm["conformer_leaf_grad_max"].values())):
        raise SystemExit(f"conformer MAML gradients: finite "
                         f"{mm['grads_finite']}, u_bias / depthwise max "
                         f"{mm['conformer_leaf_grad_max']}")
    if not (cli["encoder"] == cli["recorded_encoder"] == "conformer"
            and cli["conformer_kernel"] == 15 and len(evals) == 1
            and all(math.isfinite(v) for v in cli["heldout_wer"])
            and all(math.isfinite(v) for v in cli["meta_loss"])):
        raise SystemExit("the conformer CLI's train / evaluation failed")
    if served["conformer_cli_serve_bundle"] != \
            served["conformer_cli_serve_bundle_config"]:
        raise SystemExit("the conformer bundle served without --config "
                         "disagrees with the bundle served with it")
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer

    check_results(served["conformer_cli_serve_bundle"], 4,
                  CharTokenizer.ascii_default())
    par = cli["cuda_cpu_fp32"]
    if not (par["same_text"] and par["max_score_diff"] <= PARITY_TOL):
        raise SystemExit("cuda and cpu serving of the conformer bundle "
                         "disagree")
    if cli["launches"] != cli["launches_expected"]:
        raise SystemExit(f"conformer CLI launch counts {cli['launches']}, "
                         f"want {cli['launches_expected']}")
    return res


# ------------------------------------------------ the headline bench ----

BENCH_STEPS = 1         # steps a pass in phase 20 (the record's: 10 / 20)
SWEEP_STEPS = 1
BENCH_WARMUP = 1        # bench.measure's warm-up steps there (the rule's: 3)
BENCH_MAX_PASSES = 2    # and its timed passes (the rule's: up to 8)
BASELINE_STEPS = 1      # timed steps a baseline pass takes (theirs: 2, 8)
BENCH_WORKLOAD = {"tasks": 4, "k_support": 16, "k_query": 16,
                  "inner_steps": 3, "audio_sec": 4.0}   # bench.py:309-311


def run_main(main, argv) -> tuple[int, list, float]:
    """``main(argv)`` of a port script in this process, its standard output
    captured -> (exit code, the JSON lines it printed, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, lines, time.perf_counter() - t0


def phase_bench(torch, smi):
    """The headline bench's ``main`` and the sweep's, in this process, as a
    user runs them, cut in depth by their ``measure`` and
    ``baseline_steps`` keywords; exact launch counts for every
    ``bench.measure`` they call."""
    from metaasr_tpu_torch.scripts import bench, sweep_throughput

    out = {"phase": "bench", "measures": []}

    def measure(*args, **kwargs):
        kwargs.update(warmup=BENCH_WARMUP, max_passes=BENCH_MAX_PASSES)
        before = all_counts()
        t0 = time.perf_counter()
        r = bench.measure(*args, **kwargs)
        after = all_counts()
        m = kwargs.get("m_tasks", bench.M_TASKS)
        k = kwargs.get("k_shot", bench.K_SUPPORT)
        n = r["steps_run"]
        out["measures"].append({
            "tasks": m, "shots": k, **r,
            "unique_utts_per_sec": r["presentations_per_sec"] * 2 * k
            / (k * bench.INNER_STEPS + k),
            "seconds": round(time.perf_counter() - t0, 1),
            "launches": {c: after[c] - before[c] for c in after},
            "launches_expected": {"k1": n * 2 * m,
                                  "k2": n * m * (bench.INNER_STEPS + 1),
                                  "k3": 0, "k3b": 0, "k2b": 0}})
        return r

    zero_counts()
    # (a) the record: both measurements and both baselines
    rc, lines, sec = run_main(
        functools.partial(bench.main, measure_fn=measure,
                          baseline_steps=BASELINE_STEPS),
        ["--steps", str(BENCH_STEPS)])
    out["record"] = {"rc": rc, "seconds": round(sec, 1),
                     "line": lines[-1] if lines else None}
    out["launches"] = all_counts()
    torch.cuda.empty_cache()
    # (b) the sweep at one point
    rc_s, lines_s, sec_s = run_main(
        functools.partial(sweep_throughput.main, measure=measure),
        ["--points", "4x4", "--steps", str(SWEEP_STEPS)])
    out["sweep"] = {"rc": rc_s, "seconds": round(sec_s, 1),
                    "lines": lines_s}
    torch.cuda.empty_cache()
    log(out)

    for m in out["measures"]:
        if m["launches"] != m["launches_expected"]:
            raise SystemExit(f"bench launch counts {m['launches']}, want "
                             f"{m['launches_expected']}")
        if not (math.isfinite(m["meta_loss"]) and 0 < m["mfu"] <= 1):
            raise SystemExit(f"bench: meta loss {m['meta_loss']}, mfu "
                             f"{m['mfu']}")
    rec = out["record"]["line"]
    if len(out["measures"]) != 3 or rec is None or out["record"]["rc"]:
        raise SystemExit(f"the bench exited {out['record']['rc']} after "
                         f"{len(out['measures'])} measurements")

    def positive(x):
        return isinstance(x, (int, float)) and math.isfinite(x) and x > 0

    if not (rec["unit"] == "unique_utts/s/chip"
            and all(positive(rec[k]) for k in (
                "value", "mfu", "vs_baseline", "vs_samechip_sequential"))
            and rec["mfu"] <= 1 and rec["workload"] == BENCH_WORKLOAD
            and rec["device"]["name"] == smi.rsplit(",", 1)[0].strip()):
        raise SystemExit(f"the bench's record is not as the contract says: "
                         f"{rec}")
    rows = [x for x in lines_s if "summary" not in x]
    if not (rc_s == 0 and len(rows) == 1 and "error" not in rows[0]
            and lines_s[-1].get("summary")):
        raise SystemExit(f"the sweep failed: {lines_s}")
    return out


# ------------------------------------------------ the serving benches ----

SERVE_BENCH_BATCHES = 2     # serve_bench's batches in phase 21 (default 8):
PIPELINED_BATCHES = 2       # measure_pipelined's (8); two, so a batch is in
                            # flight when the next is dispatched
BENCH_PASSES = 1            # timed passes of each reading (default 3)
BATCHER_LOADS = (0.5,)  # offered loads, x serve_bench's pipelined rate
BATCHER_SECS = 2
BATCHER_IDLE_REQUESTS = 2   # lone requests at idle (default 10)
SERVING_BENCHES_BUDGET_S = 150


def phase_serving_benches(torch, smi):
    """decode_bench, serve_bench and batcher_bench at full width, cut by
    their keyword arguments and flags; exact (zero) launch counts."""
    from metaasr_tpu_torch.scripts import (batcher_bench, decode_bench,
                                           serve_bench)

    t0 = time.perf_counter()
    sub = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        sub[name] = round(time.perf_counter() - t, 1)
        return out

    zero_counts()
    decode = [timed("decode_b16", decode_bench.measure, 16,
                    passes=BENCH_PASSES),
              timed("decode_b16_lm", decode_bench.measure, 16,
                    lm_weight=0.3, passes=BENCH_PASSES),
              timed("decode_b16_v512", decode_bench.measure, 16, vocab=512,
                    ctc_candidates=40, passes=BENCH_PASSES)]
    pipelined = timed("pipelined", decode_bench.measure_pipelined, 16,
                      nbatches=PIPELINED_BATCHES, passes=BENCH_PASSES)
    torch.cuda.empty_cache()
    serve = timed("serve_bench", serve_bench.measure,
                  batches=SERVE_BENCH_BATCHES, passes=BENCH_PASSES)
    torch.cuda.empty_cache()
    rates = [round(f * serve["pipelined_utts_per_sec"], 2)
             for f in BATCHER_LOADS]
    rc, lines, sec = run_main(batcher_bench.main, [
        "--loads", ",".join(str(r) for r in rates), "--secs",
        str(BATCHER_SECS), "--idle-requests", str(BATCHER_IDLE_REQUESTS)])
    sub["batcher_bench"] = round(sec, 1)
    launches = all_counts()
    torch.cuda.empty_cache()
    legs = [x for x in lines if "offered_utts_per_sec" in x]
    seconds = time.perf_counter() - t0
    out = {"phase": "serving_benches", "card": smi, "decode": decode,
           "pipelined": pipelined, "serve": serve,
           "batcher": {"rc": rc, "seconds": round(sec, 1),
                       "loads": rates, "secs": BATCHER_SECS,
                       "idle_requests": BATCHER_IDLE_REQUESTS,
                       "lines": lines},
           "passes": BENCH_PASSES, "launches": launches,
           "seconds_by_call": sub, "seconds": round(seconds, 1),
           "budget_s": SERVING_BENCHES_BUDGET_S}
    log(out)
    if any(launches.values()):
        raise SystemExit(f"the serving benches launched kernels: {launches}")
    for r in decode:
        if r["hyp_lengths"] != [decode_bench.STEPS] * 2:
            raise SystemExit(f"a decode row stopped short of the forced "
                             f"length: {r}")
    if not pipelined["packed_equals_dict"]:
        raise SystemExit("the packed read-back differs from the dict one")
    if not serve["sync_pipelined_texts_equal"]:
        raise SystemExit("sync and pipelined serving gave other texts")
    if not (rc == 0 and len(legs) == len(rates)
            and all(x["completed"] == x["sent"] for x in legs)
            and any("deadline_adherence" in x for x in lines)
            and any("saturation_utts_per_sec" in x for x in lines)):
        raise SystemExit(f"the batcher bench failed or left requests "
                         f"unanswered: {lines}")
    return out


# ------------------------------------------------- the quality scripts ----

CONFIG2_YAML = "configs/config2_multitask_transformer.yaml"
CONFIG2_STEPS = 8           # train.max_steps of config2's CLI run
DEMO_STEPS = 2              # demo_meta_adaptation --steps (default 800)
DEMO_UTTS = 24              # its --utts-per-accent (default 192)
KSHOT_TRAIN_STEPS = 2       # steps of each workdir kshot_curve restores
KSHOT_KS = (0, 5)           # a zero-shot point and an adapted one
KSHOT_DRAWS = 2
KSHOT_MAX_UTTS = 16
QUALITY_BUDGET_S = 150
SMALL_WIDTH = {"model.d_model": 32, "model.num_heads": 2, "model.d_ff": 64,
               "model.num_encoder_layers": 2, "model.num_decoder_layers": 2}


@contextlib.contextmanager
def launches_per_call(cls, name, record: dict):
    """Wrap ``cls.name`` (a class's method or a module's function) so that
    each call appends its launch counts (the counters' growth over the
    call) to ``record["Cls.name"]`` (a module by its last name part)."""
    own = cls.__dict__.get(name)
    fn = getattr(cls, name)
    key = f"{cls.__name__.rsplit('.', 1)[-1]}.{name}"

    def wrapped(*args, **kwargs):
        before = all_counts()
        out = fn(*args, **kwargs)
        after = all_counts()
        record.setdefault(key, []).append(
            {k: after[k] - before[k] for k in after})
        return out

    setattr(cls, name, wrapped)
    try:
        yield
    finally:
        if own is None:
            delattr(cls, name)
        else:
            setattr(cls, name, own)


def decode_batches(n: int, bsz: int, max_utts: int) -> int:
    """Batches ``MetaASRTrainer.decode`` runs over n utterances: one K1
    launch each."""
    return -(-min(n, max_utts) // bsz)


def kernel_counts(k1=0, k2=0) -> dict:
    """all_counts()'s layout: K1 and K2 as given, no K2b/K3/K3b."""
    return {"k1": k1, "k2": k2, "k3": 0, "k3b": 0, "k2b": 0}


def config2_parity(torch, data) -> dict:
    """One config2 step at the port tests' width (fp32, dropout 0,
    SpecAugment off, dither 0) on cuda against the same step on the cpu
    from the same weights and batch: loss within rtol 1e-4, grad_norm
    within rtol 1e-3."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.train.meta_train import to_device

    over = {**SMALL_WIDTH, "model.dtype": "float32", "model.dropout": 0.0,
            "specaug.enabled": False, "frontend.dither": 0.0,
            "data.data_dir": data}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cpu", DEVICE):
            tr, _ = make_trainer(load_config(CONFIG2_YAML, dict(over)),
                                 os.path.join(d, dev), dev)
            if dev == "cpu":
                state = tr.init_state()
                params = state["params"]
                batch = next(tr.batcher.iter_from(0))
            else:
                p = {k: v.to(dev) for k, v in params.items()}
                state = dict(state, params=p, opt_state=tr.optimizer.init(p))
            _, m = tr.step(state, to_device(batch, dev))
            out[dev] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    out["loss_rel_diff"] = abs(out[DEVICE]["loss"] / out["cpu"]["loss"] - 1)
    out["grad_norm_rel_diff"] = abs(
        out[DEVICE]["grad_norm"] / out["cpu"]["grad_norm"] - 1)
    out["ok"] = out["loss_rel_diff"] <= 1e-4 \
        and out["grad_norm_rel_diff"] <= 1e-3
    return out


def quality_config2(torch, data) -> dict:
    """configs/config2_multitask_transformer.yaml at full width through
    ``cli.main --mode train`` for CONFIG2_STEPS steps; one more step of the
    restored state under the profiler."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.train.meta_train import to_device

    with strict_fp32():
        parity = config2_parity(torch, data)
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "wd")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        stdout, secs = run_cli(["--config", CONFIG2_YAML, "--mode", "train",
                                "--data-dir", data, "--workdir", wd,
                                "-o", f"train.max_steps={CONFIG2_STEPS}",
                                "-o", "train.log_every=1"])
        counts = all_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        cfg = load_config(CONFIG2_YAML, {"data.data_dir": data})
        trainer, _ = make_trainer(cfg, wd, DEVICE)
        state, at = trainer.ckpt.restore(map_location=DEVICE)
        batch = to_device(next(trainer.batcher.iter_from(at)), DEVICE)
        st = {"state": state}

        def one_step():
            st["state"], _ = trainer.step(st["state"], batch)

        one_step()
        prof = device_busy(torch, one_step)
    bsz = cfg.data.batch_size
    step_ms = [1e3 * bsz / r["utts_per_sec"] for r in recs]
    ms = statistics.median(step_ms[2:])
    m = cfg.model
    return {"config": CONFIG2_YAML, "trainer": type(trainer).__name__,
            "model": {"d_model": m.d_model, "layers": [
                m.num_encoder_layers, m.num_decoder_layers],
                "dtype": m.dtype, "vocab": m.vocab_size},
            "batch": bsz, "noam_warmup": cfg.optimizer.warmup_steps,
            "steps": len(recs), "restored_step": at, "cli_seconds": secs,
            "cli_stdout": stdout.strip().splitlines()[-1:],
            "loss": [r["loss"] for r in recs],
            "ms_per_step_logged": step_ms,
            "ms_per_step_median_3_8": ms, "utts_per_s": bsz / (ms / 1e3),
            "peak_mem_gb": peak / 1e9,
            "profiled_step": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                              "cuda_kernels": prof[2],
                              "top_kernels_ms": prof[3]},
            "device_busy_share": None if prof[1] is None else prof[1] / ms,
            "launches": counts,
            "launches_expected": kernel_counts(CONFIG2_STEPS, CONFIG2_STEPS),
            "parity_small_cuda_vs_cpu": parity}


def quality_demo(data, work) -> dict:
    """demo_meta_adaptation.main at its own width, cut by --steps and
    --utts-per-accent; launch counts per trainer call."""
    import io

    from metaasr_tpu_torch.data.dataset import Manifest
    from metaasr_tpu_torch.scripts import demo_meta_adaptation as demo
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    out_md = os.path.join(work, "RESULTS_demo.md")
    calls = {}
    t0 = time.perf_counter()
    zero_counts()
    with contextlib.ExitStack() as stack:
        for cls, name in ((MetaASRTrainer, "meta_train"),
                          (MultitaskASRTrainer, "train"),
                          (MetaASRTrainer, "meta_adapt"),
                          (MetaASRTrainer, "decode")):
            stack.enter_context(launches_per_call(cls, name, calls))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = demo.main(["--steps", str(DEMO_STEPS), "--utts-per-accent",
                             str(DEMO_UTTS), "--data-dir", data, "--workdir",
                             os.path.join(work, "demo_runs"), "--out",
                             out_md])
    total = all_counts()
    seconds = time.perf_counter() - t0
    with open(out_md) as f:
        md = f.read()
    # the counts the demo's code gives (scripts/demo_meta_adaptation.py)
    cfg = demo.make_cfg("fomaml", DEMO_STEPS)
    m, bsz = cfg.meta, cfg.data.batch_size
    n = len(Manifest.load(os.path.join(data, f"{demo.HELDOUT}.jsonl")).utts)
    zs = decode_batches(n - max(m.k_support, 8), bsz, 64)
    test = decode_batches(n - m.k_support, bsz, 64)
    want = {"MetaASRTrainer.meta_train": [kernel_counts(
                DEMO_STEPS * 2 * m.tasks_per_batch,
                DEMO_STEPS * m.tasks_per_batch * (m.inner_steps + 1))],
            "MultitaskASRTrainer.train": [
                kernel_counts(DEMO_STEPS, DEMO_STEPS)],
            "MetaASRTrainer.meta_adapt": [kernel_counts(1, 5)] * 4,
            "MetaASRTrainer.decode": [kernel_counts(b) for b in (
                zs, test, test, test) * 2]}
    want_total = {k: sum(c[k] for cs in want.values() for c in cs)
                  for k in total}
    rows = [line for line in md.splitlines()
            if line.startswith(("| fomaml |", "| multi |"))]
    wers = [v["wer"] for e in res.values() for v in e.values()
            if isinstance(v, dict)]
    return {"steps": DEMO_STEPS, "utts_per_accent": DEMO_UTTS,
            "heldout_utts": n, "seconds": seconds,
            "train_seconds": {a: e["train_seconds"] for a, e in res.items()},
            "rows": rows, "results": res, "launches": total,
            "launches_expected": want_total, "launches_per_call": calls,
            "launches_per_call_expected": want,
            "ok": (len(rows) == 2 and calls == want and total == want_total
                   and all(math.isfinite(w) for w in wers))}


def flagship_workdir(data, wd, algo, steps, device, tiny=False):
    """A workdir trained ``steps`` steps on ``device`` under the flagship
    recipe (at kshot_curve's ``--tiny`` width with ``tiny``), by the
    trainer kshot_curve restores it with -> the run's config."""
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.scripts import flagship_results as flagship
    from metaasr_tpu_torch.scripts import kshot_curve as kshot
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    tok = CharTokenizer.ascii_default()
    cfg = flagship.make_cfg(algo, steps, data)
    cfg.model.vocab_size = tok.vocab_size
    if tiny:
        flagship.apply_tiny(cfg)
    dsets = load_accent_datasets(data, tok)
    heldout = {flagship.HELDOUT: dsets.pop(flagship.HELDOUT)}
    task = ASRTask(cfg, tok.sos_eos_id, device=device)
    if algo == "multi":
        MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                            device=device).train()
    else:
        MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                       device=device).meta_train()
    return cfg


def quality_kshot(torch, data, work) -> dict:
    """Two workdirs (fomaml, multi) trained KSHOT_TRAIN_STEPS steps under
    the flagship recipe at config3 width, then kshot_curve.main over
    both."""
    import io

    from metaasr_tpu_torch.scripts import kshot_curve as kshot
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer

    runs, train, t0 = {}, {}, time.perf_counter()
    for algo in ("fomaml", "multi"):
        runs[algo] = os.path.join(work, f"kshot_{algo}")
        zero_counts()
        m = flagship_workdir(data, runs[algo], algo, KSHOT_TRAIN_STEPS,
                             DEVICE).meta
        want = (kernel_counts(KSHOT_TRAIN_STEPS, KSHOT_TRAIN_STEPS)
                if algo == "multi" else
                kernel_counts(KSHOT_TRAIN_STEPS * 2 * m.tasks_per_batch,
                              KSHOT_TRAIN_STEPS * m.tasks_per_batch
                              * (m.inner_steps + 1)))
        train[algo] = {"launches": all_counts(), "launches_expected": want}
    train_s = time.perf_counter() - t0
    out_json = os.path.join(work, "kshot_curve.json")
    calls, buf = {}, io.StringIO()
    t0 = time.perf_counter()
    zero_counts()
    with contextlib.ExitStack() as stack:
        for name in ("meta_adapt", "decode"):
            stack.enter_context(launches_per_call(MetaASRTrainer, name,
                                                  calls))
        stack.enter_context(contextlib.redirect_stdout(buf))
        res = kshot.main(["--runs", ",".join(f"{k}={v}"
                                             for k, v in runs.items()),
                          "--data-dir", data, "--ks",
                          ",".join(map(str, KSHOT_KS)), "--draws",
                          str(KSHOT_DRAWS), "--max-utts",
                          str(KSHOT_MAX_UTTS), "--out", out_json])
    total = all_counts()
    seconds = time.perf_counter() - t0
    with open(out_json) as f:
        saved = json.load(f)
    restored = {label: int(line.rsplit(" ", 1)[1])
                for line in buf.getvalue().splitlines()
                for label in runs if line.startswith(f"[{label}] restored")}
    adapt_steps = res["adapt_steps"]
    nonzero = [k for k in KSHOT_KS if k]
    want_k2 = adapt_steps * KSHOT_DRAWS * len(nonzero) * len(runs)
    want_k1 = len(runs) * (1 + 2 * KSHOT_DRAWS * len(nonzero))
    layout = (list(saved) == ["ks", "draws", "adapt_steps", *runs]
              and saved["ks"] == list(KSHOT_KS)
              and all(list(saved[r]) == [str(k) for k in KSHOT_KS]
                      and set(saved[r]["0"]) == {"mean", "std"}
                      and all(set(saved[r][str(k)]) == {"mean", "std",
                                                        "draws"}
                              and len(saved[r][str(k)]["draws"])
                              == KSHOT_DRAWS for k in nonzero)
                      for r in runs))
    wers = [v for r in runs for p in saved[r].values()
            for v in (p["mean"], *p.get("draws", ()))]
    return {"train_steps": KSHOT_TRAIN_STEPS, "train": train,
            "train_seconds": train_s, "ks": list(KSHOT_KS),
            "draws": KSHOT_DRAWS, "max_utts": KSHOT_MAX_UTTS,
            "seconds": seconds, "restored_steps": restored, "curve": saved,
            "layout_is_the_reference": layout, "launches": total,
            "launches_expected": kernel_counts(want_k1, want_k2),
            "launches_per_call": {k: len(v) for k, v in calls.items()},
            "ok": (saved == res and layout
                   and restored == dict.fromkeys(runs, KSHOT_TRAIN_STEPS)
                   and all(t["launches"] == t["launches_expected"]
                           for t in train.values())
                   and total == kernel_counts(want_k1, want_k2)
                   and all(math.isfinite(w) and w >= 0 for w in wers))}


def quality_cross_device(data, work) -> dict:
    """kshot_curve --tiny --ks 0 over a workdir written on the cpu, run on
    the card, and over one written on the card, run on the cpu: each
    restores its step 2 onto the run's device."""
    import io

    from metaasr_tpu_torch.scripts import kshot_curve as kshot

    out = {}
    zero_counts()
    for train_dev, run_dev in (("cpu", DEVICE), (DEVICE, "cpu")):
        wd = os.path.join(work, f"tiny_{train_dev}")
        flagship_workdir(data, wd, "fomaml", 2, train_dev, tiny=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = kshot.main(["--runs", f"fomaml={wd}", "--data-dir", data,
                              "--tiny", "--ks", "0", "--max-utts", "4",
                              "--device", run_dev, "--out",
                              os.path.join(work, f"tiny_{train_dev}.json")])
        wer = res["fomaml"]["0"]["mean"]
        out[f"written_{train_dev}_run_{run_dev}"] = {
            "restored_step_2": "[fomaml] restored step 2" in buf.getvalue(),
            "zero_shot_beam_wer": wer}
    # on the card: 2 tiny FOMAML steps (2 tasks, 3 inner steps) and one
    # decode batch
    return {"runs": out, "launches": all_counts(),
            "launches_expected": kernel_counts(2 * 2 * 2 + 1, 2 * 2 * 4),
            "ok": all(r["restored_step_2"] and math.isfinite(
                r["zero_shot_beam_wer"]) for r in out.values())}


def quality_paths(quality, k) -> dict:
    """Phase 22's launches of kernel ``k`` by path."""
    kshot = quality["kshot"]
    return {"config2_cli_train": quality["config2"]["launches"][k],
            "demo_meta_adaptation": quality["demo"]["launches"][k],
            "kshot_train": sum(t["launches"][k]
                               for t in kshot["train"].values()),
            "kshot_curve": kshot["launches"][k],
            "kshot_cross_device": quality["cross_device"]["launches"][k]}


def phase_quality_scripts(torch, smi):
    """config2 through the CLI at full width, the demo at its own width and
    the k-shot curve at config3 width, in this process; exact launch
    counts."""
    from metaasr_tpu_torch.data.synthetic import generate_dataset

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        data2 = os.path.join(work, "config2_data")
        generate_dataset(data2, utts_per_accent=DEMO_UTTS,
                         words_per_utt=(2, 4), seed=0)
        config2 = quality_config2(torch, data2)
        torch.cuda.empty_cache()
        data = os.path.join(work, "demo_data")   # the demo makes it
        demo = quality_demo(data, work)
        torch.cuda.empty_cache()
        kshot = quality_kshot(torch, data, work)
        cross = quality_cross_device(data, work)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    out = {"phase": "quality_scripts", "card": smi, "config2": config2,
           "demo": demo, "kshot": kshot, "cross_device": cross,
           "seconds": round(seconds, 1),
           "budget_s": QUALITY_BUDGET_S}
    log(out)
    if not config2["parity_small_cuda_vs_cpu"]["ok"]:
        raise SystemExit("config2's small step on cuda differs from the cpu")
    if not (all(math.isfinite(v) for v in config2["loss"])
            and config2["steps"] == CONFIG2_STEPS
            and config2["restored_step"] == CONFIG2_STEPS
            and config2["trainer"] == "MultitaskASRTrainer"):
        raise SystemExit("config2's CLI run failed")
    if config2["launches"] != config2["launches_expected"]:
        raise SystemExit(f"config2 launch counts {config2['launches']}, "
                         f"want {config2['launches_expected']}")
    if not demo["ok"]:
        raise SystemExit("demo_meta_adaptation: rows, WERs or launch counts "
                         "differ from what its code gives")
    if not kshot["ok"]:
        raise SystemExit("kshot_curve: restore, layout, WERs or launch "
                         "counts differ from what its code gives")
    if not (cross["ok"] and cross["launches"] == cross["launches_expected"]):
        raise SystemExit("kshot_curve did not restore across devices, or "
                         "its launch counts differ")
    return out


# --------------------------------------------- the flagship quality table ----

FLAGSHIP_STEPS = 2          # flagship_results --steps (default 1500)
FLAGSHIP_UTTS = 16          # its --utts-per-accent (default 192)
FLAGSHIP_BUDGET_S = 150
FLAGSHIP_CALLS = (          # (name, flags): the arms, Meta-SGD, --eval-only
    ("arms", ("--algos", "fomaml,maml,reptile,multi")),
    ("metasgd", ("--algos", "fomaml", "--learn-inner-lr")),
    ("eval_only", ("--algos", "fomaml", "--eval-only")))


def flagship_expected(flagship, argv, n_heldout: int) -> tuple[dict, dict]:
    """The launches each trainer call of one ``flagship_results.main(argv)``
    makes, from the code -> ({"Cls.method": [counts, ...]}, {tag: keys of
    its results entry}). Per step: FOMAML / Meta-SGD K1 2·M, K2
    M·(inner+1); MAML K1 2·M, K2 M·(2·inner+1) with ``remat_inner`` (the
    recompute) and K2b M·inner; Reptile K1 2·M, K2 M·inner
    (its inner steps on support + query at once, no query backward);
    multitask K1 1, K2 1. Each adaptation K1 1, K2 5; each decode batch
    K1 1."""
    args = flagship.build_parser().parse_args(argv)
    calls, layout = {}, {}
    entry = {"zero_shot_greedy", "zero_shot_beam", "adapt5_greedy",
             "adapt5_beam", "adapt5_beam_draws", "train_seconds"}
    for algo in args.algos.split(","):
        cfg = flagship.arm_config(args, algo, "", 30)
        m, n = cfg.meta, args.steps
        k2b = 0
        if algo == "multi":
            name, k1, k2 = "MultitaskASRTrainer.train", n, n
            cfg = flagship.make_cfg("fomaml", n, "")   # the evaluation's
        else:
            name, k1 = "MetaASRTrainer.meta_train", n * 2 * m.tasks_per_batch
            k2 = n * m.tasks_per_batch * k2_per_task(m.inner_steps, algo,
                                                     m.remat_inner)
            if algo == "maml":
                k2b = n * m.tasks_per_batch * m.inner_steps
        if algo == "multi" or not args.eval_only:
            calls.setdefault(name, []).append(
                {**kernel_counts(k1, k2), "k2b": k2b})
        avg = algo == "fomaml" and not args.eval_only
        bsz = cfg.data.batch_size
        zs = decode_batches(n_heldout - 8 if n_heldout > 8 else n_heldout,
                            bsz, 64)
        test = decode_batches(n_heldout - cfg.meta.k_support, bsz, 64)
        seeds = len(flagship.ADAPT_SEEDS) * (2 if avg else 1)
        calls.setdefault("MetaASRTrainer.meta_adapt", []).extend(
            [kernel_counts(1, 5)] * seeds)
        calls.setdefault("MetaASRTrainer.decode", []).extend(
            [kernel_counts(b) for b in [zs, zs] + [test] * (
                2 * len(flagship.ADAPT_SEEDS)
                + (len(flagship.ADAPT_SEEDS) if avg else 0))])
        layout[flagship.arm_tag(args, algo)] = (
            entry | {"adapt5_beam_avglast5"} if avg else entry)
    return calls, layout


def flagship_entry_ok(entry: dict, keys: set, draws: int) -> bool:
    """The reference's keys, ``draws`` beam draws, every WER finite."""
    wers = [entry["zero_shot_greedy"]["wer"], entry["zero_shot_beam"]["wer"],
            *entry["adapt5_beam_draws"]]
    wers += [entry[k][s] for k in ("adapt5_greedy", "adapt5_beam",
                                   "adapt5_beam_avglast5")
             if k in entry for s in ("mean", "std")]
    return (set(entry) == keys and len(entry["adapt5_beam_draws"]) == draws
            and all(math.isfinite(w) and w >= 0 for w in wers))


def phase_flagship(torch, smi, beside=None):
    """flagship_results.main at config3 width, in this process, on a fresh
    corpus and workdir: the four arms, Meta-SGD, and --eval-only over the
    arms' FOMAML workdir; exact launch counts per trainer call. ``beside``:
    what else runs on the card and the host meanwhile, printed with the
    seconds."""
    import io

    from metaasr_tpu_torch.data.dataset import Manifest
    from metaasr_tpu_torch.scripts import flagship_results as flagship
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    t_phase = time.perf_counter()
    out = {"phase": "flagship", "card": smi, "steps": FLAGSHIP_STEPS,
           "utts_per_accent": FLAGSHIP_UTTS, "seconds_read_beside": beside,
           "calls": {}}
    ok = True
    with tempfile.TemporaryDirectory() as work:
        data = os.path.join(work, "data")
        common = ["--steps", str(FLAGSHIP_STEPS), "--profile", "hard",
                  "--utts-per-accent", str(FLAGSHIP_UTTS), "--data-dir", data,
                  "--workdir", os.path.join(work, "runs"), "--out",
                  os.path.join(work, "flagship.json")]
        for name, flags in FLAGSHIP_CALLS:
            argv = [*common, *flags]
            calls, buf = {}, io.StringIO()
            t0 = time.perf_counter()
            zero_counts()
            with contextlib.ExitStack() as stack:
                for cls, method in ((MetaASRTrainer, "meta_train"),
                                    (MultitaskASRTrainer, "train"),
                                    (MetaASRTrainer, "meta_adapt"),
                                    (MetaASRTrainer, "decode")):
                    stack.enter_context(launches_per_call(cls, method,
                                                          calls))
                stack.enter_context(contextlib.redirect_stdout(buf))
                res = flagship.main(argv)
            total = all_counts()
            seconds = time.perf_counter() - t0
            n = len(Manifest.load(os.path.join(
                data, f"{flagship.HELDOUT}.jsonl")).utts)
            want, layout = flagship_expected(flagship, argv, n)
            want_total = {k: sum(c[k] for cs in want.values() for c in cs)
                          for k in total}
            entries = {t: e for t, e in res.items() if isinstance(e, dict)}
            rec = {"flags": list(flags), "seconds": round(seconds, 1),
                   "train_seconds": {t: e["train_seconds"]
                                     for t, e in entries.items()},
                   "results": entries, "launches": total,
                   "launches_expected": want_total,
                   "launches_per_call": calls,
                   "launches_per_call_expected": want,
                   "layout_is_the_reference": (
                       list(entries) == list(layout) and all(
                           flagship_entry_ok(entries[t], keys,
                                             len(flagship.ADAPT_SEEDS))
                           for t, keys in layout.items()))}
            if name == "eval_only":
                rec["restored_step_2"] = (
                    f"[fomaml] eval-only from step {FLAGSHIP_STEPS}"
                    in buf.getvalue())
            if name == "metasgd":
                state = torch.load(os.path.join(
                    work, "runs", "hard_fomaml@metasgd", "ckpts",
                    f"step_{FLAGSHIP_STEPS}.pt"), map_location="cpu",
                    weights_only=True)
                lr = state["params"]["inner_lr"]
                init = flagship.make_cfg("fomaml", 1, "").meta.inner_lr
                init = float(torch.tensor(init, dtype=torch.float32))
                rec["inner_lr"] = {
                    "leaves": len(lr), "init": init,
                    "finite": all(bool(torch.isfinite(v).all())
                                  for v in lr.values()),
                    "moved": sum(float(v) != init for v in lr.values()),
                    "min": min(float(v) for v in lr.values()),
                    "max": max(float(v) for v in lr.values())}
            rec["ok"] = (rec["layout_is_the_reference"] and calls == want
                         and total == want_total
                         and rec.get("restored_step_2", True)
                         and (name != "metasgd"
                              or (rec["inner_lr"]["finite"]
                                  and rec["inner_lr"]["moved"] >= 1)))
            ok = ok and rec["ok"]
            out["calls"][name] = rec
            torch.cuda.empty_cache()
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    out["budget_s"] = FLAGSHIP_BUDGET_S
    log(out)
    for name, rec in out["calls"].items():
        if not rec["ok"]:
            raise SystemExit(
                f"flagship_results ({name}): layout, WERs, restore, "
                f"inner rates or launch counts differ from what its code "
                f"gives: {rec['launches_per_call']} against "
                f"{rec['launches_per_call_expected']}")
    return out


def flagship_paths(flag, k) -> dict:
    """Phase 23's launches of kernel ``k`` by call."""
    return {f"flagship_{name}": rec["launches"][k]
            for name, rec in flag["calls"].items()}


# ------------------------------------------ fusion and profiling ----

FUSION_STEPS = 2            # fusion_eval --steps (default 1500)
FUSION_LM_STEPS = 10        # its --lm-steps (default 1500), the 2 x 192 LM
FUSION_UTTS = 16            # the hard corpus made first (default 192)
FUSION_WEIGHTS = "0,0.3"    # its --weights (default 0,0.1,0.2,0.3,0.5)
FUSION_BUDGET_S = 100
TRACE_TOP = 8               # rows of each decode batch's table printed
ROOFLINE_CEILING = 1.05     # a row's TF/s against bench.PEAK_FLOPS


def fusion_expected(fusion, argv, n_heldout: int) -> dict:
    """The launches each call of one ``fusion_eval.main(argv)`` (``--algo
    multi``) makes, from the code: the LM's training K3 and K3b 2 a step
    (2 layers); the multitask arm 1 K1 and 1 K2 a step; each adaptation 1
    K1 and 5 K2; each decode batch 1 K1, per weight a zero-shot decode
    and one per support seed; K2b 0, and K3/K3b 0 in the fused search."""
    args = fusion.build_parser().parse_args(argv)
    assert args.algo == "multi" and not args.tiny
    _, ev = fusion.arm_configs(args, "", 30)
    bsz, n = ev.data.batch_size, args.steps
    zs = decode_batches(n_heldout - 8 if n_heldout > 8 else n_heldout, bsz,
                        64)
    test = decode_batches(n_heldout - ev.meta.k_support, bsz, 64)
    seeds = len(fusion.ADAPT_SEEDS)
    lm_launches = 2 * args.lm_steps
    return {
        "lm.train_char_lm": [{**kernel_counts(), "k3": lm_launches,
                              "k3b": lm_launches}],
        "MultitaskASRTrainer.train": [kernel_counts(n, n)],
        "MetaASRTrainer.meta_adapt": [kernel_counts(1, 5)] * seeds,
        "MetaASRTrainer.decode": [kernel_counts(b) for b in (
            [zs] + [test] * seeds) * len(args.weights.split(","))]}


def _dump(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def traced_decode(torch, trace_summary, meta_tr, params, ds, idx, path):
    """One beam decode of ``idx`` under torch.profiler (CUDA activity),
    its Chrome trace summarized -> (summary of every row, K1 launches,
    wall seconds, the hypotheses' dump)."""
    from torch.profiler import ProfilerActivity, profile

    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel

    k1 = fused_log_mel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        meta_tr.decode(params, ds, idx, max_utts=64, mode="beam",
                       dump_path=path + ".jsonl")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return (trace_summary.summarize(path, steps=1, top=None),
            fused_log_mel.launches - k1, wall, _dump(path + ".jsonl"))


def phase_fusion_profiling(torch, smi):
    """fusion_eval.main at config3 width in this process (the multitask
    arm, a few steps; the recipe's 2 x 192 LM, a few steps; weights 0 and
    0.3) with exact launches per call; the paired design (the 0 column's
    hypotheses = a decode with ``lm_ckpt`` unset, the 0.3 column's scores
    not the 0 column's); trace_summary over one fused and one unfused
    decode batch of the same adapted parameters (K1's row against the
    wrapper's count); matmul_roofline's seven rows."""
    import io

    from metaasr_tpu_torch.data.dataset import Manifest
    from metaasr_tpu_torch.models import lm
    from metaasr_tpu_torch.scripts import (
        fusion_eval,
        matmul_roofline,
        trace_summary,
    )
    from metaasr_tpu_torch.scripts.bench import PEAK_FLOPS
    from metaasr_tpu_torch.scripts.flagship_results import ensure_corpus
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    t_phase = time.perf_counter()
    out = {"phase": "fusion_profiling", "card": smi, "steps": FUSION_STEPS,
           "lm_steps": FUSION_LM_STEPS, "utts_per_accent": FUSION_UTTS,
           "weights": FUSION_WEIGHTS}
    with tempfile.TemporaryDirectory() as work:
        data = os.path.join(work, "data")
        ensure_corpus(data, "hard", FUSION_UTTS)
        argv = ["--steps", str(FUSION_STEPS), "--lm-steps",
                str(FUSION_LM_STEPS), "--weights", FUSION_WEIGHTS,
                "--data-dir", data, "--workdir", os.path.join(work, "runs"),
                "--out", os.path.join(work, "fusion.json")]
        n = len(Manifest.load(os.path.join(
            data, f"{fusion_eval.HELDOUT}.jsonl")).utts)
        # every adaptation and decode of the sweep recorded (the decodes
        # with a hypothesis dump, their weight and seconds)
        adapted, decodes = [], []
        adapt, decode = MetaASRTrainer.meta_adapt, MetaASRTrainer.decode

        def recording_adapt(self, params, ds, **kwargs):
            res = adapt(self, params, ds, **kwargs)
            adapted.append((self, ds, res))
            return res

        def recording_decode(self, params, ds, idx, **kwargs):
            path = os.path.join(work, f"dump_{len(decodes)}.jsonl")
            t0 = time.perf_counter()
            res = decode(self, params, ds, idx, dump_path=path, **kwargs)
            decodes.append({"weight": self.cfg.train.lm_weight,
                            "seconds": time.perf_counter() - t0,
                            "idx": list(idx), "dump": _dump(path)})
            return res

        calls, buf = {}, io.StringIO()
        t0 = time.perf_counter()
        zero_counts()
        with contextlib.ExitStack() as stack:
            for name, fn in (("meta_adapt", recording_adapt),
                             ("decode", recording_decode)):
                stack.callback(setattr, MetaASRTrainer, name,
                               getattr(MetaASRTrainer, name))
                setattr(MetaASRTrainer, name, fn)
            for cls, method in ((lm, "train_char_lm"),
                                (MultitaskASRTrainer, "train"),
                                (MetaASRTrainer, "meta_adapt"),
                                (MetaASRTrainer, "decode")):
                stack.enter_context(launches_per_call(cls, method, calls))
            stack.enter_context(contextlib.redirect_stdout(buf))
            res = fusion_eval.main(argv)
        total = all_counts()
        want = fusion_expected(fusion_eval, argv, n)
        want_total = {k: sum(c[k] for cs in want.values() for c in cs)
                      for k in total}
        printed = [json.loads(ln) for ln in buf.getvalue().splitlines()
                   if ln.startswith('{"')]
        weights = [str(float(w)) for w in FUSION_WEIGHTS.split(",")]
        with open(os.path.join(work, "fusion.json")) as f:
            written = json.load(f)
        wers = [e["zero_shot_beam_wer"] for e in res["weights"].values()]
        wers += [w for e in res["weights"].values()
                 for w in e["adapt5_beam_draws"]]
        out["sweep"] = {
            "seconds": round(time.perf_counter() - t0, 1),
            "results": res, "launches": total,
            "launches_expected": want_total, "launches_per_call": calls,
            "launches_per_call_expected": want,
            "decode_seconds_by_weight": {
                w: round(sum(d["seconds"] for d in decodes
                             if str(d["weight"]) == w), 2) for w in weights},
            "layout_is_the_reference": (
                list(res) == ["algo", "steps", "seed", "lm_nll", "weights"]
                and list(res["weights"]) == weights and written == res
                and printed == [{w: res["weights"][w]} for w in weights]
                and all(math.isfinite(w) and w >= 0 for w in wers)
                and math.isfinite(res["lm_nll"]))}
        sweep_ok = (out["sweep"]["layout_is_the_reference"] and calls == want
                    and total == want_total)

        # the paired design and the traces: seed 0's adapted parameters on
        # its test split, fused (weight 0.3) and with lm_ckpt unset
        meta_tr, ds, (params0, idx0) = adapted[0]
        by_weight = {w: next(d for d in decodes if str(d["weight"]) == w
                             and d["idx"] == list(idx0)) for w in weights}
        t = meta_tr.cfg.train
        lm_ckpt = t.lm_ckpt
        traces = {}
        for tag, ckpt in (("fused", lm_ckpt), ("unfused", "")):
            t.lm_ckpt, t.lm_weight = ckpt, float(weights[-1])
            summary, k1, wall, dump = traced_decode(
                torch, trace_summary, meta_tr, params0, ds, idx0,
                os.path.join(work, f"{tag}_trace.json"))
            # K1's row: "(anonymous namespace)::fbank_fft_kernel"
            k1_rows = [r for r in summary["rows"]
                       if "fbank_fft_kernel" in r["op"]]
            traces[tag] = {
                "utterances": len(idx0), "wall_s": round(wall, 3),
                "device_ms_per_batch": summary["device_ms_per_step"],
                "device_ops": sum(r["launches"] for r in summary["rows"]),
                "op_rows": summary["ops"],
                "top": [[r["op"][:100], round(r["ms_per_step"], 3),
                         round(r["pct"], 1), r["count"]]
                        for r in summary["rows"][:TRACE_TOP]],
                "k1_wrapper_launches": k1,
                "k1_trace_count": k1_rows[0]["count"] if k1_rows else 0,
                "dump": dump}
        t.lm_ckpt = lm_ckpt
        fused, unfused = traces["fused"], traces["unfused"]
        zero, top = by_weight[weights[0]]["dump"], by_weight[weights[-1]][
            "dump"]
        out["paired"] = {
            "zero_column_equals_unset": (
                [r["hyp"] for r in unfused["dump"]]
                == [r["hyp"] for r in zero]),
            "zero_column_score_max_diff": max(
                abs(a["score"] - b["score"])
                for a, b in zip(unfused["dump"], zero)),
            "fused_scores_differ": any(a["score"] != b["score"]
                                       for a, b in zip(top, zero)),
            "fused_texts_differ": sum(a["hyp"] != b["hyp"]
                                      for a, b in zip(top, zero)),
            "traced_fused_equals_sweep": (
                [r["hyp"] for r in fused["dump"]]
                == [r["hyp"] for r in top])}
        for tr in traces.values():
            tr.pop("dump")
        out["traces"] = {**traces, "ratio": {
            "device_ms": fused["device_ms_per_batch"]
            / unfused["device_ms_per_batch"],
            "device_ops": fused["device_ops"] / unfused["device_ops"],
            "wall": fused["wall_s"] / unfused["wall_s"],
            "sweep_decode_seconds": (
                out["sweep"]["decode_seconds_by_weight"][weights[-1]]
                / out["sweep"]["decode_seconds_by_weight"][weights[0]])}}
        traces_ok = all(1 <= tr["k1_trace_count"] <= tr["k1_wrapper_launches"]
                        for tr in traces.values())
        paired_ok = (out["paired"]["zero_column_equals_unset"]
                     and out["paired"]["fused_scores_differ"])
        torch.cuda.empty_cache()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = matmul_roofline.main([])
    peak = PEAK_FLOPS / 1e12
    out["roofline"] = {
        "device": json.loads(buf.getvalue().splitlines()[0])["device"],
        "peak_tflops": peak,
        "columns": ["row", "tflops (graph)", "% peak", "ms", "eager tflops",
                    "eager ms"],
        "rows": [[r["name"], round(r["tflops"], 1), round(r["pct_peak"], 1),
                  round(r["ms"], 3), round(r["eager_tflops"], 1),
                  round(r["eager_ms"], 3)] for r in rows]}
    roofline_ok = (len(rows) == len(matmul_roofline.ROWS) and all(
        0 < r[k] <= ROOFLINE_CEILING * peak for r in rows
        for k in ("tflops", "eager_tflops")))
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    out["budget_s"] = FUSION_BUDGET_S
    out["ok"] = {"sweep": sweep_ok, "paired": paired_ok,
                 "traces": traces_ok, "roofline": roofline_ok}
    log(out)
    if not sweep_ok:
        raise SystemExit(
            f"fusion_eval: layout, WERs or launch counts differ from what "
            f"its code gives: {calls} against {want}")
    if not paired_ok:
        raise SystemExit(f"fusion_eval's paired design: {out['paired']}")
    if not traces_ok:
        raise SystemExit("trace_summary: K1's row is missing or counts "
                         "more launches than its wrapper made")
    if not roofline_ok:
        raise SystemExit(f"matmul_roofline: a row outside (0, "
                         f"{ROOFLINE_CEILING} x peak]: {out['roofline']}")
    return out


def fusion_paths(fusion, k) -> dict:
    """Phase 24's launches of kernel ``k``: the LM's training apart from
    the rest of the sweep."""
    calls = fusion["sweep"]["launches_per_call"]
    lm_part = sum(c[k] for c in calls["lm.train_char_lm"])
    return {"fusion_lm_training": lm_part,
            "fusion_sweep": fusion["sweep"]["launches"][k] - lm_part}


# ------------------------------------------- the device-resident corpus ----

RESIDENT_UTTS = 400         # utterances an accent: 7 training accents, 2,800
RESIDENT_STEPS = 2          # steps 0 and 1 fall in two buckets
# config3's default buckets put every draw of this corpus (0.5-1.9 s
# utterances) in (41,200, 32); 16-frame buckets under 256 split the draws.
# The caps, and so the store, stay config3's.
RESIDENT_FRAME_BUCKETS = (160, 176, 192, 256, 512, 1024, 1600)
RESIDENT_STORE_BYTES = 2_871_344_000   # 2,800 x (256,240 x 4 + 128 x 4 + 8)
RESIDENT_SMALL_GB = 2.0     # an auto budget the store overruns
RESIDENT_LOSS_RTOL = 1e-4
RESIDENT_BUDGET_S = 45


def h2d_records(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler -> its host-to-device copies (count
    and bytes) from the exported Chrome trace: the raw records carry no
    byte count. Keep ``fn`` short. Host and device activity are traced:
    device-only windows of this process have lost every copy record."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            copies = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "gpu_memcpy"
                      and "HtoD" in e.get("name", "")]
    return {"memcpy_htod": len(copies),
            "bytes": sum(e.get("args", {}).get("bytes", 0) for e in copies)}


def start_resident_corpus():
    """Phase 25's corpus, written by a spawned process while the phases
    before it run (generating it takes 10-17 s of one core) -> (its
    TemporaryDirectory, the process)."""
    import multiprocessing

    from metaasr_tpu_torch.data.synthetic import generate_dataset

    tmp = tempfile.TemporaryDirectory()
    proc = multiprocessing.get_context("spawn").Process(
        target=generate_dataset, args=(os.path.join(tmp.name, "data"),),
        kwargs={"utts_per_accent": RESIDENT_UTTS, "words_per_utt": (2, 4),
                "seed": 0}, daemon=True)
    proc.start()
    return tmp, proc


def phase_resident_corpus(torch, smi, corpus=None):
    """data.resident at config3 width: the 2,871,344,000-byte store built
    through ``auto``, its batches against the streaming feed's, a resident
    and a streaming ``meta_train`` from one seed, and ``auto`` over a 2 GB
    budget streaming. ``corpus``: ``start_resident_corpus()``'s result,
    else it starts here."""
    import gc

    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.train import meta_train
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer, to_device

    t_phase = time.perf_counter()
    m = config3_train()[0].meta
    want_k1 = RESIDENT_STEPS * 2 * m.tasks_per_batch
    want_k2 = RESIDENT_STEPS * m.tasks_per_batch * (m.inner_steps + 1)
    out = {"phase": "resident_corpus", "card": smi,
           "utts_per_accent": RESIDENT_UTTS,
           "frame_buckets": RESIDENT_FRAME_BUCKETS}
    tmp, proc = corpus or start_resident_corpus()
    with tmp as d:
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        proc.join()
        out["corpus_wait_s"] = time.perf_counter() - t0
        if proc.exitcode != 0:
            raise SystemExit(f"corpus generation exited {proc.exitcode}")

        def trainer(name, resident, max_gb=4.0):
            cfg = config3_train()[0]
            cfg.data.data_dir, cfg.data.heldout_accents = data, ("tango",)
            cfg.data.frame_buckets = RESIDENT_FRAME_BUCKETS
            cfg.data.resident, cfg.data.resident_max_gb = resident, max_gb
            cfg.train.log_every, cfg.train.ckpt_every = 1, 10 ** 6
            return make_trainer(cfg, os.path.join(d, name), DEVICE)[0]

        def train(tr, name, steps):
            """``meta_train`` from zeroed counts -> (state, its launches,
            the streaming feeds it opened, its logged records)."""
            feeds = {}
            zero_counts()
            with launches_per_call(MetaASRTrainer, "_batch_feed", feeds):
                state = tr.meta_train(max_steps=steps)
            torch.cuda.synchronize()
            counts = all_counts()
            with open(os.path.join(d, name, "logs", "scalars.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            return (state, counts,
                    len(feeds.get("MetaASRTrainer._batch_feed", [])), recs)

        # gate 1: auto under the 4 GB budget places the store
        res = trainer("res", "auto")
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        host = {}
        build = meta_train.build_resident_store

        def timed_build(*a):
            t = time.perf_counter()
            r = build(*a)
            host["s"] = time.perf_counter() - t
            return r

        meta_train.build_resident_store = timed_build
        try:
            t0 = time.perf_counter()
            res._setup_resident()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        finally:
            meta_train.build_resident_store = build
        if res._store is None:
            raise SystemExit("auto under the budget built no store")
        reckoned = meta_train.resident_store_bytes(
            res.accent_datasets, res._num_samples_cap(),
            res.cfg.data.max_tokens)
        placed = sum(v.numel() * v.element_size()
                     for v in res._store.values())
        out["store"] = {
            "utterances": sum(len(x) for x in res.accent_datasets.values()),
            "keys": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                     for k, v in res._store.items()},
            "bytes": placed, "reckoned_bytes": reckoned,
            "build_s": build_s, "collate_s": host["s"],
            "copy_s": build_s - host["s"],
            "memory_allocated_before": mem_before,
            "memory_allocated_with_store": torch.cuda.memory_allocated()}
        log(out)
        if not placed == reckoned == RESIDENT_STORE_BYTES:
            raise SystemExit(f"store of {placed} bytes, reckoned {reckoned}, "
                             f"expected {RESIDENT_STORE_BYTES}")

        # gate 2: the gathered batch is the streaming feed's, key for key
        shapes, batch_ok = {}, True
        for step in range(RESIDENT_STEPS):
            got = res._resident_batch(step)
            want = to_device(res.sampler.sample(step), DEVICE)
            shapes[step] = list(got["support"]["audio"].shape)
            batch_ok &= all(
                sorted(got[p]) == sorted(want[p]) and all(
                    got[p][k].dtype == v.dtype and got[p][k].is_contiguous()
                    and torch.equal(got[p][k], v)
                    for k, v in want[p].items())
                for p in ("support", "query"))
        out["batches"] = {"support_shapes": shapes, "equal": batch_ok}
        if not batch_ok:
            raise SystemExit("a gathered batch differs from the streaming one")
        if len({tuple(s) for s in shapes.values()}) < 2:
            raise SystemExit(f"steps 0-{RESIDENT_STEPS - 1} share one "
                             f"bucket: {shapes}")

        # gate 3: resident against streaming, one seed, exact launches.
        # Deterministic algorithms: by default two runs of one feed part
        # by up to 9.5e-4 relative at step 3 (PERF.md §6)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            s_res, c_res, f_res, r_res = train(res, "res", RESIDENT_STEPS)
            off = trainer("off", "off")
            s_off, c_off, f_off, r_off = train(off, "off", RESIDENT_STEPS)
        finally:
            torch.use_deterministic_algorithms(False)
        gaps = [abs(a["meta_loss"] - b["meta_loss"])
                / max(abs(a["meta_loss"]), abs(b["meta_loss"]))
                for a, b in zip(r_res, r_off)]
        steady = lambda recs: statistics.mean(  # noqa: E731
            r["utts_per_sec"] for r in recs[1:])
        out["feeds"] = {
            "resident": {"launches": c_res, "streaming_feeds": f_res,
                         "meta_loss": [r["meta_loss"] for r in r_res],
                         "steady_utts_per_sec": steady(r_res)},
            "streaming": {"launches": c_off, "streaming_feeds": f_off,
                          "meta_loss": [r["meta_loss"] for r in r_off],
                          "steady_utts_per_sec": steady(r_off)},
            "max_rel_loss_gap": max(gaps), "rtol": RESIDENT_LOSS_RTOL,
            "deterministic_algorithms": True}

        # printed: host-to-device copies of each feed's next batch (the
        # step itself copies nothing to the device: PERF.md §6)
        nxt = RESIDENT_STEPS
        out["h2d_next_batch"] = {
            "resident_feed": h2d_records(
                torch, lambda: res._resident_batch(nxt)),
            "streaming_feed": h2d_records(
                torch, lambda: next(off._batch_feed(nxt, nxt + 1))),
            "resident_index_bytes":
                m.tasks_per_batch * (m.k_support + m.k_query) * 8,
            "streaming_batch_bytes": sum(
                v.nbytes for p in ("support", "query")
                for k, v in res.sampler.sample(nxt)[p].items()
                if k != "texts")}
        torch.cuda.synchronize()
        mem_with = torch.cuda.memory_allocated()
        del res, off, s_res, s_off
        gc.collect()
        torch.cuda.empty_cache()
        out["store"]["memory_allocated_after_free"] = \
            torch.cuda.memory_allocated()
        out["store"]["memory_allocated_with_trainers"] = mem_with

        # gate 4: auto over a 2 GB budget builds no store, and the feed
        # meta_train takes is the streaming one
        over = trainer("over", "auto", RESIDENT_SMALL_GB)
        feeds = {}
        with launches_per_call(MetaASRTrainer, "_batch_feed", feeds):
            got = next(over._feed(0, 1))
        want = to_device(over.sampler.sample(0), DEVICE)
        f_over = len(feeds.get("MetaASRTrainer._batch_feed", []))
        out["auto_2gb"] = {
            "store": over._store is not None, "streaming_feeds": f_over,
            "batch_equal": all(torch.equal(got[p][k], v)
                               for p in ("support", "query")
                               for k, v in want[p].items())}
        del over, got, want
    out["launches"] = {"resident": c_res, "streaming": c_off}
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = RESIDENT_BUDGET_S
    log(out)
    for name, c, feeds in (("resident", c_res, f_res),
                           ("streaming", c_off, f_off)):
        if (c["k1"], c["k2"], c["k2b"]) != (want_k1, want_k2, 0):
            raise SystemExit(f"{name} feed: K1 {c['k1']} (want {want_k1}), "
                             f"K2 {c['k2']} (want {want_k2}), K2b {c['k2b']}")
        if feeds != (name == "streaming"):
            raise SystemExit(f"{name} feed opened {feeds} streaming feeds")
    if not max(gaps) <= RESIDENT_LOSS_RTOL:
        raise SystemExit(f"meta_loss apart by {max(gaps)} relative")
    if (out["auto_2gb"]["store"] or f_over != 1
            or not out["auto_2gb"]["batch_equal"]):
        raise SystemExit(f"auto over 2 GB: {out['auto_2gb']}")
    return out


def resident_paths(resident, k) -> dict:
    """Phase 25's launches of kernel ``k``, by feed."""
    return {f"resident_phase_{name}": c[k]
            for name, c in resident["launches"].items()}


# ------------------------------------------------------ the grain loader ----

GRAIN_UTTS = 64             # utterances an accent, 2 accents (algo no
GRAIN_WORKERS = 2           # trains on the first: 4 batches an epoch)
GRAIN_STREAM_BATCHES = 6    # batches compared between 2 workers and none
GRAIN_STEPS = 4             # the straight run; the resumed one takes 2 + 2
GRAIN_BUDGET_S = 25
# K1's rows at the caps: 8 full rows (1,600 frames), 8 ragged
GRAIN_K1_LENS = [256240] * 8 + [401, 3200, 16000, 64000, 100001, 160000,
                                200000, 255999]


def config1_grain(data: str):
    """config1 at full width on ``data`` with ``data.loader: grain``, 2
    workers, a checkpoint every 2 steps (2 kept), no evaluation."""
    cfg = config1()
    cfg.data.data_dir = data
    cfg.data.loader, cfg.data.num_workers = "grain", GRAIN_WORKERS
    cfg.train.ckpt_every, cfg.train.keep_ckpts = 2, 2
    cfg.train.eval_every, cfg.train.log_every = 0, 1
    return cfg


def phase_grain_loader(torch, smi, peaks, mono):
    """data.loader: grain in MonoASRTrainer at config1 width: the 2-worker
    stream against the 0-worker one at the caps, K1/K2/K3/K3b at the cap
    shapes against their plain versions, a straight 4-step run against a 2
    + 2 resumed one (exact), and their launches. ``mono``: phase 9's
    result, printed beside this phase's step."""
    import gc

    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.data.grain_loader import make_grain_loader
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import (
        FbankParams,
        frame_lengths,
        num_frames,
    )

    t_phase = time.perf_counter()
    out = {"phase": "grain_loader", "card": smi,
           "utts_per_accent": GRAIN_UTTS, "num_workers": GRAIN_WORKERS}
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        generate_dataset(data, accents=("alpha", "bravo"),
                         utts_per_accent=GRAIN_UTTS, words_per_utt=(2, 4),
                         seed=2)
        trainer = lambda name: make_trainer(  # noqa: E731
            config1_grain(data), os.path.join(d, name), DEVICE)[0]
        tr = trainer("straight")
        dc, mc = tr.cfg.data, tr.cfg.model
        bsz, cap, n_tok = dc.batch_size, dc.max_frames * 160 + 240, \
            dc.max_tokens
        t_out = num_frames(cap) // 2 // 2       # the VGG's two 2x2 pools

        # gate 1: the 2-worker stream is the 0-worker one (workers first,
        # so both read cold audio caches)
        def stream(workers):
            it = make_grain_loader(tr.train_datasets, bsz, cap, n_tok,
                                   seed=dc.seed, num_workers=workers)
            batches, waits = [], []
            for _ in range(GRAIN_STREAM_BATCHES):
                t0 = time.perf_counter()
                batches.append(next(it))
                waits.append(time.perf_counter() - t0)
            it.close()
            return batches, waits

        with_workers, waits_w = stream(GRAIN_WORKERS)
        alone, waits_0 = stream(0)
        equal = all(sorted(a) == sorted(b) and a["texts"] == b["texts"]
                    and all(np.array_equal(a[k], v)
                            for k, v in b.items() if k != "texts")
                    for a, b in zip(with_workers, alone))
        shapes_ok = all(b["audio"].shape == (bsz, cap)
                        and b["tokens"].shape == (bsz, n_tok)
                        for b in with_workers + alone)
        out["stream"] = {
            "batches": GRAIN_STREAM_BATCHES, "equal": equal,
            "audio_shape": list(alone[0]["audio"].shape),
            "tokens_shape": list(alone[0]["tokens"].shape),
            "next_blocks_s": {"0_workers": waits_0,
                              f"{GRAIN_WORKERS}_workers": waits_w},
            "next_blocks_s_total": {"0_workers": sum(waits_0),
                                    f"{GRAIN_WORKERS}_workers": sum(waits_w)}}
        del with_workers, alone
        if not (equal and shapes_ok):
            log(out)
            raise SystemExit("the grain stream with workers differs from "
                             "the one without, or a batch is off the caps")

        # gate 2: the kernels at the cap shapes against their plain versions
        part = card_peaks(torch.cuda.get_device_name(0))[0]
        kernels, ok = {}, True
        with strict_fp32():
            audio_np = make_waves(np.random.default_rng(26), GRAIN_K1_LENS,
                                  cap)
            audio = torch.from_numpy(audio_np).to(DEVICE)
            flens = frame_lengths(torch.tensor(
                GRAIN_K1_LENS, dtype=torch.int32, device=DEVICE))
            n_mel = tr.cfg.frontend.num_mel_bins
            entry, good = k1_check(torch, audio_np, audio, flens,
                                   GRAIN_K1_LENS, n_mel)
            params = FbankParams.create(num_mel_bins=n_mel)
            mats = fbank_kernel._device_matrices(params, audio.device)
            entry.update(
                shape=list(audio.shape),
                ms=cuda_median_ms(torch, lambda: fbank_kernel.fused_log_mel(
                    audio, flens, params), runs=10),
                plain_ms=cuda_median_ms(
                    torch, lambda: fbank_kernel.plain_log_mel(
                        audio, flens, *mats), runs=3, warmup=1),
                **k1_bound(audio, flens, params, part, peaks))
            kernels["k1"], ok = entry, ok and good
            del audio, flens, mats
            shape = (bsz, t_out, n_tok, mc.vocab_size)
            entry, good, inputs = ctc_check(torch, shape, seed=27)
            entry.update(ctc_kernel_times(torch, shape, inputs, peaks,
                                          runs=10, plain_runs=3,
                                          device_times=False))
            kernels["k2"], ok = entry, ok and good
            del inputs
            shape = (t_out, bsz, mc.blstm_hidden)
            entry, good, tensors = lstm_check(torch, shape, seed=28)
            entry.update(lstm_times(torch, shape, tensors, peaks, runs=10,
                                    plain_runs=3))
            kernels["k3_k3b"], ok = entry, ok and good
            del tensors
        out["kernels_at_caps"] = kernels
        if not ok:
            log(out)
            raise SystemExit("a kernel disagrees with its plain version at "
                             "the grain loader's cap shapes")

        # gates 3 and 4: 4 straight steps against 2 + 2 resumed (a fresh
        # trainer on the same workdir), exact launches. Deterministic
        # algorithms: by default two runs of one feed part (PERF.md §6)
        runs = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for name, wd, steps in (("straight", "straight", GRAIN_STEPS),
                                    ("resumed_to_2", "resumed", 2),
                                    ("resumed_to_4", "resumed", GRAIN_STEPS)):
                t = tr if name == "straight" else trainer(wd)
                zero_counts()
                t0 = time.perf_counter()
                state = t.train(max_steps=steps)
                torch.cuda.synchronize()
                runs[name] = {"seconds": time.perf_counter() - t0,
                              "launches": all_counts(), "state": state,
                              "next_index": t._grain_it.get_state()}
                if name == "straight":
                    peak = torch.cuda.max_memory_allocated()
        finally:
            torch.use_deterministic_algorithms(False)
        ckpts = os.path.join(d, "resumed", "ckpts")
        files = sorted(f for f in os.listdir(ckpts)
                       if f.startswith("grain_state_"))
        full, resumed = (runs[k]["state"] for k in ("straight",
                                                    "resumed_to_4"))
        leaves_equal = sorted(full["params"]) == sorted(resumed["params"]) \
            and all(torch.equal(v, resumed["params"][k])
                    for k, v in full["params"].items())
        with open(os.path.join(d, "straight", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ms = statistics.median(1e3 * bsz / r["utts_per_sec"]
                               for r in recs[1:])
        out["resume"] = {
            "deterministic_algorithms": True, "state_files": files,
            "parameter_leaves_equal": leaves_equal,
            "steps": {k: r["state"]["step"] for k, r in runs.items()},
            "next_index": {k: r["next_index"] for k, r in runs.items()},
            "seconds": {k: r["seconds"] for k, r in runs.items()},
            "loss": [r["loss"] for r in recs]}
        layers = 2 * mc.blstm_layers
        want = {name: {"k1": n, "k2": n, "k3": layers * n, "k3b": layers * n,
                       "k2b": 0}
                for name, n in (("straight", GRAIN_STEPS),
                                ("resumed_to_2", 2), ("resumed_to_4", 2))}
        out["launches"] = {f"grain_{k}": r["launches"]
                           for k, r in runs.items()}
        out["launches_expected"] = {f"grain_{k}": v for k, v in want.items()}
        out["step"] = {
            "batch": [bsz, cap], "tokens": n_tok,
            "lstm_shape_tbh": [t_out, bsz, mc.blstm_hidden],
            "ctc_shape_bts": [bsz, t_out, 2 * n_tok + 1],
            "ms_per_step": ms, "utts_per_s": bsz / (ms / 1e3),
            "ms_per_step_logged": [1e3 * bsz / r["utts_per_sec"]
                                   for r in recs],
            "peak_mem_gb": peak / 1e9,
            "phase9_at_64000_samples": {
                "batch": mono["batch"], "ms_per_step": mono["ms_per_step"],
                "utts_per_s": mono["utts_per_s"],
                "peak_mem_gb": mono["peak_mem_gb"]}}
        del tr, runs, full, resumed, state, t
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = GRAIN_BUDGET_S
    log(out)
    if not all(math.isfinite(x) for x in out["resume"]["loss"]):
        raise SystemExit("non-finite loss under the grain loader")
    if files != ["grain_state_2.bin", "grain_state_4.bin"] or \
            out["resume"]["next_index"]["resumed_to_4"] != {"next_index": 4}:
        raise SystemExit(f"grain state files {files}")
    if not leaves_equal:
        raise SystemExit("the resumed grain run differs from the straight "
                         "one")
    if out["launches"] != out["launches_expected"]:
        raise SystemExit(f"grain launches {out['launches']}, want "
                         f"{out['launches_expected']}")
    return out


def grain_paths(grain, k) -> dict:
    """Phase 26's launches of kernel ``k``, by run."""
    return {path: c[k] for path, c in grain["launches"].items()}


# ------------------------------------------- the data-parallel meta-step ----

DP_ACCENTS = ("alpha", "bravo", "echo", "delta", "tango")  # tango held out
DP_UTTS = 16                # utterances an accent
DP_STEPS = 2                # the first pair's run; the fresh pair resumes it
DP_RESUME_STEPS = 1         # by this many steps
DP_WORLD = 2                # gloo ranks on the one card
DP_LOSS_RTOL = (1e-6, 1e-4)  # step 1's meta_loss, later steps'
DP_NORM_RTOL = 1e-5         # step 1's grad_norm: a wrong 1 / M doubles it
DP_PARAM_ATOL = 1e-5
DP_TIMEOUT_S = 120          # the rendezvous and every collective
DP_BUDGET_S = 85
# the data axis (pair c): --mesh-tasks 1 on the DP_WORLD ranks, each task's
# 4 + 4 shots split 2 + 2. Its inner gradients are sums of bf16 partials
# rounded once each, one process's whole gradient is rounded once: they part
# by bf16 rounding, U = 2^-8 (PERF.md, phase 27, written before the run)
DPD_LOSS_RTOL = 2.0 ** -8    # step 1's meta_loss: U
DPD_NORM_RTOL = 2.0 ** -7    # step 1's grad_norm: 2U (two roundings)
# Adam's |m^/sqrt(v^)| is 1 at step 1 and at most sqrt(a^2/A + b^2/B) =
# 1.00136 at step 2 (Cauchy-Schwarz; a, b, A, B: the bias-corrected weights
# of g1, g2 in m^ and v^ at b1 .9, b2 .999), whatever the gradients
DPD_ADAM_RATIO = 1.0014


def dp_config(data: str):
    """config3_train() over phase 27's corpus: the streaming feed (a group
    has no resident store), a log line a step, a checkpoint at the end
    only."""
    cfg = config3_train()[0]
    cfg.data.data_dir, cfg.data.heldout_accents = data, ("tango",)
    cfg.data.resident = "off"
    cfg.train.log_every, cfg.train.ckpt_every = 1, 10 ** 6
    return cfg


@contextlib.contextmanager
def captured_meta_train():
    """Record (trainer, final state) of every ``meta_train`` call."""
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer

    seen, plain = [], MetaASRTrainer.meta_train

    def spy(self, *args, **kwargs):
        state = plain(self, *args, **kwargs)
        seen.append((self, state))
        return state

    MetaASRTrainer.meta_train = spy
    try:
        yield seen
    finally:
        MetaASRTrainer.meta_train = plain


def dp_cli(torch, argv, workdir: str, with_init: bool = False) -> dict:
    """``cli.main(argv)`` (a ``--mode train`` run) from zeroed counts under
    deterministic algorithms -> final parameters (on the cpu) and state,
    launches, gradient all-reduces, state broadcasts, the records logged
    in ``workdir`` (rank 0's, earlier runs' too), ms a step from them, peak
    memory, the store, the workdir's entries; ``with_init``: the seeded
    parameters the run started from too (on the cpu)."""
    from metaasr_tpu_torch.parallel import broadcast_state, reduce_outer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_counts()
        reduce_outer.all_reduces = broadcast_state.calls = 0
        with captured_meta_train() as seen:
            _, seconds = run_cli(argv)
        counts = all_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    (tr, state), = seen
    logs = os.path.join(workdir, "logs", "scalars.jsonl")
    recs = []
    if os.path.exists(logs):
        with open(logs) as f:
            recs = [r for r in map(json.loads, f) if "meta_loss" in r]
    m = tr.cfg.meta
    per_step = m.tasks_per_batch * (m.k_support * m.inner_steps + m.k_query)
    init = ({k: v.cpu() for k, v in tr.task.init_params(
        tr.cfg.train.seed).items()} if with_init else None)
    return {"params": {k: v.detach().cpu() for k, v in state["params"].items()},
            "init": init,
            "state": state, "step": state["step"], "launches": counts,
            "all_reduces": reduce_outer.all_reduces,
            "broadcasts": broadcast_state.calls, "records": recs,
            "ms_per_step_logged": [1e3 * per_step / r["utts_per_sec"]
                                   for r in recs],
            "cli_s": seconds, "rows": [tr.rows.start, tr.rows.stop],
            "device": str(tr.device), "store": tr._store is not None,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "workdir": ({e: sorted(os.listdir(os.path.join(workdir, e)))
                         if os.path.isdir(os.path.join(workdir, e)) else []
                         for e in sorted(os.listdir(workdir))}
                        if os.path.isdir(workdir) else {})}


def allreduce_ms(torch, n: int, group, runs: int = 3) -> float:
    """Median ms of one fp32 sum all-reduce of ``n`` elements on the card,
    the ranks released together by a barrier (after one unmeasured)."""
    import torch.distributed as dist

    from metaasr_tpu_torch.parallel import barrier

    buf = torch.zeros(n, dtype=torch.float32, device=DEVICE)
    times = []
    for _ in range(runs + 1):
        barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def state_bytes(state: dict) -> int:
    from metaasr_tpu_torch.utils.tree import flatten

    return sum(v.numel() * v.element_size()
               for v in flatten(state).values() if hasattr(v, "numel"))


def broadcast_ms(torch, state: dict, group, runs: int = 3) -> dict:
    """``broadcast_state`` of ``state`` in ``group`` (a group of one here):
    its bytes and the median ms of ``runs`` calls after one unmeasured."""
    from metaasr_tpu_torch.parallel import broadcast_state

    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        broadcast_state(state, group)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"bytes": state_bytes(state), "ms": statistics.median(times[1:])}


def checked_broadcast(torch, ckpt: str, record: dict):
    """A ``broadcast_state`` that times itself and holds what the rank
    holds right after it against rank 0's checkpoint ``ckpt``, bit for
    bit, into ``record``."""
    from metaasr_tpu_torch.parallel import broadcast_state
    from metaasr_tpu_torch.utils.tree import flatten

    def broadcast(state, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = broadcast_state(state, group)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = flatten(state)
        want = flatten(torch.load(ckpt, map_location=DEVICE,
                                  weights_only=True))
        equal = got.keys() == want.keys() and all(
            torch.equal(got[k], w) and got[k].dtype == w.dtype
            if torch.is_tensor(w) else type(got[k]) is type(w)
            and got[k] == w for k, w in want.items())
        record.update(ms=ms, bytes=state_bytes(state), equal=equal,
                      step=state["step"], leaves=len(want))
        return state

    return broadcast


def dp_worker(rank: int, d: str, pair: str) -> int:
    """``--dp-worker RANK DIR a|b``: one of phase 27's gloo ranks on the
    card. Joins its pair's group, warms up on a throwaway trainer, waits
    for ``DIR/go_<pair>``, then runs the CLI: pair ``a`` trains
    ``DP_STEPS`` steps from ``DIR/dp_config.yaml``, pair ``b`` (fresh
    processes) resumes rank 0's workdir by ``DP_RESUME_STEPS``, pair ``c``
    trains ``DP_STEPS`` steps with ``--mesh-tasks 1``, a data axis of
    ``DP_WORLD``, recording the batch of every K2 launch and its inner
    all-reduces; rank 1 has a workdir of its own, which it must never
    create. Writes ``DIR/<pair>_rank<RANK>.pt`` with the wall-clock times
    of each stage. Returns 3 if the parent goes away first."""
    stamps = {"started": time.time()}
    import gc

    import torch
    import torch.distributed as dist

    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.ops import ctc_kernel
    from metaasr_tpu_torch.parallel import initialize, reduce_inner
    from metaasr_tpu_torch.scripts.multihost_trainer_smoke import train_argv
    from metaasr_tpu_torch.train import meta_train

    resolve_device(DEVICE)
    torch.zeros(1, device=DEVICE)
    # its first call imports torch._dynamo and FSDP (seconds): not after
    # the go. dp_cli sets it again around the run.
    torch.use_deterministic_algorithms(True, warn_only=True)
    stamps["cuda_ready"] = time.time()
    group = initialize(init_method=f"file://{d}/rdzv_gloo_{pair}",
                       world_size=DP_WORLD, rank=rank, backend="gloo",
                       device=DEVICE, timeout=DP_TIMEOUT_S)
    stamps["group_ready"] = time.time()
    try:
        config = os.path.join(d, "dp_config.yaml")
        # before the go, a throwaway local meta-gradient on step 0's rows
        # (no collective, no update): the process's first-call costs
        # (CUDA modules, cuBLAS, the kernels' libraries) stay off the
        # measured steps, as in the parent, which has run steps before
        tr = make_trainer(load_config(config),
                          os.path.join(d, f"warm_{pair}{rank}"), DEVICE,
                          group)[0]
        tr._grad_fn(tr.init_state()["params"], next(tr._feed(0, 1)), 0)
        torch.cuda.synchronize()
        del tr
        gc.collect()
        stamps["warmed_up"] = time.time()
        parent, deadline = os.getppid(), time.monotonic() + 1800
        while not os.path.exists(os.path.join(d, f"go_{pair}")):
            if os.getppid() != parent or time.monotonic() > deadline:
                return 3
            time.sleep(0.02)
        stamps["go_seen"] = time.time()
        workdir = os.path.join(d, ("wd_gloo" if pair != "c" else
                                   "wd_gloo_data") if rank == 0
                               else f"wd_gloo_rank{rank}{pair}")
        bcast, k2_rows = {}, []
        if pair == "a":
            argv = train_argv(config, workdir, DP_STEPS, DEVICE, DP_WORLD)
        elif pair == "b":
            argv = train_argv(None, workdir, DP_STEPS + DP_RESUME_STEPS,
                              DEVICE, DP_WORLD)
            meta_train.broadcast_state = checked_broadcast(
                torch, os.path.join(d, "wd_gloo", "ckpts",
                                    f"step_{DP_STEPS}.pt"), bcast)
        else:
            argv = train_argv(config, workdir, DP_STEPS, DEVICE, 1)
            plain_args = ctc_kernel._launch_args

            def launch_args(logp_z, tangent):
                if not tangent:
                    k2_rows.append(logp_z.shape[0])
                return plain_args(logp_z, tangent)

            ctc_kernel._launch_args = launch_args
        inner_before = reduce_inner.all_reduces
        out = dp_cli(torch, argv, workdir)
        stamps["trained"] = time.time()
        out.pop("state")
        out["broadcast_state"] = bcast
        out["inner_all_reduces"] = reduce_inner.all_reduces - inner_before
        out["k2_rows"] = k2_rows
        if pair != "b":
            # the outer all-reduce's size; on the data axis also an inner
            # step's (every leaf adapts) with its support loss, over the
            # same two ranks
            n = sum(v.numel() for v in out["params"].values()) + (
                pair == "c")
            out["allreduce"] = {"bytes": 4 * n,
                                "ms": allreduce_ms(torch, n, group)}
            stamps["allreduce_timed"] = time.time()
        out["stamps"] = stamps
        path = os.path.join(d, f"{pair}_rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)   # whole, or not there
    finally:
        dist.destroy_process_group()
    return 0


def start_data_parallel():
    """Phase 27's corpus, its config and its three gloo pairs -> (the
    TemporaryDirectory, {pair: processes}, {pair: log paths}). ``main``
    starts them before phase 26, so that their start-up (interpreter,
    CUDA context, rendezvous, warm-up) overlaps it; each pair waits for
    its go."""
    from metaasr_tpu_torch.config import save_config
    from metaasr_tpu_torch.data.synthetic import generate_dataset

    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
    generate_dataset(data, accents=DP_ACCENTS, utts_per_accent=DP_UTTS,
                     words_per_utt=(2, 4), seed=0)
    save_config(dp_config(data), os.path.join(tmp.name, "dp_config.yaml"))
    procs, logs = {}, {}
    for pair in ("a", "b", "c"):
        logs[pair] = [os.path.join(tmp.name, f"{pair}_rank{r}.log")
                      for r in range(DP_WORLD)]
        procs[pair] = []
        for r, path in enumerate(logs[pair]):
            with open(path, "w") as f:
                procs[pair].append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dp-worker", str(r), tmp.name, pair], stdout=f,
                    stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.abspath(__file__))))
    return tmp, procs, logs


def dp_wait(procs, logs, results, timeout: float) -> None:
    """Wait until every rank has written its ``results`` file (its exit,
    which tears down a CUDA context, is waited for later); a rank that
    fails, or the time limit, stops the run with that rank's log."""
    t0 = time.monotonic()
    while not all(os.path.exists(f) for f in results):
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c is not None
               and not os.path.exists(results[r])]
        if bad or time.monotonic() - t0 > timeout:
            r = bad[0] if bad else 0
            with open(logs[r]) as f:
                tail = f.read()[-3000:]
            raise SystemExit(f"data-parallel rank {r} "
                             f"{'exited ' + str(codes[r]) if bad else 'late'}"
                             f":\n{tail}")
        time.sleep(0.02)


def phase_data_parallel(torch, smi, started=None):
    """The task-axis data-parallel meta-step at config3 width through the
    CLI: ``--mesh-tasks 1`` under a group of one over NCCL against no flag
    (bit for bit), then ``--mesh-tasks 2`` on two gloo ranks on the one
    card, each running 2 of the 4 tasks, against the one-process run, and
    a fresh gloo pair resuming their run against the one process resumed
    the same way; exact launches, all-reduces and broadcasts, rank-0-only
    writes, the state each resumed rank holds against rank 0's checkpoint.
    Then the data axis: ``--mesh-tasks 1`` on a third gloo pair, each rank
    running every task on 2 of its 4 + 4 shots, against the same one
    process: bit-equal ranks, exact launches (K2 at B = 2), inner and outer
    all-reduces, and meta_loss, grad_norm and parameters within the
    bounds of bf16 rounding and Adam's step. ``started``:
    ``start_data_parallel()``'s result, else the ranks start here."""
    import torch.distributed as dist

    from metaasr_tpu_torch.parallel import initialize
    from metaasr_tpu_torch.scripts.multihost_trainer_smoke import train_argv

    t_phase = time.perf_counter()
    m = config3_train()[0].meta
    per_rank = m.tasks_per_batch // DP_WORLD

    def want(steps, tasks):
        return kernel_counts(steps * 2 * tasks,
                             steps * tasks * (m.inner_steps + 1))

    end = DP_STEPS + DP_RESUME_STEPS
    out = {"phase": "data_parallel", "card": smi, "world": DP_WORLD,
           "tasks": m.tasks_per_batch, "steps": DP_STEPS,
           "resumed_steps": DP_RESUME_STEPS, "accents": list(DP_ACCENTS),
           "utts_per_accent": DP_UTTS, "deterministic_algorithms": True}
    tmp, procs, logs = started or start_data_parallel()
    every = [p for pair in procs.values() for p in pair]
    with tmp as d:
        config = os.path.join(d, "dp_config.yaml")
        try:
            # gate 1: --mesh-tasks 1 under a group of one over NCCL, then
            # no flag (and its resume by DP_RESUME_STEPS)
            group = initialize(init_method=f"file://{d}/rdzv_nccl",
                               world_size=1, rank=0, backend="nccl",
                               timeout=DP_TIMEOUT_S)
            try:
                wd = os.path.join(d, "wd_nccl")
                nccl = dp_cli(torch, train_argv(config, wd, DP_STEPS, DEVICE,
                                                1), wd)
                n = sum(v.numel() for v in nccl["params"].values())
                nccl["allreduce"] = {"bytes": 4 * n,
                                     "ms": allreduce_ms(torch, n, group)}
                nccl["broadcast_state"] = broadcast_ms(torch, nccl.pop(
                    "state"), group)
            finally:
                dist.destroy_process_group()
            wd = os.path.join(d, "wd_one")
            one = dp_cli(torch, train_argv(config, wd, DP_STEPS, DEVICE), wd,
                         with_init=True)
            one_resumed = dp_cli(torch, train_argv(None, wd, end, DEVICE),
                                 wd)
            for run in (one, one_resumed):
                run.pop("state")
            # gates 2 and 3: the gloo pair, then the fresh pair resuming
            # its run, each waiting since it started
            ranks = {}
            for pair in ("a", "b", "c"):
                t0, go = time.perf_counter(), time.time()
                open(os.path.join(d, f"go_{pair}"), "w").close()
                results = [os.path.join(d, f"{pair}_rank{r}.pt")
                           for r in range(DP_WORLD)]
                dp_wait(procs[pair], logs[pair], results, 600)
                out[f"pair_{pair}_wait_s"] = time.perf_counter() - t0
                ranks[pair] = [torch.load(f, weights_only=False)
                               for f in results]
                for r in ranks[pair]:
                    r["stamps_s_from_go"] = {
                        k: round(v - go, 3) for k, v in r["stamps"].items()}
            for p in every:   # they exit on their own once written
                p.wait(timeout=120)
            out["ranks_exit_s"] = time.perf_counter() - t0
        finally:
            for p in every:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in every]
    if codes != [0] * len(every):
        raise SystemExit(f"data-parallel ranks exited {codes}")

    def rel(a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-30)

    def params_equal(a, b):
        return all(torch.equal(a[k], v) for k, v in b.items())

    def worst(a, b):
        return max(float((a[k] - v).abs().max()) for k, v in b.items())

    def gaps(got, want_recs):
        return {key: [rel(a[key], b[key]) for a, b in zip(got, want_recs)]
                for key in ("meta_loss", "grad_norm")}

    def summary(run):
        return {k: run[k] for k in ("step", "launches", "all_reduces",
                                    "broadcasts", "rows", "device", "store",
                                    "ms_per_step_logged", "cli_s",
                                    "peak_mem_gb", "workdir")} | {
            "meta_loss": [r["meta_loss"] for r in run["records"]],
            "grad_norm": [r["grad_norm"] for r in run["records"]],
            "allreduce": run.get("allreduce"),
            "broadcast_state": run.get("broadcast_state"),
            "stamps_s_from_go": run.get("stamps_s_from_go")}

    (r0, r1), (b0, b1), (c0, c1) = ranks["a"], ranks["b"], ranks["c"]
    resumed = b0["records"][DP_STEPS:]       # rank 0's log: both pairs'
    one_tail = one_resumed["records"][DP_STEPS:]
    out["group_of_one_nccl"] = summary(nccl)
    out["one_process"] = summary(one)
    out["one_process_resumed"] = summary(one_resumed)
    out["gloo_ranks"] = [summary(r) for r in (r0, r1)]
    out["gloo_resumed_ranks"] = [summary(r) for r in (b0, b1)]
    out["gloo_vs_one_process"] = gaps(r0["records"], one["records"]) | {
        "param_max_abs": worst(r0["params"], one["params"])}
    out["resumed_vs_one_process"] = gaps(resumed, one_tail) | {
        "param_max_abs": worst(b0["params"], one_resumed["params"])}
    out["nccl_equal"] = {
        "params": params_equal(nccl["params"], one["params"]),
        "records": all(a[k] == b[k] for a, b in zip(nccl["records"],
                                                    one["records"])
                       for k in ("meta_loss", "grad_norm"))}
    out["ranks_params_equal"] = {
        "gloo": params_equal(r0["params"], r1["params"]),
        "resumed": params_equal(b0["params"], b1["params"])}
    out["broadcast_state"] = {
        "nccl_group_of_one": nccl["broadcast_state"],
        **{f"gloo_rank{r}": x["broadcast_state"]
           for r, x in enumerate((b0, b1))}}
    out["launches"] = {"dp_nccl_group_of_one": nccl["launches"],
                       "dp_one_process": one["launches"],
                       "dp_one_process_resumed": one_resumed["launches"],
                       **{f"dp_gloo_rank{r}": x["launches"]
                          for r, x in enumerate((r0, r1))},
                       **{f"dp_gloo_resumed_rank{r}": x["launches"]
                          for r, x in enumerate((b0, b1))},
                       **{f"dp_data_axis_rank{r}": x["launches"]
                          for r, x in enumerate((c0, c1))}}
    # the data axis against the one process: bf16 rounding bounds the
    # losses; Adam moves an element by at most DPD_ADAM_RATIO * lr a step
    # whatever the gradient, so two runs part by at most twice that, plus
    # the fp32 rounding of each run's update (half an ulp a step)
    from metaasr_tpu_torch.train.optimizer import make_optimizer

    cfg3 = config3_train()[0]
    lr = make_optimizer(cfg3.optimizer, cfg3.model.d_model).lr
    biggest = max(float(v.abs().max()) for v in one["params"].values())
    param_atol = (2 * DPD_ADAM_RATIO * sum(lr(t) for t in range(DP_STEPS))
                  + DP_STEPS * 2.0 ** -23 * biggest)
    d_gaps = gaps(c0["records"], one["records"])
    out["data_axis"] = {
        "mesh_tasks": 1, "data_axis": DP_WORLD,
        "shots_a_rank": [m.k_support // DP_WORLD, m.k_query // DP_WORLD],
        "ranks": [summary(x) | {"inner_all_reduces": x["inner_all_reduces"],
                                "k2_rows": sorted(set(x["k2_rows"]))}
                  for x in (c0, c1)],
        "vs_one_process": d_gaps | {
            "param_max_abs": worst(c0["params"], one["params"]),
            "param_atol": param_atol,
            "update_sign_agreement": update_signs(
                torch, c0["params"], one["params"], one["init"]),
            "meta_loss_rtol": DPD_LOSS_RTOL,
            "grad_norm_rtol": DPD_NORM_RTOL},
        "ranks_params_equal": params_equal(c0["params"], c1["params"]),
        "inner_allreduce": c0["allreduce"],
        "ms_per_step": {"ranks": [x["ms_per_step_logged"] for x in (c0, c1)],
                        "one_process": one["ms_per_step_logged"]},
        "peak_mem_gb_a_rank": [x["peak_mem_gb"] for x in (c0, c1)]}
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = DP_BUDGET_S
    log(out)
    if not (out["nccl_equal"]["params"] and out["nccl_equal"]["records"]
            and len(nccl["records"]) == len(one["records"]) == DP_STEPS):
        raise SystemExit("--mesh-tasks 1 in the NCCL group of one differs "
                         "from no flag")
    if (nccl["all_reduces"], one["all_reduces"], one_resumed["all_reduces"],
            r0["all_reduces"], r1["all_reduces"], b0["all_reduces"],
            b1["all_reduces"]) != (DP_STEPS, 0, 0, DP_STEPS, DP_STEPS,
                                   DP_RESUME_STEPS, DP_RESUME_STEPS):
        raise SystemExit("all-reduces a run: "
                         f"{[x['all_reduces'] for x in (nccl, one, one_resumed, r0, r1, b0, b1)]}")
    for name, run, counts in (
            ("nccl", nccl, want(DP_STEPS, m.tasks_per_batch)),
            ("one", one, want(DP_STEPS, m.tasks_per_batch)),
            ("one resumed", one_resumed,
             want(DP_RESUME_STEPS, m.tasks_per_batch)),
            ("rank0", r0, want(DP_STEPS, per_rank)),
            ("rank1", r1, want(DP_STEPS, per_rank)),
            ("resumed rank0", b0, want(DP_RESUME_STEPS, per_rank)),
            ("resumed rank1", b1, want(DP_RESUME_STEPS, per_rank))):
        if run["launches"] != counts:
            raise SystemExit(f"{name} launches {run['launches']}, want "
                             f"{counts}")
    if not (len(r0["records"]) == DP_STEPS and r1["records"] == []
            and len(b0["records"]) == end and b1["records"] == []
            and len(one_resumed["records"]) == end
            and one_resumed["step"] == b0["step"] == b1["step"] == end):
        raise SystemExit("rank 0 must log every step, rank 1 nothing, and "
                         f"the resumed runs end at step {end}")
    g = out["gloo_vs_one_process"]
    if not (g["meta_loss"][0] <= DP_LOSS_RTOL[0]
            and g["grad_norm"][0] <= DP_NORM_RTOL
            and max(g["meta_loss"][1:]) <= DP_LOSS_RTOL[1]):
        raise SystemExit(f"gloo ranks against one process: {g}")
    if not (out["ranks_params_equal"]["gloo"]
            and g["param_max_abs"] <= DP_PARAM_ATOL):
        raise SystemExit(f"ranks' parameters equal: "
                         f"{out['ranks_params_equal']}, from one process "
                         f"{g['param_max_abs']}")
    g = out["resumed_vs_one_process"]
    if not (len(resumed) == len(one_tail) == DP_RESUME_STEPS
            and max(g["meta_loss"]) <= DP_LOSS_RTOL[1]
            and out["ranks_params_equal"]["resumed"]
            and g["param_max_abs"] <= DP_PARAM_ATOL):
        raise SystemExit(f"the resumed pair against one process resumed: "
                         f"{g}, ranks' parameters equal "
                         f"{out['ranks_params_equal']['resumed']}")
    if not all(x["broadcasts"] == 1 and x["broadcast_state"]["equal"]
               and x["broadcast_state"]["step"] == DP_STEPS
               for x in (b0, b1)) or r0["broadcasts"] or one_resumed[
                   "broadcasts"]:
        raise SystemExit("each resumed rank must hold rank 0's checkpoint "
                         "after one broadcast: "
                         f"{[x['broadcast_state'] for x in (b0, b1)]}")
    if (sorted(r0["workdir"]) != ["ckpts", "config.yaml", "logs"]
            or not (r0["workdir"]["ckpts"] and r0["workdir"]["logs"])
            or r1["workdir"] or b1["workdir"]):
        raise SystemExit(f"workdirs: rank 0 {r0['workdir']}, rank 1 "
                         f"{r1['workdir']}, {b1['workdir']}")
    if any(x["store"] for x in (r0, r1, b0, b1, c0, c1, one, one_resumed,
                                nccl)):
        raise SystemExit("a resident store was built")
    per_task = m.inner_steps * DP_STEPS * m.tasks_per_batch
    for r, x in enumerate((c0, c1)):
        if x["launches"] != want(DP_STEPS, m.tasks_per_batch):
            raise SystemExit(f"data-axis rank {r} launches {x['launches']}, "
                             f"want {want(DP_STEPS, m.tasks_per_batch)}")
        if (len(x["k2_rows"]) != x["launches"]["k2"]
                or set(x["k2_rows"]) != {m.k_support // DP_WORLD}):
            raise SystemExit(f"data-axis rank {r}: K2 at batches "
                             f"{x['k2_rows']}")
        if (x["inner_all_reduces"], x["all_reduces"]) != (per_task,
                                                          DP_STEPS):
            raise SystemExit(f"data-axis rank {r}: {x['inner_all_reduces']} "
                             f"inner and {x['all_reduces']} outer "
                             f"all-reduces, want {per_task} and {DP_STEPS}")
    g = out["data_axis"]["vs_one_process"]
    if not (out["data_axis"]["ranks_params_equal"]
            and len(c0["records"]) == DP_STEPS and c1["records"] == []
            and not c1["workdir"]
            and g["meta_loss"][0] <= DPD_LOSS_RTOL
            and g["grad_norm"][0] <= DPD_NORM_RTOL
            and g["param_max_abs"] <= param_atol):
        raise SystemExit(f"the data axis against one process: {g}, ranks' "
                         "parameters equal "
                         f"{out['data_axis']['ranks_params_equal']}")
    return out


def update_signs(torch, got: dict, want: dict, start: dict) -> float:
    """The share of elements whose update from ``start`` has the same sign
    in ``got`` as in ``want`` (an element that moved in neither counts as
    agreeing)."""
    same = total = 0
    for k, w in want.items():
        a, b = torch.sign(got[k] - start[k]), torch.sign(w - start[k])
        same += int((a == b).sum())
        total += a.numel()
    return same / total


def dp_paths(dp, k) -> dict:
    """Phase 27's launches of kernel ``k``, by run."""
    return {path: c[k] for path, c in dp["launches"].items()}


def last_line(torch, kind) -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def precision_ab(torch, kind) -> int:
    """--precision-ab: phases 9 and 10 under the port's precision policy,
    then both again under strict fp32; one summary line."""
    runs = {}
    for tag in ("policy", "strict_fp32"):
        ctx = strict_fp32() if tag == "strict_fp32" else contextlib.nullcontext()
        with ctx:
            log({"precision_ab": tag, **precision_line(torch)})
            step, entry = phase_mono_step(torch), phase_mono_entry(torch)
        runs[tag] = {
            "ms_per_step": step["ms_per_step"],
            "ms_per_step_all": step["ms_per_step_all"],
            "peak_mem_gb": step["peak_mem_gb"],
            "device_busy_ms": step["profiled_step"]["device_busy_ms"],
            "top_kernels_ms": step["profiled_step"]["top_kernels_ms"],
            "dev_wer": [d["wer"] for d in entry["dev"]],
            "dev_cer": [d["cer"] for d in entry["dev"]]}
    log({"precision_ab_summary": runs})
    last_line(torch, kind)
    return 0


def abba(parent: str, argv, timeout: int, in_root: bool = False) -> list:
    """``argv(root)`` for PARENT's checkout and for this one, each in a
    process of its own (run in ``root`` if ``in_root``), in the order
    parent, this, this, parent: each run's output printed, and each run's
    last line, a JSON object, returned in that order."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (parent, here, here, parent):
        proc = subprocess.run(argv(root), cwd=root if in_root else None,
                              capture_output=True, text=True,
                              timeout=timeout, check=True)
        print(proc.stdout.strip(), flush=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def this_script(flag: str):
    """``abba``'s ``argv`` for a mode of this script that takes the root."""
    return lambda root: [sys.executable, os.path.abspath(__file__), flag,
                         root]


CTC_AB_SHAPES = ("per_task", "fused", "long_t")


def ctc_times(root: str) -> None:
    """One process's K2 and K2b times with ``root``'s metaasr_tpu_torch:
    CUDA-event medians of the wrappers and device ms per launch at
    CTC_AB_SHAPES (the inputs of phases 5 and 11); one JSON line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from metaasr_tpu_torch.ops import _build
    from metaasr_tpu_torch.ops import ctc as ctc_ops
    from metaasr_tpu_torch.ops import ctc_kernel

    if not ctc_kernel.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ctc_kernel.__file__}, not {root}'s")
    _build.build_all(("ctc",))
    out = {"root": root, "shapes": {}}
    for name in CTC_AB_SHAPES:
        i = list(CTC_SHAPES).index(name)
        lp, t_lens, labels, u_lens = ctc_inputs(torch, CTC_SHAPES[name],
                                                seed=10 + i)
        z = ctc_ops.extend_labels(labels)
        logp_z = ctc_ops.gather_emissions(lp, z).contiguous()
        skip = ctc_ops.skip_bias(z).contiguous()
        end = (2 * u_lens).contiguous()
        v = ctc_ops.gather_emissions(torch.from_numpy(
            np.random.default_rng(50 + i).standard_normal(
                tuple(lp.shape)).astype(np.float32)).to(DEVICE), z).contiguous()
        row = {}
        for key, fn in (
                ("k2", lambda: ctc_kernel.ctc_alpha_beta(logp_z, skip, t_lens,
                                                         end)),
                ("k2b", lambda: ctc_kernel.ctc_hvp(logp_z, skip, t_lens, end,
                                                   v))):
            row[f"{key}_ms"] = cuda_median_ms(torch, fn)
            row[f"{key}_device_ms"] = device_ms_per_call(torch, fn)
        out["shapes"][name] = row
    log(out)


def ctc_ab(parent: str) -> int:
    """--ctc-ab PARENT: ctc_times of PARENT's checkout and of this one, each
    in its own process, in the order parent, this, this, parent; then the
    device-time ratios, this over parent, of the means."""
    runs = abba(parent, this_script("--ctc-times"), 600)

    def mean(rs, name, key):
        return statistics.mean(r["shapes"][name][key] for r in rs)

    log({"ctc_ab_device_ratio_this_over_parent": {
        f"{name}_{key}": mean(runs[1:3], name, key) / mean(runs[::3], name, key)
        for name in CTC_AB_SHAPES for key in ("k2_device_ms", "k2b_device_ms")}})
    return 0


def fbank_times(root: str) -> None:
    """One process's K1 times with ``root``'s metaasr_tpu_torch: CUDA-event
    medians of the wrapper and device ms per launch at K1_MAIN (phase 2's
    inputs, 80 mel bins); one JSON line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import FbankParams
    from metaasr_tpu_torch.ops import _build

    if not fbank_kernel.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {fbank_kernel.__file__}, not {root}'s")
    _build.build_all(("fbank",))
    params = FbankParams.create()
    out = {"root": root, "shapes": {}}
    for name in K1_MAIN:
        _, audio, flens, _ = k1_inputs(torch, name)
        fn = lambda: fbank_kernel.fused_log_mel(audio, flens, params)  # noqa: E731
        out["shapes"][name] = {"k1_ms": cuda_median_ms(torch, fn),
                               "k1_device_ms": device_ms_per_call(torch, fn)}
    log(out)


def fbank_ab(parent: str) -> int:
    """--fbank-ab PARENT: fbank_times of PARENT's checkout and of this one,
    each in its own process, in the order parent, this, this, parent; then
    the device-time ratios, this over parent, of the means."""
    runs = abba(parent, this_script("--fbank-times"), 600)

    def mean(rs, name):
        return statistics.mean(r["shapes"][name]["k1_device_ms"] for r in rs)

    log({"fbank_ab_device_ratio_this_over_parent": {
        name: mean(runs[1:3], name) / mean(runs[::3], name)
        for name in K1_MAIN}})
    return 0


def paths_times(root: str) -> None:
    """One process's phases 3 and 6 (serving, the FOMAML meta-step) with
    ``root``'s metaasr_tpu_torch, under the port's precision policy; their
    times, kernel counts and busy times as the last JSON line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.ops import _build

    if not fbank_kernel.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {fbank_kernel.__file__}, not {root}'s")
    _build.build_all(("fbank", "ctc"))
    resolve_device(DEVICE)
    serving, meta = phase_serving(torch), phase_meta_step(torch)
    log({"root": root, "serving": {
        "ms_per_batch_full": serving["ms_per_batch_full"],
        "requests_ms": [r["ms"] for r in serving["requests"]],
        "cuda_kernels_per_full_batch": serving["profiled_full"]["cuda_kernels"],
        "device_busy_ms": serving["profiled_full"]["device_busy_ms"],
        "k1_launches": serving["k1_launches"]},
        "meta_step": {f"{c['tasks']}x{c['shots']}": {
            "ms_per_step": c["ms_per_step"],
            "ms_per_step_all": c["ms_per_step_all"],
            "cuda_kernels": c["profiled_step"]["cuda_kernels"],
            "device_busy_ms": c["profiled_step"]["device_busy_ms"],
            "k1_launches": c["k1_launches"]} for c in meta["cells"]}})


def paths_ab(parent: str) -> int:
    """--paths-ab PARENT: paths_times of PARENT's checkout and of this one,
    each in its own process, in the order parent, this, this, parent; then
    the ratios, this over parent, of the means of the step and batch times,
    kernel counts and busy times."""
    runs = abba(parent, this_script("--paths-times"), 900)

    def ratio(get):
        return (statistics.mean(get(r) for r in runs[1:3])
                / statistics.mean(get(r) for r in runs[::3]))

    keys = [("serving", "ms_per_batch_full"),
            ("serving", "cuda_kernels_per_full_batch"),
            ("serving", "device_busy_ms")] + [
        ("meta_step", cell, key) for cell in runs[0]["meta_step"]
        for key in ("ms_per_step", "cuda_kernels", "device_busy_ms")]

    def pick(r, key):
        for k in key:
            r = r[k]
        return r

    log({"paths_ab_ratio_this_over_parent": {
        "/".join(k): ratio(lambda r, k=k: pick(r, k)) for k in keys}})
    return 0


# One process's named phases, run by the chip_smoke.py of the directory it
# runs in: each phase's arguments by their names, from phase_build, the
# card's peak rates and the outputs of the phases named before it.
PHASE_TIMES = r"""
import inspect, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as c
from metaasr_tpu_torch.device import resolve_device
resolve_device("cuda")
smi, lstm_ptxas = c.phase_build()
have = {"torch": torch, "smi": smi, "lstm_ptxas": lstm_ptxas,
        "peaks": c.card_peaks(torch.cuda.get_device_name(0))[1]}
alias = {"meta_step": "meta", "mono_step": "mono"}
secs = {}
for name in sys.argv[1].split(","):
    fn = getattr(c, "phase_" + name)
    args = []
    for p, par in inspect.signature(fn).parameters.items():
        if p in have:
            args.append(have[p])
        elif par.default is inspect.Parameter.empty:
            raise SystemExit(f"phase_{name} needs {p!r}: name the phase "
                             f"that makes it before it")
    t0 = time.perf_counter()
    have[alias.get(name, name)] = fn(*args)
    secs[name] = round(time.perf_counter() - t0, 1)
print(json.dumps({"root_phase_seconds": secs}))
"""


def phases_ab(parent: str, names: str) -> int:
    """--phases-ab PARENT NAME,...: the phases ``phase_NAME`` of PARENT's
    checkout and of this one, each run by its own tree's chip_smoke.py in a
    process of its own, in the order parent, this, this, parent: every
    phase's lines, each run's phase seconds, then this tree's mean less
    the parent's per phase."""
    runs = [r["root_phase_seconds"] for r in abba(
        parent, lambda root: [sys.executable, "-c", PHASE_TIMES, names],
        1800, in_root=True)]
    log({"phases_ab_seconds": runs, "this_less_parent": {
        k: statistics.mean(r[k] for r in runs[1:3])
        - statistics.mean(r[k] for r in runs[::3]) for k in runs[0]}})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import metaasr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    from metaasr_tpu_torch.device import resolve_device

    resolve_device(DEVICE)  # the entry points' precision policy
    kind = torch.cuda.get_device_name(0)
    args = sys.argv[1:]
    if args[:1] == ["--ctc-ab"] and len(args) == 2:
        return ctc_ab(args[1])
    if args[:1] == ["--fbank-ab"] and len(args) == 2:
        return fbank_ab(args[1])
    if args[:1] == ["--paths-ab"] and len(args) == 2:
        return paths_ab(args[1])
    if args[:1] == ["--phases-ab"] and len(args) == 3:
        return phases_ab(args[1], args[2])
    if args and args != ["--precision-ab"]:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    seconds = {}
    corpus = None if args else start_resident_corpus()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.removeprefix("phase_")] = round(
            time.perf_counter() - t0, 1)
        return out

    smi, lstm_ptxas = timed(phase_build)
    part, peaks = card_peaks(kind)
    log({"card": smi, "torch": torch.__version__, "peak_rates_of": part, "fp32_flops": peaks[0],
         "hbm_bytes_per_s": peaks[1]})
    log(precision_line(torch))
    if args == ["--precision-ab"]:
        return precision_ab(torch, kind)
    with strict_fp32():
        k1 = timed(phase_kernel, torch, peaks)
    serving = timed(phase_serving, torch)
    with strict_fp32():
        timed(phase_parity, torch)
        k2 = timed(phase_ctc_kernel, torch, peaks)
    meta = timed(phase_meta_step, torch)
    entry = timed(phase_train_entry, torch)
    with strict_fp32():
        k3 = timed(phase_lstm_kernel, torch, peaks, lstm_ptxas)
    mono = timed(phase_mono_step, torch)
    mono_entry = timed(phase_mono_entry, torch)
    with strict_fp32():
        k2b = timed(phase_ctc_hvp_kernel, torch, peaks)
    maml = timed(phase_maml_step, torch)
    maml_entry = timed(phase_maml_entry, torch)
    meta_test = timed(phase_meta_test, torch)
    mono_test = timed(phase_mono_test, torch)
    prep = timed(phase_data_prep, torch, smi)
    lm = timed(phase_lm_fusion, torch, peaks, serving, smi)
    conformer = timed(phase_conformer, torch, meta)
    bench = timed(phase_bench, torch, smi)
    serving_benches = timed(phase_serving_benches, torch, smi)
    quality = timed(phase_quality_scripts, torch, smi)
    drill = start_acceptance()          # phase 17, beside phase 23
    try:
        flag = timed(phase_flagship, torch, smi, FLAGSHIP_BESIDE[0])
    except BaseException:
        drill[1].kill()
        raise
    timed(phase_acceptance, torch, drill)
    fusion = timed(phase_fusion_profiling, torch, smi)
    resident = timed(phase_resident_corpus, torch, smi, corpus)
    dp_ranks = start_data_parallel()     # they start up during phase 26
    grain = timed(phase_grain_loader, torch, smi, peaks, mono)
    dp = timed(phase_data_parallel, torch, smi, dp_ranks)
    log({"heldout_wer_random_init_trend": {
        "fomaml_config3": meta_test["profiled_eval_heldout"]["scores"],
        "maml_config4": maml_entry["heldout_eval"]["scores"],
        "fomaml_config3_conformer": conformer["cli"]["heldout_wer"],
        "note": "random init, 4 FOMAML / 2 MAML / 2 conformer FOMAML "
                "meta-steps on synthetic accents: a trend, not a result"}})
    # the host's speed beside the run's seconds: phase 21's B 16 decode
    b16_ms = serving_benches["decode"][0]["ms_per_batch"]
    log({"phase_seconds": seconds,
         "read_beside": {"flagship": "acceptance (its seconds are the "
                                     "join's alone)"},
         "total_phase_seconds": round(sum(seconds.values()), 1),
         "b16_decode_ms": b16_ms,
         "target_phase_seconds": 950 if b16_ms < 3000 else 1120})
    # the meta-test paths (phases 13-15), by kernel
    test_paths = {**meta_test["launches"],
                  "maml_heldout_eval": maml_entry["heldout_eval"]["launches"],
                  **mono_test["launches"]}
    new_paths = lambda k: {path: c[k]  # noqa: E731
                           for path, c in test_paths.items() if c[k]}
    maml_paths = lambda k: {  # noqa: E731
        "maml_step": maml["launches"][k],
        "maml_entry": maml_entry["launches"][k],
        "maml_entry_vgg_blstm": maml_entry["vgg_blstm_maml"]["launches"][k]}
    mono_paths = lambda k: {"mono_step": mono["launches"][k],  # noqa: E731
                            "mono_entry": mono_entry["launches"][k]}
    # phase 18: train_lm, fused serving and the fused CLI modes (K3/K3b:
    # train_lm only; the search steps the LM in plain PyTorch)
    lm_paths = lambda k: {path: c[k]  # noqa: E731
                          for path, c in lm["launches"].items()
                          if c[k] or k in ("k3", "k3b")}
    lstm_paths = lambda k: {**mono_paths(k), **new_paths(k),  # noqa: E731
                            **lm_paths(k), **fusion_paths(fusion, k),
                            **grain_paths(grain, k)}
    prep_paths = {path: c["k1"] for path, c in prep["launches"].items()}
    # phase 19: the conformer's meta-steps and CLI modes
    conformer_paths = lambda k: {  # noqa: E731
        path: c[k] for path, c in (
            ("conformer_fomaml_anil_decoder",
             conformer["fomaml_anil_decoder"]["launches"]),
            ("conformer_fomaml_full_body",
             conformer["fomaml_full_body"]["launches"]),
            ("conformer_maml", conformer["maml_second_order"]["launches"]),
            *conformer["cli"]["launches"].items()) if c[k]}
    k1_paths = {"serving": serving["k1_launches"],
                **{f"meta_step_{c['tasks']}x{c['shots']}": c["k1_launches"]
                   for c in meta["cells"]},
                "train_entry": entry["k1_launches"], **mono_paths("k1"),
                **maml_paths("k1"), **new_paths("k1"), **prep_paths,
                **lm_paths("k1"), **conformer_paths("k1"),
                "bench": sum(m["launches"]["k1"] for m in bench["measures"]),
                **quality_paths(quality, "k1"), **flagship_paths(flag, "k1"),
                **fusion_paths(fusion, "k1"), **resident_paths(resident, "k1"),
                **grain_paths(grain, "k1"), **dp_paths(dp, "k1")}
    k2_paths = {**{f"meta_step_{c['tasks']}x{c['shots']}": c["k2_launches"]
                   for c in meta["cells"]},
                "train_entry": entry["k2_launches"], **mono_paths("k2"),
                **maml_paths("k2"), **new_paths("k2"),
                "prep_feats_train": prep["launches"]["prep_feats_train"]["k2"],
                **lm_paths("k2"), **conformer_paths("k2"),
                "bench": sum(m["launches"]["k2"] for m in bench["measures"]),
                **quality_paths(quality, "k2"), **flagship_paths(flag, "k2"),
                **fusion_paths(fusion, "k2"), **resident_paths(resident, "k2"),
                **grain_paths(grain, "k2"), **dp_paths(dp, "k2")}
    k2b_paths = {**maml_paths("k2b"), **conformer_paths("k2b"),
                 **flagship_paths(flag, "k2b")}
    k2_task = k2["shapes"]["per_task"]
    k2b_shapes = k2b["shapes"]
    k2b_task = k2b_shapes["fused"]     # [16, 99, 65]: config4's per-task batch
    k3_shapes = k3["shapes"]
    k3_main = k3_shapes["config1"]
    yard = k3["library_yardstick"]
    at_lm = lm["kernels_at_lm_shape"]
    # phase 26: each kernel at the grain loader's cap shapes
    cap = grain["kernels_at_caps"]
    cap_k1 = {k: cap["k1"][k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "tol_ratio", "oracle_max_abs_err")}
    cap_k2 = {k: cap["k2"][k] for k in (
        "shape_btuv", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "loss_max_abs_diff", "grad_l2rel", "dependent_steps")}
    cap_k2["layout"] = cap["k2"]["plan"]["layout"]
    cap_lstm = lambda tag, err: {  # noqa: E731
        "shape_tbh": cap["k3_k3b"]["shape_tbh"],
        "ms": cap["k3_k3b"][f"{tag}_ms"],
        "plain_ms": cap["k3_k3b"][f"plain_{tag}_ms"],
        "bound_ms": cap["k3_k3b"][f"{tag}_bound_ms"],
        "bound_by": cap["k3_k3b"][f"{tag}_bound_by"],
        "max_abs_err": cap["k3_k3b"][err],
        "plan": cap["k3_k3b"]["plan"]}
    lstm_rows = [{
        "name": name, "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/lstm.cu",
        "replaces": f"metaasr_tpu/ops/lstm_pallas.py:{line}",
        "launches": sum(lstm_paths(key).values()),
        "launches_by_path": lstm_paths(key),
        "max_abs_err": max(e[err] for e in k3_shapes.values()),
        "shape_tbh": k3_main["shape_tbh"], "ms": k3_main[f"{tag}_ms"],
        "plain_ms": k3_main[f"plain_{tag}_ms"],
        "bound_ms": k3_main[f"{tag}_bound_ms"],
        "bound_by": k3_main[f"{tag}_bound_by"],
        "dependent_steps": k3_main["dependent_steps"],
        "cluster": k3_main["plan"]["cluster"],
        "tile": k3_main["plan"]["tile"],
        "library_ms": yard[lib_key], "library_is": lib_what,
        "lm_shape": {"shape_tbh": at_lm["shape_tbh"], "plan": at_lm["plan"],
                     "tiles": at_lm["tiles"], "ms": at_lm[f"{tag}_ms"],
                     "device_ms": at_lm[f"{tag}_device_ms"],
                     "plain_ms": at_lm[f"plain_{tag}_ms"],
                     "bound_ms": at_lm[f"{tag}_bound_ms"],
                     "bound_by": at_lm[f"{tag}_bound_by"],
                     "nn_lstm_ms": at_lm[f"nn_lstm_{tag}_ms"],
                     "kernel_layer_ms": at_lm[f"kernel_layer_{tag}_ms"]},
        "at_grain_caps": cap_lstm(tag, err),
        **extra}
        for name, line, key, err, tag, lib_key, lib_what, extra in (
            ("lstm_forward", 48, "k3", "fwd_max_abs_diff", "fwd",
             "nn_lstm_fwd_ms",
             "nn.LSTM forward, input projection included",
             {"us_per_dependent_step": k3_main["fwd_us_per_dependent_step"],
              "fwd_no_gates_ms": k3_main["fwd_no_gates_ms"]}),
            ("lstm_backward", 71, "k3b", "dgx_max_abs_diff", "bwd",
             "nn_lstm_bwd_ms",
             "nn.LSTM backward alone (forward + backward less forward), "
             "the input projection's backward included",
             {"us_per_dependent_step": k3_main["bptt_us_per_dependent_step"],
              "bptt_ms": k3_main["bptt_ms"], "du_ms": k3_main["du_ms"],
              "du_splits": k3_main["du_splits"],
              "dgx_l2rel": max(e["dgx_l2rel"] for e in k3_shapes.values()),
              "du_l2rel": max(e["du_l2rel"] for e in k3_shapes.values())}))]
    log({"kernels": [{
        "name": "fbank_log_mel", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/fbank.cu",
        "replaces": "metaasr_tpu/frontend/pallas_fbank.py:54",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": k1["max_abs_err"],
        "max_abs_err_where_plain_within_tol":
            k1["max_abs_err_where_plain_within_tol"],
        "tol_ratio": k1["max_tol_ratio"],
        "oracle_max_abs_err": k1["oracle_max_abs_err"],
        "shape": k1["shapes"][K1_MAIN[0]]["shape"], "ms": k1["ms"],
        "device_ms": k1["device_ms"], "host_ms": k1["host_ms"],
        "launch": k1["shapes"][K1_MAIN[0]]["launch"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "dft_gemm_bound_ms": k1["shapes"][K1_MAIN[0]]["dft_gemm_bound_ms"],
        "library_ms": None,
        "library_is": "none: no single PyTorch call computes framing, the "
                      "front-end, DFT power, mel and log; cufft_path_ms is "
                      "the several-call composite (torch.fft.rfft, @ mel_t)",
        "cufft_path_ms": k1["shapes"][K1_MAIN[0]]["cufft_path_ms"],
        "at_grain_caps": cap_k1,
        "device_ms_by_shape": {n: e["device_ms"]
                               for n, e in k1["shapes"].items()}}, {
        "name": "ctc_alpha_beta", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/ctc.cu",
        "replaces": "metaasr_tpu/ops/ctc_pallas.py:66",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        "max_abs_err": max(e["loss_max_abs_diff"]
                           for e in k2["shapes"].values()),
        "grad_l2rel": max(e["grad_l2rel"] for e in k2["shapes"].values()),
        "shape_btuv": k2_task["shape_btuv"], "ms": k2_task["ms"],
        "device_ms": k2_task["device_ms"], "host_ms": k2_task["host_ms"],
        "layout": k2_task["plan"]["layout"], "plan": k2_task["plan"],
        "dependent_steps": k2_task["dependent_steps"],
        "plain_ms": k2_task["plain_ms"], "bound_ms": k2_task["bound_ms"],
        "bound_by": k2_task["bound_by"],
        "library_ms": k2_task["library_ms"], "at_grain_caps": cap_k2}, {
        "name": "ctc_hvp", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/ctc.cu",
        "replaces": "metaasr_tpu/ops/ctc_pallas.py:191",
        "launches": sum(k2b_paths.values()),
        "launches_by_path": k2b_paths,
        "max_abs_err": max(e["hv_max_abs_diff"]
                           for e in k2b_shapes.values()),
        "hv_l2rel": max(e["hv_l2rel"] for e in k2b_shapes.values()),
        "shape_btuv": k2b_task["shape_btuv"], "ms": k2b_task["ms"],
        "device_ms": k2b_task["device_ms"], "host_ms": k2b_task["host_ms"],
        "layout": k2b_task["plan"]["layout"], "plan": k2b_task["plan"],
        "plain_ms": k2b_task["plain_ms"], "bound_ms": k2b_task["bound_ms"],
        "bound_by": k2b_task["bound_by"],
        "dependent_steps": k2b_task["dependent_steps"],
        "library_ms": None,
        "library_is": "none: no single PyTorch call computes a CTC "
                      "Hessian-vector product (F.ctc_loss is not twice "
                      "differentiable); scan_double_backward_ms is autograd "
                      "of autograd through the scan recursion on the card",
        "scan_double_backward_ms": k2b_task["scan_double_backward_ms"]},
        *lstm_rows]})
    last_line(torch, kind)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"] and len(sys.argv) == 5:
        code = dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.stdout.flush()
        os._exit(code)   # its results are written: skip the teardown
    if sys.argv[1:2] == ["--ctc-times"] and len(sys.argv) == 3:
        ctc_times(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--fbank-times"] and len(sys.argv) == 3:
        fbank_times(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--paths-times"] and len(sys.argv) == 3:
        paths_times(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
