#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``svd_lstm_tpu_torch``) on one card.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card and ``nvcc``; with no card it exits non-zero at once and
prints no result. It imports torch, numpy and the port, never JAX. With
``--parent DIR`` (another checkout of the repo, e.g. the parent commit
unpacked by ``git archive``) phase 5c also times DIR's inference kernels and
paths, narrow and wide train kernels and steps in turns with this
checkout's (see 5c).

Phases, each of which raises on failure (no phase is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``svd_lstm_tpu_torch/ops/csrc`` and print the
   build time and the compiler's resource report;
3. check each batch-1 kernel against its plain PyTorch version on the card
   at the main path's shapes (T = 6656, d = 16, TF32 off; K1's route, the
   weights' home and lanes of ``cuda_lstm.dense_plan``, K3's plan, its
   units a CTA, CTAs and the weights' home of
   ``cuda_lstm.recurrence_plan``, and K2's, its cluster of CTAs, warps a
   CTA, the weights' home and bytes a CTA of ``cuda_lstm.reduced_plan``,
   are printed; K2 on every layer of ``wide_r24_progressive`` and of the
   direct merged and split r = 24 truncations of 3×512): max abs
   difference at most 5e-4 (the layout-exactness bound of ``bench.py``: the
   sum order differs from the plain version and the error grows over 6656
   steps), and time both;
3b. check K5 (the batched fast-mode recurrence) against its plain version on
   every layer of the 3×512 and the 4×30 checkpoints at B = 256, T = 128
   (its tile and launches a call, ``cuda_batched.batched_plan``, printed):
   within 2 bf16 ulps of max |h| (the rounding of the bf16 output) or twice
   the plain version's distance from the same recurrence with float64 state,
   whichever is larger (a float32 sum order that flips the rounding of one
   bf16 h carries on to the next steps, as in ``check_state``); time both;
3c. check the batch-1 fast variants (bf16 operands, float32 sums and
   state) against their plain fast versions at the main path's widths
   (d = 16): K1f on the 4×30 checkpoint and K3f on each 3×512 layer over
   T = 6656, within K5's limit; K2f on each layer of ``wide_r24_progressive``
   (merged r = 24) and of the 4×30 split r = 15 truncation over 64 windows
   of 16 steps spread over T = 6656, each restarted from the plain
   version's (h, c); K4 (the fused reduced stack, its route, cluster, warps
   a CTA and the weights' home of ``cuda_lstm.reduced_stack_plan`` printed)
   exact over T = 6656 on 4×30 split r = 15 and the direct 3×512 merged r =
   24 truncation, within 5e-4 or twice the plain float32 version's distance
   from float64 (ROADMAP fault 3.1; the 4×30 stack's time, cuDNN's on its
   dense reconstruction and its bound logged beside the 3×512 one's), and
   fast over 64 windows of 8 steps of x from zero state on
   4×30 split r = 15 and ``wide_r24_progressive``. A windowed check holds
   the median window to 5e-4 and three quarters of the windows to 2 bf16
   ulps (``check_windows``: over a whole run, flipped bf16 roundings carry
   the two runs apart); time each kernel, its plain version and (K1f, K3f)
   cuDNN's bf16 LSTM;
4. drive the main path through the public entry points — ``load_params`` →
   ``predict(dense)`` → ``make_singular_model`` → ``make_reduced_model`` →
   ``predict(reduced)`` — on the 3×512 checkpoint (merged, r=24) and the 4×30
   one (split, r=15), with ``impl="auto"``; check the outputs (finite, of
   shape (T, 1), and on the first 256 steps within twice the CPU's own
   float32 error of the float64 plain scan), that
   every kernel's launch count rose during this run (K3 once a layer of
   the 3×512 dense ``predict``), and time dense and reduced ``predict``;
4b. drive batched inference through ``predict(model, x (B, T, d),
   precision=...)`` at B = 256, T = 128: ``"fast"`` on the 3×512 checkpoint,
   on ``wide_r24_progressive`` (reconstructed to dense) and on the 4×30
   checkpoint, ``"high"`` on the 3×512 one; check that K5 was launched, and
   each output against ``precision="exact"`` on the card: relative Frobenius
   error within the fast band of the JAX tests (2e-2 for the wide models,
   3e-2 for the narrow one; "high" is held to 2e-2 as well); time fast, high
   and exact;
4c. drive batch-1 ``predict(model, x (T, d), precision="fast")`` on the
   3×512 checkpoint (K3f), ``wide_r24_progressive`` (K2f), and the 4×30
   checkpoint dense and split r = 15 (K1f); check that each launched its
   kernel and its output against ``precision="exact"`` on the card within
   the fast bands of 4b; report (not gate) the direct 3×512 r = 24
   truncation's fast error; time fast and exact; then
   ``bench.timing.time_all_impls`` with impls "auto", "pallas" (K1 for the
   dense model, K4 for the reduced one) and "hybrid", exact and fast, on
   4×30 r = 15 and 3×512 r = 24, and check that K4 ran in both modes;
   then print the reduced/full ratios of phases 4 and 4c (3×512 merged r =
   24 and 4×30 split r = 15, exact and fast) beside the card's name and
   power limit;
5. check the train kernels against their plain versions on the card at the
   training path's shapes (K7 at 4×40, B = 32; K9 on a 512-unit layer and on
   the first layer, d = 16, B = 128; T = 200): h and c within 1e-4 or twice
   the plain float32 version's distance from the float64 one, whichever is
   larger (the cell state is unbounded and drifts by its ulps), every
   gradient within 1e-3 × its largest plain value (a weight gradient sums
   T·B products in another order), and time forward and backward. K7's
   forward is ``narrow_fwd_wave`` (the layers as a wavefront), its backward
   ``narrow_bwd_wave`` (the layers as a reverse wavefront, dx a layer of its
   own, z recomputed from the forward's h) and then ``weight_grad``, which
   reduces every layer's dz into dW, dU and db. K9's backward runs four
   phases (R: ``gemm_f32`` recomputes z over all T·B rows; C: the dh chain,
   ``wide_bwd_chain``, one persistent cooperative launch; X: dx; G: the
   weight gradients): each phase is timed alone beside its bound, and the
   kernels one call launches are listed at T and T/2 (as many either way,
   the chain kernel among them). K9's forward runs two parts (the x-side,
   ``gemm_f32`` over all T·B rows; the recurrence, ``wide_fwd_chain``, one
   persistent cooperative launch): each is timed alone beside its bound,
   and its launches are listed at T and T/2 the same way;
5b. the same for K6 (the recurrence-only train pair, K9's forward without
   the x-side and its backward without X) at run D's shapes (n = 512, B =
   128, T = 200);
6. drive the training path through the public entry points, on windows of
   the package's deterministic DROPBEAR surrogate: run A ``fit`` of a fresh
   4×40 stack (K7), run B ``finetune`` of σ under the Hoyer penalty on the
   factorized 4×30 checkpoint (K7 through the differentiable
   reconstruction), then ``make_reduced_model(cutoff=0.05)`` → ``predict``
   (K1), run C ``fit`` of the 3×512 checkpoint (K9 per layer), run D ``fit``
   of a fresh one-layer 512-unit stack (K6: one 128-aligned layer, not a
   uniform stack); check that each run launched its kernels, that every
   loss is finite, that the fine-tune froze the factors and moved σ, and the
   reduced output;
5c. the same for K8 (K7's two kernels with the weights staged in shared
   memory wherever the stack fits) at the recovery path's batch (B = 128,
   T = 200) on a fresh 4×40 stack and on the dense view of the 4×30 split r = 15
   truncation, timed beside K7 on the same inputs (K8, K7, K7, K8 in turn),
   and in turns with K7 at run A's inputs (B = 32) too; with ``--parent
   DIR``, K7 forward and backward at run A's shapes, K8's at B = 128, K9's
   at run C's (layer 1), K6's at run D's, cuDNN's on each, K9f's and K6f's
   forward and backward on the same inputs beside cuDNN's bf16 forward and
   backward, and one train step of runs A, B, E (narrow) and C, D, F (wide)
   with the float32 kernels and of C and D in the fused_kernel regime (K9f,
   K6f): its span, the host's
   time to issue it, the card's busy time from torch.profiler, in all and
   in the pair's forward and backward kernels; each measured in a fresh
   process on DIR's package and on this checkout's, in turns (P C C P C P P
   C: parent, change); in the same processes the inference side: K1 exact
   at 4×30 (the checkpoint) and 4×40 (run A's fresh stack) and K1f at 4×30
   over T = 6656, K5 on 3×512's layer 1 at B = 256, T = 128 alone and with
   its x-side product, K3 on 3×512's layer 0 over T = 6656 alone and with
   its x-side product and K3f alone, cuDNN's LSTM beside each (float32 and
   bf16 beside K3 and K3f), K2 and K2f on layer 0 of the direct merged r =
   24 truncation of 3×512 and of ``wide_r24_progressive``, with cuDNN's
   float32 and bf16 LSTM on the layer's exact dense reconstruction (with
   its x-side) beside them, K4 and K4f on the whole direct r = 24
   truncation, ``wide_r24_progressive`` and 4×30 split r = 15, cuDNN's
   float32 and bf16 LSTM on the stack's dense reconstruction beside them,
   batch-1 ``predict`` of 4×30 dense and split r =
   15 and of 3×512 dense and merged r = 24 (``wide_r24_progressive``;
   full_ms, reduced_ms), exact and fast, with their ratios, and batched
   fast ``predict`` on 3×512;
6. (continued) drive the post-truncation recovery through its public entry
   points, on the same windows: run E ``recover_reduced_gated`` of the 4×30
   split r = 15 truncation at B = 128 (K8 both ways), run F
   ``truncate_recover_progressive`` of the 3×512 checkpoint down ranks
   (32, 24), merged (K9 through the dense view); the launch counts are set
   to 0 just before these two runs and read just after. Each run's gate must
   be monotone (best validation MSE ≤ the raw truncation's), the final
   ranks held, and ``predict`` of the recovered model must launch K1 (E) or
   K2 (F) and agree with the CPU float64 scan as in 4. The gate validates on
   the first 2048 steps of the training half (its default, the whole half,
   runs the plain exact scan, which is launch-bound on the card);
7. hold each run against the same run with ``recurrence_kernel=False`` (the
   plain autograd scan): the first step's loss and gradients under the
   tolerances of 5, the loss histories within rtol 1e-3; time one train
   step of each. For E and F the first step is taken from the (first)
   truncation, every factor, bias and head gradient is held to 1e-3 × its
   largest plain value or twice the plain float32 gradient's distance from
   float64, whichever is larger (the truncations' C factors amplify the
   float32 sum order: ROADMAP fault 3.1), and the history is one epoch of
   ``finetune_reduced``;
8. drive the deployment slice, under exact matmuls, each part counted and
   checked: (8a) ``quantize_params`` on the card of ``wide_r24_progressive``
   (3×512 merged r = 24) and of the 4×30 checkpoint, their ``param_bytes``
   against a count of the tree's leaves and at most 0.35 × the float32
   bytes, ``quantized_apply(predict)`` over T = 6656 exact and fast (K2 and
   K2f, K1 and K1f launched, the launch counts set to 0 just before), exact
   against the CPU float64 scan of the dequantized model as in 4, the int8
   error against float32 reported, both predicts timed, and the tree saved
   and loaded back with ``q`` bit-equal; (8b) those two models and 4×30
   split r = 15 written from the card as CSVs and as the int8 ``.bin``, run
   by the native C++ runtime on the host over 2048 frames against the
   card's ``predict`` (of the float32 model, and of ``dequantized_params``
   for the ``.bin``) within 1e-4 on the first 256 frames
   (tests/test_native.py's limit), the maximum over all frames reported;
   (8c) ``make_stream_fn``'s CUDA-graph step on ``wide_r24_progressive``
   and 4×30 split r = 15 one frame at a time over 2048 frames against
   ``predict`` within 5e-4 (3's limit), against the eager ``stream_step``
   within 1e-6 (the same products in the same order), ``stream_many`` in
   chunks of 512 against the same run, and the per-frame wall clock (a host
   frame in, its host result out) of the graph step, the eager step and
   the native runtime, p50 and p99 over 2048 frames after 64, beside the
   500 µs frame period; (8d) ``python -m svd_lstm_tpu_torch export
   model_saves/wide_r24_progressive.npz DIR --int8`` and ``stream`` of
   ``DIR/model_int8.bin`` and of the checkpoint over 512 frames, each in a
   subprocess, against ``predict`` to the limits of 8b and 8c;
9. drive the evaluation slice. The script runs with an autotune cache of
   its own, empty at the start (``XDG_CACHE_HOME``, set before any
   ``predict``), so no winner stored on the machine redirects a phase.
   (9a) ``bench.autotune.autotune`` of every valid ``predict`` route at T =
   6656, exact, on the 3×512 dense checkpoint, ``wide_r24_progressive``, the
   4×30 checkpoint and its split r = 15 truncation, and fast at B = 256, T
   = 128 on 3×512: no candidate may fail; each winner is stored, and
   ``predict(impl="auto")`` must then launch the winner's kernel (the launch
   counters) and equal ``predict(impl=winner, consult_cache=False)`` bit for
   bit; the 4×30 ``predict(impl="auto")`` timed with a cache hit, a miss and
   the lookup off, and the lookup alone on the host; (9b)
   ``bench.trace.summarize`` of one ``predict`` of 3×512 dense, of
   ``wide_r24_progressive`` and of 4×30: the expected kernel
   (``recurrence_chain``, ``reduced_chain``, ``dense_stack_wave``) leads the
   breakdown, each batch-1 kernel's count in the trace equals its wrapper's
   launch count (the device trace can lose a kernel's event: a trace whose
   counts disagree is logged and the call traced again, up to
   ``TRACE_TRIES`` traces, one of which must agree), the rows add up to no more than ``device_ms`` (printed
   beside ``device_time_ms`` of the same call), and the ``trace`` command
   on ``wide_r24_progressive`` in a subprocess; (9c) each of those three
   calls' floor a step from ``bench/roofline.py`` against its measured time
   a step; (9d) ``bench.sweep.rank_sweep`` of the 4×30 checkpoint over the
   DROPBEAR surrogate's test run, an evaluation every 8 reductions over the
   whole order: K1 launched once an evaluation, the final RMSE equal to a
   fresh ``predict``'s of the final model; the same sweep over 512 steps,
   64 reductions, on the card and on the CPU's plain scan, the RMSE curves
   within a relative 1e-3; and 16 reductions of 3×512 over the first 6656
   steps of the training run, K3 once a layer an evaluation;
10. drive the training-precision slice. (10a) the bf16-operand train
   kernels against their plain bf16 versions (each product's operands
   rounded the same way): K7f at run A's shapes (4x40, B = 32, T = 200),
   K8f at B = 128 on the same stack, K9f on run C's layer 1 (3x512, B =
   128) and K6f at run D's shapes (1x512, B = 128): forward h and c and
   every gradient within 2 bf16 ulps of the plain output's largest value
   or twice the plain version's distance from the same arithmetic in
   float64, whichever is larger (``fast_check``: a sum order that flips a
   bf16 rounding carries on), each timed beside its plain version, cuDNN's
   bf16 LSTM and its float32 time (what the bf16 call runs on the card
   listed by the profiler) and its bound at 989 TFLOP/s bf16 (K7f's and
   K8f's own kernels on ``mma.sync``: ``narrow_fwd_mma``, and
   ``narrow_z``, ``narrow_bwd_mma``, ``narrow_wgrad`` in one call of the
   backward, each part timed alone by the profiler beside its bound, the
   plan, registers, spills and shared memory; one launch each way at T and
   T/2; K9f's and K6f's forward: the x-side on ``gemm_bf16`` over bf16
   copies of x and W (K9f), the chain
   on ``batched_chain`` with c stored, its product on ``mma.sync``; their
   backward: bf16 operand copies, ``gemm_bf16`` on ``wgmma`` for R, X and
   G, the dh chain's product on ``mma.sync``), then the kernels one K9f and
   one K6f forward and backward launch at T and T/2: each forward exactly
   the copies and one ``gemm_bf16`` (K9f) and ``batched_chain`` once a chunk
   of rows, no ``gemm_f32`` and no ``wide_fwd_chain``; each backward as many
   either way, the bf16 chain among them; (10b) runs A, C and D, 4
   Adam steps of ``fit`` in each training regime (the JAX package's five:
   f32_scan, tf32_scan, bf16_scan, fused_kernel, fused_kernel_compact where
   K8 takes the stack; and the port's float32 kernels), the launch counts
   set to 0 just before each main-path call and read just after: each
   regime launches its own wrappers and no others (the ``_fast`` ones in
   bf16), its trained model's exact whole-run ``predict`` on the test run
   within the fast band of 4b of the f32_scan regime's (the untrained
   model's outside it, or the band proves nothing; the parameters' change
   against the exact regime's logged), and one step's span and card busy
   time; run B's σ fine-tune and run E's gated recovery in
   the bf16 kernel regime (K7f, K8f); (10c) ``autotune_train`` at runs A's
   and C's shapes, the winner stored in the smoke's cache and served back
   by ``tuned_train_flags``, ``fit`` with ``auto_flags=True`` from float32
   scan flags launching the winner's kernels, then ``python -m
   svd_lstm_tpu_torch tune --train``. The ``kernels`` line's launches of
   the bf16 variants are those of these main-path calls only;
11. drive the conv hybrids (``models/conv.py``), every main-path call with
   the batch-1 and train kernels' counts set to 0 just before it and read
   just after (``count_call``), its launches added to the ``kernels``
   line's. First each kernel of the reference-scale path against its plain
   version on the hybrid's own inputs (the stack's n = 15 and d = 15 are
   widths no earlier phase runs; the plans printed): K7 at B = 32 and K8 at
   B = 128 (T = 200) as in 5 and 5c, K1 and K1f over T = 6656 as in 3 and
   3c, each timed. (11a) the reference's conv experiment, a seeded
   ``init_conv_lstm`` of 16 channels, 15 filters, k = 10, 2x15 units, on
   the surrogate's windows: ``fit`` at B = 32 (K7), ``make_conv_singular_model``
   (split), ``finetune`` of σ under Hoyer 0.01 (K7 on the dense view; the
   conv, the factors and the biases frozen, every σ moved),
   ``make_conv_reduced_model(cutoff=None, rank=8)``, ``recover_reduced_gated``
   at B = 128 (K8; the gate on 2048 steps, monotone, the rank held), then
   ``predict`` of the fitted and the recovered hybrids exact (K1 once) and
   fast (K1f once) over T = 6656: exact against the CPU float64 scan as in
   4, fast within 4b's narrow band; the fit held against
   ``recurrence_kernel=False`` as in 7 (the conv's w and b among the
   gradients); (11b) a seeded conv front end (16 -> 16, k = 10) over the
   3x512 checkpoint's layers and head and its direct merged r = 24
   truncation: ``predict`` exact (K3, K2 once a layer) and fast (K3f, K2f),
   exact against the CPU float64 scan, the dense hybrid's fast within the
   wide band (the truncation's fast error reported: ROADMAP fault 3.1);
   both hybrids, the bare stacks and the conv front end alone timed, the
   hybrid reduced/full ratio beside the bare one; (11c) on 11a's hybrids:
   ``quantize_params`` -> ``quantized_apply(predict)`` (K1) against the
   CPU float64 scan of the int8 model; the CSV exports and the int8 ``.bin``
   (version 3, the conv section) through the native runtime over 2048
   frames against ``predict`` within 1e-4; ``make_stream_fn``'s graph step
   on the recovered hybrid over 2048 frames against ``predict`` (5e-4) and
   the eager step (1e-6), p50 and p99 a frame beside the 500 µs period;
   ``autotune`` of the recovered hybrid, its winner launched by
   ``predict(impl="auto")`` bit-equal to the explicit impl; a
   ``rank_sweep`` of 16 reductions of the fitted hybrid (K1 once an
   evaluation). The phase prints its wall time;
12. drive the last training knobs and the structural surgery, every
   main-path call counted as in 11 (``count_call``). (12a) one f32_scan
   train step (``fit``'s resolver and loss) of a seeded 1x512 stack at B =
   64, T = 1024 with ``remat_chunk`` 0 and 64 (each after an untimed first
   step): the same loss (1e-6 relative) and gradients (1e-5 of each one's
   largest |value|), ``torch.cuda.max_memory_allocated`` above the step's
   start and the wall time both ways (the prediction printed first), failing
   unless the remat peak is below the plain one; the same step with
   ``recurrence_kernel`` launches K6 and gives the same result with either
   chunk (the knob is ignored); a split 4x30 singular step at T = 200 with
   remat 50 against 0. (12b) one epoch of a dropout σ fine-tune
   (``FactorConfig(dropout=0.2, recurrent_dropout=0.2)``) of the split 4x30
   model at B = 32, T = 200, 256 windows, ``recurrence_kernel`` set: no train
   kernel launched, finite losses, the masks of one (seed, epoch, batch)
   bit-identical, two runs from one seed within 1e-6, the step's ms; with
   rates 0 (K7) equal to the plain σ fine-tune and within 1e-3 of it on the
   scan. (12c) ``prune_to_width`` of the 3x512 checkpoint to 3x384: K3, K3f,
   K2 (its direct merged r = 24 truncation) and K9 (run C's B = 128) first
   held against their plain versions at n = 384 and timed, their plans
   printed; ``predict`` exact (K3 once a layer) against the CPU float64
   scan and within 5e-4 of the full model with the dropped units silenced,
   fast (K3f) within the wide band; the truncation's ``predict`` exact (K2)
   and fast (K2f); a ``fit`` at run C's shape (K9) held to the plain scan as
   in 7; ``prune_to_width`` of 4x30 to 4x20, ``predict`` (K1) against the
   CPU scan; the pruned and unpruned times and reduced/full ratios. (12d)
   two seeded 1x256 stacks merged by ``merge_parallel_cell_weights`` into
   one 1x512 layer (same input, and the inputs concatenated, 16 + 16), its
   head [w1; w2]: K3 against its plain version on the block-diagonal U,
   then ``predict(merged)`` within 2 x 5e-4 of ``predict(m1) +
   predict(m2)`` over T = 6656 (K3 once each). (12e) ``finetune_with_pruning``
   of the split 4x30 model, the schedule 0 -> 0.5 over two epochs (K7):
   every σ tensor at least floor(0.5 size) zeros, the cutoff truncation
   keeping none of them, ``predict`` (K1) against the CPU float64 scan. The
   phase prints its wall time.
13. run the workflow commands of ``python -m svd_lstm_tpu_torch`` in-process
   through their ``main`` (``svd_lstm_tpu_torch/examples``), outputs in a
   temporary directory, ``--plots ""``, an empty autotune cache of the
   phase's own, every call counted as in 11: ``timing --quick`` (K1 once a
   ``predict``); ``timing --wide`` at T = 6656 (K3 once a layer of each
   dense ``predict``, K2 once a layer of each reduced one, r = 256, 128,
   64, 32, 16 of the seeded 3x512's direct merged truncation), K2 first
   held on every layer at each rank against its plain version (TOL), its
   plan printed; ``timing --wide --fast`` the same with K3f and K2f (K2f
   held over 3c's windows, each window and the median within max(its
   limit, 2 x the plain version's drift from float64 state)); the full and reduced ms and ratios logged
   beside the card's name and power limit; ``compress --quick --kernel``
   on the 2x40 checkpoint (K7, K1); ``train --quick --kernel`` (K7), its
   checkpoint reloaded and predicting within 1e-5 of the trained model;
   ``sweep --quick`` (K1); ``batched --wide --precision fast`` (K5);
   ``batched --wide --precision exact --rank 24`` (the batch within 1e-5 of
   each sequence run alone); ``rank-rmse --quick`` (K7, K1 once an
   evaluation; 20 finite ratios);
   ``freq --quick``; ``seq-train --quick``; ``native-bench`` (the native
   runtime within 1e-4 of ``predict``). The phase prints its wall time.
14. the parallel slice (``svd_lstm_tpu_torch/parallel``): (14a) at world
   size 1 under NCCL on the card (a one-rank group in this process),
   ``fit_dp`` at run C's shape (K9), ``finetune_dp`` at run B's (K7) and
   ``finetune_reduced_dp`` at run E's (K8), each history within 1e-6 of its
   single-device run; the sharded dp x tp step (3x512, B = 128, T = 200)
   against the dp step (loss rtol 1e-5); ``make_batched_fast_inference``
   (3x512, B = 256, T = 128, K5 once a layer) within 1e-6 of
   ``predict(precision="fast")``; K3 and K2 over two chunks of 512 steps,
   the second from the (h, c) the first stored (``return_c``), h within TOL
   and c within ``check_state``'s limit of the plain versions; then
   ``make_pipeline_inference(ct=512)`` at T = 6656 on the 3x512 checkpoint
   (K3 once a layer and chunk) and ``wide_r24_progressive`` (K2) within TOL
   of ``predict``, its time beside predict's. (14b) run A's ``fit_dp`` on
   two gloo ranks on cuda:0 (K7 on each), against the one-rank run of 14a:
   histories rtol 1e-4, parameters atol 2e-4; a warm run's ms a step
   beside the one rank's. (14c) ``distributed --quick``
   (one rank, NCCL; K2 in the pipeline), ``wide_rank_accuracy`` on the
   committed 3x512 checkpoint with the recovery cut to 0 epochs (K3, K2 in
   its exact ``predict``s, K3f, K2f in its fast ones),
   ``conv_compression --quick`` (K1 in its ``predict``s) and
   ``realtime_stream --quick`` (both through the native runtime), each
   through its ``main``; ``entry()``'s forward on the card within 1e-4 of
   the plain CPU forward. The phase prints its wall time.

Beside each kernel the script times one PyTorch library call that computes
the same function (cuDNN ``torch.nn.LSTM``, TF32 off for the float32 ones;
for K2, K2f, K4 and K4f on the reduced layer's or stack's exact dense
reconstruction; the port never calls it) as the kernel's yardstick,
``library_ms``, and
takes the kernel's bound from ``bench/roofline.py``: the larger of its
operations over the H100's peak (67 TFLOP/s float32 on the CUDA cores, 989
TFLOP/s bf16) and its bytes (each input read once, each output written once)
over 3.35 TB/s.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if __name__ == "__main__" and sys.argv[1:2] == ["--time-tree"]:
    # tree_times on another checkout's package (see tree_turns): import it first
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.bench import autotune as at
from svd_lstm_tpu_torch.bench import roofline
from svd_lstm_tpu_torch.bench.devtime import device_time_ms
from svd_lstm_tpu_torch.bench.timing import time_all_impls, time_full_vs_reduced
from svd_lstm_tpu_torch.data import preprocess_raw, split_train_random, synthetic_dropbear_raw
from svd_lstm_tpu_torch.models.lstm import scan_recurrence
from svd_lstm_tpu_torch.models.reduced import bf16_round, folded_projection, reduced_projection
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.ops import cuda_batched as cb
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.reduced_train import reduced_dense_view
from svd_lstm_tpu_torch.train.finetune import make_finetune_optimizer, regularization_loss
from svd_lstm_tpu_torch.train.loop import default_apply_fn, mse_last_step, resolve_train_apply_fn
from svd_lstm_tpu_torch.utils.precision import train_matmul_scope

T = 6656
D = 16
TOL = 5e-4          # kernel vs plain version, f32 over T = 6656 steps
REF_STEPS = 256     # prefix compared with the plain CPU scan
REF_TOL = 1e-4      # floor of that comparison
TRAIN_T = 200       # window length of the training path
FWD_TOL = 1e-4      # train kernels vs plain: h and c, max abs diff (floor; see check_state)
GRAD_RTOL = 1e-3    # every gradient: max abs diff <= GRAD_RTOL * max |plain gradient|
HIST_RTOL = 1e-3    # loss histories, kernel runs vs plain runs
COMPACT_B = 128     # K8 and runs E, F: the batch from which the dispatch takes K8
GATE_STEPS = 2048   # runs E, F: the gate validates on this many steps of the training half
BATCH_B, BATCH_T = 256, 128  # batched inference: the JAX package's throughput point
FAST_BAND = {"wide": 2e-2, "narrow": 3e-2}  # rel. Frobenius error vs exact (tests/test_pallas_batched.py)
WINDOWS = 64        # 3c: windows a fast variant is checked over, spread over T
WINDOW_T = 16       # steps of a K2f window, restarted from the plain version's (h, c)
K4_WINDOW_T = 8     # steps of a K4 fast window, from zero state
WINDOW_SHARE = 0.75  # least share of the windows within 2 bf16 ulps (see check_windows)
IMPL_REPEATS = 3    # timed calls per model and impl in 4c (the JAX harness's default)
EXACT_NAMES = ("fused_dense_stack", "reduced_recurrence", "lstm_recurrence")
FAST_NAMES = ("fused_dense_stack_fast", "reduced_recurrence_fast", "lstm_recurrence_fast")
K4_NAMES = ("fused_reduced_stack", "fused_reduced_stack_fast")
SAVES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "model_saves")
DENSE_30 = os.path.join(SAVES, "pretrained_30units_v4_n1.5.npz")
DENSE_512 = os.path.join(SAVES, "pretrained_3x512_n1.5.npz")
WIDE_R24 = os.path.join(SAVES, "wide_r24_progressive.npz")


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def timed(fn):
    """``fn`` that also keeps the device time in ms (CUDA events, one call)
    of each of its calls in ``.ms``: a slow plain version's check call is
    its timed call (plain_ms), so it runs once."""

    def call(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        call.ms.append(start.elapsed_time(end))
        return out

    call.ms = []
    return call


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = max_err(got, want)
    log(f"[check] {name}: max abs diff {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{name}: max abs diff {err:.3e} above {tol:g}")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"[build] {info['path']}: nvcc {info['seconds']:.1f} s, "
        f"build+load {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------

def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested lists and tuples allowed)."""
    total = 0
    for t in tensors:
        total += nbytes(*t) if isinstance(t, (list, tuple)) else t.numel() * t.element_size()
    return total


def cudnn_lstm(layers, dev, dtype=torch.float32) -> torch.nn.LSTM:
    """cuDNN's LSTM holding the layers' (W, U, b): weight_ih = Wᵀ, weight_hh =
    Uᵀ, bias_ih = b, bias_hh = 0 (its gate order i, f, g, o is the Keras
    order of the port). Every layer must have the same width."""
    d, n = layers[0][0].shape[0], layers[0][1].shape[0]
    lstm = torch.nn.LSTM(d, n, num_layers=len(layers)).to(dev, dtype)
    with torch.no_grad():
        for i, (W, U, b) in enumerate(layers):
            getattr(lstm, f"weight_ih_l{i}").copy_(W.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(U.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(b)
            getattr(lstm, f"bias_hh_l{i}").zero_()
    lstm.flatten_parameters()
    return lstm


@contextlib.contextmanager
def cudnn_exact():
    """cuDNN's float32 RNNs default to TF32 (not exact mode): off inside."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def library_forward(name: str, layers, x: torch.Tensor, want: torch.Tensor, head=None) -> float:
    """Time of one cuDNN LSTM forward (x time-major) with the layers'
    weights; logs its distance from the port's h (or, with ``head``, from
    its read-out), a check of the weight mapping, for information."""
    lstm = cudnn_lstm(layers, x.device, x.dtype)
    with cudnn_exact(), torch.no_grad():
        out = lstm(x)[0]
        out = out if head is None else head(out)
        log(f"[info] {name}: cuDNN LSTM vs the port, max abs diff {max_err(out.float(), want.float()):.3e}")
        return device_time_ms(lambda: lstm(x))


def library_train(layers, x: torch.Tensor, dh: torch.Tensor, dtype=torch.float32) -> tuple:
    """Times of one cuDNN LSTM forward with autograd on, and of its backward
    from dh (every gradient: weights and input), in ``dtype`` (float32 with
    TF32 off, or bf16)."""
    lstm = cudnn_lstm(layers, x.device, dtype)
    x = x.detach().to(dtype).requires_grad_(True)
    dh = dh.to(dtype)
    with cudnn_exact(), torch.enable_grad():
        fwd_ms = device_time_ms(lambda: lstm(x))
        out = lstm(x)[0]
        bwd_ms = device_time_ms(lambda: torch.autograd.backward(out, dh, retain_graph=True))
    return fwd_ms, bwd_ms


def reduced_library_ms(model, x: torch.Tensor, dtype, layers: int = 1) -> float:
    """cuDNN's LSTM (TF32 off) on the first ``layers`` layers of a reduced
    model's exact dense reconstruction, with the x-side product: one
    PyTorch call computing the function of K2 (one layer from xp) or K4 (the
    stack; its head left out), the yardstick of both."""
    dense = P.reconstruct_dense_model(model)
    lstm = cudnn_lstm([(l.W, l.U, l.b) for l in dense.layers[:layers]], x.device, dtype)
    xs = x[:, None].to(dtype)
    with cudnn_exact():
        return device_time_ms(lambda: lstm(xs))


def report(name: str, r: dict) -> None:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
    log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
        f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def recurrence_args(l):
    """What a layer's recurrence kernel takes after xp."""
    if isinstance(l, P.LSTMLayer):
        return (l.U,)
    return (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)


def layer_runs(model, x, proj, plain):
    """Per layer: (layer, xp, plain h). Each layer's hoisted projection xp
    is taken from the plain h of the layer below, so every layer sees the
    inputs the stack gives it."""
    out, h = [], x
    for l in model.layers:
        xp = (proj(l, h) + l.b).contiguous()
        h = plain(xp, *recurrence_args(l))
        out.append((l, xp, h))
    return out


def kernel_checks(dev, x):
    """Phase 3: every batch-1 kernel against its plain version at main-path
    shapes, timed beside its bound and its library yardstick."""
    results = {}
    Tx, d = x.shape

    # K1: 4x30 dense, and its split r=15 truncation reconstructed to dense
    m30 = P.load_params(DENSE_30, device=dev)
    for units in ((30,) * 4, (40,) * 4, (512,) * 3):
        log(f"[info] K1 route {'x'.join(map(str, units))}, d={d}: exact "
            f"{ck.dense_plan(units, d, False)}, fast {ck.dense_plan(units, d, True)}")
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    err, plain = 0.0, timed(ck.fused_dense_stack_plain)
    for name, m in (("4x30 dense", m30), ("4x30 split r=15 reconstructed", P.reconstruct_dense_model(red30))):
        err = max(err, check_close(f"K1 fused_dense_stack {name}", ck.fused_dense_stack(m, x),
                                   plain(m, x), TOL))
    results["fused_dense_stack"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.fused_dense_stack, m30, x),
        "plain_ms": plain.ms[0],
        # cuDNN runs the stack without the head (one (T, 30)·(30, 1) product)
        "library_ms": library_forward("K1 4x30", [(l.W, l.U, l.b) for l in m30.layers], x[:, None],
                                      ck.fused_dense_stack(m30, x)[:, None], m30.head),
        **roofline.dense_step_cost(d, units_of(m30)).call_bound(Tx),
        "shape": "4x30, T=6656, d=16",
    }

    # K3: each layer of the 3x512 dense checkpoint
    m512 = P.load_params(DENSE_512, device=dev)
    log(f"[info] K3 plan, n = 512: exact {ck.card_recurrence_plan(dev, 512, False)}, "
        f"fast {ck.card_recurrence_plan(dev, 512, True)}")
    plain = timed(ck.lstm_recurrence_plain)
    runs = layer_runs(m512, x, lambda l, h: torch.matmul(h, l.W), plain)
    err = max(check_close(f"K3 lstm_recurrence 3x512 layer {i}", ck.lstm_recurrence(xp, l.U), h, TOL)
              for i, (l, xp, h) in enumerate(runs))
    l0, xp0, h0 = runs[0]
    n = l0.units
    with_x = device_time_ms(lambda: ck.lstm_recurrence((torch.matmul(x, l0.W) + l0.b).contiguous(), l0.U))
    log(f"[time] K3 with its x-side product (what cuDNN computes): {with_x:.3f} ms")
    results["lstm_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.lstm_recurrence, xp0, l0.U),
        "plain_ms": plain.ms[0],
        # cuDNN also computes the x-side product x·W + b (d = 16)
        "library_ms": library_forward("K3 512", [(l0.W, l0.U, l0.b)], x[:, None], h0[:, None]),
        **roofline.recurrence_step_cost(n).call_bound(Tx),
        "shape": "one 512-unit layer, T=6656",
    }

    # K2: merged r=24 checkpoint, the direct merged r=24 truncation of 3x512
    # (|C| ~ 1.1e4, ROADMAP fault 3.1) and its split r=24 truncation
    wide = P.load_params(WIDE_R24, device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=False), rank=24)
    proj = lambda l, h: reduced_projection(l, h, "w")
    err, first, plain = 0.0, None, timed(ck.reduced_recurrence_plain)
    for name, m in (("merged r=24 (wide_r24_progressive)", wide), ("direct merged r=24 (3x512)", direct),
                    ("split r=24 (3x512)", red512)):
        l0 = m.layers[0]
        for fast in (False, True):
            plan = ck.card_reduced_plan(dev, l0.units, ck.reduced_ranks(recurrence_args(l0)[0]), fast)
            log(f"[info] K2 plan, {name}, {'fast' if fast else 'exact'}: {plan} (a CTA's weights "
                f"{plan.weight_bytes} B)")
        for i, (l, xp, h) in enumerate(layer_runs(m, x, proj, plain)):
            args = (xp, *recurrence_args(l))
            err = max(err, check_close(f"K2 reduced_recurrence {name} layer {i}",
                                       ck.reduced_recurrence(*args), h, TOL))
            first = first or (args, h)
    args, h = first
    r = args[1].shape[1]
    results["reduced_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.reduced_recurrence, *args),
        "plain_ms": plain.ms[0],  # wide_r24_progressive's layer 0, the timed kernel's call
        # cuDNN on the layer's exact dense reconstruction, with its x-side product
        "library_ms": reduced_library_ms(wide, x, torch.float32),
        **roofline.reduced_recurrence_step_cost(n, (r,)).call_bound(Tx),
        "shape": "one 512-unit layer, merged r=24, T=6656",
    }
    for name, r in results.items():
        report(name, r)
    return results


def batched_layer_inputs(model, x):
    """Per layer of a batched fast forward: (layer, xp (T, B, 4n) bf16, the
    plain K5 h). Each layer's xp comes from the plain h of the layer below,
    as ops/cuda_batched.batched_forward_fast computes it."""
    out, h = [], x.transpose(0, 1).to(torch.bfloat16)
    for l in model.layers:
        xp = (torch.matmul(h, l.W.to(torch.bfloat16)) + l.b.to(torch.bfloat16)).contiguous()
        h = cb.batched_lstm_recurrence_plain(xp, l.U)
        out.append((l, xp, h))
    return out


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def check_k5(name: str, got, xp, U, plain) -> float:
    """K5's h against the plain version: within 2 bf16 ulps of max |h| (the
    output's own rounding) or twice the plain version's distance from the
    same recurrence run with float64 state, whichever is larger — a float32
    sum order that flips one bf16 rounding of h carries on through the
    later steps, as the float32 drift does in check_state."""
    drift = max_err(plain.double(), cb.batched_lstm_recurrence_plain(xp.double(), U.double()))
    ulps = 2 * bf16_ulp(float(plain.float().abs().max()))
    log(f"[info] {name}: 2 bf16 ulps of max |h| {ulps:.3e}, plain vs float64 state {drift:.3e}")
    return check_close(name, got.float(), plain.float(), max(ulps, 2 * drift))


def batched_kernel_checks(dev) -> dict:
    """Phase 3b: K5 against its plain version on every layer of the 3x512 and
    the 4x30 checkpoints at B = 256, T = 128, timed on a 512-wide layer."""
    xb = torch.tensor(np.random.default_rng(2).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    err, chosen = 0.0, None
    for name, path in (("3x512", DENSE_512), ("4x30", DENSE_30)):
        for i, (l, xp, h) in enumerate(batched_layer_inputs(P.load_params(path, device=dev), xb)):
            err = max(err, check_k5(f"K5 batched_lstm_recurrence {name} layer {i}",
                                    cb.batched_lstm_recurrence(xp, l.U), xp, l.U, h))
            if name == "3x512" and i == 1:
                chosen = (l, xp, h)
    for n in (512, 30):
        plan = cb.card_plan(dev, BATCH_B, n, True)
        log(f"[info] K5 at n={n}, B={BATCH_B}: {plan}, {plan.chunks(BATCH_B)} launch(es) a call")
    l, xp, h = chosen  # layer 1 of 3x512: a 512-wide input, as layers 1 and 2 have
    h_in = batched_layer_inputs(P.load_params(DENSE_512, device=dev), xb)[0][2]  # layer 0's h
    n, W16, b16 = l.units, l.W.to(torch.bfloat16), l.b.to(torch.bfloat16)
    with_x = device_time_ms(lambda: cb.batched_lstm_recurrence(torch.matmul(h_in, W16) + b16, l.U))
    log(f"[time] K5 with its x-side product (what cuDNN computes): {with_x:.3f} ms")
    r = {
        "max_abs_err": err,
        "ms": device_time_ms(cb.batched_lstm_recurrence, xp, l.U),
        "plain_ms": device_time_ms(cb.batched_lstm_recurrence_plain, xp, l.U),
        # cuDNN's bf16 LSTM also computes the x-side product h_in·W + b
        "library_ms": library_forward("K5 512 bf16", [(l.W, l.U, l.b)], h_in, h),
        **roofline.recurrence_step_cost(n, B=BATCH_B, dtype=torch.bfloat16).call_bound(BATCH_T),
        "shape": f"one 512-unit layer, B={BATCH_B}, T={BATCH_T}, bf16 xp",
    }
    log(f"[time] batched_lstm_recurrence ({r['shape']}): kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    return {"batched_lstm_recurrence": r}


def fast_limit(name: str, plain: torch.Tensor, plain64: torch.Tensor) -> float:
    """K5's limit for a fast variant: 2 bf16 ulps of the plain fast
    version's largest value, or twice its distance from the same arithmetic
    with float64 state, whichever is larger (a float32 sum order that flips
    one bf16 rounding of h carries on through the later steps)."""
    drift = max_err(plain.double(), plain64)
    ulps = 2 * bf16_ulp(float(plain.abs().max()))
    log(f"[info] {name}: 2 bf16 ulps of the largest value {ulps:.3e}, plain vs float64 state "
        f"{drift:.3e}")
    return max(ulps, 2 * drift)


def as_double(model):
    return copy.deepcopy(model).double()


def units_of(model) -> list:
    return [l.units for l in model.layers]


def reduced_cost(model, d: int, dtype=torch.float32) -> roofline.StepCost:
    """A batch-1 step of a reduced model's whole stack and head, its ranks
    read from the model."""
    return roofline.reduced_step_cost(d, units_of(model), roofline.layer_ranks(model),
                                      merged=not model.layers[0].split, dtype=dtype)


def window_starts(T: int, steps: int) -> list:
    """WINDOWS start steps spread evenly over a sequence of T steps."""
    return sorted({int(t) for t in np.linspace(0, T - steps, WINDOWS)})


def plain_states(xp, rec, starts):
    """The plain fast recurrence z_t = xp_t + rec(h) over the whole xp
    (T, 4n), run in segments that end at ``starts`` (the same steps as one
    run): (h_seq (T, n), {t: (h, c) before step t})."""
    h = c = None
    h_seq, states, prev = torch.empty_like(xp[:, : xp.shape[1] // 4]), {}, 0
    for t in [*starts, xp.shape[0]]:
        if t > prev:
            seq, (h, c) = scan_recurrence(xp[None, prev:t], rec, h, c)
            h_seq[prev:t] = seq[0]
            prev = t
        if h is None:
            h = c = torch.zeros((1, h_seq.shape[1]), dtype=xp.dtype, device=xp.device)
        states[t] = (h, c)
    return h_seq, states


def check_windows(name: str, errs, drifts, ulps: float, drift_limit: bool = False,
                  median_drift: bool = False) -> float:
    """A fast variant against its plain fast version over short windows
    (each started from the plain version's state, or from zero state): the
    median window within TOL, a float32 sum order; at least WINDOW_SHARE of
    the windows within 2 bf16 ulps of the largest value. A float32 sum order
    that flips one bf16 rounding of h (or of h·B, x·B) carries on through the
    rest of a window, and on the ill-conditioned factors such a flip can
    reach far more than 2 ulps; ``drifts``, the plain version's distance
    from float64 state over the same windows, shows how often that happens
    without the kernel. ``drift_limit`` gives each window the limit
    max(2 ulps, 2 × its plain version's distance from float64 state), the
    rule K5, K1f and K3f are held to over a whole run: for a model on which
    the plain version itself strays from float64 in more than a quarter of
    the windows (the direct truncations, ROADMAP fault 3.1). ``median_drift``
    holds the median window to max(TOL, 2 × the plain version's median
    distance from float64 state) instead of TOL: where the plain float32 sums
    themselves stray past TOL (K2f at rank 256, phase 13). Returns the
    largest window's error."""
    errs, drifts = np.asarray(errs), np.asarray(drifts)
    limits = np.maximum(ulps, 2 * drifts) if drift_limit else np.full_like(errs, ulps)
    med, share = float(np.median(errs)), float(np.mean(errs <= limits))
    med_limit = max(TOL, 2 * float(np.median(drifts))) if median_drift else TOL
    log(f"[check] {name}: {len(errs)} windows, median max abs diff {med:.3e} (tol {med_limit:g}), "
        f"share within 2 bf16 ulps ({ulps:.3e}) {np.mean(errs <= ulps):.3f}"
        + (f", within max(2 ulps, 2 x the window's plain vs float64) {share:.3f}" if drift_limit else "")
        + f" (at least {WINDOW_SHARE}), largest {errs.max():.3e}; plain vs float64 state: median "
        f"{np.median(drifts):.3e}, share within {np.mean(drifts <= ulps):.3f}")
    if not bool(np.isfinite(errs).all()) or not med <= med_limit or not share >= WINDOW_SHARE:
        fail(f"{name}: the kernel disagrees with its plain version")
    return float(errs.max())


def check_finite(name: str, got: torch.Tensor, plain: torch.Tensor) -> None:
    """A fast variant's whole run: finite, of the plain version's shape. Its
    distance from the plain run is logged, not gated: over T = 6656 steps
    the flipped bf16 roundings of check_windows carry the two runs apart."""
    if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: bad output {tuple(got.shape)}")
    log(f"[info] {name}, whole run: max abs diff from the plain version {max_err(got, plain):.3e}")


def reduced_fast_windows(label: str, model, x, drift_limit: bool = False,
                         median_drift: bool = False) -> list:
    """K2f on each layer of a reduced stack against its plain version over
    WINDOWS windows of WINDOW_T steps, each restarted from the plain
    version's (h, c), and its whole run finite; each layer's xp from the
    plain h of the layer below (``drift_limit``, ``median_drift``: see
    check_windows).
    Returns, a layer, ((xp, uB, uC), the plain h, the largest window's
    error)."""
    fast, starts, h, out = "default", window_starts(x.shape[0], WINDOW_T), x, []
    for i, l in enumerate(model.layers):
        xp = (reduced_projection(l, h, "w", bf16=True) + l.b).contiguous()
        uB, uC = recurrence_args(l)
        uB64, uC64 = double([uB, uC])
        h, states = plain_states(xp, folded_projection(uB, uC, True), starts)
        errs, drifts = [], []
        for t in starts:
            hc, cc = states[t]
            xw = xp[t : t + WINDOW_T]
            plain = ck.reduced_recurrence_plain(xw, uB, uC, hc, cc, fast)
            got = ck.reduced_recurrence(xw, uB, uC, hc, cc, dot_precision=fast)
            plain64 = ck.reduced_recurrence_plain(xw.double(), uB64, uC64, hc.double(), cc.double(), fast)
            errs.append(max_err(got, plain))
            drifts.append(max_err(plain.double(), plain64))
        name = f"{label} layer {i}"
        err = check_windows(name, errs, drifts, 2 * bf16_ulp(float(h.abs().max())), drift_limit,
                            median_drift)
        check_finite(name, ck.reduced_recurrence(xp, uB, uC, dot_precision=fast), h)
        out.append(((xp, uB, uC), h, err))
    return out


def fast_kernel_checks(dev, x) -> dict:
    """Phase 3c: the fast variants K1f–K3f and K4 (exact and fast) against
    their plain versions at main-path widths, timed beside their bounds."""
    results = {}
    Tx, d = x.shape
    fast = "default"

    # K1f: the 4x30 checkpoint
    m30 = P.load_params(DENSE_30, device=dev)
    k1f_plain = timed(ck.fused_dense_stack_plain)
    plain = k1f_plain(m30, x, fast)
    limit = fast_limit("K1f 4x30", plain, ck.fused_dense_stack_plain(as_double(m30), x.double(), fast))
    got = ck.fused_dense_stack(m30, x, dot_precision=fast)
    results["fused_dense_stack_fast"] = {
        "max_abs_err": check_close("K1f fused_dense_stack fast 4x30 dense", got, plain, limit),
        "ms": device_time_ms(lambda: ck.fused_dense_stack(m30, x, dot_precision=fast)),
        "plain_ms": k1f_plain.ms[0],
        "library_ms": library_forward("K1f 4x30 bf16", [(l.W, l.U, l.b) for l in m30.layers],
                                      x[:, None].bfloat16(), got[:, None],
                                      lambda o: m30.head(o.float())),
        **roofline.dense_step_cost(d, units_of(m30), dtype=torch.bfloat16).call_bound(Tx),
        "shape": "4x30, T=6656, d=16, bf16 operands",
    }

    # K3f: each layer of 3x512, from the fast x-side of the fast layer below
    m512 = P.load_params(DENSE_512, device=dev)
    proj = lambda l, h: torch.matmul(bf16_round(h), bf16_round(l.W))
    rec = timed(lambda xp, U: ck.lstm_recurrence_plain(xp, U, dot_precision=fast))
    runs = layer_runs(m512, x, proj, rec)
    err = 0.0
    for i, (l, xp, h) in enumerate(runs):
        limit = fast_limit(f"K3f 3x512 layer {i}", h, rec(xp.double(), l.U.double()))
        err = max(err, check_close(f"K3f lstm_recurrence fast 3x512 layer {i}",
                                   ck.lstm_recurrence(xp, l.U, dot_precision=fast), h, limit))
    l0, xp0, h0 = runs[0]
    n = l0.units
    results["lstm_recurrence_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.lstm_recurrence(xp0, l0.U, dot_precision=fast)),
        "plain_ms": rec.ms[0],  # layer 0's, in layer_runs
        # cuDNN's bf16 LSTM also computes the x-side product x·W + b (d = 16)
        "library_ms": library_forward("K3f 512 bf16", [(l0.W, l0.U, l0.b)], x[:, None].bfloat16(),
                                      h0[:, None]),
        **roofline.recurrence_step_cost(n, dtype=torch.bfloat16).call_bound(Tx),
        "shape": "one 512-unit layer, T=6656, bf16 operands",
    }

    # K2f: each layer of wide_r24_progressive (merged r=24) and of 4x30 split
    # r=15, over WINDOWS windows of WINDOW_T steps, each restarted from the
    # plain version's (h, c); each layer's xp from the plain h of the layer below
    wide = P.load_params(WIDE_R24, device=dev)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    err, first = 0.0, None
    for name, m in (("merged r=24 (wide_r24_progressive)", wide), ("4x30 split r=15", red30)):
        for args, h, e in reduced_fast_windows(f"K2f reduced_recurrence fast {name}", m, x):
            err = max(err, e)
            first = first or (args, h)
    args, h = first
    r = args[1].shape[1]
    results["reduced_recurrence_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.reduced_recurrence(*args, dot_precision=fast)),
        "plain_ms": device_time_ms(lambda: ck.reduced_recurrence_plain(*args, dot_precision=fast), warmup=0,
                                   repeats=1),
        # cuDNN's bf16 LSTM on the layer's exact dense reconstruction, with its x-side
        "library_ms": reduced_library_ms(wide, x, torch.bfloat16),
        **roofline.reduced_recurrence_step_cost(n, (r,), dtype=torch.bfloat16).call_bound(Tx),
        "shape": "one 512-unit layer, merged r=24, T=6656, bf16 operands",
    }

    # K4 exact over the whole run: 4x30 split r=15 and the direct 3x512 merged
    # r=24 truncation (|C| ~ 1.1e4, ROADMAP fault 3.1)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    err, k4_plain = 0.0, timed(ck.fused_reduced_stack_plain)
    for name, m in (("4x30 split r=15", red30), ("3x512 merged r=24", red512)):
        log(f"[info] K4 plan, {name}: exact {ck.card_reduced_stack_plan(dev, m, d, False)}, "
            f"fast {ck.card_reduced_stack_plan(dev, m, d, True)}")
        plain = k4_plain(m, x)
        drift = max_err(plain.double(), ck.fused_reduced_stack_plain(as_double(m), x.double()))
        log(f"[info] K4 {name} exact: plain float32 vs float64 {drift:.3e}")
        err = max(err, check_close(f"K4 fused_reduced_stack exact {name}",
                                   ck.fused_reduced_stack(m, x), plain, max(TOL, 2 * drift)))
    k4_30 = {
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red30, x)),
        "library_ms": reduced_library_ms(red30, x, torch.float32, len(red30.layers)),
        **reduced_cost(red30, d).call_bound(Tx),
    }
    log(f"[time] K4 exact 4x30 split r=15: kernel {k4_30['ms']:.3f} ms, library (cuDNN on the dense "
        f"reconstruction) {k4_30['library_ms']:.3f} ms, bound {k4_30['bound_ms']:.4f} ms "
        f"({k4_30['bound_by']})")
    results["fused_reduced_stack"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red512, x)),
        "plain_ms": k4_plain.ms[1],  # red512's
        # cuDNN on the stack's exact dense reconstruction (the head left out)
        "library_ms": reduced_library_ms(red512, x, torch.float32, len(red512.layers)),
        **reduced_cost(red512, d).call_bound(Tx),
        "shape": "3x512 merged r=24 (direct truncation), T=6656, d=16",
    }

    # K4 fast over WINDOWS windows of K4_WINDOW_T steps of x, each from zero
    # state (the kernel takes no initial state): 4x30 split r=15 and
    # wide_r24_progressive (3x512 merged r=24 after recovery, |C| <= 199; the
    # direct truncation's bf16 operands flip apart within a few steps)
    err, k4f_plain = 0.0, timed(ck.fused_reduced_stack_plain)
    for name, m in (("4x30 split r=15", red30), ("3x512 merged r=24 (wide_r24_progressive)", wide)):
        m64 = as_double(m)
        errs, drifts, largest = [], [], 0.0
        for t in window_starts(Tx, K4_WINDOW_T):
            xw = x[t : t + K4_WINDOW_T]
            plain = ck.fused_reduced_stack_plain(m, xw, fast)
            errs.append(max_err(ck.fused_reduced_stack(m, xw, dot_precision=fast), plain))
            drifts.append(max_err(plain.double(), ck.fused_reduced_stack_plain(m64, xw.double(), fast)))
            largest = max(largest, float(plain.abs().max()))
        label = f"K4 fused_reduced_stack fast {name}"
        err = max(err, check_windows(label, errs, drifts, 2 * bf16_ulp(largest)))
        got = ck.fused_reduced_stack(m, x, dot_precision=fast)
        check_finite(label, got, k4f_plain(m, x, fast))
    k4f_30 = {
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red30, x, dot_precision=fast)),
        "library_ms": reduced_library_ms(red30, x, torch.bfloat16, len(red30.layers)),
        **reduced_cost(red30, d, torch.bfloat16).call_bound(Tx),
    }
    log(f"[time] K4 fast 4x30 split r=15: kernel {k4f_30['ms']:.3f} ms, library (cuDNN bf16 on the "
        f"dense reconstruction) {k4f_30['library_ms']:.3f} ms, bound {k4f_30['bound_ms']:.4f} ms "
        f"({k4f_30['bound_by']})")
    results["fused_reduced_stack_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(wide, x, dot_precision=fast)),
        "plain_ms": k4f_plain.ms[1],  # wide_r24_progressive's whole run
        # cuDNN's bf16 LSTM on the stack's exact dense reconstruction (the head left out)
        "library_ms": reduced_library_ms(wide, x, torch.bfloat16, len(wide.layers)),
        **reduced_cost(wide, d, torch.bfloat16).call_bound(Tx),
        "shape": "3x512 merged r=24 (wide_r24_progressive), T=6656, d=16, bf16 operands",
    }
    for name, r in results.items():
        report(name, r)
    return results


def check_vs_cpu_reference(name: str, y: torch.Tensor, m_cpu, x_cpu: torch.Tensor) -> None:
    """A card output y (T, 1) of predict(impl="auto") of a model: finite, and
    on its first REF_STEPS steps against the float64 plain scan of the same
    model on the CPU. The tolerance is twice the float32 error of the same
    impl on the CPU (plain versions), floored at REF_TOL: a reduced model
    with large C factors is ill-conditioned in float32 whatever the device.
    Converts m_cpu to float64."""
    from svd_lstm_tpu_torch.models.conv import inner_stack  # a conv hybrid routes on its stack

    if y.ndim != 2 or y.shape[1] != 1 or not bool(torch.isfinite(y).all()):
        fail(f"{name}: bad output {tuple(y.shape)}")
    impl = "fused" if max(l.units for l in inner_stack(m_cpu).layers) <= 128 else "hybrid"  # auto's pick
    cpu32 = P.predict(m_cpu, x_cpu, impl=impl)
    ref64 = P.predict(m_cpu.double(), x_cpu.double(), impl="scan").float()
    cpu_err = max_err(cpu32, ref64)
    log(f"[info] {name} first {len(x_cpu)} steps: CPU float32 impl={impl!r} "
        f"vs float64 scan {cpu_err:.3e}")
    check_close(f"{name} first {len(x_cpu)} steps vs CPU float64 scan",
                y[: len(x_cpu)].cpu(), ref64, max(REF_TOL, 2 * cpu_err))


def weights(model) -> int:
    return int(sum(p.numel() for l in model.layers for p in l.parameters()))


def main_path(dev, x):
    """Phase 4: the compress-and-predict path through the public entry
    points, counted, checked and timed. Returns the launches and each
    model's reduced / full time ratio."""
    configs = (
        ("3x512 merged r=24", DENSE_512, True, 24),
        ("4x30 split r=15", DENSE_30, False, 15),
    )
    ck.reset_launch_counts()
    runs = []
    for name, path, merged, rank in configs:
        dense = P.load_params(path, device=dev)
        k3 = ck.LAUNCHES["lstm_recurrence"]
        y_full = P.predict(dense, x)
        if path == DENSE_512 and ck.LAUNCHES["lstm_recurrence"] - k3 != len(dense.layers):
            fail(f"{name}: dense predict launched K3 {ck.LAUNCHES['lstm_recurrence'] - k3} times, "
                 f"not once a layer")
        reduced = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
        y_red = P.predict(reduced, x)
        runs.append((name, path, merged, rank, dense, reduced, y_full, y_red))
    torch.cuda.synchronize()
    launches = {k: ck.LAUNCHES[k] for k in EXACT_NAMES}
    log(f"[main] kernel launches during the main path: {launches}")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the main path")

    x_cpu = x[:REF_STEPS].cpu()
    ratios = {}
    for name, path, merged, rank, dense, reduced, y_full, y_red in runs:
        # The same surgery on the CPU. The reference is its float64 plain
        # scan; the tolerance is twice the float32 error of the same impl on
        # the CPU (plain versions), floored at REF_TOL: a reduced model with
        # large C factors is ill-conditioned in float32 whatever the device.
        dense_cpu = P.load_params(path, device="cpu")
        red_cpu = P.make_reduced_model(P.make_singular_model(dense_cpu, merged_kernel=merged), rank=rank)
        for label, y, m in (("dense", y_full, dense_cpu), ("reduced", y_red, red_cpu)):
            check_vs_cpu_reference(f"{name} {label}", y, m, x_cpu)
        timing = time_full_vs_reduced(dense, reduced, x)
        ratios[f"{name} exact"] = timing.ratio
        err = P.rmse(y_full.cpu().numpy(), y_red.cpu().numpy())
        log(f"[main] {name}: full_ms {timing.full_ms:.3f}  reduced_ms {timing.reduced_ms:.3f}  "
            f"ratio {timing.ratio:.4f}  rmse(reduced vs dense) {err:.6f}  "
            f"weights {weights(dense)} -> {weights(reduced)}")
        if merged:
            scan_ms = device_time_ms(lambda: P.predict(dense, x, impl="scan"))
            log(f"[main] {name}: dense impl='scan' {scan_ms:.3f} ms")
    return launches, ratios


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative Frobenius error, in float64."""
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


def batched_path(dev) -> dict:
    """Phase 4b: batched inference through predict(precision=...) at B = 256,
    T = 128, counted, checked against exact mode on the card, and timed."""
    xb = torch.tensor(np.random.default_rng(3).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    configs = (  # name, checkpoint, precision, band
        ("3x512 dense", DENSE_512, "fast", "wide"),
        ("wide_r24_progressive (reduced, to dense)", WIDE_R24, "fast", "wide"),
        ("4x30 dense", DENSE_30, "fast", "narrow"),
        ("3x512 dense", DENSE_512, "high", "wide"),
    )
    models = {path: P.load_params(path, device=dev) for path in (DENSE_512, WIDE_R24, DENSE_30)}
    for k in cb.KERNELS:
        k.launches = 0
    outs = [P.predict(models[path], xb, precision=prec) for _, path, prec, _ in configs]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in cb.KERNELS}
    log(f"[batched] kernel launches during the batched path: {launches}")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the batched path")

    for (name, path, prec, band), y in zip(configs, outs):
        m = models[path]
        exact = P.predict(m, xb)
        if tuple(y.shape) != (BATCH_B, BATCH_T, 1) or not bool(torch.isfinite(y).all()):
            fail(f"batched {prec} {name}: bad output {tuple(y.shape)}")
        rel = rel_err(y, exact)
        log(f"[check] batched {prec} {name} vs exact: rel Frobenius {rel:.3e}, max abs "
            f"{max_err(y, exact):.3e} (band {FAST_BAND[band]:g})")
        if not rel <= FAST_BAND[band]:
            fail(f"batched {prec} {name}: rel error {rel:.3e} above {FAST_BAND[band]:g}")
        times = {p: device_time_ms(lambda p=p: P.predict(m, xb, precision=p))
                 for p in dict.fromkeys((prec, "exact"))}
        log(f"[batched] {name} B={BATCH_B} T={BATCH_T}: "
            + ", ".join(f"{p} {t:.3f} ms" for p, t in times.items()))
    return launches


def fast_path(dev, x) -> tuple:
    """Phase 4c: batch-1 predict(precision="fast") through the public entry
    points, counted, checked against exact mode on the card and timed; then
    the timing harness over its impls, which reaches K4 through "pallas".
    Returns the launches and the fast reduced / full time ratios."""
    m512, m30 = P.load_params(DENSE_512, device=dev), P.load_params(DENSE_30, device=dev)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    configs = (  # name, model, band (None: reported, not gated), the kernel it must launch
        ("3x512 dense", m512, "wide", "lstm_recurrence_fast"),
        ("wide_r24_progressive", P.load_params(WIDE_R24, device=dev), "wide", "reduced_recurrence_fast"),
        ("4x30 dense", m30, "narrow", "fused_dense_stack_fast"),
        ("4x30 split r=15", red30, "narrow", "fused_dense_stack_fast"),
        ("3x512 direct merged r=24", red512, None, "reduced_recurrence_fast"),
    )
    ck.reset_launch_counts()
    outs = []
    for name, m, _, kernel in configs:
        before = ck.LAUNCHES[kernel]
        outs.append(P.predict(m, x, precision="fast"))
        torch.cuda.synchronize()
        if ck.LAUNCHES[kernel] == before:
            fail(f"batch-1 fast {name}: {kernel} was not launched")
    launches = {k: ck.LAUNCHES[k] for k in FAST_NAMES}
    log(f"[fast] kernel launches during the batch-1 fast path: {launches}")

    times = {}
    for (name, m, band, _), y in zip(configs, outs):
        if tuple(y.shape) != (T, 1) or not bool(torch.isfinite(y).all()):
            fail(f"batch-1 fast {name}: bad output {tuple(y.shape)}")
        exact = P.predict(m, x)
        rel = rel_err(y, exact)
        limit = "reported, not gated (ROADMAP fault 3.1)" if band is None else f"band {FAST_BAND[band]:g}"
        log(f"[check] batch-1 fast {name} vs exact: rel Frobenius {rel:.3e}, max abs "
            f"{max_err(y, exact):.3e} ({limit})")
        if band is not None and not rel <= FAST_BAND[band]:
            fail(f"batch-1 fast {name}: rel error {rel:.3e} above {FAST_BAND[band]:g}")
        times[name] = {p: device_time_ms(lambda p=p: P.predict(m, x, precision=p))
                       for p in ("fast", "exact")}
        log(f"[fast] {name} T={T}: fast {times[name]['fast']:.3f} ms, exact "
            f"{times[name]['exact']:.3f} ms")
    ratios = {}
    for full, red, key in (("3x512 dense", "3x512 direct merged r=24", "3x512 merged r=24"),
                           ("4x30 dense", "4x30 split r=15", "4x30 split r=15")):
        ratios[f"{key} fast"] = times[red]["fast"] / times[full]["fast"]
        log(f"[fast] reduced/full fast ratio, {red}: {ratios[key + ' fast']:.4f}")

    for name, dense, reduced in (("4x30 split r=15", m30, red30), ("3x512 merged r=24", m512, red512)):
        for precision in ("exact", "fast"):
            for impl, r in time_all_impls(dense, reduced, x, impls=("auto", "pallas", "hybrid"),
                                          repeats=IMPL_REPEATS, precision=precision).items():
                log(f"[timing] {name} {precision} impl={impl!r}: full {r.full_ms:.3f} ms "
                    f"({r.full_us_per_step:.3f} us/step), reduced {r.reduced_ms:.3f} ms "
                    f"({r.reduced_us_per_step:.3f} us/step), ratio {r.ratio:.4f}")
    torch.cuda.synchronize()
    launches.update({k: ck.LAUNCHES[k] for k in K4_NAMES})
    log(f"[timing] K4 launches through impl='pallas': {launches}")
    for k in K4_NAMES:
        if launches[k] < 1:
            fail(f"kernel {k} was not launched by the timing harness")
    return launches, ratios


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainRun:
    name: str
    make: object                       # device -> a fresh initial model
    cfg: P.TrainConfig
    kernels: tuple                     # the wrappers the run must launch
    factor_cfg: P.FactorConfig | None = None  # set: finetune; None: fit


TRAIN_RUNS = (
    TrainRun("A 4x40 fit",
             lambda dev: P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D,
                                             units=(40, 40, 40, 40), device=dev),
             P.TrainConfig(window_len=TRAIN_T, batch_size=32, learning_rate=1e-3,
                           recurrence_kernel=True, num_windows=128, epochs=2),
             (ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd)),
    TrainRun("B 4x30 split finetune",
             lambda dev: P.make_singular_model(P.load_params(DENSE_30, device=dev), merged_kernel=False),
             P.TrainConfig(batch_size=32, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=128, epochs=2),
             (ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd),
             P.FactorConfig(hoyer=0.01)),
    TrainRun("C 3x512 fit",
             lambda dev: P.load_params(DENSE_512, device=dev),
             P.TrainConfig(batch_size=128, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=256, epochs=1),
             (ct.wide_layer_fwd, ct.wide_layer_bwd)),
    TrainRun("D 1x512 fit",
             lambda dev: P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D,
                                             units=(512,), device=dev),
             P.TrainConfig(batch_size=128, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=256, epochs=1),
             (ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_bwd)),
)


def truncation(path: str, merged: bool, rank: int, dev):
    """A checkpoint factorized and truncated to ``rank``."""
    dense = P.load_params(path, device=dev)
    return P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)


@dataclasses.dataclass(frozen=True)
class RecoveryRun(TrainRun):
    """A post-truncation recovery: ``make`` gives the first stage's
    truncation of ``path``; one rank runs ``recover_reduced_gated`` on it,
    several run ``truncate_recover_progressive`` from the checkpoint."""

    path: str = ""
    merged: bool = False
    ranks: tuple = ()
    max_epochs: int = 1
    predict_kernel: str = ""  # the batch-1 kernel that predict runs the recovered model through


def recovery_run(name, path, merged, ranks, max_epochs, kernels, predict_kernel) -> RecoveryRun:
    return RecoveryRun(
        name, lambda dev: truncation(path, merged, ranks[0], dev),
        P.TrainConfig(batch_size=COMPACT_B, window_len=TRAIN_T, recurrence_kernel=True,
                      num_windows=256, epochs=1),
        kernels, path=path, merged=merged, ranks=ranks, max_epochs=max_epochs,
        predict_kernel=predict_kernel,
    )


RECOVERY_RUNS = (
    recovery_run("E 4x30 split r=15 gated recovery", DENSE_30, False, (15,), 2,
                 (ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_compact_bwd),
                 "fused_dense_stack"),
    recovery_run("F 3x512 merged progressive r=32 -> 24", DENSE_512, True, (32, 24), 1,
                 (ct.wide_layer_fwd, ct.wide_layer_bwd), "reduced_recurrence"),
)


def train_data():
    """The package's deterministic DROPBEAR surrogate, preprocessed."""
    return preprocess_raw(synthetic_dropbear_raw(duration=12.0), P.DataConfig(split_time=8.0))


def train(run: TrainRun, model, data, kernel: bool):
    """Runs A–D as phase 6 trains them; for E and F one epoch of
    ``finetune_reduced`` from the truncation (their loss history in 7)."""
    cfg = dataclasses.replace(run.cfg, recurrence_kernel=kernel)
    if isinstance(run, RecoveryRun):
        return P.finetune_reduced(model, data.X_train, data.y_train, cfg)
    if run.factor_cfg is None:
        return P.fit(model, data.X_train, data.y_train, cfg)
    return P.finetune(model, data.X_train, data.y_train, run.factor_cfg, cfg)


def recover(run: RecoveryRun, data, dev):
    """Run E or F through its public entry point. Returns (model, infos)."""
    X, y = data.X_train, data.y_train
    gate = dict(max_epochs=run.max_epochs, validation=(X[:, :GATE_STEPS], y[:GATE_STEPS]))
    if len(run.ranks) == 1:
        model, info = P.recover_reduced_gated(run.make(dev), X, y, train_cfg=run.cfg, **gate)
        return model, [info]
    return P.truncate_recover_progressive(P.load_params(run.path, device=dev), X, y, ranks=run.ranks,
                                          train_cfg=run.cfg, merged_kernel=run.merged, **gate)


def first_batch(run: TrainRun, data, dev):
    """The first batch ``fit`` trains on: its sampler's windows, epoch 0's
    order. Returns x (B, T, d), y (B,) on the card."""
    cfg = run.cfg
    X, y = split_train_random(data.X_train, data.y_train, cfg.num_windows, cfg.window_len,
                              seed=cfg.seed)
    sel = np.random.default_rng(cfg.seed).permutation(len(X))[: cfg.batch_size]
    return torch.tensor(X[sel], device=dev), torch.tensor(y[sel], device=dev)


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    return check_close(name, got, want, GRAD_RTOL * float(want.abs().max()))


def check_state(name: str, got: torch.Tensor, plain: torch.Tensor, plain64: torch.Tensor) -> float:
    """A forward h or c of a train kernel against the plain version. The
    cell state is unbounded (|c| passes 100 in the 3x512 checkpoint), so two
    float32 recurrences drift apart by its ulps over T steps: the tolerance
    is FWD_TOL or twice the plain float32 version's own distance from the
    float64 plain version, whichever is larger."""
    drift = max_err(plain.double(), plain64)
    log(f"[info] {name}: max |plain| {float(plain.abs().max()):.3f}, plain float32 vs float64 "
        f"{drift:.3e}")
    return check_close(name, got, plain, max(FWD_TOL, 2 * drift))


def double(tensors):
    return [tuple(t.double() for t in l) if isinstance(l, tuple) else l.double() for l in tensors]


def time_pair(name: str, shape: str, kernel, plain, *args, library_ms=None, **bounds) -> dict:
    """The kernel's time (median of 5) beside its plain version's: ``plain``
    a callable timed the same way, or a ``timed`` one already called on
    these inputs (its check call's time, so a slow plain version runs once)."""
    plain_ms = plain.ms[0] if hasattr(plain, "ms") else device_time_ms(plain, *args)
    r = {"ms": device_time_ms(kernel, *args), "plain_ms": plain_ms,
         "library_ms": library_ms, **bounds, "shape": shape}
    extra = ""
    if bounds:
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        extra = f", library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
    log(f"[time] {name} ({shape}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{extra}")
    return r


def entry_launches(fn) -> list:
    """The C entry points one call of ``fn`` launched through the train
    wrappers (``cuda_train._launch``), in order; each of the wide backward's
    (wide_gemm, wide_bwd_chain, sum_splits) launches one kernel, and its
    launcher reports a launch the card refused. Counted on the host, since
    torch.profiler's device trace can drop kernels (a call once listed 1 of
    its 5)."""
    names = []
    launch = ct._launch

    def counted(name, device, *args):
        names.append(name)
        launch(name, device, *args)

    ct._launch = counted
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ct._launch = launch
    return names


def wide_bwd_phases(name: str, x, W, U, b, h, c, dh) -> None:
    """K9's backward (W given) or K6's (W None, x the projection xp) by
    phase, each alone beside its bound: R (z), C (the dh chain), X (dx, K9),
    G (the weight gradients); then the kernels one wrapper call launches at
    T and at T/2: as many either way, the chain kernel among them."""
    T, B, n = h.shape
    G, M = 4 * n, T * B
    din = 0 if W is None else x.shape[2]
    sms = ct.sm_count(x.device)
    plan = ct.chain_plan(B, n, sms)
    z = ct.phase_r(x, W, U, b, h)
    dz = torch.empty_like(z)
    Ut = U.t().contiguous()
    ct.phase_c(z, Ut, c, dh, dz, plan)
    phases = [("R", lambda: ct.phase_r(x, W, U, b, h), M * (din + n) * G,
               nbytes(x, h, U, z) + (0 if W is None else nbytes(W, b))),
              ("C", lambda: ct.phase_c(z, Ut, c, dh, dz, plan), (T - 1) * B * G * n,
               nbytes(z, U, c, dh, dz))]
    if W is None:
        phases.append(("G", lambda: ct.phase_g(None, h, dz, sms), M * G * n, nbytes(dz, h, U)))
    else:
        phases += [("X", lambda: ct.phase_x(dz, W), M * G * din, nbytes(dz, W, x)),
                   ("G", lambda: ct.phase_g(x, h, dz, sms), M * G * (din + n + 1),
                    nbytes(dz, x, h, W, U, b))]
    for phase, fn, macs, moved in phases:
        ms = device_time_ms(fn)
        r = roofline.bound(macs, moved)
        log(f"[phase] {name} {phase}: {ms:.3f} ms, {2 * macs / ms / 1e9:.1f} TFLOP/s, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[phase] {name} chain: {plan}")
    del z, dz

    def call(steps):
        part = [t[:steps].contiguous() for t in (x, h, c, dh)]
        if W is None:
            return ct.lstm_recurrence_train_bwd(part[0], U, *part[1:])
        return ct.wide_layer_bwd(part[0], W, U, b, *part[1:])

    launches_at_two_lengths(name, call, T, "wide_bwd_chain", "one copy of U's transpose")


def launches_at_two_lengths(name: str, call, T: int, chain: str, extra: str, expect=None) -> None:
    """The kernels one wrapper call launches at T and at T/2 steps
    (``call(steps)``): as many either way, the chain kernel among them; with
    ``expect``, exactly those entry points in that order at both lengths."""
    counts = {}
    for steps in (T, T // 2):
        names = entry_launches(lambda: call(steps))
        counts[steps] = len(names)
        log(f"[launches] {name} at T={steps}: {len(names)} kernels and {extra}: " + ", ".join(names))
        if chain not in names:
            fail(f"{name}: the chain kernel did not run")
        if expect is not None and names != expect:
            fail(f"{name}: launched {names}, expected {expect}")
    if counts[T] != counts[T // 2]:
        fail(f"{name}: launches grow with T: {counts}")


def bf16_fwd_launches(name: str, call, x, n: int, with_x_side: bool) -> None:
    """K9f's or K6f's forward at T and T/2 (``call(steps)``): the copies of
    x and W and one gemm_bf16 (K9f only), then batched_chain (its entry
    point, batched_lstm_recurrence) once a chunk of rows of the plan; no
    gemm_f32 (wide_gemm) and no wide_fwd_chain."""
    T, B = x.shape[:2]
    plan = ct.fwd_plan_bf16(x.device, B, n)
    log(f"[phase] {name} chain (batched_chain, c stored): {plan}, {plan.chunks(B)} launch(es)")
    expect = (["bf16_copy", "bf16_copy", "gemm_bf16"] if with_x_side else []) + \
        ["batched_lstm_recurrence"] * plan.chunks(B)
    launches_at_two_lengths(name, call, T, "batched_lstm_recurrence", "one rounding of U's transpose",
                            expect)


def wide_fwd_phases(name: str, x, W, U, b) -> None:
    """K9's forward (W given) or K6's (W None, x the projection xp) by part,
    each alone beside its bound: the x-side GEMM (K9) and the chain; then
    the kernels one wrapper call launches at T and at T/2: as many either
    way, the chain kernel among them."""
    T, B, din = x.shape
    n = U.shape[0]
    G, M = 4 * n, T * B
    plan = ct.fwd_chain_plan(B, n, ct.sm_count(x.device))
    xz = x if W is None else ct.phase_x_side(x, W, b)
    Ui = ct.pack_gates_interleaved(U)
    h = torch.empty((T, B, n), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    parts = [] if W is None else [("x-side", lambda: ct.phase_x_side(x, W, b), M * din * G,
                                   nbytes(x, W, b, xz))]
    parts.append(("chain", lambda: ct.phase_chain_fwd(xz, Ui, h, c, plan), (T - 1) * B * n * G,
                  nbytes(xz, U, h, c)))
    for part, fn, macs, moved in parts:
        ms = device_time_ms(fn)
        r = roofline.bound(macs, moved)
        log(f"[phase] {name} {part}: {ms:.3f} ms, {2 * macs / ms / 1e9:.1f} TFLOP/s, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[phase] {name} chain: {plan}")

    def call(steps):
        part = x[:steps].contiguous()
        if W is None:
            return ct.lstm_recurrence_train_fwd(part, U)
        return ct.wide_layer_fwd(part, W, U, b)

    launches_at_two_lengths(name, call, T, "wide_fwd_chain", "one packing of U")


@torch.no_grad()
def train_kernel_checks(dev, data) -> dict:
    """Phases 5 and 5b: K7, K9 and K6 against their plain versions at the
    training path's shapes, timed beside their bounds and cuDNN's LSTM
    forward and backward (which also compute the x-side products where the
    kernel does not: K6)."""
    rng = np.random.default_rng(1)
    results = {}

    # K7 at run A's shapes: 4x40, B = 32, T = 200, d = 16
    run = TRAIN_RUNS[0]
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in run.make(dev).layers]
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    dh = torch.tensor(rng.normal(size=(*x.shape[:2], 40)), dtype=torch.float32, device=dev)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(layers, x)
    hs64, cs64 = ct.fused_narrow_train_fwd_plain(double(layers), x.double())
    hs, cs = ct.fused_narrow_train_fwd(layers, x)
    err = max(check_state(f"K7 fwd 4x40 {k}{i}", a, r, r64)
              for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64))
              for i, (a, r, r64) in enumerate(zip(got, want, want64)))
    shape = "4x40, B=32, T=200, d=16"
    T7, B7, d7 = x.shape
    macs = roofline.lstm_macs(T7, B7, [(W.shape[0], U.shape[0]) for W, U, _ in layers])
    lib_fwd, lib_bwd = library_train(layers, x, dh)
    results["fused_narrow_train_fwd"] = {
        "max_abs_err": err,
        **time_pair("K7 fwd", shape, ct.fused_narrow_train_fwd, ct.fused_narrow_train_fwd_plain, layers, x,
                    library_ms=lib_fwd, **roofline.bound(macs, nbytes(layers, x, hs, cs))),
    }
    args = (layers, x, hs_p, cs_p, dh)
    got, want = ct.fused_narrow_train_bwd(*args), ct.fused_narrow_train_bwd_plain(*args)
    err = max(check_grad(f"K7 bwd 4x40 {k}{i}", a, r)
              for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3])
              for i, (a, r) in enumerate(zip(gs, ws)))
    err = max(err, check_grad("K7 bwd 4x40 dx", got[3], want[3]))
    results["fused_narrow_train_bwd"] = {
        "max_abs_err": err,
        **time_pair("K7 bwd", shape, ct.fused_narrow_train_bwd, ct.fused_narrow_train_bwd_plain, *args,
                    library_ms=lib_bwd, **roofline.bound(3 * macs, nbytes(args, got))),
    }
    time_pair("K7 fwd+bwd", shape,
              lambda: ct.fused_narrow_train_bwd(layers, x, *ct.fused_narrow_train_fwd(layers, x), dh),
              lambda: ct.fused_narrow_train_bwd_plain(layers, x, *ct.fused_narrow_train_fwd_plain(layers, x), dh))

    # K9 at run C's shapes: the first two layers of 3x512, B = 128, T = 200
    run = TRAIN_RUNS[2]
    m512 = run.make(dev)
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()
    fwd_err = bwd_err = 0.0
    for i, l in enumerate(m512.layers[:2]):
        W, U, b = (p.detach() for p in (l.W, l.U, l.b))
        h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b)
        h64, c64 = ct.wide_layer_fwd_plain(*double([x, W, U, b]))
        h, c = ct.wide_layer_fwd(x, W, U, b)
        name = f"K9 layer {i} (d={x.shape[-1]})"
        fwd_err = max(fwd_err, check_state(f"{name} fwd h", h, h_p, h64),
                      check_state(f"{name} fwd c", c, c_p, c64))
        dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
        args = (x, W, U, b, h_p, c_p, dh)
        got, want = ct.wide_layer_bwd(*args), ct.wide_layer_bwd_plain(*args)
        bwd_err = max(bwd_err, *(check_grad(f"{name} bwd {k}", a, r)
                                 for k, a, r in zip(("dx", "dW", "dU", "db"), got, want)))
        x = h_p
    shape = "one 512-unit layer, d=512, B=128, T=200"
    T9, B9, d9 = args[0].shape
    macs = roofline.lstm_macs(T9, B9, [(d9, args[2].shape[0])])
    lib_fwd, lib_bwd = library_train([args[1:4]], args[0], dh)
    results["wide_layer_fwd"] = {
        "max_abs_err": fwd_err,
        **time_pair("K9 fwd", shape, ct.wide_layer_fwd, ct.wide_layer_fwd_plain, *args[:4],
                    library_ms=lib_fwd, **roofline.bound(macs, nbytes(args[:6]))),
    }
    results["wide_layer_bwd"] = {
        "max_abs_err": bwd_err,
        **time_pair("K9 bwd", shape, ct.wide_layer_bwd, ct.wide_layer_bwd_plain, *args,
                    library_ms=lib_bwd, **roofline.bound(3 * macs, nbytes(args, got))),
    }
    wide_fwd_phases("K9 fwd", *args[:4])
    wide_bwd_phases("K9 bwd", *args)
    time_pair("K9 fwd+bwd", shape,
              lambda: ct.wide_layer_bwd(*args[:4], *ct.wide_layer_fwd(*args[:4]), dh),
              lambda: ct.wide_layer_bwd_plain(*args[:4], *ct.wide_layer_fwd_plain(*args[:4]), dh))
    results.update(recurrence_train_checks(dev, data, rng))
    results.update(compact_kernel_checks(dev, data, rng))
    return results


def recurrence_train_checks(dev, data, rng) -> dict:
    """Phase 5b: K6 at run D's shapes (one 512-unit layer, d = 16, B = 128,
    T = 200), from the xp its fresh model gives its first batch."""
    run = TRAIN_RUNS[3]
    l = run.make(dev).layers[0]
    W, U, b = (p.detach() for p in (l.W, l.U, l.b))
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    xp = (torch.matmul(x, W) + b).contiguous()
    h_p, c_p = ct.lstm_recurrence_train_fwd_plain(xp, U)
    h64, c64 = ct.lstm_recurrence_train_fwd_plain(xp.double(), U.double())
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    fwd_err = max(check_state("K6 fwd h", h, h_p, h64), check_state("K6 fwd c", c, c_p, c64))
    dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
    args = (xp, U, h_p, c_p, dh)
    got, want = ct.lstm_recurrence_train_bwd(*args), ct.lstm_recurrence_train_bwd_plain(*args)
    bwd_err = max(check_grad(f"K6 bwd {k}", a, r) for k, a, r in zip(("dxp", "dU"), got, want))
    shape = "one 512-unit layer, B=128, T=200, xp from d=16"
    T6, B6, _ = xp.shape
    macs = roofline.lstm_macs(T6, B6, [(0, U.shape[0])])
    lib_fwd, lib_bwd = library_train([(W, U, b)], x, dh)
    results = {
        "lstm_recurrence_train_fwd": {
            "max_abs_err": fwd_err,
            **time_pair("K6 fwd", shape, ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_fwd_plain,
                        xp, U, library_ms=lib_fwd, **roofline.bound(macs, nbytes(xp, U, h, c))),
        },
        "lstm_recurrence_train_bwd": {
            "max_abs_err": bwd_err,
            **time_pair("K6 bwd", shape, ct.lstm_recurrence_train_bwd, ct.lstm_recurrence_train_bwd_plain,
                        *args, library_ms=lib_bwd, **roofline.bound(3 * macs, nbytes(args, got))),
        },
    }
    wide_fwd_phases("K6 fwd", xp, None, U, None)
    wide_bwd_phases("K6 bwd", xp, None, U, None, h_p, c_p, dh)
    time_pair("K6 fwd+bwd", shape,
              lambda: ct.lstm_recurrence_train_bwd(xp, U, *ct.lstm_recurrence_train_fwd(xp, U), dh),
              lambda: ct.lstm_recurrence_train_bwd_plain(xp, U, *ct.lstm_recurrence_train_fwd_plain(xp, U), dh))

    def fwd_with_x():
        return ct.lstm_recurrence_train_fwd((torch.matmul(x, W) + b).contiguous(), U)

    def bwd_with_x():
        dxp, dU = ct.lstm_recurrence_train_bwd(*args)
        return torch.matmul(dxp, W.t()), torch.einsum("tbd,tbg->dg", x, dxp), dxp.sum(dim=(0, 1)), dU

    log(f"[time] K6 with its x-side products (what cuDNN computes): forward "
        f"{device_time_ms(fwd_with_x):.3f} ms, backward {device_time_ms(bwd_with_x):.3f} ms")
    return results


def in_turns(name: str, shape: str, a, b, *args) -> None:
    """Two kernels on the same inputs timed in turns (a, b, b, a) in one
    call: the card and its neighbours change between calls."""
    ms = [device_time_ms(f, *args) for f in (a, b, b, a)]
    log(f"[time] {name} ({shape}), in turns: {ms[0]:.3f}, {ms[1]:.3f}, {ms[2]:.3f}, {ms[3]:.3f} ms")


def compact_kernel_checks(dev, data, rng) -> dict:
    """Phase 5c: K8 against its plain version at the recovery path's batch
    (B = 128, T = 200, d = 16) on a fresh 4x40 stack (run A's) and on the
    dense view of run E's 4x30 split r=15 truncation; timed on 4x40 beside
    its plain version, cuDNN's LSTM and, in turns, K7 on the same inputs."""
    x = first_batch(RECOVERY_RUNS[0], data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    cases = (
        ("4x40", [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in TRAIN_RUNS[0].make(dev).layers]),
        ("4x30 split r=15 dense view",
         [tuple(p.detach() for p in l) for l in reduced_dense_view(RECOVERY_RUNS[0].make(dev)).layers]),
    )
    fwd_err = bwd_err = 0.0
    for name, layers in cases:
        hs_p, cs_p = ct.fused_narrow_train_compact_fwd_plain(layers, x)
        hs64, cs64 = ct.fused_narrow_train_compact_fwd_plain(double(layers), x.double())
        hs, cs = ct.fused_narrow_train_compact_fwd(layers, x)
        fwd_err = max(fwd_err, *(check_state(f"K8 fwd {name} {k}{i}", a, r, r64)
                                 for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64))
                                 for i, (a, r, r64) in enumerate(zip(got, want, want64))))
        dh = torch.tensor(rng.normal(size=hs_p[-1].shape), dtype=torch.float32, device=dev)
        args = (layers, x, hs_p, cs_p, dh)
        got, want = ct.fused_narrow_train_compact_bwd(*args), ct.fused_narrow_train_compact_bwd_plain(*args)
        bwd_err = max(bwd_err, *(check_grad(f"K8 bwd {name} {k}{i}", a, r)
                                 for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3])
                                 for i, (a, r) in enumerate(zip(gs, ws))),
                      check_grad(f"K8 bwd {name} dx", got[3], want[3]))
        shape = f"{name}, B={x.shape[1]}, T={x.shape[0]}, d={x.shape[2]}"
        in_turns("K8 fwd, K7 fwd", shape, ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_fwd,
                 layers, x)
        in_turns("K8 bwd, K7 bwd", shape, ct.fused_narrow_train_compact_bwd, ct.fused_narrow_train_bwd,
                 *args)
        if name == "4x40":
            chosen = (shape, layers, hs, cs, args, got)
    # below the dispatch's B = 128: K8 and K7 on run A's inputs (B = 32)
    xa = first_batch(TRAIN_RUNS[0], data, dev)[0].transpose(0, 1).contiguous()
    layers = chosen[1]
    hs_a, cs_a = ct.fused_narrow_train_fwd_plain(layers, xa)
    dh_a = torch.tensor(rng.normal(size=hs_a[-1].shape), dtype=torch.float32, device=dev)
    shape_a = f"4x40, B={xa.shape[1]}, T={xa.shape[0]}, d={xa.shape[2]}"
    in_turns("K8 fwd, K7 fwd", shape_a, ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_fwd,
             layers, xa)
    in_turns("K8 bwd, K7 bwd", shape_a, ct.fused_narrow_train_compact_bwd, ct.fused_narrow_train_bwd,
             layers, xa, hs_a, cs_a, dh_a)
    shape, layers, hs, cs, args, got = chosen
    T8, B8, _ = x.shape
    macs = roofline.lstm_macs(T8, B8, [(W.shape[0], U.shape[0]) for W, U, _ in layers])
    lib_fwd, lib_bwd = library_train(layers, x, args[-1])
    results = {
        "fused_narrow_train_compact_fwd": {
            "max_abs_err": fwd_err,
            **time_pair("K8 fwd", shape, ct.fused_narrow_train_compact_fwd,
                        ct.fused_narrow_train_compact_fwd_plain, layers, x,
                        library_ms=lib_fwd, **roofline.bound(macs, nbytes(layers, x, hs, cs))),
        },
        "fused_narrow_train_compact_bwd": {
            "max_abs_err": bwd_err,
            **time_pair("K8 bwd", shape, ct.fused_narrow_train_compact_bwd,
                        ct.fused_narrow_train_compact_bwd_plain, *args,
                        library_ms=lib_bwd, **roofline.bound(3 * macs, nbytes(args, got))),
        },
    }
    dh = args[-1]
    time_pair("K8 fwd+bwd", shape,
              lambda: ct.fused_narrow_train_compact_bwd(layers, x, *ct.fused_narrow_train_compact_fwd(layers, x), dh),
              lambda: ct.fused_narrow_train_compact_bwd_plain(
                  layers, x, *ct.fused_narrow_train_compact_fwd_plain(layers, x), dh))
    return results


@torch.no_grad()
def narrow_times(dev, data) -> dict:
    """K7's pair at run A's shapes, K8's at B = 128 (4x40), cuDNN's LSTM on
    both; K7f's and K8f's pair on the same inputs beside cuDNN's bf16 LSTM:
    ms of each, in the package this process imported."""
    rng = np.random.default_rng(1)
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in TRAIN_RUNS[0].make(dev).layers]
    out = {}
    for tag, run, fwd, bwd in (("K7", TRAIN_RUNS[0], ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd),
                               ("K8", RECOVERY_RUNS[0], ct.fused_narrow_train_compact_fwd,
                                ct.fused_narrow_train_compact_bwd)):
        x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()
        hs, cs = fwd(layers, x)
        dh = torch.tensor(rng.normal(size=hs[-1].shape), dtype=torch.float32, device=dev)
        shape = f"B={x.shape[1]}"
        out[f"{tag} fwd ({shape})"] = device_time_ms(fwd, layers, x)
        out[f"{tag} bwd ({shape})"] = device_time_ms(bwd, layers, x, hs, cs, dh)
        out[f"cuDNN fwd ({shape})"], out[f"cuDNN bwd ({shape})"] = library_train(layers, x, dh)
        out[f"{tag}f fwd ({shape})"] = device_time_ms(fwd, layers, x, True)
        out[f"{tag}f bwd ({shape})"] = device_time_ms(bwd, layers, x, hs, cs, dh, True)
        out[f"cuDNN bf16 fwd ({shape})"], out[f"cuDNN bf16 bwd ({shape})"] = library_train(
            layers, x, dh, torch.bfloat16)
    return out


# the narrow pair's kernels in this checkout and in earlier ones (K7f's and
# K8f's own since their redesign: narrow_fwd_mma; narrow_z, narrow_bwd_mma,
# narrow_wgrad, nb_sum_splits; the float32 backward's weight_grad and
# sum_splits counted with it)
NARROW_PARTS = {"narrow fwd": ("narrow_fwd",),
                "narrow bwd": ("narrow_bwd", "narrow_z", "narrow_wgrad", "nb_", "weight_grad", "sum_splits")}
# the wide pair's kernels in this checkout and in earlier ones (a
# wide_fwd_step a step before the forward chain; K9f's and K6f's forward
# chain batched_chain since the bf16 forward's redesign): the x-side GEMM
# and the copies are counted with the backward's (gemm_f32, gemm_bf16,
# bf16_copy)
WIDE_PARTS = {"wide fwd": ("wide_fwd_step", "wide_fwd_chain", "batched_chain"),
              "wide bwd": ("gemm_f32", "gemm_bf16", "bf16_copy", "wide_bwd_chain", "wide_bwd_gates",
                           "matmul_nt", "weight_grad", "sum_splits")}


def step_split(step, parts: dict) -> dict:
    """A train step's host time to issue it (the card idle at its start;
    median of 5) and what it ran on the card (``bench.trace``'s breakdown
    of 3 steps, torch.profiler's device events, the mean a step): the
    summed duration of its kernels and copies, and of the kernels whose
    names hold one of ``parts``' strings; ms each."""
    # imported here: --time-tree runs this function on trees without the module
    from svd_lstm_tpu_torch.bench import trace

    issue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        issue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        stats = trace.op_breakdown(trace.capture_trace(lambda: [step() for _ in range(3)], out_dir=tmp,
                                                       warmup=0))

    def busy(names=("",)) -> float:
        return sum(s.total_ms for s in stats if any(nm in s.name for nm in names)) / 3

    return {"host issue": sorted(issue)[2], "card busy": busy(),
            **{f"card busy in the {part}": busy(names) for part, names in parts.items()}}


@torch.no_grad()
def wide_times(dev, data) -> dict:
    """K9's pair at run C's shapes (the 3x512 checkpoint's layer 1, x its
    layer 0's h) and K6's at run D's (a fresh 512-unit layer's xp), cuDNN's
    LSTM on both; K9f's and K6f's pair on the same inputs beside cuDNN's
    bf16 LSTM forward and backward: ms of each, in the package this process
    imported."""
    rng = np.random.default_rng(1)
    out = {}
    model = TRAIN_RUNS[2].make(dev)
    x = first_batch(TRAIN_RUNS[2], data, dev)[0].transpose(0, 1).contiguous()
    l0, l1 = ([p.detach() for p in (l.W, l.U, l.b)] for l in model.layers[:2])
    x = ct.wide_layer_fwd(x, *l0)[0]
    W, U, b = l1
    h, c = ct.wide_layer_fwd(x, W, U, b)
    dh = torch.tensor(rng.normal(size=h.shape), dtype=torch.float32, device=dev)
    out["K9 fwd (run C layer 1)"] = device_time_ms(ct.wide_layer_fwd, x, W, U, b)
    out["K9 bwd (run C layer 1)"] = device_time_ms(ct.wide_layer_bwd, x, W, U, b, h, c, dh)
    out["cuDNN fwd (run C layer 1)"], out["cuDNN bwd (run C layer 1)"] = library_train([(W, U, b)], x, dh)
    out["K9f fwd (run C layer 1)"] = device_time_ms(ct.wide_layer_fwd, x, W, U, b, True)
    out["K9f bwd (run C layer 1)"] = device_time_ms(ct.wide_layer_bwd, x, W, U, b, h, c, dh, True)
    out["cuDNN bf16 fwd (run C layer 1)"], out["cuDNN bf16 bwd (run C layer 1)"] = library_train(
        [(W, U, b)], x, dh, torch.bfloat16)
    l = TRAIN_RUNS[3].make(dev).layers[0]
    W, U, b = (p.detach() for p in (l.W, l.U, l.b))
    x = first_batch(TRAIN_RUNS[3], data, dev)[0].transpose(0, 1).contiguous()
    xp = (torch.matmul(x, W) + b).contiguous()
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    dh = torch.tensor(rng.normal(size=h.shape), dtype=torch.float32, device=dev)
    out["K6 fwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_fwd, xp, U)
    out["K6 bwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_bwd, xp, U, h, c, dh)
    out["cuDNN fwd (run D)"], out["cuDNN bwd (run D)"] = library_train([(W, U, b)], x, dh)
    out["K6f fwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_fwd, xp, U, True)
    out["K6f bwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_bwd, xp, U, h, c, dh, True)
    out["cuDNN bf16 fwd (run D)"], out["cuDNN bf16 bwd (run D)"] = library_train(
        [(W, U, b)], x, dh, torch.bfloat16)
    return out


@torch.no_grad()
def inference_times(dev) -> dict:
    """K1 exact at 4x30 (the checkpoint) and 4x40 (run A's fresh stack) and
    K1f at 4x30 over T = 6656; K5 on 3x512's layer 1 at B = 256, T = 128,
    alone and with its x-side product; cuDNN's LSTM beside each (the whole
    stack, or the layer with its x-side, as in phases 3, 3b, 3c); batch-1
    predict of 4x30 dense and split r = 15; batched fast predict on 3x512;
    K3 on 3x512's layer 0 over T = 6656 alone and with its x-side product,
    K3f alone, cuDNN's float32 and bf16 LSTM (with the x-side) beside them;
    K2 and K2f on layer 0 of the direct r = 24 truncation and of
    ``wide_r24_progressive``, cuDNN beside them; K4 and K4f on the whole
    direct r = 24 truncation, ``wide_r24_progressive`` and 4x30 split r = 15,
    cuDNN's float32 and bf16 LSTM on the stack's dense reconstruction beside
    them; batch-1 predict of 3x512 dense (full_ms) and of merged r = 24
    (``wide_r24_progressive``, reduced_ms), exact and fast, with their
    ratio: ms of each, in the package this process imported."""
    out = {}
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    m30 = P.load_params(DENSE_30, device=dev)
    m40 = TRAIN_RUNS[0].make(dev)
    for name, m, dp in (("K1 4x30", m30, None), ("K1 4x40", m40, None), ("K1f 4x30", m30, "default")):
        out[name] = device_time_ms(lambda: ck.fused_dense_stack(m, x, dot_precision=dp))
        xs = x[:, None] if dp is None else x[:, None].bfloat16()
        lstm = cudnn_lstm([(l.W, l.U, l.b) for l in m.layers], dev, xs.dtype)
        with cudnn_exact():
            out[f"cuDNN beside {name}"] = device_time_ms(lambda: lstm(xs))
    m512 = P.load_params(DENSE_512, device=dev)
    xb = torch.tensor(np.random.default_rng(2).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    (_, _, h_in), (l, xp, _) = batched_layer_inputs(m512, xb)[:2]
    W16, b16 = l.W.to(torch.bfloat16), l.b.to(torch.bfloat16)
    out["K5 3x512 layer 1"] = device_time_ms(cb.batched_lstm_recurrence, xp, l.U)
    out["K5 3x512 layer 1 with its x-side"] = device_time_ms(
        lambda: cb.batched_lstm_recurrence(torch.matmul(h_in, W16) + b16, l.U))
    lstm = cudnn_lstm([(l.W, l.U, l.b)], dev, torch.bfloat16)
    out["cuDNN bf16 beside K5 (with its x-side)"] = device_time_ms(lambda: lstm(h_in))
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    for precision in ("exact", "fast"):
        timing = time_full_vs_reduced(m30, red30, x, precision=precision)
        tag = "" if precision == "exact" else " fast"
        out[f"predict 4x30 dense{tag} (full_ms)"] = timing.full_ms
        out[f"predict 4x30 split r=15{tag} (reduced_ms)"] = timing.reduced_ms
        out[f"ratio 4x30 split r=15 {precision} (reduced / full)"] = timing.ratio
    l0 = m512.layers[0]
    xp = (torch.matmul(x, l0.W) + l0.b).contiguous()
    out["K3 3x512 layer 0"] = device_time_ms(ck.lstm_recurrence, xp, l0.U)
    out["K3 3x512 layer 0 with its x-side"] = device_time_ms(
        lambda: ck.lstm_recurrence((torch.matmul(x, l0.W) + l0.b).contiguous(), l0.U))
    xpf = (torch.matmul(bf16_round(x), bf16_round(l0.W)) + l0.b).contiguous()
    out["K3f 3x512 layer 0"] = device_time_ms(
        lambda: ck.lstm_recurrence(xpf, l0.U, dot_precision="default"))
    for name, dtype in (("cuDNN beside K3 (with its x-side)", torch.float32),
                        ("cuDNN bf16 beside K3f (with its x-side)", torch.bfloat16)):
        lstm = cudnn_lstm([(l0.W, l0.U, l0.b)], dev, dtype)
        xs = x[:, None].to(dtype)
        with cudnn_exact():
            out[name] = device_time_ms(lambda: lstm(xs))
    wide = P.load_params(WIDE_R24, device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    for mname, model in (("direct r=24", direct), ("wide_r24_progressive", wide)):
        l = model.layers[0]
        for kname, fast in (("K2", False), ("K2f", True)):
            xpr = (reduced_projection(l, x, "w", bf16=fast) + l.b).contiguous()
            dp = "default" if fast else None
            out[f"{kname} 3x512 {mname} layer 0"] = device_time_ms(
                lambda: ck.reduced_recurrence(xpr, l.uB, l.uC, dot_precision=dp))
    for name, dtype in (("cuDNN beside K2 (dense reconstruction, with its x-side)", torch.float32),
                        ("cuDNN bf16 beside K2f (dense reconstruction, with its x-side)", torch.bfloat16)):
        out[name] = reduced_library_ms(wide, x, dtype)
    for kname, dp in (("K4", None), ("K4f", "default")):
        for mname, model in (("3x512 direct r=24", direct), ("3x512 wide_r24_progressive", wide),
                             ("4x30 split r=15", red30)):
            out[f"{kname} {mname}"] = device_time_ms(
                lambda: ck.fused_reduced_stack(model, x, dot_precision=dp))
    for mname, model in (("3x512 direct r=24", direct), ("4x30 split r=15", red30)):
        for name, dtype in (("cuDNN beside K4", torch.float32), ("cuDNN bf16 beside K4f", torch.bfloat16)):
            out[f"{name} {mname} (dense reconstruction)"] = reduced_library_ms(
                model, x, dtype, len(model.layers))
    for precision in ("exact", "fast"):
        timing = time_full_vs_reduced(m512, wide, x, precision=precision)
        out[f"predict 3x512 dense {precision} (full_ms)"] = timing.full_ms
        out[f"predict 3x512 merged r=24 {precision} (reduced_ms)"] = timing.reduced_ms
        out[f"ratio 3x512 merged r=24 {precision} (reduced / full)"] = timing.ratio
    xb3 = torch.tensor(np.random.default_rng(3).normal(size=(BATCH_B, BATCH_T, D)),
                       dtype=torch.float32, device=dev)
    out["batched fast predict 3x512"] = device_time_ms(lambda: P.predict(m512, xb3, precision="fast"))
    return out


def tree_times(dev) -> dict:
    """``--time-tree DIR``: inference_times, narrow_times, wide_times and
    one train step (forward, backward, Adam) of runs A, B, E (narrow) and C,
    D, F (wide) with the float32 kernels, and of A, C and D in the
    fused_kernel regime (bf16 operands: K7f, K9f, K6f) and E in bf16 (K8f),
    on DIR's package: the step's span on
    the card, the host's time to issue it and the card's busy time in it,
    in all and in the pair's kernels (step_split)."""
    data = train_data()
    with exact_matmul():
        out = inference_times(dev)
        out.update(narrow_times(dev, data))
        out.update(wide_times(dev, data))
    for run, parts in ((TRAIN_RUNS[0], NARROW_PARTS), (TRAIN_RUNS[1], NARROW_PARTS),
                       (RECOVERY_RUNS[0], NARROW_PARTS), (TRAIN_RUNS[2], WIDE_PARTS),
                       (TRAIN_RUNS[3], WIDE_PARTS), (RECOVERY_RUNS[1], WIDE_PARTS)):
        x, y = first_batch(run, data, dev)
        step = first_step(run, dev, x, y, kernel=True)[2]
        name = f"run {run.name.split()[0]} step"
        out[name] = device_time_ms(step)
        out.update({f"{name}, {k}": v for k, v in step_split(step, parts).items()})
    # the bf16 kernel regime: A, C, D in fused_kernel (K7f, K9f, K6f) and E's
    # recovery at B = 128 (K8f, compact "auto")
    for run, parts, compact in ((TRAIN_RUNS[0], NARROW_PARTS, False), (TRAIN_RUNS[2], WIDE_PARTS, False),
                                (TRAIN_RUNS[3], WIDE_PARTS, False), (RECOVERY_RUNS[0], NARROW_PARTS, "auto")):
        x, y = first_batch(run, data, dev)
        base_apply, loss_extra, make_opt = at._train_apply_for(run.make(dev))
        apply_fn = resolve_train_apply_fn(regime_cfg(run, "bfloat16", True, compact), base_apply)[0]
        step = at._train_step(run.make(dev), apply_fn, loss_extra, make_opt, "bfloat16", x, y)
        name = f"run {run.name.split()[0]} {'bf16 kernel' if compact else 'fused_kernel'} step"
        out[name] = device_time_ms(step)
        out.update({f"{name}, {k}": v for k, v in step_split(step, parts).items()})
    return out


def tree_turns(parent: str) -> None:
    """``--parent DIR``: tree_times on DIR's package and on this checkout's,
    each in a fresh process (their kernels built from their own sources),
    in turns, each side first in one pair of two: parent, change, change,
    parent, change, parent, parent, change."""
    here = os.path.dirname(os.path.abspath(__file__))
    order = (parent, here, here, parent, here, parent, parent, here)
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = "/".join("P" if tree == parent else "C" for tree in order)
    for key in runs[0]:
        ms = [r[key] for r in runs]
        p = np.median([m for m, tree in zip(ms, order) if tree == parent])
        c = np.median([m for m, tree in zip(ms, order) if tree != parent])
        unit = "" if key.startswith("ratio") else " (ms)"
        log(f"[turns] {key}{unit}, {sides} (P parent, C change): "
            + ", ".join(f"{m:.3f}" for m in ms) + f"; medians P {p:.3f}, C {c:.3f}")


def check_finetune(init, tuned, data, dev) -> None:
    """Run B's end: the factors stayed frozen and σ moved; truncate and
    predict the test half through K1."""
    for i, (old, new) in enumerate(zip(init.layers, tuned.layers)):
        for f in ("wl", "wr", "ul", "ur", "b"):
            if not torch.equal(getattr(old, f), getattr(new, f)):
                fail(f"run B: frozen layers[{i}].{f} changed during the fine-tune")
        for f in ("ws", "us"):
            if torch.equal(getattr(old, f), getattr(new, f)):
                fail(f"run B: layers[{i}].{f} did not move during the fine-tune")
    reduced = P.make_reduced_model(tuned, cutoff=0.05)
    x = torch.tensor(data.X_test[0], device=dev)
    k1 = ck.LAUNCHES["fused_dense_stack"]
    y_red = P.predict(reduced, x)
    torch.cuda.synchronize()
    if ck.LAUNCHES["fused_dense_stack"] == k1:
        fail("run B: the reduced predict did not launch K1 (fused_dense_stack)")
    y_tuned = P.predict(tuned, x)
    check_vs_cpu_reference("run B reduced predict", y_red, copy.deepcopy(reduced).cpu(),
                           x[:REF_STEPS].cpu())
    y_true = data.y_test
    log(f"[train] run B: weights {weights(tuned)} -> {weights(reduced)} (cutoff 0.05); "
        f"RMSE vs the test targets: fine-tuned {P.rmse(y_tuned[:, 0].cpu().numpy(), y_true):.6f}, "
        f"reduced {P.rmse(y_red[:, 0].cpu().numpy(), y_true):.6f}")


def train_path(dev, data) -> tuple:
    """Phase 6: runs A to D through the public entry points, counted.
    Returns (launches, {run name: loss history})."""
    ck.reset_launch_counts()
    ct.reset_launch_counts()
    histories = {}
    for run in TRAIN_RUNS:
        before = dict(ct.LAUNCHES)
        init = run.make(dev)
        t0 = time.perf_counter()
        res = train(run, init, data, kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in ct.LAUNCHES.items()}
        log(f"[train] run {run.name}: loss history {res.history}, rollbacks {res.rollbacks}, "
            f"{wall:.2f} s wall, train kernel launches {delta}")
        for k in run.kernels:
            if delta[k.__name__] < 1:
                fail(f"run {run.name}: {k.__name__} was not launched")
        if not res.history or res.rollbacks or not np.all(np.isfinite(res.history)):
            fail(f"run {run.name}: non-finite loss")
        if run.factor_cfg is not None:
            check_finetune(init, res.params, data, dev)
        histories[run.name] = res.history
    torch.cuda.synchronize()
    launches = dict(ct.LAUNCHES)
    log(f"[train] kernel launches during the training path: {launches}")
    return launches, histories


def final_ranks(model) -> set:
    """Every recurrent-side rank of a reduced model (every gate); the input
    side of the first layer holds at most d = 16."""
    return {r for l in model.layers for r in l.ranks[1]}


def recovery_path(dev, data) -> dict:
    """Phase 6, runs E and F: the recovery through its public entry points,
    counted from zero just before and read just after. Returns the train
    kernels' launch counts of these runs."""
    ck.reset_launch_counts()
    ct.reset_launch_counts()
    x = torch.tensor(data.X_test[0], device=dev)
    for run in RECOVERY_RUNS:
        before = dict(ct.LAUNCHES)
        t0 = time.perf_counter()
        model, infos = recover(run, data, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in ct.LAUNCHES.items()}
        log(f"[recover] run {run.name}: {wall:.2f} s wall, train kernel launches {delta}")
        for k in run.kernels:
            if delta[k.__name__] < 1:
                fail(f"run {run.name}: {k.__name__} was not launched")
        for r, info in zip(run.ranks, infos):
            log(f"[recover] run {run.name} rank {r}: raw val MSE {info['raw_val_mse']:.6e}, best "
                f"{info['best_val_mse']:.6e}, trace {info['trace']}")
            if not (np.isfinite(info["best_val_mse"]) and info["best_val_mse"] <= info["raw_val_mse"]):
                fail(f"run {run.name} rank {r}: the gate returned a model worse than the truncation")
        if final_ranks(model) != {run.ranks[-1]}:
            fail(f"run {run.name}: ranks {final_ranks(model)} after recovery, not {run.ranks[-1]}")
        k = ck.LAUNCHES[run.predict_kernel]
        y_pred = P.predict(model, x)
        torch.cuda.synchronize()
        if ck.LAUNCHES[run.predict_kernel] == k:
            fail(f"run {run.name}: predict did not launch {run.predict_kernel}")
        check_vs_cpu_reference(f"run {run.name} predict", y_pred, copy.deepcopy(model).cpu(),
                               x[:REF_STEPS].cpu())
        log(f"[recover] run {run.name}: RMSE of the recovered model vs the test targets "
            f"{P.rmse(y_pred[:, 0].cpu().numpy(), data.y_test):.6f}")
    torch.cuda.synchronize()
    launches = dict(ct.LAUNCHES)
    log(f"[recover] kernel launches during the recovery path: {launches}")
    return launches


def first_step(run: TrainRun, dev, x, y, kernel: bool, dtype=torch.float32):
    """The first train step of a run from its initial model (in ``dtype``:
    float64 for a plain reference). Returns (loss, {parameter: gradient},
    step), where step() runs one whole train step (forward, backward, Adam)
    on the same model, for timing."""
    model = run.make(dev).to(dtype)
    cfg = dataclasses.replace(run.cfg, recurrence_kernel=kernel)
    apply_fn, used = resolve_train_apply_fn(cfg, default_apply_fn(model))
    if used != kernel:
        fail(f"run {run.name}: recurrence_kernel={kernel} resolved to the other path")
    if run.factor_cfg is None:
        opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    else:
        opt = make_finetune_optimizer(model, run.factor_cfg, cfg.learning_rate)

    def loss_of():
        loss = mse_last_step(model, x, y, apply_fn)
        if run.factor_cfg is not None:
            loss = loss + regularization_loss(model, run.factor_cfg)
        return loss

    def step():
        with exact_matmul():
            opt.zero_grad(set_to_none=True)
            loss_of().backward()
            opt.step()

    with exact_matmul():
        loss = loss_of()
        loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
    return loss.item(), grads, step


def train_comparisons(dev, data, histories: dict) -> None:
    """Phase 7: each run against the same run on the plain autograd scan.
    ``histories`` holds runs A–D's loss histories from phase 6; E's and F's
    are one epoch of ``finetune_reduced``, taken here."""
    for run in TRAIN_RUNS + RECOVERY_RUNS:
        compare_run(run, dev, data, histories)


def compare_run(run: TrainRun, dev, data, histories: dict) -> None:
    """One run against the same run on the plain autograd scan: the first
    step's loss and gradients, the loss histories, one step's time."""
    x, y = first_batch(run, data, dev)
    loss_k, grads_k, step_k = first_step(run, dev, x, y, kernel=True)
    loss_p, grads_p, step_p = first_step(run, dev, x, y, kernel=False)
    tol = FWD_TOL * max(1.0, abs(loss_p))
    drifts = {}
    if isinstance(run, RecoveryRun):  # the drift of the plain float32 step from float64
        loss64, grads64, _ = first_step(run, dev, x.double(), y.double(), False, torch.float64)
        tol = max(tol, 2 * abs(loss_p - loss64))
        drifts = {name: 2 * max_err(g.double(), grads64[name]) for name, g in grads_p.items()}
    log(f"[check] run {run.name} first-step loss: kernel {loss_k:.8f}, plain {loss_p:.8f} "
        f"(tol {tol:g})")
    if not abs(loss_k - loss_p) <= tol:
        fail(f"run {run.name}: first-step loss differs by {abs(loss_k - loss_p):.3e}")
    for name, want in grads_p.items():
        check_close(f"run {run.name} first-step d{name}", grads_k[name], want,
                    max(GRAD_RTOL * float(want.abs().max()), drifts.get(name, 0.0)))
    if run.name not in histories:
        histories[run.name] = train(run, run.make(dev), data, kernel=True).history
    hist_k = np.asarray(histories[run.name])
    hist_p = np.asarray(train(run, run.make(dev), data, kernel=False).history)
    rel = float(np.max(np.abs(hist_k - hist_p) / np.abs(hist_p)))
    log(f"[check] run {run.name} loss history: kernel {hist_k.tolist()}, plain "
        f"{hist_p.tolist()}, max rel diff {rel:.3e} (rtol {HIST_RTOL:g})")
    if not (hist_k.shape == hist_p.shape and rel <= HIST_RTOL):
        fail(f"run {run.name}: loss histories of kernel and plain runs disagree")
    ms_k, ms_p = device_time_ms(step_k), device_time_ms(step_p)
    log(f"[time] run {run.name} one train step (forward, backward, Adam; B={run.cfg.batch_size}, "
        f"T={run.cfg.window_len}): kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")


# ---------------------------------------------------------------------------
# deployment (phase 8)
# ---------------------------------------------------------------------------

STREAM_FRAMES = 2048   # 8b, 8c: frames streamed one at a time
STREAM_CHUNK = 512     # 8c: stream_many's chunk; 8d: frames of the commands' input
STREAM_WARMUP = 64     # 8c: frames before the latency is taken
NATIVE_TOL = 1e-4      # native runtime vs the card's predict (tests/test_native.py)
GRAPH_TOL = 1e-6       # graph step vs the eager step: the same products in the same order
INT8_BYTES_MAX = 0.35  # int8 tree bytes / float32 bytes
FRAME_PERIOD_US = 16 * 500 / 16  # 16 samples a frame, one every 500/16 µs (config.py)


def int8_bytes(tree) -> int:
    """The int8 tree's bytes counted leaf by leaf: one a q entry, four a
    per-column scale, four a float32 entry (the 1-D leaves)."""
    # imported here: --time-tree runs this script on trees without the module
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    total = []
    map_tree(lambda t: total.append(t.q.numel() + 4 * t.scale.numel()
                                    if isinstance(t, P.QuantizedTensor) else 4 * t.numel()), tree)
    return sum(total)


def require_launched(name: str, before: dict, kernels) -> None:
    """Fail unless each wrapper in ``kernels`` launched since ``before``."""
    torch.cuda.synchronize()
    for k in kernels:
        if ck.LAUNCHES[k] == before[k]:
            fail(f"{name}: {k} was not launched")


def int8_path(dev, x) -> dict:
    """Phase 8a: the int8 trees of 3x512 merged r = 24 (wide_r24_progressive)
    and 4x30 dense, quantized on the card, through quantized_apply(predict),
    exact and fast, counted from zero; their bytes, error and time."""
    configs = (  # name, checkpoint, the exact and fast wrappers predict must launch
        ("3x512 merged r=24 (wide_r24_progressive)", WIDE_R24,
         ("reduced_recurrence", "reduced_recurrence_fast")),
        ("4x30 dense", DENSE_30, ("fused_dense_stack", "fused_dense_stack_fast")),
    )
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    qpredict = P.quantized_apply(P.predict)
    ck.reset_launch_counts()
    runs = []
    for name, path, kernels in configs:
        model = P.load_params(path, device=dev)
        q = P.quantize_params(model)
        before = dict(ck.LAUNCHES)
        y8 = qpredict(q, x)
        require_launched(f"int8 {name} exact", before, kernels[:1])
        before = dict(ck.LAUNCHES)
        y8_fast = qpredict(q, x, precision="fast")
        require_launched(f"int8 {name} fast", before, kernels[1:])
        runs.append((name, path, model, q, y8, y8_fast))
    torch.cuda.synchronize()
    launches = {k: ck.LAUNCHES[k] for k in (*EXACT_NAMES[:2], *FAST_NAMES[:2])}
    log(f"[int8] kernel launches during the int8 path: {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        for name, path, model, q, y8, y8_fast in runs:
            f32, i8, counted = P.param_bytes(model), P.param_bytes(q), int8_bytes(q)
            log(f"[int8] {name}: param_bytes float32 {f32}, int8 {i8} (counted {counted}), "
                f"ratio {i8 / f32:.4f} (limit {INT8_BYTES_MAX})")
            if i8 != counted or not i8 <= INT8_BYTES_MAX * f32:
                fail(f"int8 {name}: {i8} bytes, counted {counted}, float32 {f32}")
            if tuple(y8.shape) != (T, 1) or not bool(torch.isfinite(y8_fast).all()):
                fail(f"int8 {name}: bad output {tuple(y8.shape)}")
            dq_cpu = P.from_numpy_tree(P.to_numpy_tree(P.dequantize_params(q)), device="cpu")
            check_vs_cpu_reference(f"int8 {name} exact", y8, dq_cpu, x[:REF_STEPS].cpu())
            y32 = P.predict(model, x)
            log(f"[int8] {name}: int8 vs float32 predict: rel Frobenius {rel_err(y8, y32):.4e}, "
                f"RMSE {P.rmse(y32.cpu().numpy(), y8.cpu().numpy()):.4e}; fast vs exact int8 "
                f"rel Frobenius {rel_err(y8_fast, y8):.4e} (reported, not gated)")
            ms32 = device_time_ms(lambda: P.predict(model, x))
            ms8 = device_time_ms(lambda: qpredict(q, x))
            log(f"[int8] {name} T={T}: predict float32 {ms32:.3f} ms, int8 (dequantization "
                f"included) {ms8:.3f} ms on {card_line()}")
            qpath = os.path.join(tmp, "q.npz")
            P.save_params(qpath, q)
            back = P.load_params(qpath, device=dev)
            pairs, loaded = [], []
            map_tree(pairs.append, q)
            map_tree(loaded.append, back)
            for a, b in zip(pairs, loaded):
                a, b = (a.q, b.q) if isinstance(a, P.QuantizedTensor) else (a, b)
                if b.device.type != dev.type or not torch.equal(a, b):
                    fail(f"int8 {name}: the saved tree does not load back bit-equal on the card")
            log(f"[check] int8 {name}: saved and loaded back, q bit-equal ({len(pairs)} leaves)")
    return launches


def deploy_models(dev) -> dict:
    m30 = P.load_params(DENSE_30, device=dev)
    return {
        "3x512 merged r=24 (wide_r24_progressive)": P.load_params(WIDE_R24, device=dev),
        "4x30 split r=15": P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15),
        "4x30 dense": m30,
    }


def check_prefix(name: str, got: np.ndarray, want: torch.Tensor, tol: float) -> None:
    """got (N,) against want (N, 1) on the first REF_STEPS frames within tol;
    the max over all N reported."""
    want = want[:, 0].cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{name}: bad output {got.shape}")
    log(f"[check] {name}: max abs diff over {len(got)} frames {np.abs(got - want).max():.3e}")
    check_close(f"{name} first {REF_STEPS} frames", torch.tensor(got[:REF_STEPS]),
                torch.tensor(want[:REF_STEPS]), tol)


def export_path(dev, x, models: dict) -> None:
    """Phase 8b: each model written from the card as CSVs (per-gate for dense,
    two-step for reduced) and as the int8 .bin, run by the native runtime on
    the host over STREAM_FRAMES frames, against the card's predict."""
    from svd_lstm_tpu_torch.io import csv_weights, int8_export, native

    frames = x[:STREAM_FRAMES]
    frames_np = frames.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, model) in enumerate(models.items()):
            d = os.path.join(tmp, f"model{i}")
            if isinstance(model, P.ReducedLSTM):
                native.save_reduced_weights_as_csv(model, d)
            else:
                csv_weights.save_model_weights_as_csv(model, d)
            binpath = d + ".bin"
            nbytes = int8_export.save_model_int8_bin(model, binpath)
            t0 = time.perf_counter()
            y_csv = native.NativeModel.from_export_dir(d).run(frames_np)
            y_bin = native.NativeModel.from_int8(binpath).run(frames_np)
            host_s = time.perf_counter() - t0
            log(f"[native] {name}: int8 .bin {nbytes} bytes; both runs of {STREAM_FRAMES} "
                f"frames (load included) {host_s:.3f} s on the host")
            check_prefix(f"native CSV {name} vs card predict", y_csv, P.predict(model, frames),
                         NATIVE_TOL)
            dq = int8_export.dequantized_params(model)
            check_prefix(f"native int8 .bin {name} vs card predict of the artifact's model",
                         y_bin, P.predict(dq, frames), NATIVE_TOL)


def percentiles(name: str, lat_s: list) -> str:
    us = np.asarray(lat_s) * 1e6
    return f"{name} p50 {np.percentile(us, 50):.1f} us, p99 {np.percentile(us, 99):.1f} us"


def stream_latency(step, state, frames_np, dev) -> list:
    """Per-frame wall clock of ``step`` from a host frame to its host result,
    STREAM_WARMUP frames first, then STREAM_FRAMES."""
    lat = []
    for t in range(STREAM_WARMUP + len(frames_np)):
        frame = frames_np[t % len(frames_np)][None]
        t0 = time.perf_counter()
        y, state = step(state, torch.as_tensor(frame, device=dev))
        y = float(y[0, 0])
        if t >= STREAM_WARMUP:
            lat.append(time.perf_counter() - t0)
    return lat


def stream_path(dev, x, models: dict) -> None:
    """Phase 8c: make_stream_fn's graph step one frame at a time against
    predict, the eager stream_step and stream_many in chunks; then the
    per-frame latency of the graph step, the eager step and the native
    runtime."""
    from svd_lstm_tpu_torch.io import int8_export, native

    frames = x[:STREAM_FRAMES]
    frames_np = frames.cpu().numpy()
    for name in ("3x512 merged r=24 (wide_r24_progressive)", "4x30 split r=15"):
        model = models[name]
        fn, state0 = P.make_stream_fn(model)
        state, ys = state0, []
        for t in range(len(frames)):
            y, state = fn(state, frames[t : t + 1])
            ys.append(y)
        graph = torch.cat(ys)
        check_close(f"stream graph step {name} vs predict, {len(frames)} frames", graph,
                    P.predict(model, frames), TOL)
        state, ys = P.init_stream(model), []
        for t in range(len(frames)):
            y, state = P.stream_step(model, state, frames[t : t + 1])
            ys.append(y)
        eager = torch.cat(ys)
        check_close(f"stream graph step {name} vs eager stream_step", graph, eager, GRAPH_TOL)
        state, ys = P.init_stream(model), []
        for k in range(0, len(frames), STREAM_CHUNK):
            y, state = P.stream_many(model, state, frames[None, k : k + STREAM_CHUNK])
            ys.append(y[0])
        check_close(f"stream_many {name}, chunks of {STREAM_CHUNK}, vs eager stream_step",
                    torch.cat(ys), eager, GRAPH_TOL)

        lat_graph = stream_latency(fn, state0, frames_np, dev)
        lat_eager = stream_latency(lambda s, f: P.stream_step(model, s, f), P.init_stream(model),
                                   frames_np, dev)
        with tempfile.TemporaryDirectory() as tmp:
            binpath = os.path.join(tmp, "model_int8.bin")
            int8_export.save_model_int8_bin(model, binpath)
            nm = native.NativeModel.from_int8(binpath)
            for f in frames_np[:STREAM_WARMUP]:
                nm.step(f)
            lat_native = []
            for f in frames_np:
                t0 = time.perf_counter()
                nm.step(f)
                lat_native.append(time.perf_counter() - t0)
        log(f"[stream] {name}, per-frame wall clock over {len(frames_np)} frames after "
            f"{STREAM_WARMUP}: {percentiles('graph step', lat_graph)}; "
            f"{percentiles('eager stream_step', lat_eager)}; "
            f"{percentiles('native int8 (host)', lat_native)}; frame period "
            f"{FRAME_PERIOD_US:.0f} us; {card_line()}")


def command(*args) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", *args], capture_output=True,
                         text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        fail(f"command {' '.join(args)} exited {out.returncode}: {out.stderr[-2000:]}")
    return out


def command_path(dev, x, models: dict) -> None:
    """Phase 8d: ``export ... --int8`` of wide_r24_progressive, then ``stream``
    of its .bin (native) and of the checkpoint (the card's graph step) over
    STREAM_CHUNK frames, each in a subprocess, against predict."""
    from svd_lstm_tpu_torch.io import int8_export

    name = "3x512 merged r=24 (wide_r24_progressive)"
    model = models[name]
    frames = x[:STREAM_CHUNK]
    device_args = [] if dev.type == "cuda" else ["--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "deploy")
        log("[command] " + command("export", WIDE_R24, out, "--int8", *device_args).stdout.strip()
            .replace("\n", "; "))
        fin = os.path.join(tmp, "frames.csv")
        np.savetxt(fin, frames.cpu().numpy(), delimiter=",")
        for artifact, want, tol in (
            (os.path.join(out, "model_int8.bin"), int8_export.dequantized_params(model), NATIVE_TOL),
            (WIDE_R24, model, TOL),
        ):
            run = command("stream", artifact, "--input", fin, "--stats", *device_args)
            got = np.array([float(v) for v in run.stdout.split()], dtype=np.float32)
            stats = run.stderr.strip().splitlines()[-1]  # --stats' line comes last
            log(f"[command] stream {os.path.basename(artifact)}: {stats}")
            check_prefix(f"stream command, {os.path.basename(artifact)}", got,
                         P.predict(want, frames), tol)


def deployment_path(dev, x) -> dict:
    """Phase 8: the deployment slice (8a-8d). Returns 8a's launches."""
    launches = int8_path(dev, x)
    models = deploy_models(dev)
    export_path(dev, x, models)
    stream_path(dev, x, models)
    command_path(dev, x, models)
    return launches


# ---------------------------------------------------------------------------
# the evaluation slice (phase 9)
# ---------------------------------------------------------------------------

TUNE_REPEATS = 1      # 9a: timed calls a candidate (one sample: the winners are not rankings)
SWEEP_EVERY = 8       # 9d: reductions between evaluations
SWEEP_CPU_STEPS = 512  # 9d: the card's sweep against the CPU's over this many steps
SWEEP_CPU_REDUCTIONS = 64
SWEEP_WIDE_REDUCTIONS = 16
SWEEP_RTOL = 1e-3     # 9d: card vs CPU RMSE curve, relative
LOOKUPS = 2000        # 9a: host lookups timed
TRACE_TRIES = 3       # 9b: traces of a call, one of which must count every kernel its wrappers launched
# each batch-1 wrapper's kernels, as the profiler names them
KERNEL_NAMES = {"fused_dense_stack": ("dense_stack_wave", "fused_dense_stack_kernel"),
                "lstm_recurrence": ("recurrence_chain",), "reduced_recurrence": ("reduced_chain",)}


def route_kernel(model, impl: str):
    """The batch-1 exact wrapper predict's ``impl`` launches on a model, or
    None (the scan launches none)."""
    if impl == "fused":
        return "fused_dense_stack"
    if impl == "hybrid":
        return "reduced_recurrence" if isinstance(model, P.ReducedLSTM) else "lstm_recurrence"
    return None


def autotune_path(dev, x, models: dict) -> None:
    """Phase 9a: autotune every valid predict route of the 3x512 dense,
    wide_r24_progressive, 4x30 dense and 4x30 split r=15 models at T = 6656
    (exact) and of 3x512 at B = 256, T = 128 (fast), the winners stored in
    the smoke's own cache; then predict(impl="auto") must launch the winner's
    kernel and equal predict(impl=winner, consult_cache=False) bit for bit;
    then the lookup's cost at 4x30, on the card and on the host."""
    xb = torch.tensor(np.random.default_rng(3).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    cases = [(name, m, x, "exact") for name, m in models.items()]
    cases.append(("3x512 dense batched", models["3x512 dense"], xb, "fast"))
    for name, m, xx, precision in cases:
        t0 = time.perf_counter()
        r = at.autotune(m, xx, precision=precision, repeats=TUNE_REPEATS)
        log(f"[tune] {name} {tuple(xx.shape)} {precision}: winner {r.impl!r}, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(r.table.items(), key=lambda kv: kv[1]))
            + f" ({time.perf_counter() - t0:.1f} s with the warm-ups; {card_line()})")
        if r.failed:
            fail(f"autotune {name}: candidates failed: {r.failed}")
        at.store_tuned(at.cache_key(m, xx, precision), r.impl)
        before = dict(ck.LAUNCHES)
        k5 = [k.launches for k in cb.KERNELS]
        y = P.predict(m, xx, precision=precision)
        torch.cuda.synchronize()
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES if ck.LAUNCHES[k] != before[k]}
        delta.update({k.__name__: k.launches - n for k, n in zip(cb.KERNELS, k5) if k.launches != n})
        if xx.ndim == 3:
            want = {"batched_lstm_recurrence"} if r.impl == "auto" else set()
        else:
            want = {route_kernel(m, r.impl)} - {None}
        if set(delta) != want:
            fail(f"autotune {name}: predict(impl='auto') launched {delta}, winner {r.impl!r} wants {want}")
        same = P.predict(m, xx, impl=r.impl, precision=precision, consult_cache=False)
        if not torch.equal(y, same):
            fail(f"autotune {name}: predict(impl='auto') differs from impl={r.impl!r}")
        log(f"[tune] {name}: predict(impl='auto') launched {delta or 'no kernel'}, bit-equal to "
            f"impl={r.impl!r}")

    m30 = models["4x30 dense"]
    hit_dir = os.environ["XDG_CACHE_HOME"]
    times = {}
    with tempfile.TemporaryDirectory() as miss_dir:  # an empty cache: every lookup misses
        try:
            for label, env, consult in (("hit", hit_dir, True), ("miss", miss_dir, True),
                                        ("off", hit_dir, False)):
                os.environ["XDG_CACHE_HOME"] = env
                times[label] = device_time_ms(lambda: P.predict(m30, x, consult_cache=consult))
                lookup = ""
                if consult:
                    found = at.cached_impl(m30, x)
                    t0 = time.perf_counter()
                    for _ in range(LOOKUPS):
                        at.cached_impl(m30, x)
                    lookup = (f"; the lookup alone on the host {(time.perf_counter() - t0) / LOOKUPS * 1e6:.3f}"
                              f" us (mean of {LOOKUPS}, finds {found!r})")
                log(f"[tune] 4x30 predict(impl='auto'), cache {label}: {times[label]:.4f} ms (median of "
                    f"5){lookup}")
        finally:
            os.environ["XDG_CACHE_HOME"] = hit_dir
    log(f"[tune] 4x30 predict(impl='auto') hit - off {times['hit'] - times['off']:+.4f} ms, miss - off "
        f"{times['miss'] - times['off']:+.4f} ms; {card_line()}")


def kernel_counts(stats, names) -> int:
    return sum(s.count for s in stats if any(nm in s.name for nm in names))


def trace_path(dev, x, models: dict) -> None:
    """Phase 9b: bench.trace.summarize of one predict of the 3x512 dense,
    wide_r24_progressive and 4x30 dense models: the expected kernel leads
    the table, each batch-1 kernel's count in the trace equals its wrapper's
    launch count (in one of TRACE_TRIES traces of the call: the device trace
    can lose an event), the rows add up to no more than device_ms; device_ms
    beside device_time_ms of the same call. Then the trace command on
    wide_r24_progressive in a subprocess."""
    from svd_lstm_tpu_torch.bench import trace

    cases = (("3x512 dense", "lstm_recurrence"), ("wide_r24_progressive", "reduced_recurrence"),
             ("4x30 dense", "fused_dense_stack"))
    with tempfile.TemporaryDirectory() as tmp:
        for name, lead in cases:
            m = models[name]
            fn = lambda mm, xx: P.predict(mm, xx)  # noqa: E731
            fn(m, x)
            torch.cuda.synchronize()
            for attempt in range(1, TRACE_TRIES + 1):
                before = dict(ck.LAUNCHES)
                s = trace.summarize(fn, m, x, out_dir=os.path.join(tmp, f"{name} {attempt}"), top=0, warmup=0)
                launched = {k: ck.LAUNCHES[k] - before[k] for k in KERNEL_NAMES}
                counted = {k: kernel_counts(s["ops"], names) for k, names in KERNEL_NAMES.items()}
                if counted == launched:
                    break
                log(f"[trace] {name} predict, trace {attempt} of {TRACE_TRIES}: the trace counted "
                    f"{counted}, the wrappers launched {launched}")
            else:
                fail(f"trace {name}: no trace of {TRACE_TRIES} counted the kernels the wrappers launched "
                     f"(the last counted {counted}, launched {launched})")
            log(f"[trace] {name} predict: device_ms {s['device_ms']:.3f}, device_time_ms "
                f"{device_time_ms(fn, m, x):.3f} (median of 5); launch counters {launched}, trace {attempt}\n"
                + trace.format_breakdown(s["ops"][:8], total_ms=s["device_ms"]))
            if not s["ops"] or not any(nm in s["ops"][0].name for nm in KERNEL_NAMES[lead]):
                fail(f"trace {name}: {KERNEL_NAMES[lead]} does not lead the breakdown")
            total = sum(o.total_ms for o in s["ops"])
            if not total <= s["device_ms"] + 1e-6:  # 1 ns for the float sums of µs timestamps
                fail(f"trace {name}: the rows add up to {total:.4f} ms, past device_ms {s['device_ms']:.4f}")
        out = command("trace", os.path.join(tmp, "cmd"), "--checkpoint", WIDE_R24, "--steps", str(T))
        lines = out.stdout.strip().splitlines()
        log("[trace] trace command, wide_r24_progressive: " + "; ".join(lines[:4]))
        if not lines[0].startswith("device total:") or "reduced_chain" not in out.stdout:
            fail("trace command: no device total or no reduced_chain row")


def roofline_path(dev, x, models: dict) -> None:
    """Phase 9c: the per-step floor of the three main-path calls against
    their measured time a step."""
    costs = {"3x512 dense": roofline.dense_step_cost(D, units_of(models["3x512 dense"])),
             "wide_r24_progressive": reduced_cost(models["wide_r24_progressive"], D),
             "4x30 dense": roofline.dense_step_cost(D, units_of(models["4x30 dense"]))}
    for name, cost in costs.items():
        m = models[name]
        us = device_time_ms(lambda: P.predict(m, x)) * 1e3 / T
        call = cost.call_bound(T)
        log(f"[roofline] {name} predict, T={T}: {us:.4f} us a step measured; floor {cost.floor_us() * 1e3:.3f} "
            f"ns a step ({call['bound_ms'] * 1e6 / T:.3f} with the weights read once a call, "
            f"{call['bound_by']}), {us / cost.floor_us():.0f}x; {cost.stages} dependent products a "
            f"step; {card_line()}\n" + roofline.report(cost, us))


def sweep_path(dev, data) -> None:
    """Phase 9d: rank_sweep of the 4x30 checkpoint over the surrogate's test
    run (every SWEEP_EVERY reductions, the whole order): K1 once an
    evaluation, the final RMSE that of a fresh predict of the final model;
    the same sweep over SWEEP_CPU_STEPS steps (SWEEP_CPU_REDUCTIONS) on the
    card and on the CPU, the curves within SWEEP_RTOL; and 3x512 over T =
    6656 of the training run (SWEEP_WIDE_REDUCTIONS) through K3's hybrid."""
    from svd_lstm_tpu_torch.bench.sweep import rank_sweep, sorted_sigma_indices
    from svd_lstm_tpu_torch.factor.svd import set_model_matrix_rank

    from svd_lstm_tpu_torch.config import SweepConfig

    inv = data.pin_scaler.inverse_transform
    y_m = inv(data.y_test.reshape(-1, 1)).ravel()
    cfg = SweepConfig(evaluate_every=SWEEP_EVERY)
    m30 = P.load_params(DENSE_30, device=dev)

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = rank_sweep(m30, data.X_test, y_m, inv, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = ck.LAUNCHES["fused_dense_stack"]
    log(f"[sweep] 4x30, T={data.X_test.shape[1]}: {res.reductions_done} reductions, {len(res.rmse)} "
        f"evaluations, {wall:.2f} s wall; K1 launches {k1}; RMSE {res.rmse[0]:.6f} -> {res.rmse[-1]:.6f}, "
        f"ratio at 1/4, 1/2, 3/4, end of the order "
        + ", ".join(f"{res.rmse_ratio[int(f * (len(res.rmse) - 1))]:.4f}" for f in (0.25, 0.5, 0.75, 1.0))
        + f"; weights eliminated {res.weights_eliminated[-1]}")
    if k1 != len(res.rmse):
        fail(f"sweep 4x30: K1 launched {k1} times for {len(res.rmse)} evaluations")
    final, ranks = m30, {}
    for li, wj, g, _ in sorted_sigma_indices(m30):
        key = (int(li), int(wj), int(g))
        layer = m30.layers[key[0]]
        ranks.setdefault(key, min(layer.input_dim, layer.units) if wj == 0 else layer.units)
        if ranks[key] > 1:
            ranks[key] -= 1
            final = set_model_matrix_rank(final, key, ranks[key])
    fresh = P.from_numpy_tree(P.to_numpy_tree(final), device=dev)
    x_test = torch.tensor(data.X_test[0], device=dev)
    want = P.rmse(y_m, inv(P.predict(fresh, x_test)[:, 0].cpu().numpy().reshape(-1, 1)).ravel())
    log(f"[check] sweep 4x30: final RMSE {float(res.rmse[-1])!r}, a fresh predict of the final model "
        f"{want!r}")
    if res.rmse[-1] != want:
        fail("sweep 4x30: the final evaluation differs from a fresh model's")

    X, y = data.X_test[:, :SWEEP_CPU_STEPS], y_m[:SWEEP_CPU_STEPS]
    card = rank_sweep(m30, X, y, inv, cfg, max_reductions=SWEEP_CPU_REDUCTIONS)
    cpu = rank_sweep(P.load_params(DENSE_30, device="cpu"), X, y, inv, cfg,
                     max_reductions=SWEEP_CPU_REDUCTIONS)
    rel = float(np.max(np.abs(card.rmse - cpu.rmse) / cpu.rmse))
    log(f"[check] sweep 4x30, first {SWEEP_CPU_STEPS} steps, {SWEEP_CPU_REDUCTIONS} reductions: card vs "
        f"CPU plain scan RMSE, max relative diff {rel:.3e} over {len(cpu.rmse)} evaluations "
        f"(rtol {SWEEP_RTOL:g})")
    if not (np.array_equal(card.order, cpu.order) and card.rmse.shape == cpu.rmse.shape and rel <= SWEEP_RTOL):
        fail("sweep 4x30: the card's curve disagrees with the CPU's")

    m512 = P.load_params(DENSE_512, device=dev)
    before = ck.LAUNCHES["lstm_recurrence"]
    t0 = time.perf_counter()
    # the training run's first T steps: the test run is shorter than T
    y_train = inv(data.y_train[:T].reshape(-1, 1)).ravel()
    wide = rank_sweep(m512, data.X_train[:, :T], y_train, inv, cfg, max_reductions=SWEEP_WIDE_REDUCTIONS)
    torch.cuda.synchronize()
    k3 = ck.LAUNCHES["lstm_recurrence"] - before
    log(f"[sweep] 3x512, T={T}, {wide.reductions_done} reductions: RMSE {', '.join(f'{v:.6f}' for v in wide.rmse)}, "
        f"{time.perf_counter() - t0:.2f} s wall, K3 launches {k3}; {card_line()}")
    if k3 != len(m512.layers) * len(wide.rmse) or not np.isfinite(wide.rmse).all():
        fail(f"sweep 3x512: K3 launched {k3} times for {len(wide.rmse)} evaluations")


def evaluation_path(dev, x, data) -> None:
    """Phase 9: the evaluation slice (9a-9d)."""
    m30 = P.load_params(DENSE_30, device=dev)
    models = {
        "3x512 dense": P.load_params(DENSE_512, device=dev),
        "wide_r24_progressive": P.load_params(WIDE_R24, device=dev),
        "4x30 dense": m30,
        "4x30 split r=15": P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15),
    }
    autotune_path(dev, x, models)
    trace_path(dev, x, models)
    roofline_path(dev, x, models)
    sweep_path(dev, data)


# ---------------------------------------------------------------------------
# training precision (phase 10)
# ---------------------------------------------------------------------------

PRECISION_STEPS = 4   # 10b, 10c: Adam steps of each regime's fit
# 10b's runs: the fast band, and the regimes (None: every one; D, there for
# K6f, takes its two kernel regimes, the float32 one as the exact reference)
PRECISION_RUNS = {"A 4x40 fit": ("narrow", None), "C 3x512 fit": ("wide", None),
                  "D 1x512 fit": ("wide", ("f32_kernel", "fused_kernel"))}


def fast_check(name: str, got: torch.Tensor, plain: torch.Tensor, plain64: torch.Tensor) -> float:
    """A bf16 variant's output against its plain bf16 version, within
    ``fast_limit`` (PERF.md §2: K3f's and K5's rule)."""
    return check_close(name, got, plain, fast_limit(name, plain, plain64))


def bf16_variant(fn):
    """A wrapper or plain version called with bf16=True."""
    return lambda *args: fn(*args, True)


def kernel_resources(*names: str) -> dict:
    """Registers, spilled bytes and static shared memory of each kernel of
    the build whose mangled name holds one of ``names`` (ptxas -v in the
    build's log; empty where the library was reused)."""
    out, entry = {}, None
    for line in _build.build()["log"].splitlines():
        if "Compiling entry function" in line:
            entry = next((nm for nm in names if nm in line), None)
            tag = line.split("'")[1] if "'" in line else line
        elif entry and "spill stores" in line:
            out.setdefault(tag, {})["spilled B"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif entry and "Used" in line and "registers" in line:
            r = out.setdefault(tag, {})
            r["registers"] = int(line.split("Used")[1].split("registers")[0])
            r["static smem B"] = int(line.split("bytes smem")[0].split(",")[-1]) if "smem" in line else 0
    return out


def cudnn_bf16_kernels(layers, x) -> str:
    """What cuDNN's bf16 LSTM yardstick (library_train) runs on the card: the
    kernels of one forward with autograd on, by name and count."""
    from svd_lstm_tpu_torch.bench import trace

    lstm = cudnn_lstm(layers, x.device, torch.bfloat16)
    xb = x.detach().to(torch.bfloat16).requires_grad_(True)
    with tempfile.TemporaryDirectory() as tmp, cudnn_exact(), torch.enable_grad():
        stats = trace.op_breakdown(trace.capture_trace(lambda: lstm(xb), out_dir=tmp))
    launches = sum(st.count for st in stats)
    top = ", ".join(f"{st.name[:60]} x{st.count}" for st in stats[:4])
    return f"{launches} device ops ({top})"


def kernel_ms(fn, calls: int = 3) -> dict:
    """The card's time in each kernel of one call of ``fn`` (ms: the mean
    over the launches of it that torch.profiler's device trace of ``calls``
    calls recorded, after a warm-up; the trace can drop some), and their
    sum: the kernels alone, without the host's time to issue them that CUDA
    events around the call would count."""
    from svd_lstm_tpu_torch.bench import trace

    with tempfile.TemporaryDirectory() as tmp:
        stats = trace.op_breakdown(trace.capture_trace(lambda: [fn() for _ in range(calls)], out_dir=tmp))
    out = {st.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0][:40]:
           round(st.total_ms / st.count, 4) for st in stats}
    out["sum"] = round(sum(out.values()), 4)
    return out


def narrow_bf16_parts(tag: str, layers, x, hs, cs, dh) -> None:
    """K7f's or K8f's kernels by part on the card: the plan, the forward
    alone, each kernel of the backward (narrow_z, the chain, the weight
    gradients and their ordered sum, from one capture of whole calls), the
    GEMMs beside their bounds; registers, spills and shared memory."""
    T, B, d = x.shape
    units = [U.shape[0] for _, U, _ in layers]
    M, plan = T * B, ct.narrow_bf16_plan(units, d)
    splits = ct.narrow_bf16_splits(units, d, M, ct.sm_count(x.device))
    log(f"[parts] {tag}: {plan}, splits {splits}; shared memory fwd "
        f"{ct.narrow_bf16_fwd_smem_bytes(units, d)} B, bwd chain "
        f"{ct.narrow_bf16_bwd_smem_bytes(units, d)} B; "
        f"{ct.narrow_bf16_fwd_layout(units, d)}, {ct.narrow_bf16_bwd_layout(units, d)}")
    for name, r in kernel_resources("narrow_fwd_mma", "narrow_bwd_mma", "narrow_z", "narrow_wgrad").items():
        log(f"[parts] {tag} kernel {name}: {r}")
    log(f"[parts] {tag} fwd on the card (profiler): {kernel_ms(lambda: ct.narrow_bf16_fwd(layers, x, plan))}")
    log(f"[parts] {tag} bwd on the card by kernel (profiler): "
        f"{kernel_ms(lambda: ct.narrow_bf16_bwd(layers, x, hs, cs, dh, plan, splits))}")
    macs = sum(M * (din + n) * 4 * n for din, n in zip([d] + units[:-1], units))
    # narrow_z reads W, U, b, x and h and writes z; narrow_wgrad reads x, h
    # and dz (z's size) and writes [dW; dU; db] (the weights' size)
    zbytes = 4 * M * 4 * sum(units)
    for name, moved in (("narrow_z", nbytes(layers, x, hs) + zbytes),
                        ("narrow_wgrad", nbytes(layers, x, hs) + zbytes)):
        r = roofline.bound(macs, moved, "bfloat16")
        log(f"[parts] {tag} bwd {name}'s bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


@torch.no_grad()
def precision_kernel_checks(dev, data) -> dict:
    """Phase 10a: K7f at run A's shapes, K8f at B = 128 (4x40), K9f on run
    C's layer 1 and K6f at run D's shapes against their plain bf16 versions
    (forward h and c, every gradient), timed beside cuDNN's bf16 LSTM and
    the bf16 bound."""
    rng = np.random.default_rng(5)
    results = {}
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in TRAIN_RUNS[0].make(dev).layers]
    for tag, key, run in (("K7f", "fused_narrow_train", TRAIN_RUNS[0]),
                          ("K8f", "fused_narrow_train_compact", RECOVERY_RUNS[0])):
        fwd, bwd = getattr(ct, f"{key}_fwd"), getattr(ct, f"{key}_bwd")
        fwd_p = timed(bf16_variant(getattr(ct, f"{key}_fwd_plain")))
        bwd_p = timed(bf16_variant(getattr(ct, f"{key}_bwd_plain")))
        fwd_p64, bwd_p64 = getattr(ct, f"{key}_fwd_plain"), getattr(ct, f"{key}_bwd_plain")
        x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
        T_, B_, d_ = x.shape
        dh = torch.tensor(rng.normal(size=(T_, B_, layers[-1][1].shape[0])), dtype=torch.float32,
                          device=dev)
        hs_p, cs_p = fwd_p(layers, x)
        hs64, cs64 = fwd_p64(double(layers), x.double(), True)
        hs, cs = fwd(layers, x, True)
        err = max(fast_check(f"{tag} fwd {k}{i}", a, r, r64)
                  for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64))
                  for i, (a, r, r64) in enumerate(zip(got, want, want64)))
        shape = f"4x40, B={B_}, T={T_}, d={d_}"
        macs = roofline.lstm_macs(T_, B_, [(W.shape[0], U.shape[0]) for W, U, _ in layers])
        lib_fwd, lib_bwd = library_train(layers, x, dh, torch.bfloat16)
        f32_fwd, f32_bwd = library_train(layers, x, dh)
        runs = f"; the bf16 forward runs {cudnn_bf16_kernels(layers, x)}" if tag == "K7f" else ""
        log(f"[library] {tag}'s yardstick, cuDNN's LSTM at {shape}: bf16 fwd {lib_fwd:.3f} ms, bwd "
            f"{lib_bwd:.3f} ms; float32 (TF32 off) fwd {f32_fwd:.3f}, bwd {f32_bwd:.3f}{runs}")
        results[f"{key}_fwd_fast"] = {
            "max_abs_err": err,
            **time_pair(f"{tag} fwd", shape, bf16_variant(fwd), fwd_p, layers, x,
                        library_ms=lib_fwd,
                        **roofline.bound(macs, nbytes(layers, x, hs, cs), "bfloat16")),
        }
        args = (layers, x, hs_p, cs_p, dh)
        got, want = bwd(*args, True), bwd_p(*args)
        want64 = bwd_p64(double(layers), x.double(), double(hs_p), double(cs_p), dh.double(), True)
        err = max(fast_check(f"{tag} bwd {k}{i}", a, r, r64)
                  for k, gs, ws, ws64 in zip(("dW", "dU", "db"), got[:3], want[:3], want64[:3])
                  for i, (a, r, r64) in enumerate(zip(gs, ws, ws64)))
        err = max(err, fast_check(f"{tag} bwd dx", got[3], want[3], want64[3]))
        narrow_bf16_parts(tag, layers, x, hs_p, cs_p, dh)
        launches_at_two_lengths(f"{tag} fwd", lambda steps: fwd(layers, x[:steps].contiguous(), True), T_,
                                "narrow_bf16_fwd", "no copy", ["narrow_bf16_fwd"])
        launches_at_two_lengths(
            f"{tag} bwd", lambda steps: bwd(layers, x[:steps].contiguous(), [h[:steps].contiguous() for h in hs_p],
                                            [c[:steps].contiguous() for c in cs_p], dh[:steps].contiguous(), True),
            T_, "narrow_bf16_bwd", "no copy", ["narrow_bf16_bwd"])
        results[f"{key}_bwd_fast"] = {
            "max_abs_err": err,
            **time_pair(f"{tag} bwd", shape, bf16_variant(bwd), bwd_p, *args,
                        library_ms=lib_bwd,
                        **roofline.bound(3 * macs, nbytes(args, got), "bfloat16")),
        }

    # K9f on run C's layer 1 (3x512, B = 128), its input layer 0's h
    run = TRAIN_RUNS[2]
    l0, l1 = ([p.detach() for p in (l.W, l.U, l.b)] for l in run.make(dev).layers[:2])
    x = ct.wide_layer_fwd(first_batch(run, data, dev)[0].transpose(0, 1).contiguous(), *l0)[0]
    W, U, b = l1
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b, True)
    h64, c64 = ct.wide_layer_fwd_plain(*double([x, W, U, b]), True)
    h, c = ct.wide_layer_fwd(x, W, U, b, True)
    fwd_err = max(fast_check("K9f fwd h", h, h_p, h64), fast_check("K9f fwd c", c, c_p, c64))
    dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
    args = (x, W, U, b, h_p, c_p, dh)
    got, want = ct.wide_layer_bwd(*args, True), ct.wide_layer_bwd_plain(*args, True)
    want64 = ct.wide_layer_bwd_plain(*double(args), True)
    bwd_err = max(fast_check(f"K9f bwd {k}", a, r, r64)
                  for k, a, r, r64 in zip(("dx", "dW", "dU", "db"), got, want, want64))
    T9, B9, d9 = x.shape
    shape = "run C's layer 1: 512 units, d=512, B=128, T=200"
    macs = roofline.lstm_macs(T9, B9, [(d9, U.shape[0])])
    lib_fwd, lib_bwd = library_train([(W, U, b)], x, dh, torch.bfloat16)
    results["wide_layer_fwd_fast"] = {
        "max_abs_err": fwd_err,
        **time_pair("K9f fwd", shape, bf16_variant(ct.wide_layer_fwd), bf16_variant(ct.wide_layer_fwd_plain),
                    x, W, U, b, library_ms=lib_fwd,
                    **roofline.bound(macs, nbytes(args[:6]), "bfloat16")),
    }
    bf16_fwd_launches("K9f fwd", lambda steps: ct.wide_layer_fwd(x[:steps].contiguous(), W, U, b, True),
                      x, U.shape[0], True)
    launches_at_two_lengths(
        "K9f bwd", lambda steps: ct.wide_layer_bwd(*(a[:steps].contiguous() if a.dim() == 3 else a
                                                     for a in args), True),
        T9, "wide_bwd_chain_bf16", "no other copy")
    results["wide_layer_bwd_fast"] = {
        "max_abs_err": bwd_err,
        **time_pair("K9f bwd", shape, bf16_variant(ct.wide_layer_bwd), bf16_variant(ct.wide_layer_bwd_plain),
                    *args, library_ms=lib_bwd,
                    **roofline.bound(3 * macs, nbytes(args, got), "bfloat16")),
    }

    # K6f at run D's shapes: a fresh 512-unit layer's xp, B = 128
    run = TRAIN_RUNS[3]
    l = run.make(dev).layers[0]
    W, U, b = (p.detach() for p in (l.W, l.U, l.b))
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()
    xp = (torch.matmul(x, W) + b).contiguous()
    h_p, c_p = ct.lstm_recurrence_train_fwd_plain(xp, U, True)
    h64, c64 = ct.lstm_recurrence_train_fwd_plain(xp.double(), U.double(), True)
    h, c = ct.lstm_recurrence_train_fwd(xp, U, True)
    fwd_err = max(fast_check("K6f fwd h", h, h_p, h64), fast_check("K6f fwd c", c, c_p, c64))
    dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
    args = (xp, U, h_p, c_p, dh)
    got, want = ct.lstm_recurrence_train_bwd(*args, True), ct.lstm_recurrence_train_bwd_plain(*args, True)
    want64 = ct.lstm_recurrence_train_bwd_plain(*double(args), True)
    bwd_err = max(fast_check(f"K6f bwd {k}", a, r, r64) for k, a, r, r64 in zip(("dxp", "dU"), got, want, want64))
    T6, B6, _ = xp.shape
    shape = "run D: one 512-unit layer, B=128, T=200, xp from d=16"
    macs = roofline.lstm_macs(T6, B6, [(0, U.shape[0])])
    lib_fwd, lib_bwd = library_train([(W, U, b)], x, dh, torch.bfloat16)
    results["lstm_recurrence_train_fwd_fast"] = {
        "max_abs_err": fwd_err,
        **time_pair("K6f fwd", shape, bf16_variant(ct.lstm_recurrence_train_fwd),
                    bf16_variant(ct.lstm_recurrence_train_fwd_plain), xp, U, library_ms=lib_fwd,
                    **roofline.bound(macs, nbytes(xp, U, h, c), "bfloat16")),
    }
    bf16_fwd_launches("K6f fwd", lambda steps: ct.lstm_recurrence_train_fwd(xp[:steps].contiguous(), U, True),
                      xp, U.shape[0], False)
    launches_at_two_lengths(
        "K6f bwd", lambda steps: ct.lstm_recurrence_train_bwd(*(a[:steps].contiguous() if a.dim() == 3 else a
                                                              for a in args), True),
        xp.shape[0], "wide_bwd_chain_bf16", "no other copy")
    results["lstm_recurrence_train_bwd_fast"] = {
        "max_abs_err": bwd_err,
        **time_pair("K6f bwd", shape, bf16_variant(ct.lstm_recurrence_train_bwd),
                    bf16_variant(ct.lstm_recurrence_train_bwd_plain), *args, library_ms=lib_bwd,
                    **roofline.bound(3 * macs, nbytes(args, got), "bfloat16")),
    }
    return results


def regime_kernels(run: TrainRun, matmul_precision: str, kernel: bool, compact: bool) -> set:
    """The train wrappers a regime of ``run`` must launch, and no others:
    the run's own pair (K8's for the compact regime), "_fast" in bf16;
    none on the scan."""
    if not kernel:
        return set()
    names = [k.__name__ for k in run.kernels]
    if compact:
        names = [n.replace("fused_narrow_train", "fused_narrow_train_compact") for n in names]
    return {n + ("_fast" if matmul_precision == "bfloat16" else "") for n in names}


def counted(total: dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one call of the main path, with the train
    kernels' counts set to 0 just before it and read just after; its
    launches are added to ``total``. Returns (its result, its launches)."""
    ct.reset_launch_counts()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    launched = {k: v for k, v in ct.LAUNCHES.items() if v}
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    return out, launched


def param_change(trained, init) -> torch.Tensor:
    """The trained model's parameters less the initial model's, one float64
    vector."""
    return torch.cat([(a - b).detach().double().reshape(-1)
                      for a, b in zip(trained.parameters(), init.parameters())])


def card_busy_ms(step) -> float:
    """The card's busy time in one train step (torch.profiler's kernels and
    copies, ``bench.trace``), the card idle before it."""
    from svd_lstm_tpu_torch.bench import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        stats = trace.op_breakdown(trace.capture_trace(step, out_dir=tmp, warmup=0))
    return sum(s.total_ms for s in stats)


def regime_cfg(run: TrainRun, matmul_precision: str, kernel: bool, compact: bool) -> P.TrainConfig:
    return dataclasses.replace(run.cfg, matmul_precision=matmul_precision, recurrence_kernel=kernel,
                               compact_gates=compact, num_windows=PRECISION_STEPS * run.cfg.batch_size,
                               epochs=1)


def regime_path(dev, data, launches: dict) -> None:
    """Phase 10b: runs A and C (and D for K6f), PRECISION_STEPS Adam steps
    of ``fit`` in each regime from the same model and windows; each
    regime's launches (its own wrappers only), its whole-run prediction
    (exact ``predict`` of the trained model on the test run) against the
    exact regime's (the first: f32_scan, D's f32_kernel) within the fast
    band, the untrained model's distance from it and the regime's change of
    the parameters against the exact regime's change, and one train step's
    span (CUDA events, the median of 2, the step warm from the fit) and card
    busy time (torch.profiler); then run B's σ fine-tune and run E's gated
    recovery in the bf16 kernel regime. The main-path calls' launches are
    added to ``launches``."""
    x_test = torch.tensor(data.X_test[0], device=dev)
    # the JAX package's five training regimes, then the port's float32 kernels
    regimes = at._TRAIN_REGIMES + (("f32_kernel", "float32", True, False),)
    for run in TRAIN_RUNS:
        if run.name not in PRECISION_RUNS:
            continue
        band, only = PRECISION_RUNS[run.name]
        x, y = first_batch(run, data, dev)
        base_apply, loss_extra, make_opt = at._train_apply_for(run.make(dev))
        init = run.make(dev)
        init_pred = P.predict(init, x_test)
        exact_pred = exact_change = None
        chosen = [r for name in only for r in regimes if r[0] == name] if only else regimes
        for name, prec, kernel, compact in chosen:
            if compact and not at._compact_candidate(run.make(dev), x):
                continue
            cfg = regime_cfg(run, prec, kernel, compact)
            t0 = time.perf_counter()
            res, delta = counted(launches, P.fit, run.make(dev), data.X_train, data.y_train, cfg)
            wall = time.perf_counter() - t0
            want = regime_kernels(run, prec, kernel, compact)
            if set(delta) != want or not np.all(np.isfinite(res.history)) or res.rollbacks:
                fail(f"run {run.name} {name}: launched {delta}, wants {sorted(want)}; history "
                     f"{res.history}")
            pred = P.predict(res.params, x_test)
            change = param_change(res.params, init)
            if exact_pred is None:
                # the exact regime, the first: the band must tell its trained
                # model from the untrained one (PERF.md §2)
                exact_pred, exact_change = pred, change
                init_err = rel_err(init_pred, pred)
                log(f"[precision] run {run.name} {name}: the untrained model's prediction vs the "
                    f"trained one's rel. Frobenius {init_err:.3e} (band {FAST_BAND[band]:g}); "
                    f"parameter change {float(torch.linalg.norm(change)):.4e} over {change.numel()} "
                    "parameters")
                if not init_err > FAST_BAND[band]:
                    fail(f"run {run.name}: the fast band holds the untrained model too")
            err, change_err = rel_err(pred, exact_pred), rel_err(change, exact_change)
            cos = float(change @ exact_change / (torch.linalg.norm(change) * torch.linalg.norm(exact_change)))
            step = at._train_step(run.make(dev), resolve_train_apply_fn(cfg, base_apply)[0], loss_extra,
                                  make_opt, prec, x, y)
            span = device_time_ms(step, warmup=0, repeats=2)
            busy = card_busy_ms(step)
            log(f"[precision] run {run.name} {name}: {PRECISION_STEPS} steps {wall:.2f} s wall, loss "
                f"{res.history}, launches {delta}; one step (B={run.cfg.batch_size}, T={run.cfg.window_len}) "
                f"span {span:.3f} ms, card busy {busy:.3f} ms; whole-run prediction vs the exact regime's "
                f"rel. Frobenius {err:.3e} (band {FAST_BAND[band]:g}); parameter change vs the exact "
                f"regime's rel. {change_err:.3e}, cosine {cos:.6f}; {card_line()}")
            if not err <= FAST_BAND[band]:
                fail(f"run {run.name} {name}: the trained model's prediction left the fast band")

    run = TRAIN_RUNS[1]
    init = run.make(dev)
    res, delta = counted(launches, P.finetune, init, data.X_train, data.y_train, run.factor_cfg,
                         regime_cfg(run, "bfloat16", True, "auto"))
    log(f"[precision] run {run.name} bf16 kernels: loss {res.history}, launches {delta}")
    if set(delta) != regime_kernels(run, "bfloat16", True, False) or not np.all(np.isfinite(res.history)):
        fail(f"run {run.name}: the bf16 fine-tune did not run through K7f")
    check_finetune(init, res.params, data, dev)
    run = RECOVERY_RUNS[0]
    X, y = data.X_train, data.y_train
    (_, info), delta = counted(launches, P.recover_reduced_gated, run.make(dev), X, y,
                               train_cfg=regime_cfg(run, "bfloat16", True, "auto"), max_epochs=1,
                               validation=(X[:, :GATE_STEPS], y[:GATE_STEPS]))
    log(f"[precision] run {run.name} bf16 kernels: raw val MSE {info['raw_val_mse']:.6e}, best "
        f"{info['best_val_mse']:.6e}, launches {delta}")
    if (set(delta) != regime_kernels(run, "bfloat16", True, False)
            or not info["best_val_mse"] <= info["raw_val_mse"]):
        fail(f"run {run.name}: the bf16 recovery did not run through K8f or was not gated")


def autotune_train_path(dev, data, launches: dict) -> None:
    """Phase 10c: ``autotune_train`` at runs A's and C's shapes, the winner
    stored in the smoke's cache and served back by ``tuned_train_flags``;
    ``fit(auto_flags=True)`` from flags that say f32_scan must launch the
    winner's kernels (its launches added to ``launches``; autotune's own
    timing is not the main path's); then ``tune --train`` in a subprocess."""
    for run in (TRAIN_RUNS[0], TRAIN_RUNS[2]):
        x, y = first_batch(run, data, dev)
        model = run.make(dev)
        t0 = time.perf_counter()
        r = at.autotune_train(model, x, y, repeats=2)
        log(f"[tune-train] run {run.name} (B={x.shape[0]}, T={x.shape[1]}): winner "
            f"{(r.matmul_precision, r.recurrence_kernel, r.compact_gates)}, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(r.table.items(), key=lambda kv: kv[1]))
            + f"; skipped {r.failed} ({time.perf_counter() - t0:.1f} s; {card_line()})")
        if any(v != "compact layout ineligible for this model" for v in r.failed.values()):
            fail(f"autotune_train {run.name}: regimes failed: {r.failed}")
        flags = (r.matmul_precision, r.recurrence_kernel, r.compact_gates)
        at.store_tuned(at.train_cache_key(model, x), at.encode_train_flags(*flags))
        if at.tuned_train_flags(model, x, y) != flags:
            fail(f"autotune_train {run.name}: the cache did not serve the winner back")
        cfg = dataclasses.replace(regime_cfg(run, "float32", False, "auto"), auto_flags=True)
        res, delta = counted(launches, P.fit, model, data.X_train, data.y_train, cfg)
        want = regime_kernels(run, *flags)
        log(f"[tune-train] run {run.name} fit(auto_flags=True): loss {res.history}, launches {delta}")
        if set(delta) != want or not np.all(np.isfinite(res.history)):
            fail(f"run {run.name}: fit(auto_flags=True) launched {delta}, the winner wants {sorted(want)}")
    out = command("tune", "--train")
    lines = out.stdout.strip().splitlines()
    log("[tune-train] tune --train command: " + "; ".join(lines))
    if "<- winner" not in out.stdout or "cached ->" not in out.stdout:
        fail("tune --train: no winner stored")


def precision_path(dev, data) -> tuple:
    """Phase 10: the bf16 train kernels against their plain versions (10a),
    then the regimes' runs and autotune's training half. The launches are
    those of the main-path calls (``fit``, ``finetune``, the recovery and
    ``fit(auto_flags=True)``), each counted from zero just before it and
    read just after; the step timing, the profiler's capture and
    autotune's measurements are not counted. Returns (checks, launches)."""
    t0 = time.perf_counter()
    with exact_matmul():
        checks = precision_kernel_checks(dev, data)
    launches = dict.fromkeys(ct.LAUNCHES, 0)
    regime_path(dev, data, launches)
    autotune_train_path(dev, data, launches)
    log(f"[precision] train kernel launches of 10b-10c's main-path calls: {launches}; phase 10 "
        f"took {time.perf_counter() - t0:.1f} s")
    return checks, launches


# ---------------------------------------------------------------------------
# the conv hybrids (phase 11)
# ---------------------------------------------------------------------------

CONV_K = 10          # 11: the reference's conv experiment, Conv1D(15, k = 10, causal, relu) -> 2x LSTM(15)
CONV_UNITS = (15, 15)
CONV_RANK = 8        # 11a: make_conv_reduced_model(cutoff=None, rank=8), as examples/conv_compression.py
WIDE_CONV_RANK = 24  # 11b: the direct merged truncation of the 3x512 stack, as phase 4's
CONV_SWEEP_REDUCTIONS = 16
CONV_FIT = TrainRun(
    "11a conv 2x15 fit",
    lambda dev: P.init_conv_lstm(torch.Generator().manual_seed(0), in_channels=D, filters=CONV_UNITS[0],
                                 kernel_size=CONV_K, units=CONV_UNITS, device=dev),
    P.TrainConfig(window_len=TRAIN_T, batch_size=32, recurrence_kernel=True, num_windows=128, epochs=2),
    (ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd))
CONV_RECOVER_CFG = P.TrainConfig(batch_size=COMPACT_B, window_len=TRAIN_T, recurrence_kernel=True,
                                 num_windows=256, epochs=1)


def count_call(total: dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one call of phase 11's main path, with the
    batch-1 and train kernels' counts set to 0 just before it and read just
    after; its launches are added to ``total``. Returns (its result, its
    launches)."""
    ck.reset_launch_counts()
    ct.reset_launch_counts()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    launched = {k: v for counts in (ck.LAUNCHES, ct.LAUNCHES) for k, v in counts.items() if v}
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    return out, launched


def require(name: str, launched: dict, kernels, times: int | None = None, tag: str = "conv") -> None:
    """Fail unless each wrapper in ``kernels`` launched (``times`` times
    each, where given)."""
    for k in kernels:
        n = launched.get(k, 0)
        if n < 1 or (times is not None and n != times):
            fail(f"{name}: {k} launched {n} times{'' if times is None else f', not {times}'}")
    log(f"[{tag}] {name}: launches {launched}")


def conv_windows(model, data, dev, cfg: P.TrainConfig) -> torch.Tensor:
    """The hybrid's stack's input on the first batch of ``cfg``'s windows:
    the conv front end's output, time-major (T, B, filters)."""
    run = dataclasses.replace(CONV_FIT, cfg=cfg)
    x = first_batch(run, data, dev)[0]
    with exact_matmul(), torch.no_grad():
        return P.models.conv.conv_front(model.conv, x).transpose(0, 1).contiguous()


def conv_kernel_checks(dev, data, x) -> None:
    """11, before the path: each kernel of the 2x15 path (n = 15, d = 15, odd
    widths no earlier phase runs) against its plain version on the hybrid's
    own inputs, and timed: K7 at B = 32 and K8 at B = 128 (T = 200), K1 and
    K1f over T = 6656. Their plans are printed first."""
    rng = np.random.default_rng(5)
    model = CONV_FIT.make(dev)
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in model.layers]
    units, d = list(CONV_UNITS), CONV_UNITS[0]
    log(f"[conv] plans at 2x15, d=15: K1 exact {ck.dense_plan(units, d, False)}, fast "
        f"{ck.dense_plan(units, d, True)}; K7 lanes fwd {ct.narrow_fwd_lanes(units, d)}, bwd "
        f"{ct.narrow_bwd_lanes(units, d)} (weights staged: {ct.narrow_bwd_staged(units, d)}); K8 "
        f"{ct.compact_smem_bytes(units, d)} B of shared memory (fits: {ct.compact_fits(units, d)})")
    for tag, cfg, fwd, bwd, fwd_p, bwd_p in (
        ("K7", CONV_FIT.cfg, ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd,
         ct.fused_narrow_train_fwd_plain, ct.fused_narrow_train_bwd_plain),
        ("K8", CONV_RECOVER_CFG, ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_compact_bwd,
         ct.fused_narrow_train_compact_fwd_plain, ct.fused_narrow_train_compact_bwd_plain),
    ):
        xw = conv_windows(model, data, dev, cfg)
        shape = f"2x15, B={xw.shape[1]}, T={xw.shape[0]}, d={xw.shape[2]}"
        hs_p, cs_p = fwd_p(layers, xw)
        hs64, cs64 = fwd_p(double(layers), xw.double())
        hs, cs = fwd(layers, xw)
        for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64)):
            for i, (a, r, r64) in enumerate(zip(got, want, want64)):
                check_state(f"{tag} fwd {shape} {k}{i}", a, r, r64)
        dh = torch.tensor(rng.normal(size=hs_p[-1].shape), dtype=torch.float32, device=dev)
        args = (layers, xw, hs_p, cs_p, dh)
        got, want = bwd(*args), bwd_p(*args)
        for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3]):
            for i, (a, r) in enumerate(zip(gs, ws)):
                check_grad(f"{tag} bwd {shape} {k}{i}", a, r)
        check_grad(f"{tag} bwd {shape} dx", got[3], want[3])
        macs = roofline.lstm_macs(xw.shape[0], xw.shape[1], [(W.shape[0], U.shape[0]) for W, U, _ in layers])
        lib_fwd, lib_bwd = library_train(layers, xw, dh)
        time_pair(f"{tag} fwd", shape, fwd, fwd_p, layers, xw, library_ms=lib_fwd,
                  **roofline.bound(macs, nbytes(layers, xw, hs, cs)))
        time_pair(f"{tag} bwd", shape, bwd, bwd_p, *args, library_ms=lib_bwd,
                  **roofline.bound(3 * macs, nbytes(args, got)))
    with exact_matmul(), torch.no_grad():
        xc = P.models.conv.conv_front(model.conv, x[None])[0]
        stack = model.stack
        k1_plain = timed(ck.fused_dense_stack_plain)
        plain = k1_plain(stack, xc, "default")
        limit = fast_limit("K1f 2x15", plain, ck.fused_dense_stack_plain(as_double(stack), xc.double(),
                                                                         "default"))
        check_close("K1f fused_dense_stack fast 2x15",
                    ck.fused_dense_stack(stack, xc, dot_precision="default"), plain, limit)
        check_close("K1 fused_dense_stack 2x15 (the conv's output)", ck.fused_dense_stack(stack, xc),
                    k1_plain(stack, xc), TOL)
        for tag, dp, plain_ms in (("K1", None, k1_plain.ms[1]), ("K1f", "default", k1_plain.ms[0])):
            cost = roofline.dense_step_cost(d, units, dtype=torch.float32 if dp is None else torch.bfloat16)
            r = {"ms": device_time_ms(lambda: ck.fused_dense_stack(stack, xc, dot_precision=dp)),
                 "plain_ms": plain_ms, **cost.call_bound(T)}
            log(f"[time] {tag} (2x15, T={T}, d=15): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); {card_line()}")


def check_sigma_tune(init, tuned) -> None:
    """11a: the σ fine-tune froze the conv front end, the factors and the
    biases, and moved every σ."""
    for name, old in init.named_parameters():
        new = dict(tuned.named_parameters())[name]
        moved = not torch.equal(old, new)
        if moved != name.endswith(("ws", "us")) and not name.startswith("inner.head."):
            fail(f"11a finetune: {name} {'moved' if moved else 'did not move'}")
    log("[conv] 11a finetune: the conv and the factors frozen, every σ moved")


def conv_reference_path(dev, data, x, total: dict) -> dict:
    """11a: fit -> make_conv_singular_model -> finetune (Hoyer) ->
    make_conv_reduced_model -> recover_reduced_gated -> predict, exact and
    fast, each call counted; the outputs against the CPU float64 scan.
    Returns the models and the fit's loss history."""
    X, y = data.X_train, data.y_train
    res, launched = count_call(total, P.fit, CONV_FIT.make(dev), X, y, CONV_FIT.cfg)
    require("11a fit (B=32)", launched, [k.__name__ for k in CONV_FIT.kernels])
    if not res.history or res.rollbacks or not np.all(np.isfinite(res.history)):
        fail("11a fit: non-finite loss")
    log(f"[conv] 11a fit: loss history {res.history}")
    smodel = P.make_conv_singular_model(res.params, merged_kernel=False)
    tuned, launched = count_call(total, P.finetune, smodel, X, y, P.FactorConfig(hoyer=0.01), CONV_FIT.cfg)
    require("11a finetune (B=32)", launched, [k.__name__ for k in CONV_FIT.kernels])
    check_sigma_tune(smodel, tuned.params)
    reduced = P.make_conv_reduced_model(tuned.params, cutoff=None, rank=CONV_RANK)
    gate = dict(max_epochs=2, validation=(X[:, :GATE_STEPS], y[:GATE_STEPS]))
    (rec, info), launched = count_call(total, P.recover_reduced_gated, reduced, X, y,
                                       train_cfg=CONV_RECOVER_CFG, **gate)
    require(f"11a recover_reduced_gated (B={COMPACT_B})", launched,
            ["fused_narrow_train_compact_fwd", "fused_narrow_train_compact_bwd"])
    log(f"[conv] 11a recovery: raw val MSE {info['raw_val_mse']:.6e}, best {info['best_val_mse']:.6e}, "
        f"trace {info['trace']}")
    if not (np.isfinite(info["best_val_mse"]) and info["best_val_mse"] <= info["raw_val_mse"]):
        fail("11a recovery: the gate returned a model worse than the truncation")
    if final_ranks(rec.inner) != {CONV_RANK}:
        fail(f"11a recovery: ranks {final_ranks(rec.inner)}, not {CONV_RANK}")

    models = {"dense": res.params, "reduced": rec}
    x_cpu = x[:REF_STEPS].cpu()
    times = {}
    for name, m in models.items():
        y_exact, launched = count_call(total, P.predict, m, x)
        require(f"11a predict {name} exact", launched, ["fused_dense_stack"], times=1)
        y_fast, launched = count_call(total, P.predict, m, x, precision="fast")
        require(f"11a predict {name} fast", launched, ["fused_dense_stack_fast"], times=1)
        check_vs_cpu_reference(f"11a {name} hybrid", y_exact, copy.deepcopy(m).cpu(), x_cpu)
        rel = rel_err(y_fast, y_exact)
        log(f"[check] 11a {name} hybrid fast vs exact: rel Frobenius {rel:.3e} "
            f"(band {FAST_BAND['narrow']:g})")
        if not rel <= FAST_BAND["narrow"]:
            fail(f"11a {name} hybrid: fast error {rel:.3e}")
        times[name] = {p: device_time_ms(lambda p=p: P.predict(m, x, precision=p)) for p in ("exact", "fast")}
    y_true = data.y_test
    x_test = torch.tensor(data.X_test[0], device=dev)
    log(f"[conv] 11a T={T}: predict dense exact {times['dense']['exact']:.3f} ms, fast "
        f"{times['dense']['fast']:.3f} ms; reduced r={CONV_RANK} exact {times['reduced']['exact']:.3f} ms, "
        f"fast {times['reduced']['fast']:.3f} ms; test RMSE dense "
        f"{P.rmse(P.predict(res.params, x_test)[:, 0].cpu().numpy(), y_true):.6f}, recovered "
        f"{P.rmse(P.predict(rec, x_test)[:, 0].cpu().numpy(), y_true):.6f}; weights "
        f"{sum(p.numel() for p in res.params.parameters())} -> {rec.weight_count()}; {card_line()}")
    return models, res.history


def conv_wide_path(dev, x, total: dict) -> None:
    """11b: a seeded conv front end (16 -> 16, k = 10) over the 3x512
    checkpoint's own layers and head, dense (K3 and K3f once a layer) and
    its direct merged r = 24 truncation (K2 and K2f once a layer), exact and
    fast; exact against the CPU float64 scan, dense fast within the wide
    band (the direct truncation's fast error reported: ROADMAP fault 3.1);
    times beside the bare stacks' and the conv front end's."""
    m512 = P.load_params(DENSE_512, device=dev)
    front = P.init_conv_lstm(torch.Generator().manual_seed(1), in_channels=D, filters=D, kernel_size=CONV_K,
                             units=(), device=dev).conv
    hybrid = P.ConvLSTM(front, list(m512.layers), m512.head)
    reduced = P.make_conv_reduced_model(P.make_conv_singular_model(hybrid, merged_kernel=True), cutoff=None,
                                        rank=WIDE_CONV_RANK)
    bare_red = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=WIDE_CONV_RANK)
    x_cpu = x[:REF_STEPS].cpu()
    L = len(m512.layers)
    for name, m, kernel in (("dense", hybrid, "lstm_recurrence"),
                            (f"merged r={WIDE_CONV_RANK}", reduced, "reduced_recurrence")):
        y_exact, launched = count_call(total, P.predict, m, x)
        require(f"11b predict {name} exact", launched, [kernel], times=L)
        y_fast, launched = count_call(total, P.predict, m, x, precision="fast")
        require(f"11b predict {name} fast", launched, [kernel + "_fast"], times=L)
        check_vs_cpu_reference(f"11b 3x512 {name} hybrid", y_exact, copy.deepcopy(m).cpu(), x_cpu)
        rel = rel_err(y_fast, y_exact)
        gated = name == "dense"
        log(f"[check] 11b {name} hybrid fast vs exact: rel Frobenius {rel:.3e} "
            + (f"(band {FAST_BAND['wide']:g})" if gated else "(reported, not gated: ROADMAP fault 3.1)"))
        if gated and not rel <= FAST_BAND["wide"]:
            fail(f"11b {name} hybrid: fast error {rel:.3e}")
    ms = {}
    for name, m in (("hybrid dense", hybrid), ("hybrid reduced", reduced), ("bare dense", m512),
                    ("bare reduced", bare_red)):
        for p in ("exact", "fast"):
            ms[name, p] = device_time_ms(lambda m=m, p=p: P.predict(m, x, precision=p))
    with exact_matmul(), torch.no_grad():
        conv_ms = device_time_ms(lambda: P.models.conv.conv_front(front, x[None]))
    for p in ("exact", "fast"):
        log(f"[ratio] 11b 3x512 {p}, T={T}: hybrid dense {ms['hybrid dense', p]:.3f} ms, hybrid merged "
            f"r={WIDE_CONV_RANK} {ms['hybrid reduced', p]:.3f} ms, ratio "
            f"{ms['hybrid reduced', p] / ms['hybrid dense', p]:.4f}; "
            f"bare dense {ms['bare dense', p]:.3f} ms, "
            f"bare r={WIDE_CONV_RANK} {ms['bare reduced', p]:.3f} ms, ratio "
            f"{ms['bare reduced', p] / ms['bare dense', p]:.4f}; the conv front end alone {conv_ms:.3f} ms; "
            f"{card_line()}")


def conv_deploy_path(dev, x, data, models: dict, total: dict) -> None:
    """11c, on 11a's hybrids: the int8 tree through quantized_apply(predict)
    (K1); the CSV and int8 .bin exports through the native runtime against
    predict; make_stream_fn's graph step against predict and the eager
    step, its per-frame latency; autotune of the reduced hybrid, its winner
    launched by predict(impl="auto"); a rank sweep of the dense hybrid (K1
    once an evaluation)."""
    from svd_lstm_tpu_torch.bench.sweep import rank_sweep
    from svd_lstm_tpu_torch.config import SweepConfig
    from svd_lstm_tpu_torch.io import csv_weights, int8_export, native
    from svd_lstm_tpu_torch.models.conv import inner_stack

    dense, rec = models["dense"], models["reduced"]
    x_cpu = x[:REF_STEPS].cpu()
    q = P.quantize_params(rec)
    y8, launched = count_call(total, P.quantized_apply(P.predict), q, x)
    require("11c int8 predict", launched, ["fused_dense_stack"], times=1)
    dq_cpu = P.from_numpy_tree(P.to_numpy_tree(P.dequantize_params(q)), device="cpu")
    check_vs_cpu_reference("11c int8 reduced hybrid", y8, dq_cpu, x_cpu)
    log(f"[conv] 11c int8: param_bytes {P.param_bytes(rec)} -> {P.param_bytes(q)}; int8 vs float32 predict "
        f"rel Frobenius {rel_err(y8, P.predict(rec, x)):.4e}")

    frames = x[:STREAM_FRAMES]
    frames_np = frames.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for name, model in models.items():
            d = os.path.join(tmp, name)
            if name == "reduced":
                native.save_reduced_weights_as_csv(model, d)
            else:
                csv_weights.save_model_weights_as_csv(model, d)
            binpath = d + ".bin"
            size = int8_export.save_model_int8_bin(model, binpath)
            check_prefix(f"11c native CSV {name} hybrid vs card predict",
                         native.NativeModel.from_export_dir(d).run(frames_np), P.predict(model, frames),
                         NATIVE_TOL)
            check_prefix(f"11c native int8 .bin ({size} bytes) {name} hybrid vs card predict of the "
                         f"artifact's model", native.NativeModel.from_int8(binpath).run(frames_np),
                         P.predict(int8_export.dequantized_params(model), frames), NATIVE_TOL)

        fn, state0 = P.make_stream_fn(rec)
        state, ys = state0, []
        for t in range(len(frames)):
            yt, state = fn(state, frames[t : t + 1])
            ys.append(yt)
        graph = torch.cat(ys)
        check_close(f"11c stream graph step, reduced hybrid, vs predict, {len(frames)} frames", graph,
                    P.predict(rec, frames), TOL)
        state, ys = P.init_stream(rec), []
        for t in range(len(frames)):
            yt, state = P.stream_step(rec, state, frames[t : t + 1])
            ys.append(yt)
        check_close("11c stream graph step, reduced hybrid, vs eager stream_step", graph, torch.cat(ys),
                    GRAPH_TOL)
        lat_graph = stream_latency(fn, state0, frames_np, dev)
        lat_eager = stream_latency(lambda s, f: P.stream_step(rec, s, f), P.init_stream(rec), frames_np, dev)
        nm = native.NativeModel.from_int8(os.path.join(tmp, "reduced.bin"))
        lat_native = []
        for f in frames_np:
            t0 = time.perf_counter()
            nm.step(f)
            lat_native.append(time.perf_counter() - t0)
    log(f"[stream] 11c reduced hybrid, per-frame wall clock over {len(frames_np)} frames after "
        f"{STREAM_WARMUP}: {percentiles('graph step', lat_graph)}; "
        f"{percentiles('eager stream_step', lat_eager)}; {percentiles('native int8 (host)', lat_native)}; "
        f"frame period {FRAME_PERIOD_US:.0f} us; {card_line()}")

    r = at.autotune(rec, x, repeats=TUNE_REPEATS)
    log(f"[tune] 11c reduced hybrid {tuple(x.shape)} exact: winner {r.impl!r}, "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(r.table.items(), key=lambda kv: kv[1]))
        + f"; {card_line()}")
    if r.failed:
        fail(f"11c autotune: candidates failed: {r.failed}")
    at.store_tuned(at.cache_key(rec, x, "exact"), r.impl)
    y_auto, launched = count_call(total, P.predict, rec, x)
    want = {route_kernel(inner_stack(rec), r.impl)} - {None}
    if set(launched) != want:
        fail(f"11c autotune: predict(impl='auto') launched {launched}, winner {r.impl!r} wants {want}")
    if not torch.equal(y_auto, P.predict(rec, x, impl=r.impl, consult_cache=False)):
        fail(f"11c autotune: predict(impl='auto') differs from impl={r.impl!r}")
    log(f"[tune] 11c: predict(impl='auto') launched {launched or 'no kernel'}, bit-equal to impl={r.impl!r}")

    inv = data.pin_scaler.inverse_transform
    y_m = inv(data.y_test.reshape(-1, 1)).ravel()
    res, launched = count_call(total, rank_sweep, dense, data.X_test, y_m, inv,
                               SweepConfig(evaluate_every=SWEEP_EVERY), max_reductions=CONV_SWEEP_REDUCTIONS)
    require("11c rank sweep", launched, ["fused_dense_stack"], times=len(res.rmse))
    if res.reductions_done != CONV_SWEEP_REDUCTIONS or not np.isfinite(res.rmse).all():
        fail(f"11c rank sweep: {res.reductions_done} reductions, RMSE {res.rmse}")
    log(f"[sweep] 11c dense hybrid, T={data.X_test.shape[1]}, {res.reductions_done} reductions: RMSE "
        f"{', '.join(f'{v:.6f}' for v in res.rmse)}, weights eliminated {res.weights_eliminated[-1]}")


def conv_path(dev, x, data) -> dict:
    """Phase 11: the conv hybrids (11a-11c), every main-path call counted.
    Returns the launches of those calls."""
    t0 = time.perf_counter()
    total: dict = {}
    conv_kernel_checks(dev, data, x)
    models, history = conv_reference_path(dev, data, x, total)
    compare_run(CONV_FIT, dev, data, {CONV_FIT.name: history})
    with exact_matmul(), torch.no_grad():
        conv_wide_path(dev, x, total)
        conv_deploy_path(dev, x, data, models, total)
    log(f"[conv] phase 11 kernel launches of its main-path calls: {total}; phase 11 took "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    return total


# ---------------------------------------------------------------------------
# the last training knobs and the structural surgery (phase 12)
# ---------------------------------------------------------------------------

REMAT_B, REMAT_T, REMAT_K = 64, 1024, 64  # 12a: the 1x512 f32_scan step and its chunk
SINGULAR_REMAT = 50        # 12a: the 4x30 split model's chunk at T = 200
REMAT_LOSS_RTOL = 1e-6     # 12a: remat vs plain step: the same arithmetic, recomputed
REMAT_GRAD_RTOL = 1e-5     # 12a: every gradient, of its largest |value|
DROPOUT = 0.2              # 12b: both rates
SEED_RTOL = 1e-6           # 12b: two dropout fine-tunes from one seed
PRUNED_WIDE = (384, 384, 384)     # 12c: prune_to_width of the 3x512 checkpoint
PRUNED_NARROW = (20, 20, 20, 20)  # 12c: of the 4x30 checkpoint
PRUNED_RANK = 24           # 12c: the direct merged truncation of the pruned 3x384
SILENCED_TOL = 5e-4        # 12c: pruned vs the full model with the dropped units silenced
MERGE_UNITS = 256          # 12d: each parallel cell; the merged layer has twice as many
MERGE_TOL = 2 * TOL        # 12d: the merged predict against the sum of two
SIGMA_SPARSITY = 0.5       # 12e: the schedule's final sparsity
KNOB_CFG = P.TrainConfig(batch_size=32, window_len=TRAIN_T, recurrence_kernel=True, num_windows=256,
                         epochs=1)  # 12b, 12e (two epochs)


def knob_step(model, x, y, cfg: P.TrainConfig, apply_fn):
    """One train step's forward and backward as ``fit`` takes it (its
    resolver, its loss, its regime) on a copy of ``model``. Returns (loss,
    {parameter: gradient}, the peak of allocated device memory above the
    step's start in bytes, wall seconds, whether a train kernel took it)."""
    m = copy.deepcopy(model)
    fn, used = resolve_train_apply_fn(cfg, apply_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with train_matmul_scope(cfg.matmul_precision):
        loss = mse_last_step(m, x, y, fn)
        loss.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    grads = {name: p.grad.detach().clone() for name, p in m.named_parameters()}
    return loss.item(), grads, peak, wall, used


def check_same_step(name: str, got: tuple, want: tuple) -> None:
    """Two knob_step results of one step: loss within REMAT_LOSS_RTOL, every
    gradient within REMAT_GRAD_RTOL of its largest |value|."""
    (lg, gg), (lw, gw) = got[:2], want[:2]
    log(f"[check] {name} loss: {lg:.9f} vs {lw:.9f} (rtol {REMAT_LOSS_RTOL:g})")
    if not abs(lg - lw) <= REMAT_LOSS_RTOL * abs(lw):
        fail(f"{name}: losses differ by {abs(lg - lw):.3e}")
    for k, w in gw.items():
        check_close(f"{name} d{k}", gg[k], w, REMAT_GRAD_RTOL * float(w.abs().max()))


def remat_path(dev, data, total: dict) -> None:
    """12a: one f32_scan step of a seeded 1x512 stack at B = 64, T = 1024
    with remat_chunk 0 and 64: the same loss and gradients, the remat peak
    memory below the plain one; the same step with recurrence_kernel (K6,
    the knob ignored); a split 4x30 singular step with remat 50 at T = 200."""
    model = P.init_stacked_lstm(torch.Generator().manual_seed(12), input_dim=D, units=(512,), device=dev)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(REMAT_B, REMAT_T, D)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.normal(size=REMAT_B), dtype=torch.float32, device=dev)
    step_mib = 7 * REMAT_B * 512 * 4 / 2**20
    log(f"[knobs] 12a prediction: the plain scan keeps ~7 (B, n) tensors a step ({step_mib:.2f} MiB), "
        f"{REMAT_T} steps ~{REMAT_T * step_mib / 1024:.2f} GiB plus xp (B, T, 4n) "
        f"{REMAT_B * REMAT_T * 2048 * 4 / 2**30:.2f} GiB: a peak of 1.5-2.0 GiB; remat keeps "
        f"{REMAT_T // REMAT_K} chunk boundaries, the (B, T, n) output and one chunk's {REMAT_K} steps "
        "while it recomputes: 0.25-0.45 GiB; its step 1.3-2x the plain step's wall time")
    cfg = P.TrainConfig(batch_size=REMAT_B, window_len=REMAT_T)
    steps = {}
    for K in (0, REMAT_K):
        # a first step of each, untimed: it pays torch.utils.checkpoint's lazy imports
        knob_step(model, x, y, dataclasses.replace(cfg, remat_chunk=K), P.stacked_lstm_apply)
        steps[K], launched = count_call(total, knob_step, model, x, y, dataclasses.replace(cfg, remat_chunk=K),
                                        P.stacked_lstm_apply)
        if launched or steps[K][4]:
            fail(f"12a f32_scan step, remat_chunk={K}: launched {launched}")
        log(f"[knobs] 12a 1x512 f32_scan step (B={REMAT_B}, T={REMAT_T}, d={D}), remat_chunk={K}: loss "
            f"{steps[K][0]:.9f}, peak {steps[K][2] / 2**20:.1f} MiB above the step's start, wall "
            f"{steps[K][3] * 1e3:.1f} ms; {card_line()}")
    check_same_step(f"12a remat_chunk={REMAT_K} vs 0", steps[REMAT_K], steps[0])
    if not steps[REMAT_K][2] < steps[0][2]:
        fail(f"12a: the remat peak {steps[REMAT_K][2]} B is not below the plain peak {steps[0][2]} B")
    kernel = {}
    for K in (0, REMAT_K):
        kernel[K], launched = count_call(
            total, knob_step, model, x, y, dataclasses.replace(cfg, recurrence_kernel=True, remat_chunk=K),
            P.stacked_lstm_apply)
        require(f"12a recurrence_kernel step, remat_chunk={K}", launched,
                ["lstm_recurrence_train_fwd", "lstm_recurrence_train_bwd"], tag="knobs")
        log(f"[knobs] 12a K6 step, remat_chunk={K}: peak {kernel[K][2] / 2**20:.1f} MiB, wall "
            f"{kernel[K][3] * 1e3:.1f} ms")
    check_same_step(f"12a K6 step, remat_chunk={REMAT_K} vs 0 (ignored)", kernel[REMAT_K], kernel[0])
    grad_err = max(max_err(kernel[0][1][k], g) / float(g.abs().max()) for k, g in steps[0][1].items())
    log(f"[info] 12a K6 step vs the f32_scan step: loss {kernel[0][0]:.9f} vs {steps[0][0]:.9f}, "
        f"gradients within {grad_err:.3e} of their largest |value|")

    smodel = P.make_singular_model(P.load_params(DENSE_30, device=dev), merged_kernel=False)
    xs, ys = first_batch(TRAIN_RUNS[1], data, dev)
    sing = {}
    for K in (0, SINGULAR_REMAT):
        sing[K], launched = count_call(total, knob_step, smodel, xs, ys,
                                       P.TrainConfig(remat_chunk=K), P.singular_lstm_apply)
        if launched:
            fail(f"12a singular scan step launched {launched}")
        log(f"[knobs] 12a 4x30 split singular step (B={xs.shape[0]}, T={xs.shape[1]}), remat_chunk={K}: "
            f"peak {sing[K][2] / 2**20:.1f} MiB, wall {sing[K][3] * 1e3:.1f} ms")
    check_same_step(f"12a 4x30 split remat_chunk={SINGULAR_REMAT} vs 0", sing[SINGULAR_REMAT], sing[0])


def dropout_path(dev, data, total: dict) -> None:
    """12b: one epoch of a dropout σ fine-tune of the split 4x30 model with
    recurrence_kernel set (the wrapper keeps the scan: no train kernel),
    twice from one seed; the same fine-tune with rates 0 (K7) against the
    plain σ fine-tune and its scan."""
    from svd_lstm_tpu_torch.models.lstm import layer_masks
    from svd_lstm_tpu_torch.train.loop import batch_generator

    X, y = data.X_train, data.y_train
    smodel = P.make_singular_model(P.load_params(DENSE_30, device=dev), merged_kernel=False)
    fcfg = P.FactorConfig(hoyer=0.01, dropout=DROPOUT, recurrent_dropout=DROPOUT)
    l0 = smodel.layers[0]
    masks = [layer_masks(batch_generator(KNOB_CFG.seed ^ 0x5EED, 0, 0, dev), DROPOUT, DROPOUT, 4,
                         KNOB_CFG.batch_size, l0.input_dim, l0.units, torch.float32, dev) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*masks)):
        fail("12b: one (seed, epoch, batch) drew two different masks")
    keep = float(masks[0][0].ne(0).float().mean())
    log(f"[knobs] 12b batch (0, 0)'s layer-0 masks bit-identical from one seed; kept share {keep:.4f} "
        f"(rate {DROPOUT})")
    steps = KNOB_CFG.num_windows // KNOB_CFG.batch_size
    hists = []
    for i in range(2):
        t0 = time.perf_counter()
        res, launched = count_call(total, P.finetune, smodel, X, y, fcfg, KNOB_CFG)
        wall = time.perf_counter() - t0
        if launched:
            fail(f"12b dropout fine-tune launched {launched}: it must keep the scan")
        if not res.history or res.rollbacks or not np.all(np.isfinite(res.history)):
            fail(f"12b dropout fine-tune: history {res.history}, rollbacks {res.rollbacks}")
        hists.append(np.asarray(res.history))
        log(f"[knobs] 12b dropout fine-tune run {i}: history {res.history}, {steps} steps in {wall:.2f} s "
            f"({wall / steps * 1e3:.1f} ms a step, B={KNOB_CFG.batch_size}, T={TRAIN_T}); {card_line()}")
    rel = float(np.max(np.abs(hists[0] - hists[1]) / np.abs(hists[1])))
    log(f"[check] 12b two dropout fine-tunes from one seed: max rel diff {rel:.3e} (rtol {SEED_RTOL:g})")
    if not rel <= SEED_RTOL:
        fail("12b: two dropout fine-tunes from one seed disagree")
    zero, launched = count_call(total, P.finetune, smodel, X, y,
                                P.FactorConfig(hoyer=0.01, dropout=0.0, recurrent_dropout=0.0), KNOB_CFG)
    require("12b fine-tune with rates 0", launched, ["fused_narrow_train_fwd", "fused_narrow_train_bwd"],
            tag="knobs")
    plain, _ = count_call(total, P.finetune, smodel, X, y, P.FactorConfig(hoyer=0.01), KNOB_CFG)
    scan = P.finetune(smodel, X, y, P.FactorConfig(hoyer=0.01), dataclasses.replace(KNOB_CFG, recurrence_kernel=False))
    for name, other, tol in (("the plain σ fine-tune", plain.history, SEED_RTOL),
                             ("the plain σ fine-tune on the scan", scan.history, HIST_RTOL)):
        rel = float(np.max(np.abs(np.asarray(zero.history) - other) / np.abs(other)))
        log(f"[check] 12b rates 0 {zero.history} vs {name} {other}: max rel diff {rel:.3e} (rtol {tol:g})")
        if not rel <= tol:
            fail(f"12b: the fine-tune with rates 0 differs from {name}")
    if np.allclose(hists[0], zero.history, rtol=SEED_RTOL, atol=0):
        fail("12b: the dropout fine-tune trained as if nothing dropped")


def silenced(model, keep: list):
    """A copy of a dense stack with every unit outside ``keep`` silenced: its
    g-gate columns of W, U and b zeroed (its c and h stay 0) and its rows of
    the next layer's W or the head zeroed."""
    m = copy.deepcopy(model)
    with torch.no_grad():
        for li, layer in enumerate(m.layers):
            n = layer.units
            drop = torch.tensor(np.setdiff1d(np.arange(n), keep[li]), device=layer.W.device)
            for M in (layer.W, layer.U):
                M[:, 2 * n + drop] = 0.0
            layer.b[2 * n + drop] = 0.0
            (m.layers[li + 1].W if li + 1 < len(m.layers) else m.head.w)[drop] = 0.0
    return m


def pruned_kernel_checks(dev, x, data, pruned, red) -> None:
    """12c, before the path: K3 and K3f on each layer of the pruned 3x384, K2
    on each layer of its direct merged r = 24 truncation (T = 6656) and K2f
    over windows of it as phase 3c holds K2f, and K9
    on its first two layers at run C's B = 128 (T = 200), each against its
    plain version and timed; the plans first (n = 384 is a width no earlier
    phase runs)."""
    n = PRUNED_WIDE[0]
    sms = ct.sm_count(dev)
    log(f"[knobs] 12c plans at n = {n}: K3 exact {ck.card_recurrence_plan(dev, n, False)}, fast "
        f"{ck.card_recurrence_plan(dev, n, True)}; K2 merged r={PRUNED_RANK} exact "
        f"{ck.card_reduced_plan(dev, n, ck.reduced_ranks(red.layers[0].uB), False)}, fast "
        f"{ck.card_reduced_plan(dev, n, ck.reduced_ranks(red.layers[0].uB), True)}; K9 at B={COMPACT_B}: "
        f"forward chain {ct.fwd_chain_plan(COMPACT_B, n, sms)}, backward chain {ct.chain_plan(COMPACT_B, n, sms)}")
    Tx, d = x.shape
    with torch.no_grad():
        k3_plain = timed(ck.lstm_recurrence_plain)
        runs = layer_runs(pruned, x, lambda l, h: torch.matmul(h, l.W), k3_plain)
        for i, (l, xp, h) in enumerate(runs):
            check_close(f"12c K3 lstm_recurrence 3x384 layer {i}", ck.lstm_recurrence(xp, l.U), h, TOL)
            plain = ck.lstm_recurrence_plain(xp, l.U, dot_precision="default")
            limit = fast_limit(f"12c K3f 3x384 layer {i}", plain,
                               ck.lstm_recurrence_plain(xp.double(), l.U.double(), dot_precision="default"))
            check_close(f"12c K3f lstm_recurrence fast 3x384 layer {i}",
                        ck.lstm_recurrence(xp, l.U, dot_precision="default"), plain, limit)
        l0, xp0, h0 = runs[0]
        log(f"[time] 12c K3 (one 384-unit layer, T={Tx}): kernel "
            f"{device_time_ms(ck.lstm_recurrence, xp0, l0.U):.3f} ms, fast "
            f"{device_time_ms(lambda: ck.lstm_recurrence(xp0, l0.U, dot_precision='default')):.3f} ms, plain "
            f"{k3_plain.ms[0]:.3f} ms, "
            f"library {library_forward('12c K3 384', [(l0.W, l0.U, l0.b)], x[:, None], h0[:, None]):.3f} ms, "
            f"bound {roofline.recurrence_step_cost(n).call_bound(Tx)['bound_ms']:.4f} ms; {card_line()}")
        proj = lambda l, h: reduced_projection(l, h, "w")  # noqa: E731
        first, k2_plain = None, timed(ck.reduced_recurrence_plain)
        for i, (l, xp, h) in enumerate(layer_runs(red, x, proj, k2_plain)):
            args = (xp, *recurrence_args(l))
            check_close(f"12c K2 reduced_recurrence 3x384 merged r={PRUNED_RANK} layer {i}",
                        ck.reduced_recurrence(*args), h, TOL)
            first = first or args
        with exact_matmul():  # the direct truncation: each window's limit takes its plain drift in
            reduced_fast_windows(f"12c K2f reduced_recurrence fast 3x384 merged r={PRUNED_RANK}", red, x,
                                 drift_limit=True)
        log(f"[time] 12c K2 (one 384-unit layer, merged r={PRUNED_RANK}, T={Tx}): kernel "
            f"{device_time_ms(ck.reduced_recurrence, *first):.3f} ms, fast "
            f"{device_time_ms(lambda: ck.reduced_recurrence(*first, dot_precision='default')):.3f} ms, plain "
            f"{k2_plain.ms[0]:.3f} ms, "
            f"library {reduced_library_ms(red, x, torch.float32):.3f} ms, bound "
            f"{roofline.reduced_recurrence_step_cost(n, (PRUNED_RANK,)).call_bound(Tx)['bound_ms']:.4f} ms")
    rng = np.random.default_rng(6)
    xw = first_batch(TRAIN_RUNS[2], data, dev)[0].transpose(0, 1).contiguous()
    with exact_matmul():
        for i, l in enumerate(pruned.layers[:2]):
            W, U, b = (p.detach() for p in (l.W, l.U, l.b))
            h_p, c_p = ct.wide_layer_fwd_plain(xw, W, U, b)
            h64, c64 = ct.wide_layer_fwd_plain(*double([xw, W, U, b]))
            h, c = ct.wide_layer_fwd(xw, W, U, b)
            name = f"12c K9 3x384 layer {i} (d={xw.shape[-1]})"
            check_state(f"{name} fwd h", h, h_p, h64)
            check_state(f"{name} fwd c", c, c_p, c64)
            dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
            args = (xw, W, U, b, h_p, c_p, dh)
            got, want = ct.wide_layer_bwd(*args), ct.wide_layer_bwd_plain(*args)
            for k, a, r in zip(("dx", "dW", "dU", "db"), got, want):
                check_grad(f"{name} bwd {k}", a, r)
            xw = h_p
        shape = f"one {n}-unit layer, d={n}, B={COMPACT_B}, T={TRAIN_T}"
        macs = roofline.lstm_macs(TRAIN_T, COMPACT_B, [(n, n)])
        lib_fwd, lib_bwd = library_train([args[1:4]], args[0], dh)
        time_pair("12c K9 fwd", shape, ct.wide_layer_fwd, ct.wide_layer_fwd_plain, *args[:4],
                  library_ms=lib_fwd, **roofline.bound(macs, nbytes(args[:6])))
        time_pair("12c K9 bwd", shape, ct.wide_layer_bwd, ct.wide_layer_bwd_plain, *args,
                  library_ms=lib_bwd, **roofline.bound(3 * macs, nbytes(args, got)))


def prune_path(dev, x, data, total: dict) -> None:
    """12c: prune_to_width of the 3x512 checkpoint to 3x384 and of the 4x30
    one to 4x20; predict exact and fast, against the CPU float64 scan and
    against the full model with the dropped units silenced; the direct
    merged r = 24 truncation of the pruned stack; one fit at run C's shape
    on K9 held to the plain scan; the times beside the unpruned models'."""
    m512 = P.load_params(DENSE_512, device=dev)
    keep = [np.sort(np.argsort(s)[::-1][:w]) for s, w in zip(P.unit_importance(m512), PRUNED_WIDE)]
    pruned = P.prune_to_width(m512, PRUNED_WIDE)
    red = P.make_reduced_model(P.make_singular_model(pruned, merged_kernel=True), rank=PRUNED_RANK)
    pruned_kernel_checks(dev, x, data, pruned, red)
    x_cpu = x[:REF_STEPS].cpu()
    L = len(PRUNED_WIDE)
    with exact_matmul(), torch.no_grad():
        y_exact, launched = count_call(total, P.predict, pruned, x)
        require("12c predict 3x384 exact", launched, ["lstm_recurrence"], times=L, tag="knobs")
        check_vs_cpu_reference("12c 3x384", y_exact, copy.deepcopy(pruned).cpu(), x_cpu)
        y_fast, launched = count_call(total, P.predict, pruned, x, precision="fast")
        require("12c predict 3x384 fast", launched, ["lstm_recurrence_fast"], times=L, tag="knobs")
        rel = rel_err(y_fast, y_exact)
        log(f"[check] 12c 3x384 fast vs exact: rel Frobenius {rel:.3e} (band {FAST_BAND['wide']:g})")
        if not rel <= FAST_BAND["wide"]:
            fail(f"12c 3x384: fast error {rel:.3e}")
        y_sil, launched = count_call(total, P.predict, silenced(m512, keep), x)
        require("12c predict 3x512 silenced", launched, ["lstm_recurrence"], times=L, tag="knobs")
        check_close("12c pruned 3x384 vs 3x512 with the dropped units silenced", y_exact, y_sil, SILENCED_TOL)
        y_red, launched = count_call(total, P.predict, red, x)
        require(f"12c predict 3x384 merged r={PRUNED_RANK} exact", launched, ["reduced_recurrence"], times=L,
                tag="knobs")
        check_vs_cpu_reference(f"12c 3x384 merged r={PRUNED_RANK}", y_red, copy.deepcopy(red).cpu(), x_cpu)
        y_redf, launched = count_call(total, P.predict, red, x, precision="fast")
        require(f"12c predict 3x384 merged r={PRUNED_RANK} fast", launched, ["reduced_recurrence_fast"],
                times=L, tag="knobs")
        log(f"[check] 12c 3x384 merged r={PRUNED_RANK} fast vs exact: rel Frobenius "
            f"{rel_err(y_redf, y_red):.3e} (reported, not gated: ROADMAP fault 3.1)")
        m30 = P.load_params(DENSE_30, device=dev)
        p20 = P.prune_to_width(m30, PRUNED_NARROW)
        y20, launched = count_call(total, P.predict, p20, x)
        require("12c predict 4x20 exact", launched, ["fused_dense_stack"], times=1, tag="knobs")
        check_vs_cpu_reference("12c 4x20", y20, copy.deepcopy(p20).cpu(), x_cpu)
        red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=PRUNED_RANK)
        for p in ("exact", "fast"):
            a = time_full_vs_reduced(pruned, red, x, precision=p)
            b = time_full_vs_reduced(m512, red512, x, precision=p)
            log(f"[ratio] 12c {p}, T={T}: 3x384 dense {a.full_ms:.3f} ms, merged r={PRUNED_RANK} "
                f"{a.reduced_ms:.3f} ms, ratio {a.ratio:.4f}; 3x512 dense {b.full_ms:.3f} ms, merged "
                f"r={PRUNED_RANK} {b.reduced_ms:.3f} ms, ratio {b.ratio:.4f}; pruned/unpruned dense "
                f"{a.full_ms / b.full_ms:.4f}, reduced {a.reduced_ms / b.reduced_ms:.4f}; {card_line()}")
        ms20, ms30 = (device_time_ms(P.predict, m, x) for m in (p20, m30))
        log(f"[ratio] 12c T={T} exact: 4x20 {ms20:.3f} ms, 4x30 {ms30:.3f} ms, ratio {ms20 / ms30:.4f}; "
            f"test RMSE 4x20 {P.rmse(P.predict(p20, torch.tensor(data.X_test[0], device=dev))[:, 0].cpu().numpy(), data.y_test):.6f}, "
            f"4x30 {P.rmse(P.predict(m30, torch.tensor(data.X_test[0], device=dev))[:, 0].cpu().numpy(), data.y_test):.6f}")
    run = TrainRun("12c 3x384 fit", lambda dev: P.prune_to_width(P.load_params(DENSE_512, device=dev), PRUNED_WIDE),
                   TRAIN_RUNS[2].cfg, TRAIN_RUNS[2].kernels)
    res, launched = count_call(total, P.fit, pruned, data.X_train, data.y_train, run.cfg)
    require(f"12c fit 3x384 (B={run.cfg.batch_size})", launched, [k.__name__ for k in run.kernels], tag="knobs")
    if not res.history or res.rollbacks or not np.all(np.isfinite(res.history)):
        fail("12c fit: non-finite loss")
    compare_run(run, dev, data, {run.name: res.history})


def merge_path(dev, x, total: dict) -> None:
    """12d: two seeded 1x256 stacks merged into one 1x512 layer, the
    merged head [w1; w2] with bias b1 and the second head's bias 0, so
    predict(merged) = predict(m1) + predict(m2) over T = 6656; with the
    same input and with the inputs concatenated (16 + 16). K3 first against
    its plain version on the merged, block-diagonal U."""
    x2 = torch.tensor(np.random.default_rng(13).normal(size=(T, D)), dtype=torch.float32, device=dev)
    for same_x in (True, False):
        m1, m2 = (P.init_stacked_lstm(torch.Generator().manual_seed(seed), input_dim=D, units=(MERGE_UNITS,),
                                      device=dev) for seed in (1, 2))
        with torch.no_grad():
            m2.head.b.zero_()
        layer = P.merge_parallel_cell_weights(m1.layers[0], m2.layers[0], same_x=same_x)
        head = P.DenseHead(torch.cat([m1.head.w, m2.head.w]).detach(), m1.head.b.detach().clone())
        merged = P.StackedLSTM([layer], head)
        xm = x if same_x else torch.cat([x, x2], dim=-1)
        name = f"12d merged 1x{2 * MERGE_UNITS} ({'same x' if same_x else 'x concatenated'})"
        zero = float((layer.U == 0).float().mean())
        with exact_matmul(), torch.no_grad():
            xp = (torch.matmul(xm, layer.W) + layer.b).contiguous()
            check_close(f"{name} K3 lstm_recurrence (U {zero:.3f} zero)", ck.lstm_recurrence(xp, layer.U),
                        ck.lstm_recurrence_plain(xp, layer.U), TOL)
            y, launched = count_call(total, P.predict, merged, xm)
            require(f"{name} predict", launched, ["lstm_recurrence"], times=1, tag="knobs")
            y1, launched = count_call(total, P.predict, m1, x)
            require("12d predict 1x256 (first)", launched, ["lstm_recurrence"], times=1, tag="knobs")
            y2, launched = count_call(total, P.predict, m2, x if same_x else x2)
            require("12d predict 1x256 (second)", launched, ["lstm_recurrence"], times=1, tag="knobs")
            check_close(f"{name} predict vs the two cells' sum, T={T}", y, y1 + y2, MERGE_TOL)
            log(f"[time] {name}: predict {device_time_ms(P.predict, merged, xm):.3f} ms, each 1x256 "
                f"{device_time_ms(P.predict, m1, x):.3f} ms; {card_line()}")


def sigma_prune_path(dev, x, data, total: dict) -> None:
    """12e: finetune_with_pruning of the split 4x30 singular model, the
    schedule 0 -> 0.5 over the run's steps, two epochs (K7 through the
    singular dense view); every σ tensor at least floor(0.5·size) zeros;
    the cutoff truncation drops at least those; predict exact (K1)."""
    smodel = P.make_singular_model(P.load_params(DENSE_30, device=dev), merged_kernel=False)
    cfg = dataclasses.replace(KNOB_CFG, epochs=2)
    steps = cfg.num_windows // cfg.batch_size
    sched = P.PolynomialDecaySchedule(0.0, SIGMA_SPARSITY, begin_step=0, end_step=cfg.epochs * steps)
    t0 = time.perf_counter()
    res, launched = count_call(total, P.finetune_with_pruning, smodel, data.X_train, data.y_train, sched,
                               steps_per_epoch=steps, factor_cfg=P.FactorConfig(hoyer=0.01), train_cfg=cfg)
    wall = time.perf_counter() - t0
    require("12e finetune_with_pruning", launched, ["fused_narrow_train_fwd", "fused_narrow_train_bwd"],
            tag="knobs")
    if len(res.history) != cfg.epochs or res.rollbacks or not np.all(np.isfinite(res.history)):
        fail(f"12e: history {res.history}, rollbacks {res.rollbacks}")
    tuned = res.params
    for i, l in enumerate(tuned.layers):
        for f in ("ws", "us"):
            v = getattr(l, f)
            zeros, need = int((v == 0).sum()), int(np.floor(SIGMA_SPARSITY * v.numel()))
            if zeros < need:
                fail(f"12e layers[{i}].{f}: {zeros} zeros, fewer than {need}")
    reduced = P.make_reduced_model(tuned, cutoff=0.05)
    for i, (l, r) in enumerate(zip(tuned.layers, reduced.layers)):
        for f, ranks in (("ws", r.ranks[0]), ("us", r.ranks[1])):
            nonzero = [max(1, int((g != 0).sum())) for g in getattr(l, f)]
            if any(k > nz for k, nz in zip(ranks, nonzero)):
                fail(f"12e layers[{i}].{f}: ranks {ranks} keep pruned σ (nonzero {nonzero})")
    log(f"[knobs] 12e finetune_with_pruning: history {res.history}, σ sparsity "
        f"{P.sigma_sparsity(tuned):.4f} (schedule end {SIGMA_SPARSITY}), {wall:.2f} s; cutoff 0.05 keeps "
        f"{weights(reduced)} of {weights(P.make_reduced_model(smodel, cutoff=0.05))} weights; ranks "
        f"{[r.ranks for r in reduced.layers]}")
    with exact_matmul(), torch.no_grad():
        y, launched = count_call(total, P.predict, reduced, x)
        require("12e predict (cutoff 0.05)", launched, ["fused_dense_stack"], times=1, tag="knobs")
        check_vs_cpu_reference("12e σ-pruned reduced", y, copy.deepcopy(reduced).cpu(), x[:REF_STEPS].cpu())


def knobs_path(dev, x, data) -> dict:
    """Phase 12: remat (12a), the dropout fine-tune (12b), unit pruning
    (12c), the merge (12d) and σ magnitude pruning (12e), every main-path
    call counted. Returns the launches of those calls."""
    t0 = time.perf_counter()
    total: dict = {}
    remat_path(dev, data, total)
    dropout_path(dev, data, total)
    prune_path(dev, x, data, total)
    merge_path(dev, x, total)
    sigma_prune_path(dev, x, data, total)
    log(f"[knobs] phase 12 kernel launches of its main-path calls: {total}; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    return total


# ---------------------------------------------------------------------------
# the workflow commands (phase 13)
# ---------------------------------------------------------------------------

WORKFLOW_TOL = 1e-5   # 13: a checkpoint's reload, and batched exact against each sequence alone


def counted_main(total: dict, name: str, module, argv: list, kernels=(), times: dict | None = None):
    """``module.main(argv)``, one command of phase 13, counted as in 11
    (``count_call``) with K5's count too; each wrapper in ``kernels`` must
    have launched (``times``: exactly so often). Returns main's result."""
    for k in cb.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out, launched = count_call(total, module.main, argv)
    for k in cb.KERNELS:
        if k.launches:
            launched[k.__name__] = k.launches
            total[k.__name__] = total.get(k.__name__, 0) + k.launches
    require(name, launched, kernels, tag="workflow")
    for k, n in (times or {}).items():
        if launched.get(k, 0) != n:
            fail(f"{name}: {k} launched {launched.get(k, 0)} times, not {n}")
    log(f"[workflow] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def hold_wide_ranks(dev, fast: bool) -> None:
    """13: before ``timing --wide [--fast]`` times them, K2 (K2f) on every
    layer of each of the command's reduced models (3x512 merged, the direct
    truncation at each rank of WIDE_RANKS, x its input) against its plain
    version: exact within TOL over the whole run, fast over 3c's windows
    (``check_windows``) with each window's limit and the median's raised to
    twice the plain version's own drift from float64 state where that is
    larger (§2's rule for K5, K1f, K3f: at r = 256 the plain float32 sums
    flip bf16 roundings of h·B, ~7e-4 to 1.3e-3 from float64, a quarter of
    the windows past 2 ulps); each rank's plan printed, and layer 0's
    kernel timed beside its bound."""
    from svd_lstm_tpu_torch.examples import timing_curves as tc

    _, xw, reduced = tc.models(tc.WIDE_UNITS, True, tc.WIDE_RANKS, T, dev)
    proj = lambda l, h: reduced_projection(l, h, "w")  # noqa: E731
    dp = "default" if fast else None
    for r, m in reduced.items():
        n = m.layers[0].units
        plan = ck.card_reduced_plan(dev, n, (r,), fast)
        label = f"timing --wide{' --fast' if fast else ''} r={r}"
        log(f"[info] K2{'f' if fast else ''} plan, {label}: {plan} (a CTA's weights {plan.weight_bytes} B)")
        if fast:
            runs = reduced_fast_windows(f"K2f reduced_recurrence_fast {label}", m, xw, drift_limit=True,
                                        median_drift=True)
            args = runs[0][0]
        else:
            for i, (l, xp, h) in enumerate(layer_runs(m, xw, proj, ck.reduced_recurrence_plain)):
                check_close(f"K2 reduced_recurrence {label} layer {i}",
                            ck.reduced_recurrence(xp, *recurrence_args(l)), h, TOL)
                if i == 0:
                    args = (xp, *recurrence_args(l))
        ms = device_time_ms(lambda: ck.reduced_recurrence(*args, dot_precision=dp))
        b = roofline.reduced_recurrence_step_cost(n, (r,), torch.bfloat16 if fast else torch.float32
                                                  ).call_bound(T)
        log(f"[time] K2{'f' if fast else ''} {label} layer 0: {ms:.3f} ms ({ms * 1e3 / T:.3f} us a step), "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) on {card_line()}")


def timing_commands(dev, total: dict) -> None:
    """13: the timing curves, narrow (K1) and wide exact (K3, K2) and fast
    (K3f, K2f), each launch count as the command's calls give it."""
    from svd_lstm_tpu_torch.examples import timing_curves as tc

    calls = lambda n: 1 + 3 + (n > 0)  # noqa: E731  a warm-up, 3 timed, the kept output
    narrow = len(tc.QUICK_NARROW_KS)
    counted_main(total, "timing --quick", tc, ["--quick", "--plots", ""],
                 ["fused_dense_stack"], {"fused_dense_stack": calls(0) + narrow * calls(1)})
    layers, ranks = len(tc.WIDE_UNITS), len(tc.WIDE_RANKS)
    for fast in (False, True):
        sfx = "_fast" if fast else ""
        with exact_matmul(), torch.no_grad():
            hold_wide_ranks(dev, fast)
        argv = ["--wide", "--plots", ""] + (["--fast"] if fast else [])
        curve = counted_main(total, "timing " + " ".join(argv[:1] + argv[3:]), tc, argv,
                             [f"lstm_recurrence{sfx}", f"reduced_recurrence{sfx}"],
                             {f"lstm_recurrence{sfx}": layers * calls(0),
                              f"reduced_recurrence{sfx}": layers * ranks * calls(1)})
        for r, y in zip(curve.ranks, curve.outputs):
            if tuple(y.shape) != (T, 1) or not bool(torch.isfinite(y).all()):
                fail(f"timing --wide r={r}: bad output {tuple(y.shape)}")
        log(f"[workflow] wide timing curve{' (fast)' if fast else ''} on {card_line()}: full "
            f"{curve.full_ms:.3f} ms; " + ", ".join(
                f"r={r} {ms:.3f} ms ratio {ms / curve.full_ms:.4f}"
                for r, ms in zip(curve.ranks, curve.reduced_ms)))


def workflow_path(dev) -> dict:
    """Phase 13: every workflow command of ``python -m svd_lstm_tpu_torch``
    run in-process through its ``main`` on the card, outputs in a temporary
    directory, no figures, an autotune cache of its own; each command's
    kernels counted (``counted_main``). Returns the launches."""
    from svd_lstm_tpu_torch.examples import (
        batched_inference,
        bench_native,
        frequency_prediction,
        rank_rmse_published,
        rank_sweep,
        sequentialize_train,
        svd_acceleration,
        train_full_model,
    )

    t0 = time.perf_counter()
    total: dict = {}
    k7 = ["fused_narrow_train_fwd", "fused_narrow_train_bwd"]
    sequential = os.path.join(SAVES, "pretrained_sequential.npz")
    cache = os.environ.get("XDG_CACHE_HOME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_") as tmp:
        os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
        try:
            timing_commands(dev, total)
            r = counted_main(total, "compress --quick --kernel", svd_acceleration,
                             ["--quick", "--kernel", "--ckpt", sequential, "--plots", ""],
                             k7 + ["fused_dense_stack"])
            log(f"[workflow] compress: weights {r['full_weights']} -> {r['reduced_weights']}, σ below the "
                f"cutoff {r['below']}, RMSE full {r['rmse_full']:.6f} m, reduced {r['rmse_reduced']:.6f} m, "
                f"ratio {r['reduced_ms'] / r['full_ms']:.4f}")
            r = counted_main(total, "train --quick --kernel", train_full_model,
                             ["--quick", "--kernel", "--out", tmp, "--plots", ""], k7)
            with exact_matmul(), torch.no_grad():
                xq = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32,
                                  device=dev)
                check_close("train --quick --kernel: the reloaded checkpoint's predict",
                            P.predict(P.load_params(r["checkpoint"], device=dev), xq),
                            P.predict(r["result"].params, xq), WORKFLOW_TOL)
            counted_main(total, "sweep --quick", rank_sweep,
                         ["--quick", "--ckpt", sequential, "--plots", ""], ["fused_dense_stack"])
            counted_main(total, "batched --wide --precision fast", batched_inference,
                         ["--wide", "--precision", "fast"], ["batched_lstm_recurrence"])
            r = counted_main(total, "batched --wide --precision exact --rank 24", batched_inference,
                             ["--wide", "--precision", "exact", "--rank", "24"])
            if not r["err"] <= WORKFLOW_TOL:
                fail(f"batched exact: the batch {r['err']:.3e} from each sequence alone")
            art = counted_main(total, "rank-rmse --quick", rank_rmse_published,
                               ["--quick", "--out", os.path.join(tmp, "rank_rmse.json"), "--plot", ""],
                               k7 + ["fused_dense_stack"],
                               {"fused_dense_stack": len(rank_rmse_published.KS)})
            if len(art["ratio"]) != 20 or not np.isfinite(art["ratio"]).all():
                fail(f"rank-rmse: bad ratios {art['ratio']}")
            r = counted_main(total, "freq --quick", frequency_prediction, ["--quick", "--plots", ""])
            if not np.isfinite(r["losses"]).all():
                fail("freq: non-finite losses")
            counted_main(total, "seq-train --quick", sequentialize_train, ["--quick", "--out", tmp])
            counted_main(total, "native-bench", bench_native, [])
        finally:
            if cache is None:
                os.environ.pop("XDG_CACHE_HOME", None)
            else:
                os.environ["XDG_CACHE_HOME"] = cache
    log(f"[workflow] phase 13 kernel launches of its commands: {total}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    return total


# ---------------------------------------------------------------------------
# the parallel slice (phase 14)
# ---------------------------------------------------------------------------

PP_CT = 512            # 14a: the pipeline's chunk
DP_STEP_RTOL = 1e-5    # 14a: the sharded step's loss against the dp step's (tests/test_parallel.py)
HIST_RTOL_ONE = 1e-6   # 14a: fit_dp at one rank against fit: the same arithmetic
DP2_HIST_RTOL = 1e-4   # 14b: two ranks against one (tests/test_parallel_fit.py)
DP2_PARAM_ATOL = 2e-4
ENTRY_TOL = 1e-4       # 14c: entry()'s forward on the card against the plain CPU forward


def count_batched(fn, *args):
    """``fn(*args)`` with K5's count read around it. Returns (its result,
    the launches)."""
    before = cb.batched_lstm_recurrence.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return out, cb.batched_lstm_recurrence.launches - before


def check_carried_c(dev, x) -> None:
    """14a, before the pipeline: K3 (3x512 layer 0) and K2 (layer 0 of
    wide_r24_progressive) over the pipeline's first two chunks, the second
    from the (h, c) the first stored (``return_c``): h within TOL of the
    plain version's whole run, the stored c within check_state's limit of
    the plain version's."""
    for name, model, kernel, plain in (
            ("K3 lstm_recurrence 3x512", P.load_params(DENSE_512, device=dev), ck.lstm_recurrence,
             ck.lstm_recurrence_plain),
            ("K2 reduced_recurrence wide_r24_progressive", P.load_params(WIDE_R24, device=dev),
             ck.reduced_recurrence, ck.reduced_recurrence_plain)):
        l = model.layers[0]
        args = recurrence_args(l)
        xp = ((torch.matmul(x[: 2 * PP_CT], l.W) if isinstance(l, P.LSTMLayer)
               else reduced_projection(l, x[: 2 * PP_CT], "w")) + l.b).contiguous()
        h1, c1 = kernel(xp[:PP_CT], *args, return_c=True)
        h2, c2 = kernel(xp[PP_CT:], *args, h1[-1], c1, return_c=True)
        want_h, want_c = plain(xp, *args, return_c=True)
        _, c_half = plain(xp[:PP_CT], *args, return_c=True)
        _, c_half64 = plain(xp[:PP_CT].double(), *double(args), return_c=True)
        check_close(f"14a {name} layer 0, two chunks from the stored (h, c)", torch.cat([h1, h2]), want_h, TOL)
        check_state(f"14a {name} layer 0, the stored c after chunk 0", c1, c_half, c_half64)
        check_state(f"14a {name} layer 0, the stored c after chunk 1", c2, want_c,
                    plain(xp.double(), *double(args), return_c=True)[1])


def warm_step_ms(fit_call, cfg: P.TrainConfig) -> float:
    """ms a step of a warm ``fit_call()`` (host clock to a synchronize, the
    run's every step, its model's copy and the epoch loop included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (cfg.epochs * (cfg.num_windows // cfg.batch_size))


def world_one_path(dev, data, total: dict) -> list:
    """14a: every parallel entry point at world size 1 under NCCL on the
    card, each against the single-device path it shards. Returns run A's
    fit_dp history and parameters (14b's reference)."""
    from svd_lstm_tpu_torch import parallel as par

    A, B, C = TRAIN_RUNS[:3]
    E = RECOVERY_RUNS[0]
    X, y = data.X_train, data.y_train
    with par.process_group("nccl"):
        mesh = par.make_mesh(device=dev)
        log(f"[parallel] 14a mesh: {mesh.dp}x{mesh.tp}, {mesh.backend}, {mesh.device}")
        for run, dp_fn, one_fn, kernels in (
                (C, lambda m: par.fit_dp(m, X, y, mesh, cfg=C.cfg),
                 lambda m: P.fit(m, X, y, C.cfg), ["wide_layer_fwd", "wide_layer_bwd"]),
                (B, lambda m: par.finetune_dp(m, X, y, mesh, factor_cfg=B.factor_cfg, train_cfg=B.cfg),
                 lambda m: P.finetune(m, X, y, B.factor_cfg, B.cfg), ["fused_narrow_train_fwd"]),
                (E, lambda m: par.finetune_reduced_dp(m, X, y, mesh, train_cfg=E.cfg),
                 lambda m: P.finetune_reduced(m, X, y, E.cfg), ["fused_narrow_train_compact_fwd"])):
            t0 = time.perf_counter()
            got, launched = count_call(total, dp_fn, run.make(dev))
            dp_s = time.perf_counter() - t0
            require(f"14a {run.name} through the dp loop", launched, kernels, tag="parallel")
            t0 = time.perf_counter()
            want = one_fn(run.make(dev))
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            err = float(np.max(np.abs(np.asarray(got.history) / np.asarray(want.history) - 1)))
            log(f"[parallel] 14a {run.name}: fit_dp-family history {got.history} against "
                f"{want.history} (max rel diff {err:.3e}); {dp_s:.2f} s against {one_s:.2f} s "
                f"(host clock, first calls) on {card_line()}")
            if not err <= HIST_RTOL_ONE:
                fail(f"14a {run.name}: the one-rank dp history {err:.3e} from the single-device one")
        ref, launched = count_call(total, lambda: par.fit_dp(A.make(dev), X, y, mesh, cfg=A.cfg))
        require("14a A 4x40 fit through fit_dp (14b's reference)", launched, ["fused_narrow_train_fwd"],
                tag="parallel")
        ref.step_ms = warm_step_ms(lambda: par.fit_dp(A.make(dev), X, y, mesh, cfg=A.cfg), A.cfg)

        x, yb = first_batch(C, data, dev)
        local = par.shard_params_for_mesh(C.make(dev), mesh)
        sharded = par.make_sharded_train_step(mesh, torch.optim.Adam(local.parameters(), lr=1e-3))
        plain = C.make(dev)
        dp_step = par.make_dp_train_step(mesh, torch.optim.Adam(plain.parameters(), lr=1e-3),
                                         P.stacked_lstm_apply)
        loss_s, loss_d = sharded(local, x, yb), dp_step(plain, x, yb)
        log(f"[parallel] 14a sharded step 3x512 (B=128, T=200): loss {loss_s:.8f}, dp step {loss_d:.8f}")
        if not abs(loss_s - loss_d) <= DP_STEP_RTOL * abs(loss_d):
            fail(f"14a sharded step loss {loss_s} against the dp step's {loss_d}")

        with exact_matmul(), torch.no_grad():
            dense = P.load_params(DENSE_512, device=dev)
            xb = torch.tensor(np.random.default_rng(0).normal(size=(256, 128, D)), dtype=torch.float32,
                              device=dev)
            got, k5 = count_batched(par.make_batched_fast_inference(mesh), dense, xb)
            total["batched_lstm_recurrence"] = total.get("batched_lstm_recurrence", 0) + k5
            if k5 != len(dense.layers):
                fail(f"14a batched fast inference launched K5 {k5} times, not {len(dense.layers)}")
            check_close("14a make_batched_fast_inference 3x512 (B=256, T=128) against predict(fast)", got,
                        P.predict(dense, xb, precision="fast"), 1e-6)

            xl = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
            check_carried_c(dev, xl)
            pp = par.make_pipeline_inference(mesh, ct=PP_CT)
            for name, path, kernel in (("3x512 dense", DENSE_512, "lstm_recurrence"),
                                       ("wide_r24_progressive", WIDE_R24, "reduced_recurrence")):
                model = P.load_params(path, device=dev)
                got, launched = count_call(total, pp, model, xl[None])
                chunks = -(-T // PP_CT)
                require(f"14a pipeline {name}", launched, [kernel], times=len(model.layers) * chunks,
                        tag="parallel")
                want = P.predict(model, xl)
                check_close(f"14a make_pipeline_inference(ct={PP_CT}) {name} T={T} against predict", got[0],
                            want, TOL)
                pp_ms = device_time_ms(lambda: pp(model, xl[None]))
                pr_ms = device_time_ms(lambda: P.predict(model, xl))
                log(f"[time] 14a pipeline {name} (1 stage, {chunks} chunks of {PP_CT}): {pp_ms:.3f} ms, "
                    f"predict {pr_ms:.3f} ms, ratio {pp_ms / pr_ms:.4f} on {card_line()}")
    return ref


def _dp_rank(dev, name: str) -> dict:
    """14b: one of two gloo ranks on the card, run ``name`` of TRAIN_RUNS
    through fit_dp; its history, parameters and train-kernel launches."""
    from svd_lstm_tpu_torch import parallel as par

    run = next(r for r in TRAIN_RUNS if r.name == name)
    data = train_data()
    mesh = par.make_mesh(device=dev)
    ck.reset_launch_counts()
    ct.reset_launch_counts()
    t0 = time.perf_counter()
    res = par.fit_dp(run.make(dev), data.X_train, data.y_train, mesh, cfg=run.cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in ct.LAUNCHES.items() if v}
    step_ms = warm_step_ms(lambda: par.fit_dp(run.make(dev), data.X_train, data.y_train, mesh, cfg=run.cfg),
                           run.cfg)
    return {"history": res.history, "params": [p.detach().cpu() for p in res.params.parameters()],
            "launches": launches, "s": first_s, "step_ms": step_ms, "device": str(dev)}


def two_rank_path(ref, total: dict) -> None:
    """14b: run A's fit_dp on two gloo ranks on cuda:0 (the batch of 32 split
    16 + 16, the gradients averaged through all_reduce on the card) against
    its one-rank run (14a): histories within rtol 1e-4, parameters within
    atol 2e-4."""
    from svd_lstm_tpu_torch import parallel as par

    A = TRAIN_RUNS[0]
    t0 = time.perf_counter()
    r0, r1 = par.launch(_dp_rank, 2, "gloo", "cuda", A.name)
    log(f"[parallel] 14b two gloo ranks on {r0['device']} and {r1['device']}: {time.perf_counter() - t0:.1f} s "
        f"with the spawn, the first fit_dp {r0['s']:.2f} s (host clock) on {card_line()}")
    log(f"[time] 14b {A.name} warm fit_dp, ms a step (host clock, B = {A.cfg.batch_size}): two ranks on the "
        f"one card {r0['step_ms']:.3f} and {r1['step_ms']:.3f}, one rank {ref.step_ms:.3f}, ratio "
        f"{max(r0['step_ms'], r1['step_ms']) / ref.step_ms:.3f} on {card_line()}")
    for r in (r0, r1):
        require(f"14b {A.name} on one of two ranks", r["launches"], ["fused_narrow_train_fwd",
                                                                      "fused_narrow_train_bwd"], tag="parallel")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    if r0["history"] != r1["history"]:
        fail(f"14b the ranks disagree: {r0['history']} against {r1['history']}")
    err = float(np.max(np.abs(np.asarray(r0["history"]) / np.asarray(ref.history) - 1)))
    perr = max(max_err(a, b.detach().cpu()) for a, b in zip(r0["params"], ref.params.parameters()))
    log(f"[parallel] 14b {A.name}: history {r0['history']} against one rank's {ref.history} (max rel diff "
        f"{err:.3e}), parameters max abs diff {perr:.3e}")
    if not (err <= DP2_HIST_RTOL and perr <= DP2_PARAM_ATOL):
        fail(f"14b two ranks against one: history {err:.3e} (rtol {DP2_HIST_RTOL}), parameters {perr:.3e} "
             f"(atol {DP2_PARAM_ATOL})")


def parallel_commands(dev, total: dict) -> None:
    """14c: ``distributed --quick`` (one rank, NCCL) and the three examples'
    ``main`` with the JAX scripts' ``--quick`` cuts (wide_rank_accuracy on
    the committed 3x512 checkpoint, the recovery cut to 0 epochs), then
    ``entry()``'s forward on the card against the plain CPU forward."""
    from svd_lstm_tpu_torch.entry import entry
    from svd_lstm_tpu_torch.examples import (
        conv_compression,
        distributed_training,
        realtime_stream,
        wide_rank_accuracy,
    )

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        r = counted_main(total, "distributed --quick", distributed_training, ["--quick"], ["reduced_recurrence"])
        log(f"[parallel] distributed --quick: pp over {r['stages']} stage(s), T={r['T']}, max|pp - direct| "
            f"{r['pp_err']:.3e}")
        art = counted_main(total, "wide_rank_accuracy (3x512, --recover-epochs 0)", wide_rank_accuracy,
                           ["--ckpt", DENSE_512, "--recover-epochs", "0", "--out",
                            os.path.join(tmp, "wide.json"), "--plot", ""],
                           ["lstm_recurrence", "reduced_recurrence"])
        log(f"[parallel] wide_rank_accuracy on {card_line()}: full {art['full_ms']:.3f} ms, " + ", ".join(
            f"r={row['rank']} RMSE x{row['rmse_ratio']:.4f} (fast x{row['rmse_fast_ratio']:.4f}) time "
            f"x{row['timing_ratio']:.4f}" for row in art["rows"]))
        r = counted_main(total, "conv_compression --quick", conv_compression, ["--quick", "--out", tmp],
                         ["fused_dense_stack"])
        log(f"[parallel] conv_compression: RMSE dense {r['rmse_dense_mm']:.3f} mm, reduced "
            f"{r['rmse_reduced_mm']:.3f} mm, native {r['native_err']:.2e}")
        r = counted_main(total, "realtime_stream --quick", realtime_stream, ["--quick"])
        log(f"[parallel] realtime_stream: graph step {r['stream_us']:.1f} us/frame (host clock), err "
            f"{r['stream_err']:.2e}; native {r['native_us']:.1f} us/frame, err {r['native_err']:.2e}")
    forward, (model, x) = entry(device=dev)
    cpu_forward, (cpu_model, cpu_x) = entry(device="cpu")
    with exact_matmul(), torch.no_grad():
        check_close("14c entry()'s forward on the card against the plain CPU forward", forward(model, x).cpu(),
                    cpu_forward(cpu_model, cpu_x), ENTRY_TOL)


def parallel_path(dev, data) -> dict:
    """Phase 14: the parallel entry points at world size 1 (14a), fit_dp on
    two ranks of the one card (14b), the distributed command, the three
    examples and entry() (14c). Returns the launches of its main-path
    calls."""
    t0 = time.perf_counter()
    total: dict = {}
    ref = world_one_path(dev, data, total)
    two_rank_path(ref, total)
    cache = os.environ.get("XDG_CACHE_HOME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_cache_") as tmp:
        os.environ["XDG_CACHE_HOME"] = tmp
        try:
            parallel_commands(dev, total)
        finally:
            if cache is None:
                os.environ.pop("XDG_CACHE_HOME", None)
            else:
                os.environ["XDG_CACHE_HOME"] = cache
    log(f"[parallel] phase 14 kernel launches of its main-path calls: {total}; phase 14 took "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs only "
              "on a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--time-tree"]:
        print(json.dumps(tree_times(torch.device("cuda", 0))))
        return 0
    if args and (args[0] != "--parent" or len(args) != 2 or not os.path.isdir(args[1])):
        print(f"usage: {sys.argv[0]} [--parent DIR]", file=sys.stderr)
        return 2
    # the smoke's own autotune cache, empty, before any predict: no winner
    # stored on the machine redirects a phase, and 9a's winners go nowhere else
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache:
        os.environ["XDG_CACHE_HOME"] = cache
        return smoke(args)


def wall_clock():
    """``lap(name)`` logs the seconds since the last lap (or since this
    call) and since this call, so a run's wall time splits by phase."""
    t0 = last = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"[wall] phase {name}: {now - last:.1f} s, {now - t0:.1f} s since the build began")
        last = now

    return lap


def smoke(args) -> int:
    """Phases 1-14 (see the module docstring)."""
    log(card_line())  # the card's name and power limit, as nvidia-smi prints them
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    lap = wall_clock()
    build_kernels()
    lap("2 build")

    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    with exact_matmul(), torch.no_grad():
        checks = kernel_checks(dev, x)
        checks.update(batched_kernel_checks(dev))
        checks.update(fast_kernel_checks(dev, x))
        lap("3-3c kernel checks")
        launches, ratios = main_path(dev, x)
        launches.update(batched_path(dev))
        fast_launches, fast_ratios = fast_path(dev, x)
        launches.update(fast_launches)
        lap("4-4c batch-1 and batched predict")
    log(f"[ratio] reduced / full batch-1 predict on {card_line()}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in {**ratios, **fast_ratios}.items()))

    data = train_data()
    with exact_matmul():
        checks.update(train_kernel_checks(dev, data))
    lap("5-5c train kernel checks")
    if args:
        tree_turns(args[1])
        lap("5c parent in turns")
    train_launches, histories = train_path(dev, data)
    recovery_launches = recovery_path(dev, data)
    # a train kernel's launches: phase 6's runs A-D and E-F, each counted from zero
    launches.update({k: train_launches[k] + recovery_launches[k] for k in train_launches})
    train_comparisons(dev, data, histories)
    lap("6-7 training and recovery")
    with exact_matmul(), torch.no_grad():
        deployment_path(dev, x)
        lap("8 deployment")
        evaluation_path(dev, x, data)
        lap("9 evaluation")
    precision_checks, precision_launches = precision_path(dev, data)
    checks.update(precision_checks)
    # the bf16 variants' launches: 10b-10c's main-path calls' (the float32 kernels' are phase 6's)
    launches.update({k: v for k, v in precision_launches.items() if k.endswith("_fast")})
    lap("10 training precision")
    # and phase 11's main-path calls on the conv hybrids, and phase 12's
    for name, phase in (("11 conv hybrids", conv_path), ("12 knobs and surgery", knobs_path)):
        for k, v in phase(dev, x, data).items():
            launches[k] = launches.get(k, 0) + v
        lap(name)
    for k, v in workflow_path(dev).items():
        launches[k] = launches.get(k, 0) + v
    lap("13 workflow commands")
    for k, v in parallel_path(dev, data).items():
        launches[k] = launches.get(k, 0) + v
    lap("14 parallel")

    print(json.dumps({"kernels": kernel_entries(checks, launches)}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def kernel_entries(checks: dict, launches: dict) -> list:
    """One entry of the ``kernels`` line per kernel wrapper."""
    return [
        {
            "name": name,
            "route": "cuda",
            "source": getattr(module, "SOURCES", {}).get(name, module.SOURCE),
            "replaces": module.REPLACES[name],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": checks[name]["ms"],
            "plain_ms": checks[name]["plain_ms"],
            "bound_ms": checks[name]["bound_ms"],
            "bound_by": checks[name]["bound_by"],
            "library_ms": checks[name]["library_ms"],
        }
        for module in (ck, cb, ct)
        for name in module.REPLACES
    ]


if __name__ == "__main__":
    sys.exit(main())
