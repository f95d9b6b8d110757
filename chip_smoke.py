#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (generative_models_tpu_torch) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each timed ([time] lines, and phase_sec in the summary); any
failure exits non-zero before the result lines:
  1. device  -- require CUDA (no fallback); print nvidia-smi's name and
                power limit.
  2. build   -- compile ops/csrc/*.cu (one nvcc per source, in parallel)
                and print the build seconds and ptxas's registers and
                spills of every entry function (Kernels C, E, D, K, L and
                M's by D bucket, H's and I's by their VEC flag, A's and
                B's by VEC flag and LN width and F's by VEC flag also in
                the kernels line; fails where C, E or D
                spill at D=32 or H, I, A, B, K, L, M or F spills).
  3. kernels -- hold each kernel against its plain PyTorch version on the
                card at the main paths' shapes (pixel_transformer's,
                vqvae's and made's at hidden_size=2048), with seeded inputs
                and a stated tolerance; A (the decode step's LN + product)
                at its four path shapes and eleven ragged ones (B 1-70, N 7
                and 96, C 100-4096, x at an odd offset), launched twice and
                bitwise equal; Kernel F (the VQ search, 3xTF32 on the tensor
                cores) at its three shapes, launched twice and bitwise
                equal, its indices identical but for ties within rounding,
                then untimed at N 1-3137, K 1-4096, D 7-256, z at an odd
                offset and two NaN cases (indices exactly the plain
                version's); Kernel H exactly 0
                off its mask, and Kernel I (int8 x int8 -> int32) bitwise
                equal; I and J (the dequantizing product) at every product
                of the quantized serving paths (rnn's wh is the vqvae
                prior's fc1 shape; wavenet's res1x1, (64,320)->320, with L2
                flushed too) and at four ragged shapes, I
                also at K=100000; G at six ragged ones (both layouts), H at
                five (K 1 to 200, an x at an odd offset); B (the decode
                step's second half) at both path widths, three ragged row
                counts and three ragged widths (both load routes); B, G, H,
                I and J launched twice and bitwise equal; C (the flash
                forward) and E and D (the
                backward) at the three attention shapes and nine edge
                cases of their tiling, each launched twice and bitwise
                equal;
                the ring's hop Kernels K, L and M on rings of 2, 4 and 8 at
                their first hop and at a carry hop (each launched twice and
                bitwise equal, then untimed at D 8-128, t_valid 75 and one
                rank's launch of a ring of 4), and the whole ring at 4 and 8
                against Kernels C, E and D on the full sequence.
                Time kernel, plain version and, where one PyTorch call
                computes the same function, that call, as device time
                (torch.profiler's CUDA trace) and as eager back-to-back time
                (CUDA events, host issue included).
  4. slice   -- pixel_transformer's serving path through its entry points:
                load_server at its default width, requests at serve_bs=64
                (warm, n=25, n=64 seed=7 twice, an HTTP /sample and
                /healthz), then a batch scored through the full forward.
                Every launch count is reset just before each path and read
                just after, and must equal what the path implies. Then the
                sampled tokens are teacher-forced through the kernel decode
                chain (must redraw the same tokens), the plain decode chain
                and the full forward, and a CPU f32 forward checks the card.
  5. train   -- pixel_transformer's training path: main.main at the
                default width, bs=64, on the synthetic set cut to 640/128
                images (10 steps, 2 eval batches), one epoch with a save
                each epoch. Exact launch counts of every kernel; the
                artifacts; finite metrics; eval/nlogp falling.
  6. grads   -- one batch's gradients on the card, from the trained
                model.pt, for every parameter: finite, non-zero, and within
                a bf16 tolerance of the same batch's gradients from a CPU
                f32 copy.
  7. seq_train -- phase 5 under --mesh=seq:4: attention through a ring of 4
                on the card, K 112, L and M 80 launches and no other kernel
                (sampling takes the per-op chain).
  8. seq_grads -- phase 6 for the seq_train model, the card's ring against
                an unsharded CPU f32 copy.
  9. vq_serve -- vqvae's serving path at its default width (warm, n=25,
                seed=7 twice) with exact launch counts; the seed=7 codes
                redrawn through the kernel decode chain, against the full
                prior forward and a CPU f32 prior and decoder.
  10. vq_train -- vqvae's training path through main.main, as phase 5:
                exact launch counts, artifacts, finite metrics, the test
                recon_loss falling, the perplexity in [1, vqK].
  11. vq_grads -- phase 6 for vqvae, every AE and prior parameter, and the
                count of codes the card and the CPU copy assign apart
                (reported in the vqvae_train summary).
  12. made_serve -- made's serving path at hidden_size=2048, the width at
                which it takes the kernel route (warm, n=25, seed=7 twice):
                Kernel G 784 * 4 launches a pass and nothing else; the
                kernel route's causality, bitwise, on a random canvas; its
                logits against a CPU f32 copy.
  13. made_default -- one made pass at the default hidden_size=1024: the
                premasked route, no kernel launched.
  14. made_train -- made's training path through main.main at 2048, as
                phase 5: G 6358 and H 40 launches, artifacts, finite
                metrics, eval/nlogp falling.
  15. made_grads -- phase 6 for made, against a CPU copy on the
                fold-the-mask route; dW exactly 0 off the mask on both.
  16. quant_serve -- --quantize serving of each model at its default width
                (pixel_transformer, vqvae, made at hidden_size=1024, rnn at
                256, wavenet at 320), w8a8 and w8a16, through load_server
                (seed=7 once, no warm pass): Kernel I (w8a8) or J (w8a16) once a
                quantized Linear or masked layer a step (rnn's wh: 784 a
                pass; wavenet's nine res1x1: 7056), nothing else; the /healthz fields; the
                request redrawn through the quantized chain; the card's
                int8 table bitwise equal to a CPU copy's; teacher-forced
                quantized logits against a CPU f32 copy of the unquantized
                chain (relative error < 0.05), against the card's
                unquantized chain (reported), that chain against the CPU f32
                one (reported), and against a CPU copy of the same quantized
                chain; made's causality under w8a16, bitwise, and under
                w8a8 the logits that move (one absmax scale a row sees
                every unit).
  17. diff_serve -- diffusion_model's class-conditional serving path at
                its default configuration (hidden_size=128, timesteps=250,
                v, ddim, bf16; every ResBlock's zero-init output conv drawn
                from seed 0) through load_server at serve_bs=64: warm, then
                guided 250-step DDIM requests with labels (64 mixed with -1,
                seed=7 twice and bitwise equal; 25 with y=3; 16 with y=3
                over HTTP), bad labels refused, one request at
                --fused_cfg=1 and one at --sampler=dpm2m --sample_steps=25;
                no kernel of ops/ launched; then at batch 4 the card's
                forward and a 10-step guided chain against a CPU f32 copy,
                and fused against two-call guidance on the card, each within
                its stated bound.
  18. diff_train -- diffusion_model's training path through main.main at
                bs=64 (10 steps, --ema=0.999, --eval_heavy=0): no kernel of
                ops/, finite losses, the grid's event file and the three
                chain GIFs of each epoch, the EMA copy in model.pt; then the
                model restored from it, Adam's step counters on the card
                (the capturable form), takes one step.
  19. diff_grads -- one train step's gradients on the card, bf16 and from an
                f32 copy, against a CPU f32 copy from the same draws; one
                Adam step from the same gradients and state; each conv
                shape of the UNet in bf16 against f32 arithmetic on its
                bf16 operands (forward, dgrad, wgrad, bias gradient).
  20. (diff_distill: its checks run on the chain phase's students, 23b:
                each, its frozen teacher and its EMA at step 0 equal to its
                teacher, the teacher frozen.)
  21. arb_load -- the shipped arbiters (weights/autoencoder.pt,
                weights/classifier.pt) decoded by the port's msgpack reader
                and loaded on the card; their features and logits of 64
                synthetic images at 28x28 and 32x32 against a CPU f32 copy.
  22. (arb_train: its checks run on the chain phase's arbiters, 23b:
                trained through main.main, model.jit.pt read on the card.)
  23. eval_heavy -- diffusion_model at its defaults (--eval_heavy=1,
                --class_cond=1) through main's load_model_and_data and
                train, --epochs=0, the shipped arbiters, dpm2m at 25 steps
                for eval_heavy's samples and 512 test images (all 8 rounds,
                512 samples a side): every eval/* value finite, the FIDs
                against a float64 scipy recomputation from the phase's own
                features, the seconds split into sampling, arbiter forwards
                and metrics; no kernel of ops/.
  23b. chain -- the orchestration scripts (generative_models_tpu_torch/
                scripts/) at diffusion's defaults, as chip_smoke.py
                --only=chain,graphs, a process started before resume and
                joined after train_flags (the run's order below is that of
                the joins; graphs, below, runs after chain in it):
                train_arbiters (EPOCHS=1; each model.jit.pt installed under
                the phase's WEIGHTS_DIR, read back on the card within
                ARB_REL of a CPU copy), progressive_distillation
                (EPOCHS_TEACHER=EPOCHS_STUDENT=1, --eval_heavy=0, --ema:
                ten stages at timesteps 256, 256, 128, ..., 1, 3 steps
                each, finite losses, each student and its EMA at step 0
                equal to its teacher and the frozen teacher bitwise
                unchanged), eval_distill_chain with those arbiters (every
                stage's eval/* finite; 128 test images, one batch),
                collect_distill and distill_latency
                (--reps=2: the 64-image latency from the 256-step teacher to
                the 1-step student); the shipped weights/*.pt unchanged; no
                kernel of ops/.
  24. vae    -- vae at its default width through main.main (one epoch, 10
                steps at bs=64), 64 samples served through load_server, one
                step's gradients against a CPU f32 copy, a profiled train
                step and request; no kernel of ops/.
  25. gan    -- the same for gan (the twin step's gradients, and both nets'
                batch statistics after it, against a float64 CPU copy, the
                CPU f32 copy's error and a float64 twin step on the card
                logged beside; samples served in [0, 1]).
  26-29. rnn, wavenet, pixel_cnn, gated_pixel_cnn -- each at its default
                width (rnn hidden 256; wavenet hidden 320, bf16 on the card;
                pixel_cnn 128 filters, gated_pixel_cnn 96, 5 layers, 7x7)
                through main.main (one epoch, 10 steps at bs=64): finite
                metrics, model.pt, hps.yaml, the event file and a sampling
                GIF each epoch; 64 samples served through load_server
                (warm, seed=7 twice equal, 25 unseeded), in {0, 1}; from the
                model.pt, the full forward's logits of 8 test images and
                one step's gradients against a CPU copy (wavenet's against
                the port's CPU bf16 net, CPU f32 logged beside; the pixel
                CNNs' against a float64 copy, the CPU f32 copy's error
                logged beside); a profiled
                train step and a request's launches; every ops/ counter 0.
  30. profile -- device time by kernel over one request (CUDA activity
                alone for whole requests) and one train step
                of each model, one pixel_transformer scoring forward, one
                seq:4 train step, one quantized request of vqvae and of made
                in each mode, 8 decode steps of a quantized
                pixel_transformer, rnn and wavenet request in each mode,
                one guided DDIM
                step of a diffusion request, a whole dpm2m request and one
                diffusion train step; the device-to-host copies of one
                vqvae and one diffusion train step, counted, each with the
                op and the Python lines that issued it (both models'
                optimizers restored from model.pt: none may come from
                Adam.step).
  31. diff_quant -- diffusion_model's --quantize from diff_train's
                model.pt: a UNet forward quantized on the card (w8a8 and
                w8a16) against a CPU f32 unquantized one, on the trained
                weights and with every ResBlock's output conv drawn; a
                guided dpm2m-25 request through load_server in each mode, I
                or J exactly 750 launches a request, profiled.
  32. gan_sn -- phase 25 with --spectral_norm=1 (each SpectralNorm's u and
                sigma held with the batch statistics).
  33. resume -- --resume=1 through main.main, made at 2048: a run cut
                after one epoch and resumed, bitwise the uninterrupted run;
                the first resumed step makes no device-to-host copy.
  34. jax_ckpt -- made at 2048 and pixel_transformer written on the card
                as the JAX package's TrainState (flax msgpack, the port's
                writer) and read back: bitwise, on the card, Adam's counters
                on the card (capturable), no device-to-host copy in the
                first step.
  35. stream -- --stream_data=1 at --stream_chunk 1 and 16 for made at 2048
                and diffusion: the on-device run's params, the epochs' walls.
  36. cli_profile -- --profile=1 through main.main (made at 2048): a Chrome
                trace under logdir/profile/ naming Kernels G and H.
  37. parity -- the twelve reference loss curves (reference_cpu_baseline
                .json) trained on the card and held to the JAX package's
                parity contract (data/parity.py).
  38. export -- every model's deployment artifact (serve.py --export) at
                its serve phase's width, pixel_transformer and rnn also in
                w8a8 and w8a16, diffusion guided DDIM 250 and dpm2m-25:
                the artifact's seed=7 batch bitwise the live server's, each
                kernel's launches the live request's (A and B, G, I, J > 0
                where the model runs them), one synchronizing call a
                request (the batch's copy; traced as one device-to-host
                copy for vqvae, made, vae and gan); export, load and
                request seconds, the bytes; the pixel_transformer
                artifact's request profiled beside the live one's (CUDA
                activity); vae's artifact through a --from_export CLI
                subprocess; the gmt:: ops' dispatch cost against their CUDA
                implementations.
  39. moe  -- pixel_transformer --moe_experts=8 at its default width: 10
                train steps at bs=64 through main.main (C 28, E and D 20
                launches, no A or B: the MoE decode is the module-by-module
                chain), eval/nlogp falling and moe_aux finite; served at
                serve_bs=64 (warm, seed=7 twice equal, its batch scored: C
                2); w8a8 and w8a16 (I or J 8 a decode step, 6272 a request,
                nothing else); an export artifact (traced by a process of its
                own while this one serves) whose seed=7 batch is bitwise the
                live one's; one step's gradients against a CPU f32 copy; a
                profiled train step, a request's launches and device time
                (CUDA activity alone) and 8 decode steps profiled.
  40. mesh -- one torchrun --nproc_per_node=1 subprocess running main's
                load and train with --mesh=data:1,model:1, with --fsdp=1
                and without (the process group's code path: NCCL, FSDP2 or
                the data axis's all-reduce, the model axis's collectives at
                size 1) for pixel_transformer, diffusion_model (dpm2m-25
                sampling) and gan at their default widths, one epoch of 3
                steps at bs=64 each, against the same runs with no group in
                this process, twice: the backend NCCL, every kernel's
                launches equal, model.pt's distance from the first no-group
                run's over that run's update within MESH_BOUND (bitwise for
                pixel_transformer) and the metrics within
                MESH_METRIC_BOUND, the second no-group run included; the
                --fsdp=1 run's and the first no-group run's median wall of 5
                more steps and one more step profiled. Then the pipe and
                expert axes: pixel_transformer at pipe:1 in this process
                (C, E and D four times the no-pipe run's launches, M = 4
                microbatches; no A or B; model.pt within PIPE_BOUND of the
                no-pipe run's, the key biases held apart; its seed=7 batch
                bitwise the --fused_decode=0 one-process server's) and in
                the group at data:1,pipe:1,model:1 with --fsdp=1, and
                --moe_experts=8 at expert:1 in this process and in the
                group, each group run held as above; and servers in the
                group at data:1,model:1 (pixel_transformer plain and w8a16,
                diffusion dpm2m-25; serve_bs=64, seed=7) against the
                one-process servers of the same model.pt: the batch bitwise
                (diffusion within DIFF_CHAIN_REL), every kernel's launches
                equal.
  41. train_flags -- --remat=1 against --remat=0 (pixel_transformer and
                diffusion, 3 steps: bitwise, else within REMAT_BOUND of the
                update; C recomputed L x 3 times more); made at 2048 with
                --grad_clip, --grad_accum=2, the warmup-cosine schedule and
                --keep_best=eval/nlogp over 2 epochs: the weights unchanged
                by each window's first micro-step and by the lr-0 first
                update, the schedule's lr, the clip biting (each norm
                above the clip, after it the clip within CLIP_RTOL),
                best.json the
                least eval/nlogp, the card within MADE_FLAGS_BOUND of a CPU
                run of the same command.
  42. graphs -- --jit_epoch=1 and --decode_unroll as CUDA graphs
                (utils/graphs.py), after chain in its process: every
                registry name at its default width, bs=64, and diffusion
                with --ema and --dropout, a distilled student (step2), made
                at 2048 with --grad_accum=2, warmup-cosine and --grad_clip,
                pixel_transformer at --mesh=seq:4, --moe_experts=8 and
                --remat=1, gan --spectral_norm=1: an epoch (the warm-up
                step, the capture, replays) graphed and per-step from the
                same init, batches and CUDA seed, bitwise (params, buffers,
                every Adam state, counters, metric floats, both
                generators) with every kernel counter equal, then a step
                of each timed and traced; a resumed graphed diffusion run
                bitwise the uninterrupted one; pixel_transformer's request
                at serve_bs=64 at --decode_unroll 1 and 8 bitwise the
                per-step loop's, A and B counts equal, again after a train
                step has moved the weights, and under --quantize=w8a16 (J
                equal). Each step's and request's wall in both modes. A
                replay runs no Python, so its counts are the capture's
                increments (utils/graphs.py): every traced step, graphed and
                eager, must count on the trace, kernel function by kernel
                function (KERNEL_FUNCTIONS), what the counters say, and each
                decode graph's replays, traced alone, its capture's
                increments. Then graph_gc: a graph left to the cyclic collector
                and collected during another capture, in two processes of
                its own, without utils/graphs.py's collection before the
                capture (the capture must fail) and with it (it must pass).
                Then every sampler (samplers, SAMPLER_CASES: diffusion's
                guided DDIM-250, and at 25 steps dpm2m, noisy, fused_cfg,
                a distilled student, teacher_test, w8a8 and w8a16; made at
                2048 and its w8a8 and w8a16; vqvae, rnn, wavenet, pixel_cnn,
                gated_pixel_cnn, vae, gan): its serve_bs=64 request
                through SampleServer graphed (models/base.py pass_graphs;
                the warm-up captures) and per-step (graph_sampling off),
                bitwise, every counter equal, one synchronizing call (the
                batch's copy) in a graphed request; the graphed wall (the
                median of 3) beside the per-step one, a graphed request
                traced (device ms, kernels), the counters' total over
                every pass of the case (warm to the traced request) held
                to the passes times the per-step request's, and each
                graph's replays traced as its capture counted (A, B, G,
                I, J); the noisy sampler's own sample() three times
                graphed from the model's generator, each batch and the
                generator's state after it bitwise the per-step loop's.
Every serving, sampling and eval_heavy phase above runs its samplers as
CUDA graphs, the default: a server's warm() is two passes (the eager one
and the capture), which the phases' launch counts include.
Then the kernels line, the nvidia-smi line and, last, the device line.
`--only=<phase>,...` runs the build and those phases alone (diff_quant
after diff_train), for work on them: it prints no kernels or device line.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import copy
import itertools
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense tf32 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_train'
VQ_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_vqvae'
MADE_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_made'
MADE_FLAGS = ['--model=made', '--hidden_size=2048']  # the kernel route's width
QUANT_MODES = ('w8a8', 'w8a16')
QUANT_KERNEL = {'w8a8': 'int8_gemm', 'w8a16': 'dequant_gemm'}
RING_KERNELS = ('ring_chunk_fwd', 'ring_chunk_bwd_dq', 'ring_chunk_bwd_dkv')
NO_RING = dict.fromkeys(RING_KERNELS, 0)  # the ring's kernels run only under --mesh=seq:N
SEQ_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_seq'
SEQ = 4  # the seq_train phase's ring: --mesh=seq:4
PT_DECODE_WINDOW = range(392, 400)  # the profiled steps of a quantized pixel_transformer request
DIFF_FLAGS = ['--model=diffusion_model', '--eval_heavy=0']  # eval_heavy has a phase of its own
DIFF_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_diffusion'
DIFF_LABELS = [i % 11 - 1 for i in range(64)]  # every class and -1 (unconditional)
# the card's bf16 UNet against a CPU f32 copy of the same weights at batch 4,
# as relative Frobenius errors: one forward and a 10-step guided DDIM chain
# from the same noise and guidance weights (measured 0.0102 and 0.0094 on
# an H100, a bf16 rounding of 2^-9 through ~30 layers: bounds 3x that);
# fused against two-call guidance on the card (measured 0: bitwise; the
# bound leaves room for cuDNN to take another algorithm at batch 8 than at
# 4); a train step's Adam update from the same gradients and optimizer
# state (f32 on both sides)
DIFF_FWD_REL, DIFF_CHAIN_REL, DIFF_FUSED_REL, DIFF_ADAM_REL = 0.03, 0.03, 1e-3, 1e-4
# a train step's gradients against a CPU f32 copy's, as grad_check's (rel of
# each gradient's norm, floor of the whole gradient's): the card's f32 copy
# (TF32 off) to f32 rounding (measured 3.9e-6 at most on an H100); the
# card's bf16 UNet within 0.25 of each gradient's norm plus 5e-3 of the
# whole gradient's: bf16 moves this loss's gradients far more than
# pixel_transformer's (measured on an H100: a median 3.8 %, 12 % at
# norm_out.bias and 159 % at conv_out.bias, the output's mean, 3.2e-3 of the
# whole gradient's norm), while each bf16 conv alone stays within
# DIFF_CONV_REL of f32 arithmetic on the same bf16 operands (2^-9, the
# rounding of its bf16 output, and the bias added after it, rounded again)
DIFF_GRAD_F32, DIFF_GRAD_BF16, DIFF_CONV_REL = (1e-3, 1e-5), (0.25, 5e-3), 3e-3
ROOT = Path(__file__).resolve().parent
EH_DIR = ROOT / 'build' / 'chip_smoke_eval_heavy'
# eval_heavy stops at 500 samples or where a full batch no longer fits in
# the test set: 512 test images give it all 8 rounds of bs=64
EH_TEST_N = 512
EH_FLAGS = ['--model=diffusion_model', '--eval_sampler=dpm2m', '--eval_sample_steps=25']
# the card's arbiter features and logits against a CPU f32 copy of the same
# file (f32, TF32 off: relative Frobenius); eval_heavy's FIDs against a
# float64 recomputation from the phase's own features (scipy's sqrtm of the
# covariance product, the reference's formula); vae's and gan's f32
# gradients and gan's batch statistics after a step against a CPU f32 copy
# (grad_check: rel of each norm, floor of the whole gradient's). gan's
# against a float64 CPU copy instead: every gradient upstream of a
# train-mode BatchNorm passes its backward, which cancels most of what it
# sums, so two f32 twin steps (the card's and the CPU's) can sit 1e-3 of a
# gradient's norm apart though each is close to float64; the phase logs
# the CPU f32 copy's own error (not bounded, as the pixel CNNs') and a
# float64 twin step on the card (its arithmetic apart from f32's) beside
# the card's
ARB_REL, EH_FID_REL, SMALL_GRAD, GAN_STATS_REL = 1e-4, 1e-3, (1e-3, 1e-5), 1e-4
# the chain phase: the orchestration scripts at diffusion's defaults on the
# synthetic set cut to 192 training images (3 steps of bs=64) and 128 test
# images (eval_heavy's 2 rounds: 128 samples a side of the autoencoder's 64
# features, so the covariances have full rank); each stage's latency timed
# over CHAIN_REPS calls after a warm one. --save_n=1: with EPOCHS_*=1 a
# stage saves after its epoch (the scripts' default epochs, 20 and 5, are
# multiples of the default --save_n=5). The chain's stages also take
# --ema: each student's EMA starts from its teacher's weights, updates every
# step and is what the eval chain and the latency reload and sample from
CHAIN_DIR = ROOT / 'build' / 'chip_smoke_chain'
CHAIN_LOG = ROOT / 'build' / 'chip_smoke_chain.log'
CHAIN_TRAIN_N, CHAIN_TEST_N, CHAIN_REPS = 192, 128, 2
CHAIN_FLAGS = ['--bs=64', '--data_source=synthetic', '--save_n=1']
CHAIN_STAGE_FLAGS = CHAIN_FLAGS + ['--eval_heavy=0', '--ema=0.999']
# the eval chain draws eval_heavy's 128 samples a side as one batch of 128
# (one round) in place of two of 64: the same samples' count, half the
# host-bound chains (a guided step at B=64 is 23-44 ms of wall for 10 of
# device on the card). The eval chain and the latency guide in one
# doubled-batch call a step (--fused_cfg=1; bitwise the two calls on the
# card, diff_serve): a stage's chain costs about half the host's launches
CHAIN_EVAL_FLAGS = ['--bs=128', '--fused_cfg=1']
CHAIN_LATENCY_FLAGS = [f'--reps={CHAIN_REPS}', '--fused_cfg=1']
SHIPPED_ARBITERS = (ROOT / 'weights' / 'autoencoder.pt', ROOT / 'weights' / 'classifier.pt')
# the train_flags phase. --remat=1 against --remat=0, 3 steps from seed 0
# (the distance of _run_diff over the update; written before the first
# call: both bitwise expected, since recomputation replays the same
# deterministic kernels, with room for a reordered gradient sum, the gap a
# world-1 group shows, MESH_BOUND). made at 2048 with --grad_clip at
# MADE_CLIP (below the global gradient norm of every update, which the
# phase logs: the clip bites; the norm after clipping MADE_CLIP within
# CLIP_RTOL, f32 rounding of two norms of the whole gradient and a scale: a
# dropped or misscaled clip, which Adam's scale invariance would hide
# from the weights' bound, shows there), --grad_accum=2 and the warmup-cosine
# schedule, 2 epochs of 4 micro-steps: the card's final weights against a
# CPU run of the same command within MADE_FLAGS_BOUND of the CPU run's
# update (the card's bf16 operands against the CPU's f32 through four Adam
# steps; made_grads holds each gradient within 5e-2)
TRAIN_FLAGS_DIR = ROOT / 'build' / 'chip_smoke_train_flags'
TRAIN_FLAGS_N = dict(remat=(192, 64), made=(256, 128))  # (TRAIN_N, TEST_N)
REMAT_BOUND = dict(pixel_transformer=1e-2, diffusion=1e-2)
MADE_CLIP, MADE_FLAGS_BOUND, CLIP_RTOL = 1e-3, 5e-2, 1e-5
MADE_SCHEDULE = [f'--grad_clip={MADE_CLIP}', '--grad_accum=2', '--lr_scheduler=cosine',
                 '--warmup_steps=2', '--lr_decay_steps=8', '--keep_best=eval/nlogp']
GAN_GRAD = (1e-2, 1e-5)
# rnn, wavenet, pixel_cnn and gated_pixel_cnn at their default widths: the
# card's full-forward logits on 8 test images (relative Frobenius) and one
# step's gradients (grad_check's rel of each norm, floor of the whole
# gradient's) against a CPU copy. rnn's products take bf16 operands on the
# card (the port's policy), held against CPU f32 as pixel_transformer's;
# wavenet computes in bf16 on the card, held against the port's CPU bf16
# net (its error against CPU f32 logged beside it); the pixel CNNs run f32
# convs and LayerNorms (TF32 off) against CPU f32
RASTER = ('rnn', 'wavenet', 'pixel_cnn', 'gated_pixel_cnn')
RASTER_FWD_REL = {'rnn': 3e-2, 'wavenet': 3e-2, 'pixel_cnn': 1e-4, 'gated_pixel_cnn': 1e-4}
RASTER_GRAD = {'rnn': (5e-2, 1e-4), 'wavenet': (5e-2, 1e-4), 'pixel_cnn': SMALL_GRAD,
               'gated_pixel_cnn': SMALL_GRAD}
# the models whose card gradients are held against a float64 CPU copy (the
# CPU f32 copy's own error logged beside), at the same bound
RASTER_GRAD_F64 = ('pixel_cnn', 'gated_pixel_cnn')


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters, warmup=3):
    """Mean ms per call over iters back-to-back calls from Python, CUDA
    events: what a caller issuing one call at a time pays (for a kernel
    shorter than its wrapper, the host's issue time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _on_device(event):
    """A kernel or copy on the card's timeline; not a user annotation (such
    as Optimizer.step), whose span covers kernels already counted."""
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CUDA and not getattr(event, 'is_user_annotation', False)


def _raw_device_events(prof):
    """(name, us) of each kernel or copy on the card's timeline in a
    finished trace, read from the profiler's raw events: the ones
    prof.events() keeps and _on_device passes, without building
    prof.events()'s event objects, which take tens of seconds for a
    request of 100k launches and well under one read so."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and not e.is_hidden_event() and e.name() not in ('[memory]', '[OutOfMemory]')]


def _device_events(fn, iters, flush=None, tries=6):
    """The card's events over iters calls of fn (each after a write of
    flush, where given) under torch.profiler's CUDA trace. A trace with no
    device event at all is taken again, a second later, up to tries times:
    the trace now and then comes back empty, up to three times running (it
    also loses a window's first events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if _on_device(e)]
        if events:
            return events
        log(f'[profile] the trace has no device event; taking it again ({attempt + 1} of {tries})')
        time.sleep(1.0)
    raise AssertionError('the profiler saw no device events')


def device_ms(fn, iters):
    """Mean device ms per call: the summed duration of the kernels (and
    copies) that iters calls ran, from torch.profiler's CUDA trace, so the
    host's issue time between launches is not counted."""
    return sum(e.time_range.elapsed_us() for e in _device_events(fn, iters)) / 1e3 / iters


def l2_cold_ms(fn, kernel_name, flush, iters=50):
    """Mean device ms of the kernel named kernel_name when each call follows
    a write of flush (larger than the 50 MB L2), so its operands come from
    HBM: the events of that kernel alone, from torch.profiler's trace."""
    us = [e.time_range.elapsed_us() for e in _device_events(fn, iters, flush)
          if kernel_name in e.name]
    if not us:
        raise AssertionError(f'the profiler saw no {kernel_name} events')
    return sum(us) / 1e3 / len(us)


def timings(kernel, plain, library=None, iters=200):
    """ms / plain_ms / library_ms (device time) and their eager twins."""
    out = dict(
        ms=device_ms(kernel, iters), eager_ms=eager_ms(kernel, iters),
        plain_ms=device_ms(plain, iters), plain_eager_ms=eager_ms(plain, iters),
        library_ms=None, library_eager_ms=None,
    )
    if library is not None:
        out.update(library_ms=device_ms(library, iters),
                   library_eager_ms=eager_ms(library, iters))
    return out


def bound(nbytes, flops, peak=H100_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type (bf16 unless given)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _twice_bitwise(name, fn):
    """fn() twice on the same inputs; raises unless the two (a tensor or a
    tuple of tensors) are bitwise equal. Returns the first."""
    a, b = fn(), fn()
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f'{name}: two launches on the same inputs differ')
    return a


def compare(name, got, ref, atol, rtol):
    """Max abs error; raises if any |got - ref| > atol + rtol * |ref|."""
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite output')
    bad = err > atol + rtol * ref.abs()
    max_err = float(err.max())
    if bad.any():
        raise AssertionError(
            f'{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; '
            f'max abs err {max_err:.3g}'
        )
    return max_err


def ptxas_report(text):
    """{entry function: {registers, spill_stores, spill_loads}} from
    `nvcc -Xptxas -v` output, in the order ptxas compiled them."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name]['registers'] = int(m.group(1))
    return out


def phase_build():
    """Builds every kernel source; logs ptxas's registers and spills of
    each entry function. Returns the reports of the kernels redesigned for
    the tensor cores, Kernels C, E, D, K, L and M by D bucket, H, I and F by
    their VEC flag and A and B by VEC flag and LN width (A's dot route as 'dot'),
    as {'causal_attention_fwd': {'DP=32': {...}, ...}, 'flash_bwd_dq': ...,
    'flash_bwd_dkv': ..., 'mask_out_matmul': {'VEC=1': {...}, 'VEC=0':
    {...}}, 'int8_gemm': ..., 'block_tail': {'VEC=1,VPL=4': {...}, ...},
    'ln_matmul': {'VEC=1,VPL=4': {...}, 'dot,VPL=4': {...}, ...},
    'ring_chunk_fwd': {'DP=32': {...}, ...}, 'ring_chunk_bwd_dq': ...,
    'ring_chunk_bwd_dkv': ..., 'vq_one_hot': {'VEC=1': {...}, ...}}, and
    raises if C, E or D spill at D=32 (every path's width) or H, I, A, B, K,
    L, M or F spill at all."""
    from generative_models_tpu_torch.ops.common import BUILD_DIR, KERNEL_SOURCES, build_kernels

    t0 = time.time()
    build_kernels()
    log(f'[build] {len(KERNEL_SOURCES)} sources in {time.time() - t0:.1f}s -> {BUILD_DIR}')
    # (library, mangled kernel name with its template arguments, wrapper,
    # key): the D bucket (C, E, D), the VEC flag (H, I, F), VEC and the LN
    # width (A, B)
    watched = (('attention', r'flash_fwd_kernelILi(\d+)E', 'causal_attention_fwd', 'DP={}'),
               ('attention_bwd', r'flash_bwd_dq_kernelILi(\d+)E', 'flash_bwd_dq', 'DP={}'),
               ('attention_bwd', r'flash_bwd_dkv_kernelILi(\d+)E', 'flash_bwd_dkv', 'DP={}'),
               ('masked_dense', r'mask_out_matmul_kernelILb(\d+)E', 'mask_out_matmul', 'VEC={}'),
               ('int8', r'int8_gemm_kernelILb(\d+)E', 'int8_gemm', 'VEC={}'),
               ('decode_fused', r'block_tail_kernelILb(\d+)ELi(\d+)E', 'block_tail',
                'VEC={},VPL={}'),
               ('decode_fused', r'ln_matmul_kernelILb(\d+)ELi(\d+)E', 'ln_matmul',
                'VEC={},VPL={}'),
               ('decode_fused', r'ln_matmul_dot_kernelILi(\d+)E', 'ln_matmul', 'dot,VPL={}'),
               ('ring_attention', r'ring_fwd_kernelILi(\d+)E', 'ring_chunk_fwd', 'DP={}'),
               ('ring_attention', r'ring_bwd_dq_kernelILi(\d+)E', 'ring_chunk_bwd_dq', 'DP={}'),
               ('ring_attention', r'ring_bwd_dkv_kernelILi(\d+)E', 'ring_chunk_bwd_dkv',
                'DP={}'),
               ('quantize', r'vq_one_hot_kernelILb(\d+)E', 'vq_one_hot', 'VEC={}'))
    # held at every D bucket, not at D=32 alone
    every_bucket = ('ring_chunk_fwd', 'ring_chunk_bwd_dq', 'ring_chunk_bwd_dkv')
    reps = {name: {} for _, _, name, _ in watched}
    for p in sorted(BUILD_DIR.glob('*.log')):
        for fn, rep in ptxas_report(p.read_text()).items():
            log(f'[build] {p.stem}: {fn}: {json.dumps(rep)}')
            for lib, mangled, name, key in watched:
                m = re.match(rf'_Z\d+{mangled}', fn)
                if m and p.stem.startswith(f'lib{lib}-'):
                    reps[name][key.format(*m.groups())] = rep
    for name, rep in reps.items():
        log(f'[build] {name} ptxas {json.dumps(rep)}')
        if not rep:
            raise AssertionError(f'{name}: no ptxas report')
        held = ([('DP=32', rep['DP=32'])] if 'DP=32' in rep and name not in every_bucket
                else rep.items())
        for key, r in held:
            if r.get('spill_stores', 0):
                raise AssertionError(f'{name} spills at {key}: {r}')
    return reps


def phase_kernels(dev):
    """Each kernel vs its plain version at the main paths' shapes:
    pixel_transformer's (C=128, T=784 and 2048) first, then vqvae's (the
    prior at C=256, 8 heads, T=49; the codebook search at its batches)."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
        flash_bwd_dq_plain,
    )
    from generative_models_tpu_torch.ops.decode_fused import (
        block_tail, block_tail_plain, ln_matmul, ln_matmul_plain, plan_block_tail,
        plan_ln_matmul,
    )

    rng = np.random.RandomState(0)
    f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    cases = {'ln_matmul': [], 'block_tail': [], 'causal_attention_fwd': [],
             'flash_bwd_dq': [], 'flash_bwd_dkv': [], 'vq_one_hot': []}

    # Kernels A and B vs plain at the same operand rounding (bf16, f32
    # accumulation). Tolerance atol 1e-2 + rtol 1e-2: the f32 sums differ
    # only in order (~1e-6), but a normalised input that lands within an
    # f32 ulp of a bf16 rounding boundary rounds the other way in one of the
    # two, moving its products by up to 2^-8 relative. A launches twice on
    # the same inputs and the two must be bitwise equal (no atomics, no split
    # K); ms_l2_cold: with L2 flushed before each launch. Then untimed:
    # ragged rows (B = 1, 25, 70: a part-filled 16-row strip), ragged N (7:
    # the dot route at N > 1; 96: a part-filled 64-column slice), ragged C
    # (100: plain loads; 1024 and 4096: LN by loops, the weight streamed
    # through the stage ring), and x at an odd offset (plain loads).
    tol_dense = dict(atol=1e-2, rtol=1e-2)
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    B = 64
    for C, N, path in ((128, 384, 'pixel_transformer'), (128, 1, 'pixel_transformer'),
                       (256, 768, 'vqvae'), (256, 64, 'vqvae')):
        x, s, b = f32(B, C), 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        got = _twice_bitwise(f'ln_matmul C={C} N={N}', lambda: ln_matmul(x, s, b, w, bias))
        ref = ln_matmul_plain(x, s, b, w, bias, dtype=bf)
        err = compare(f'ln_matmul C={C} N={N}', got, ref, **tol_dense)
        nbytes = B * C * 4 + 2 * C * 4 + C * N * 2 + N * 4 + B * N * 4
        bms, by = bound(nbytes, 2 * B * C * N)
        cases['ln_matmul'].append(dict(
            shape=f'x ({B},{C}) -> ({B},{N})', path=path, max_abs_err=err, **tol_dense,
            bound_ms=bms, bound_by=by, bitwise_twice=True,
            plan=plan_ln_matmul(B, C, N)._asdict(),
            ms_l2_cold=l2_cold_ms(lambda: ln_matmul(x, s, b, w, bias), 'ln_matmul', flush),
            **timings(
                lambda: ln_matmul(x, s, b, w, bias),
                lambda: ln_matmul_plain(x, s, b, w, bias, dtype=bf),
            ),
        ))
    for rows, C, N, odd in ((1, 128, 384, False), (25, 128, 384, False), (70, 256, 768, False),
                            (64, 128, 7, False), (64, 128, 96, False), (64, 100, 96, False),
                            (25, 1024, 384, False), (70, 1024, 1, False), (5, 4096, 96, False),
                            (64, 128, 384, True), (25, 100, 1, True)):
        s, b = 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        # 4 bytes past a 16-byte boundary: the plain-load route
        x = f32(rows * C + 1)[1:].view(rows, C) if odd else f32(rows, C)
        shape = f'ragged x ({rows},{C}) -> ({rows},{N}){", at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'ln_matmul {shape}', lambda: ln_matmul(x, s, b, w, bias))
        err = compare(f'ln_matmul {shape}', got, ln_matmul_plain(x, s, b, w, bias, dtype=bf),
                      **tol_dense)
        plan = plan_ln_matmul(rows, C, N, aligned=not odd)._asdict()
        cases['ln_matmul'].append(dict(shape=shape, path='ragged', max_abs_err=err, **tol_dense,
                                       bitwise_twice=True, plan=plan))
    # Kernel B launched twice on the same inputs must be bitwise equal (its
    # cluster's partial sums meet in rank order); ms_l2_cold: with L2
    # flushed before each launch. Then untimed: ragged rows (B = 1, 25, 70:
    # a part-filled 16-row strip) and ragged C, C=144 on the 16-byte route
    # (P=32 slices over 8 blocks, the last rank's 16 wide, ranks 5-7 empty)
    # and on the plain-load route (x, y at an odd offset), and C=100 (not a
    # multiple of 16: plain loads)

    def block_tail_params(C):
        return dict(
            wproj=f32(C, C, scale=C ** -0.5).to(bf), bproj=f32(C, scale=0.1),
            ln2_scale=1 + f32(C, scale=0.1), ln2_bias=f32(C, scale=0.1),
            wfc1=f32(C, 4 * C, scale=C ** -0.5).to(bf), bfc1=f32(4 * C, scale=0.1),
            wfc2=f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), bfc2=f32(C, scale=0.1),
        )

    for C, path in ((128, 'pixel_transformer'), (256, 'vqvae')):
        lp = block_tail_params(C)
        x, y = f32(B, C), f32(B, C)
        got = _twice_bitwise(f'block_tail C={C}', lambda: block_tail(x, y, lp))
        err = compare(f'block_tail C={C}', got, block_tail_plain(x, y, lp, dtype=bf), **tol_dense)
        nbytes = 3 * B * C * 4 + 9 * C * C * 2 + 8 * C * 4
        bms, by = bound(nbytes, 2 * B * 9 * C * C)
        cases['block_tail'].append(dict(
            shape=f'x, y ({B},{C})', path=path, max_abs_err=err, **tol_dense,
            bound_ms=bms, bound_by=by, bitwise_twice=True,
            plan=plan_block_tail(C)._asdict(),
            ms_l2_cold=l2_cold_ms(lambda: block_tail(x, y, lp), 'block_tail_kernel', flush),
            **timings(
                lambda: block_tail(x, y, lp),
                lambda: block_tail_plain(x, y, lp, dtype=bf),
            ),
        ))
    del flush
    for rows, C, odd in ((1, 128, False), (25, 128, False), (70, 256, False), (64, 144, False),
                         (64, 144, True), (25, 100, False)):
        lp = block_tail_params(C)
        if odd:  # 4 bytes past a 16-byte boundary: the plain-load route
            x, y = (f32(rows * C + 1)[1:].view(rows, C) for _ in range(2))
        else:
            x, y = f32(rows, C), f32(rows, C)
        shape = f'ragged x, y ({rows},{C}){", at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'block_tail {shape}', lambda: block_tail(x, y, lp))
        err = compare(f'block_tail {shape}', got, block_tail_plain(x, y, lp, dtype=bf),
                      **tol_dense)
        cases['block_tail'].append(dict(shape=shape, path='ragged', max_abs_err=err, **tol_dense,
                                        bitwise_twice=True, plan=plan_block_tail(C)._asdict()))

    cases['causal_attention_fwd'] = flash_fwd_cases(f32, dev)

    # Kernels E (dQ, delta) and D (dK, dV) vs the dense plain backward on the
    # same bf16 operands, P and dS in f32 in the plain version (the kernels
    # carry each as a bf16 hi/lo pair): rtol 1e-3 / atol 1e-4, the JAX
    # package's flash-vs-dense gradient tolerance (sums of up to T terms in
    # another order). Each launches twice on the same inputs, and the two
    # must be bitwise equal (no atomics, fixed sum order). library_ms: the
    # backward alone of scaled_dot_product_attention (dq, dk and dv in one
    # call); ms_l2_cold at the path shape: each kernel with L2 flushed
    # before it. Then untimed edge cases of the tiling (64-row blocks,
    # 16-row chunks, D padded to 16, 32, 64 or 128) at a small B*H.
    tol_bwd = dict(atol=1e-4, rtol=1e-3)
    bwd_shapes = (((64, 4, 784, 32), (209, 209), 'pixel_transformer'),
                  ((1, 4, 2048, 32), (389, 418), 'long T'),
                  ((64, 8, 49, 32), (209, 209), 'vqvae'))
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for (Bq, Hq, T, D), lines, path in bwd_shapes:
        q, k, v, do = (f32(Bq, Hq, T, D).to(bf) for _ in range(4))
        o, lse = causal_attention_fwd(q, k, v)
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        dq, delta = _twice_bitwise(f'flash_bwd_dq {shape}',
                                   lambda: flash_bwd_dq(q, k, v, o, lse, do))
        dk, dv = _twice_bitwise(f'flash_bwd_dkv {shape}',
                                lambda: flash_bwd_dkv(q, k, v, do, lse, delta))
        rdq, rdelta = flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf)
        err_dq = max(compare(f'bwd dq {shape}', dq, rdq, **tol_bwd),
                     compare(f'bwd delta {shape}', delta, rdelta, **tol_bwd))
        del rdq
        rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, lse, rdelta, dtype=bf)
        err_dkv = max(compare(f'bwd dk {shape}', dk, rdk, **tol_bwd),
                      compare(f'bwd dv {shape}', dv, rdv, **tol_bwd))
        del rdk, rdv
        torch.cuda.empty_cache()
        qg, kg, vg = (u.detach().clone().requires_grad_() for u in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
        BH, pairs = Bq * Hq, Bq * Hq * T * (T + 1) // 2
        n = BH * T * D
        iters = 10 if T > 64 else 100
        cold = {}
        if path == 'pixel_transformer':
            cold = dict(
                dq=l2_cold_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do), 'flash_bwd_dq_kernel',
                              flush),
                dkv=l2_cold_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta),
                               'flash_bwd_dkv_kernel', flush))
        # E reads q, k, v, dO (bf16), o, lse and writes dq, delta; three
        # D-long products a live pair (S, dP, dQ)
        bms, by = bound(4 * n * 2 + n * 4 + BH * T * 4 + n * 4 + BH * T * 4, 3 * 2 * D * pairs)
        cases['flash_bwd_dq'].append(dict(
            shape=shape, path=path, replaces_line=lines[0], max_abs_err=err_dq, **tol_bwd,
            bound_ms=bms, bound_by=by, library_covers='dq, dk and dv', bitwise_twice=True,
            **({'ms_l2_cold': cold['dq']} if cold else {}), **timings(
                lambda: flash_bwd_dq(q, k, v, o, lse, do),
                lambda: flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf),
                sdpa_bwd, iters=iters,
            ),
        ))
        # D reads q, k, v, dO (bf16), lse, delta and writes dk, dv; four
        # D-long products a live pair (S, dP, dK, dV)
        bms, by = bound(4 * n * 2 + 2 * BH * T * 4 + 2 * n * 4, 4 * 2 * D * pairs)
        cases['flash_bwd_dkv'].append(dict(
            shape=shape, path=path, replaces_line=lines[1], max_abs_err=err_dkv, **tol_bwd,
            bound_ms=bms, bound_by=by, library_covers='dq, dk and dv', bitwise_twice=True,
            **({'ms_l2_cold': cold['dkv']} if cold else {}), **timings(
                lambda: flash_bwd_dkv(q, k, v, do, lse, delta),
                lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, dtype=bf),
                sdpa_bwd, iters=iters,
            ),
        ))
        del out, sdpa_bwd, qg, kg, vg
        torch.cuda.empty_cache()
    del flush
    edge_shapes = ([(2, 3, T, 32) for T in (1, 63, 65, 130)]
                   + [(2, 3, 200, D) for D in (8, 16, 24, 64, 128)])
    for Bq, Hq, T, D in edge_shapes:
        q, k, v, do = (f32(Bq, Hq, T, D).to(bf) for _ in range(4))
        o, lse = causal_attention_fwd(q, k, v)
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        dq, delta = _twice_bitwise(f'flash_bwd_dq {shape}',
                                   lambda: flash_bwd_dq(q, k, v, o, lse, do))
        dk, dv = _twice_bitwise(f'flash_bwd_dkv {shape}',
                                lambda: flash_bwd_dkv(q, k, v, do, lse, delta))
        rdq, rdelta = flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf)
        rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, lse, rdelta, dtype=bf)
        err_dq = max(compare(f'bwd dq {shape}', dq, rdq, **tol_bwd),
                     compare(f'bwd delta {shape}', delta, rdelta, **tol_bwd))
        err_dkv = max(compare(f'bwd dk {shape}', dk, rdk, **tol_bwd),
                      compare(f'bwd dv {shape}', dv, rdv, **tol_bwd))
        for name, err in (('flash_bwd_dq', err_dq), ('flash_bwd_dkv', err_dkv)):
            cases[name].append(dict(shape=shape, path='edge', max_abs_err=err, **tol_bwd,
                                    bitwise_twice=True))

    cases['vq_one_hot'] = vq_cases(f32)
    cases['masked_matmul'], cases['mask_out_matmul'] = made_cases(f32, dev)
    cases['int8_gemm'], cases['dequant_gemm'] = int8_cases(rng, dev)
    ring = ring_cases(f32)
    cases.update(ring.pop('cases'))
    torch.cuda.synchronize()
    for name, cs in cases.items():
        for c in cs:
            log(f'[kernels] {name} {json.dumps(c)}')
    return cases, ring


def flash_fwd_cases(f32, dev):
    """Kernel C vs the dense plain version on the same bf16 operands, both
    in f32: atol 2e-5 + rtol 2e-4, the JAX package's flash-vs-dense
    tolerance (sums in another order, exp/log implementations differ; C
    carries P into P v as a bf16 hi/lo pair, the plain version keeps it in
    f32). At the three attention shapes of the main paths, timed, and at
    untimed edge cases of the tiling (64-row blocks, 16-key chunks, D
    padded to 16, 32, 64 or 128) at a small B*H. Every case launches C
    twice on the same inputs, and the two must be bitwise equal (no
    atomics, fixed sum order). library_ms: scaled_dot_product_attention's
    forward; ms_l2_cold at the path shape: C with L2 flushed before it."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, causal_attention_plain,
    )

    tol = dict(atol=2e-5, rtol=2e-4)
    bf, out = torch.bfloat16, []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    shapes = ([((64, 4, 784, 32), 148, 'pixel_transformer'), ((1, 4, 2048, 32), 312, 'long T'),
               ((64, 8, 49, 32), 148, 'vqvae')]
              + [((2, 3, T, 32), None, 'edge') for T in (1, 63, 65, 130)]
              + [((2, 3, 200, D), None, 'edge') for D in (8, 16, 24, 64, 128)])
    for (Bq, Hq, T, D), replaces, path in shapes:
        q, k, v = (f32(Bq, Hq, T, D).to(bf) for _ in range(3))
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        o, lse = _twice_bitwise(f'causal_attention_fwd {shape}',
                                lambda: causal_attention_fwd(q, k, v))
        o_ref, lse_ref = causal_attention_plain(q, k, v, dtype=bf)
        err = max(compare(f'attention o {shape}', o, o_ref, **tol),
                  compare(f'attention lse {shape}', lse, lse_ref, **tol))
        del o_ref, lse_ref
        case = dict(shape=shape, path=path, max_abs_err=err, **tol, bitwise_twice=True)
        if path != 'edge':
            BH = Bq * Hq
            nbytes = 3 * BH * T * D * 2 + BH * T * D * 4 + BH * T * 4
            flops = 4 * D * BH * T * (T + 1) // 2  # QK^T and PV over live pairs
            bms, by = bound(nbytes, flops)
            kern = lambda: causal_attention_fwd(q, k, v)
            if path == 'pixel_transformer':
                case['ms_l2_cold'] = l2_cold_ms(kern, 'flash_fwd_kernel', flush)
            case.update(replaces_line=replaces, bound_ms=bms, bound_by=by, **timings(
                kern, lambda: causal_attention_plain(q, k, v, dtype=bf),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                iters=10 if T > 64 else 100,
            ))
        out.append(case)
        torch.cuda.empty_cache()
    del flush
    return out


def _live_pairs(n, Tl, hop):
    """(query, key) pairs with a live causal pair at one hop of a ring of n,
    over the real rows of every position: the diagonal's triangle, a past
    chunk's square, a future chunk's nothing."""
    pairs = 0
    for p in range(n):
        c = (p - hop) % n
        pairs += Tl * (Tl + 1) // 2 if c == p else (Tl * Tl if c < p else 0)
    return pairs


def _live_positions(n, hop):
    """Ring positions with any live pair at one hop of a ring of n: those
    whose visiting chunk is the diagonal or a past one. A hop's bound
    counts the bytes of these positions' real rows only."""
    return sum((p - hop) % n <= p for p in range(n))


def ring_cases(f32, shape=(64, 4, 784, 32)):
    """Kernels K, L and M vs their plain versions at pixel_transformer's
    shapes (B=64, H=4, T=784, D=32: BH=256) on rings of 4 (the seq_train
    phase's), 2 and 8, at the first hop (the init variant) and at hop 1
    (the carry from hop 0). Inputs: one seeded (64,4,784,32) q, k, v and dO
    in bf16, cut into the ring's chunks as the ring cuts them (dO zero on
    padded rows); L and M get lse and delta from the full forward ring.
    Tolerances are Kernel C's for K (atol 2e-5 + rtol 2e-4) and E/D's for
    L and M (atol 1e-4 + rtol 1e-3): the same bf16 operands on both sides,
    f32 sums in another order. Each case launches each kernel twice on the
    same inputs, and the two must be bitwise equal; at the seq_train ring
    each is also timed with L2 flushed (ms_l2_cold). No single PyTorch call
    computes a hop's carry: library_ms is null. Then each kernel, untimed,
    at the edges of its tiling (ring_edge_cases), and the whole ring at n =
    4 and 8 through ring_causal_attention (its autograd Function) against
    Kernels C, E and D on the full sequence, o and the three gradients,
    its forward and backward timed beside scaled_dot_product_attention's."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import (
        _chunks, ring_causal_attention, ring_forward,
    )

    B, H, T, D = shape
    BH, bf = B * H, torch.bfloat16
    q, k, v, do = (f32(B, H, T, D).to(bf) for _ in range(4))
    tol_k, tol_lm = dict(atol=2e-5, rtol=2e-4), dict(atol=1e-4, rtol=1e-3)
    flush = torch.empty(64 << 20, device=q.device)  # 256 MB of f32
    out = {'ring_chunk_fwd': [], 'ring_chunk_bwd_dq': [], 'ring_chunk_bwd_dkv': []}
    clone = lambda xs: None if xs is None else tuple(x.clone() for x in xs)
    for n in (4, 2, 8):
        Tl = T // n
        Tp = att._pick_chunk_blk(Tl)[1]
        qc, kc, vc, doc = (_chunks(u, n, Tp, bf) for u in (q, k, v, do))
        o, lse = ring_forward(qc, kc, vc, Tl)
        delta = (doc.float() * o).sum(-1)
        carry = att.ring_chunk_fwd(qc, kc, vc, None, 0, Tl)  # hop 0's carry for hop 1
        dq0 = att.ring_chunk_bwd_dq(qc, kc, vc, doc, lse, delta, None, 0, Tl)
        dkv0 = att.ring_chunk_bwd_dkv(qc, kc, vc, doc, lse, delta, None, 0, Tl)
        for hop, init in ((1, False), (0, True)):
            shape = f'ring of {n}: (n={n},BH={BH},Tp={Tp},D={D}), t_valid {Tl}, hop {hop}'
            variant = 'init' if init else 'carry'
            pairs = BH * _live_pairs(n, Tl, hop)
            # bytes over the live positions' real rows only: rows is one f32
            # a row (m, l, lse or delta), full one element a row and channel
            live_rows = BH * _live_positions(n, hop) * Tl
            rows, full = live_rows * 4, live_rows * D
            common = dict(shape=shape, path='seq_train' if n == 4 else f'seq:{n}', variant=variant,
                          live_pairs=pairs, library_covers=None)
            c_in = None if init else carry
            dq_in = None if init else dq0
            dkv_in = None if init else dkv0
            # K: q and the visited k, v read, the carry read (not at init)
            # and written; launched twice on the same inputs, bitwise equal
            # (no atomics); timed in place, as the ring runs it, and at the
            # seq_train ring also with L2 flushed before each launch
            got = _twice_bitwise(f'ring_chunk_fwd {shape}', lambda: att.ring_chunk_fwd(
                qc, kc, vc, clone(c_in), hop, Tl))
            ref = att.ring_hop_fwd_plain(qc, kc, vc, c_in, hop, Tl, dtype=bf)
            err = max(compare(f'ring_chunk_fwd {x} {shape}', g, r, **tol_k)
                      for x, g, r in zip(('acc', 'm', 'l'), got, ref))
            bms, by = bound(3 * full * 2 + (1 if init else 2) * (full * 4 + 2 * rows),
                            4 * D * pairs)
            scratch = clone(carry)
            k_call = lambda: att.ring_chunk_fwd(qc, kc, vc, None if init else scratch, hop, Tl)
            cold = {'ms_l2_cold': l2_cold_ms(k_call, 'ring_fwd_kernel', flush)} if n == 4 else {}
            out['ring_chunk_fwd'].append(dict(
                **common, max_abs_err=err, **tol_k, bound_ms=bms, bound_by=by,
                bitwise_twice=True, **cold, **timings(
                    k_call, lambda: att.ring_hop_fwd_plain(qc, kc, vc, c_in, hop, Tl, dtype=bf),
                    iters=10)))
            # L: q, k, v, dO, lse, delta read, dq read (not at init) and
            # written; launched twice on the same inputs, bitwise equal (no
            # atomics); timed in place, as the ring runs it, and at the
            # seq_train ring also with L2 flushed before each launch
            got = _twice_bitwise(f'ring_chunk_bwd_dq {shape}', lambda: att.ring_chunk_bwd_dq(
                qc, kc, vc, doc, lse, delta, None if init else dq0.clone(), hop, Tl))
            ref = att.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, dtype=bf)
            err = compare(f'ring_chunk_bwd_dq {shape}', got, ref, **tol_lm)
            bms, by = bound(4 * full * 2 + 2 * rows + (1 if init else 2) * full * 4,
                            3 * 2 * D * pairs)
            dq_s = dq0.clone()
            l_call = lambda: att.ring_chunk_bwd_dq(qc, kc, vc, doc, lse, delta,
                                                   None if init else dq_s, hop, Tl)
            cold = {'ms_l2_cold': l2_cold_ms(l_call, 'ring_bwd_dq_kernel', flush)} if n == 4 else {}
            out['ring_chunk_bwd_dq'].append(dict(
                **common, max_abs_err=err, **tol_lm, bound_ms=bms, bound_by=by,
                bitwise_twice=True, **cold, **timings(
                    l_call,
                    lambda: att.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop,
                                                      Tl, dtype=bf),
                    iters=10)))
            # M: q, k, v, dO, lse, delta read, the visited chunk's dk and dv
            # read (not at init) and written; twice bitwise, timed in place,
            # L2 flushed at the seq_train ring, as K and L
            got = _twice_bitwise(f'ring_chunk_bwd_dkv {shape}', lambda: att.ring_chunk_bwd_dkv(
                qc, kc, vc, doc, lse, delta, clone(dkv_in), hop, Tl))
            ref = att.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, dkv_in, hop, Tl,
                                             dtype=bf)
            err = max(compare(f'ring_chunk_bwd_dkv {x} {shape}', g, r, **tol_lm)
                      for x, g, r in zip(('dk', 'dv'), got, ref))
            bms, by = bound(4 * full * 2 + 2 * rows + (1 if init else 2) * 2 * full * 4,
                            4 * 2 * D * pairs)
            dkv_s = clone(dkv0)
            m_call = lambda: att.ring_chunk_bwd_dkv(qc, kc, vc, doc, lse, delta,
                                                    None if init else dkv_s, hop, Tl)
            cold = ({'ms_l2_cold': l2_cold_ms(m_call, 'ring_bwd_dkv_kernel', flush)}
                    if n == 4 else {})
            out['ring_chunk_bwd_dkv'].append(dict(
                **common, max_abs_err=err, **tol_lm, bound_ms=bms, bound_by=by,
                bitwise_twice=True, **cold, **timings(
                    m_call,
                    lambda: att.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, dkv_in,
                                                       hop, Tl, dtype=bf),
                    iters=10)))
            del got, ref
        del qc, kc, vc, doc, o, lse, delta, carry, dq0, dkv0
        torch.cuda.empty_cache()
    del flush
    for name, cs in ring_edge_cases(f32, tol_k, tol_lm).items():
        out[name] += cs

    # the whole ring against Kernels C, E and D on the full sequence; f32
    # inputs holding bf16 values, so the ring's gradients come back in f32
    oc, lsec = att.causal_attention_fwd(q, k, v)
    refs = (oc, *att.causal_attention_bwd(q, k, v, oc, lsec, do))
    whole = {}
    for n in (4, 8):
        qg, kg, vg = (u.float().requires_grad_() for u in (q, k, v))
        o = ring_causal_attention(qg, kg, vg, n)
        grads = torch.autograd.grad(o, (qg, kg, vg), do.float(), retain_graph=True)
        errs = {x: compare(f'ring of {n} vs C/E/D {x}', g, r, **(tol_k if x == 'o' else tol_lm))
                for x, g, r in zip(('o', 'dq', 'dk', 'dv'), (o.detach(), *grads), refs)}
        with torch.no_grad():
            fwd = lambda: ring_causal_attention(qg, kg, vg, n)
            whole[f'ring_{n}'] = dict(
                max_abs_err=errs, fwd_ms=device_ms(fwd, 10), fwd_eager_ms=eager_ms(fwd, 10))
        bwd = lambda: torch.autograd.grad(o, (qg, kg, vg), do.float(), retain_graph=True)
        whole[f'ring_{n}'].update(bwd_ms=device_ms(bwd, 10), bwd_eager_ms=eager_ms(bwd, 10))
        del o, grads, qg, kg, vg
        torch.cuda.empty_cache()
    qs, ks, vs = (u.detach().clone().requires_grad_() for u in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    whole['sdpa'] = dict(
        fwd_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10),
        bwd_ms=device_ms(lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True), 10))
    whole['c_e_d'] = dict(
        fwd_ms=device_ms(lambda: att.causal_attention_fwd(q, k, v), 10),
        bwd_ms=device_ms(lambda: att.causal_attention_bwd(q, k, v, oc, lsec, do), 10))
    whole.update(shape=f'(B={B},H={H},T={T},D={D})', tol_o=tol_k, tol_grads=tol_lm)
    log(f'[kernels] whole ring {json.dumps(whole)}')
    del so, qs, ks, vs, oc, lsec, refs
    torch.cuda.empty_cache()
    return dict(cases=out, whole=whole)


def ring_edge_cases(f32, tol_k, tol_lm):
    """Kernels K, L and M, untimed, at the edges of their tiling, each
    launched twice (bitwise equal) and held against its plain version on
    the same arguments (K at tol_k on acc, m and l, L and M at tol_lm): D =
    8, 16, 64 and 128 (every D bucket, 32 being the path's) on a ring of 4
    at T=784 (t_valid 196), and t_valid 75 on a ring of 2 (T=150, chunks of
    80 rows), each at the first hop and a carry hop; and one rank's launch
    of a ring of 4 (P=1, pos0=2, the visiting chunk in slot 0) at every
    hop, on a carry (K's acc, L's dq, M's dk and dv) at an odd offset at
    the carry hops (the wrappers' copy back). Returns {wrapper: cases}."""
    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import _chunks, ring_forward

    bf = torch.bfloat16
    out = {'ring_chunk_fwd': [], 'ring_chunk_bwd_dq': [], 'ring_chunk_bwd_dkv': []}

    def fresh(x, odd):
        """a copy of x (None stays None), 4 bytes past a 16-byte boundary
        where odd"""
        if x is None or not odd:
            return None if x is None else x.clone()
        buf = torch.empty(x.numel() + 1, device=x.device)
        buf[1:] = x.flatten()
        return buf[1:].view(x.shape)

    def check(label, args, carries, hop, Tl, pos0=0, n_ring=None, odd=False):
        """args: q, k, v, dO, lse, delta; carries: K's (acc, m, l), L's dq,
        M's (dk, dv), each None at the first hop"""
        qc, kc, vc = args[:3]
        c_k, c_l, c_m = carries
        runs = (
            ('ring_chunk_fwd', ('acc', 'm', 'l'), tol_k,
             lambda: att.ring_chunk_fwd(qc, kc, vc, None if c_k is None else (
                 fresh(c_k[0], odd), c_k[1].clone(), c_k[2].clone()), hop, Tl, pos0, n_ring),
             lambda: att.ring_hop_fwd_plain(qc, kc, vc, c_k, hop, Tl, pos0, n_ring, dtype=bf)),
            ('ring_chunk_bwd_dq', ('dq',), tol_lm,
             lambda: (att.ring_chunk_bwd_dq(*args, fresh(c_l, odd), hop, Tl, pos0, n_ring),),
             lambda: (att.ring_hop_bwd_dq_plain(*args, c_l, hop, Tl, pos0, n_ring, dtype=bf),)),
            ('ring_chunk_bwd_dkv', ('dk', 'dv'), tol_lm,
             lambda: att.ring_chunk_bwd_dkv(*args, None if c_m is None else tuple(
                 fresh(u, odd) for u in c_m), hop, Tl, pos0, n_ring),
             lambda: att.ring_hop_bwd_dkv_plain(*args, c_m, hop, Tl, pos0, n_ring, dtype=bf)),
        )
        for name, parts, tol, kern, plain in runs:
            got = _twice_bitwise(f'{name} {label}', lambda: tuple(kern()))
            err = max(compare(f'{name} {x} {label}', g, r, **tol)
                      for x, g, r in zip(parts, got, plain()))
            out[name].append(dict(shape=label, path='edge', bitwise_twice=True, **tol,
                                  max_abs_err=err))

    def ring_inputs(n, B, H, T, D):
        Tl = T // n
        Tp = att._pick_chunk_blk(Tl)[1]
        qc, kc, vc, doc = (_chunks(f32(B, H, T, D), n, Tp, bf) for _ in range(4))
        o, lse = ring_forward(qc, kc, vc, Tl)
        return Tl, Tp, (qc, kc, vc, doc, lse, (doc.float() * o).sum(-1))

    for n, (B, H, T, D) in ((4, (2, 3, 784, 8)), (4, (2, 3, 784, 16)), (4, (2, 3, 784, 64)),
                            (4, (2, 3, 784, 128)), (2, (2, 3, 150, 32))):
        Tl, Tp, args = ring_inputs(n, B, H, T, D)
        carries = (att.ring_chunk_fwd(*args[:3], None, 0, Tl),
                   att.ring_chunk_bwd_dq(*args, None, 0, Tl),
                   att.ring_chunk_bwd_dkv(*args, None, 0, Tl))
        for hop in (0, 1):
            check(f'ring of {n}: (n={n},BH={B * H},Tp={Tp},D={D}), t_valid {Tl}, hop {hop}',
                  args, (None,) * 3 if hop == 0 else carries, hop, Tl)
    n, (B, H, T, D) = 4, (2, 3, 200, 32)
    Tl, Tp, args = ring_inputs(n, B, H, T, D)
    for hop in range(n):
        c = (2 - hop) % n  # the chunk visiting position 2
        one = tuple(u[2:3] for u in args)
        one = (one[0], args[1][c:c + 1], args[2][c:c + 1], *one[3:])
        carries = (None,) * 3 if hop == 0 else (
            (f32(1, B * H, Tp, D), f32(1, B * H, Tp), 1 + f32(1, B * H, Tp).abs()),
            f32(1, B * H, Tp, D), (f32(1, B * H, Tp, D), f32(1, B * H, Tp, D)))
        check(f'one rank of a ring of {n}: P=1, pos0=2, (BH={B * H},Tp={Tp},D={D}), '
              f't_valid {Tl}, hop {hop}', one, carries, hop, Tl, 2, n, odd=hop > 0)
    return out


def vq_cases(f32):
    """Kernel F vs its plain version (f32 on both sides) at vqvae's
    training batch, at evaluate's 8 images and at a codebook of 16 K-tiles,
    each launched twice and bitwise equal, timed also with L2 flushed
    (ms_l2_cold); then untimed at ragged N, K and D, z at an odd float
    offset (the kernel's 4-byte copies) and two NaN cases. The indices must
    be identical but for ties: where one differs, the plain scores of the
    two codes must differ by less than 1e-5 of the row's largest |score|
    (vq_ties_missed: a sum in another order may break such a tie either
    way). At the NaN cases (a NaN code, taken by every row, the first of
    two; a row of z all NaN, index 0) they must be identical."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.quantize import (
        VQ_TIE_REL, vq_one_hot, vq_one_hot_plain, vq_ties_missed,
    )

    def check(label, z, e, exact=False):
        oh, idx = _twice_bitwise(f'vq_one_hot {label}', lambda: vq_one_hot(z, e))
        roh, ridx = vq_one_hot_plain(z, e)
        if idx.dtype != torch.int64 or not torch.equal(oh, F.one_hot(idx, e.shape[0]).float()):
            raise AssertionError(f'vq_one_hot {label}: one-hot disagrees with its index')
        differ = int((idx != ridx).sum())
        missed = differ if exact else vq_ties_missed(idx, ridx, z, e)
        if differ:
            log(f'[kernels] vq_one_hot {label}: {differ} rows differ, {missed} beyond a tie')
        if missed:
            raise AssertionError(f'vq_one_hot {label}: indices differ beyond a tie at {missed} rows')
        return dict(shape=label, rows_differ=differ, max_abs_err=float((oh - roh).abs().max()),
                    atol=0.0, rtol=0.0, tie_rel_gap=0.0 if exact else VQ_TIE_REL,
                    bitwise_twice=True)

    out = []
    flush = torch.empty(64 << 20, device='cuda')  # 256 MB of f32, past the 50 MB L2
    for N, K, D, path in ((3136, 64, 64, 'vqvae train'), (392, 64, 64, 'vqvae evaluate'),
                          (12544, 1024, 64, 'K-tiles')):
        z, e = f32(N, D), f32(K, D)
        # bytes: z and the codebook read once, the one-hot and the int64
        # index written once; operations: the z.e products, three tf32
        # products a multiply-add on the tensor cores (3xTF32)
        bms, by = bound(4 * (N * D + K * D + N * K) + 8 * N, 3 * 2 * N * K * D,
                        peak=H100_TF32_FLOPS)
        out.append(dict(
            check(f'z ({N},{D}) x e ({K},{D})', z, e), path=path, bound_ms=bms, bound_by=by,
            ms_l2_cold=l2_cold_ms(lambda: vq_one_hot(z, e), 'vq_one_hot_kernel', flush),
            **timings(lambda: vq_one_hot(z, e), lambda: vq_one_hot_plain(z, e),
                      iters=100 if N * K < 2 ** 24 else 20),
        ))
        del z, e
    del flush
    for N, K, D in ((1, 64, 64), (17, 64, 64), (3137, 64, 64), (300, 1, 64), (300, 7, 64),
                    (300, 65, 64), (300, 4096, 64), (300, 64, 8), (300, 64, 20), (300, 64, 100),
                    (300, 64, 256), (300, 64, 7)):
        out.append(dict(check(f'ragged z ({N},{D}) x e ({K},{D})', f32(N, D), f32(K, D)),
                        path='ragged'))
    z = f32(3136 * 64 + 1)[1:].view(3136, 64)  # 4 bytes past a 16-byte boundary
    out.append(dict(check('z (3136,64) at an odd offset x e (64,64)', z, f32(64, 64)),
                    path='ragged'))
    z, e = f32(392, 64), f32(1024, 64)
    e[900, 1] = e[700, 3] = float('nan')  # every row takes code 700, the first NaN score
    out.append(dict(check('NaN codes 700, 900 of e (1024,64), z (392,64)', z, e, exact=True),
                    path='nan'))
    z, e = f32(392, 64), f32(64, 64)
    z[7] = float('nan')  # row 7's scores all NaN: index 0
    out.append(dict(check('z (392,64) with row 7 all NaN x e (64,64)', z, e, exact=True),
                    path='nan'))
    torch.cuda.empty_cache()
    return out


def made_cases(f32, dev):
    """Kernels G and H vs their plain versions at made's shapes at
    hidden_size=2048 and bs=64, with made's own masks
    (create_made_masks(784, (2048,) * 3, 42)): G at the four forward
    products, the widest first, and at the dX product of a hidden layer
    with w and its mask read as (N, K); H at the weight gradients of a
    hidden layer and of the input layer, x read as (K, M). Tolerance atol
    1e-3 + rtol 1e-3: the same bf16-rounded operands on both sides, f32
    sums of up to 2048 products in another order (~1e-6 relative). H must
    be exactly 0 wherever its mask is 0. G's two launches on the same inputs
    must be bitwise equal (its K splits are summed in a fixed order). Then G
    untimed at ragged shapes in both layouts, with random {0, 1} masks: M
    past 64 and not a multiple of 64, K shorter than one split's share, N
    not a multiple of 16 (plain loads instead of 16-byte cp.async).
    library_ms: torch.matmul on bf16
    operands with the weight already masked (for H, the unmasked x^T g), the
    product the premasked route pays for instead. ms_l2_cold: the kernel's
    device time with L2 flushed before each launch, as in a made request,
    whose four layers' weights and masks do not fit in L2 together, against
    ms, where the one layer's operands stay in L2 across the iterations.
    H launches twice on the same inputs and must be bitwise equal too, and
    is checked untimed at ragged shapes and odd K. library_f32_out_ms for
    H: torch.mm with an f32 result, where this PyTorch offers it
    (torch.matmul on bf16 writes a bf16 dW, half of H's bytes)."""
    from generative_models_tpu_torch.models.made import create_made_masks
    from generative_models_tpu_torch.ops.masked_dense import (
        mask_out_matmul, mask_out_matmul_plain, masked_matmul, masked_matmul_plain,
    )

    masks = [torch.tensor(m, device=dev).to(torch.uint8)
             for m in create_made_masks(784, (2048,) * 3, 42)]
    tol = dict(atol=1e-3, rtol=1e-3)
    bf, B = torch.bfloat16, 64
    library_covers = 'torch.matmul, bf16 operands, the weight already masked'
    g_cases, h_cases = [], []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for layer, trans_b in ((1, False), (0, False), (2, False), (3, False), (1, True)):
        m = masks[layer]
        K, N = m.shape
        w = f32(K, N, scale=K ** -0.5)
        wmb = (w * m).to(bf)
        if trans_b:  # dX = g @ (w * m)^T: g (B, N), output (B, K)
            x = f32(B, N)
            kern = lambda: masked_matmul(x, w, m, trans_b=True)
            plain = lambda: masked_matmul_plain(x, w.t(), m.t())
            xb = x.to(bf)
            lib = lambda: torch.matmul(xb, wmb.t())
            dims, shape = (B, N, K), f'dX g ({B},{N}) x (w*m)^T, w ({K},{N}) read as (N, K)'
        else:
            x = f32(B, K)
            kern = lambda: masked_matmul(x, w, m)
            plain = lambda: masked_matmul_plain(x, w, m)
            xb = x.to(bf)
            lib = lambda: torch.matmul(xb, wmb)
            dims, shape = (B, K, N), f'x ({B},{K}) x w ({K},{N})'
        err = compare(f'masked_matmul {shape}', _twice_bitwise(f'masked_matmul {shape}', kern),
                      plain(), **tol)
        M_, K_, N_ = dims
        # f32 x and w read once, the uint8 mask once, the f32 output written
        bms, by = bound(4 * M_ * K_ + 5 * K_ * N_ + 4 * M_ * N_, 2 * M_ * K_ * N_)
        g_cases.append(dict(shape=shape, path='made', layer=layer, max_abs_err=err, **tol,
                            bound_ms=bms, bound_by=by, library_covers=library_covers,
                            ms_l2_cold=l2_cold_ms(kern, 'masked_matmul_kernel', flush),
                            **timings(kern, plain, lib)))
    rng = np.random.RandomState(1)
    for (M, K, N), trans_b in itertools.product(((10, 72, 136), (80, 40, 136), (200, 784, 130)),
                                                (False, True)):
        x, m = f32(M, K), torch.tensor(rng.rand(K, N) < 0.5, device=dev).to(torch.uint8)
        w = f32(K, N, scale=K ** -0.5)
        wl, ml = (w.t().contiguous(), m.t().contiguous()) if trans_b else (w, m)
        shape = f'ragged x ({M},{K}) x w ({K},{N}){" read as (N, K)" if trans_b else ""}'
        got = _twice_bitwise(f'masked_matmul {shape}',
                             lambda: masked_matmul(x, wl, ml, trans_b=trans_b))
        err = compare(f'masked_matmul {shape}', got, masked_matmul_plain(x, w, m), **tol)
        g_cases.append(dict(shape=shape, path='ragged', max_abs_err=err, **tol))
    for layer in (1, 0):
        m = masks[layer]
        K, N = m.shape
        x, g = f32(B, K), f32(B, N)
        shape = f'dW x^T ({K},{B}) x g ({B},{N}), x read as (K, M)'
        kern = lambda: mask_out_matmul(x, g, m)
        got = _twice_bitwise(f'mask_out_matmul {shape}', kern)
        err = compare(f'mask_out_matmul {shape}', got, mask_out_matmul_plain(x.t(), g, m), **tol)
        if got[m == 0].any():
            raise AssertionError(f'mask_out_matmul {shape}: non-zero off the mask')
        xb, gb = x.to(bf), g.to(bf)
        bms, by = bound(4 * B * K + 4 * B * N + 5 * K * N, 2 * K * B * N)
        h_cases.append(dict(
            shape=shape, path='made', layer=layer, max_abs_err=err, **tol,
            exact_zero_off_mask=True, bitwise_twice=True, bound_ms=bms, bound_by=by,
            library_covers='torch.matmul, bf16 operands, unmasked, a bf16 result',
            ms_l2_cold=l2_cold_ms(kern, 'mask_out_matmul_kernel', flush),
            library_f32_out_ms=_f32_out_mm_ms(xb, gb),
            **timings(kern, lambda: mask_out_matmul_plain(x.t(), g, m),
                      lambda: torch.matmul(xb.t(), gb)),
        ))
    # H untimed where the tile is ragged (M not a multiple of 64, N of 128),
    # at K = 1, 10, 37 and 200 (one and four 64-deep chunks), with random
    # {0, 1} masks; M not a multiple of 4 or N of 16, and x a view at an odd
    # offset (4 bytes past a 16-byte boundary), take the plain-load route
    for M, K, N, odd in ((200, 37, 130, False), (784, 10, 784, False), (64, 1, 2048, False),
                         (300, 200, 272, False), (784, 64, 2048, True)):
        m = torch.tensor(rng.rand(M, N) < 0.5, device=dev).to(torch.uint8)
        x = f32(K * M + 1)[1:].view(K, M) if odd else f32(K, M)
        g = f32(K, N)
        shape = f'ragged dW x^T ({M},{K}) x g ({K},{N}){", x at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'mask_out_matmul {shape}', lambda: mask_out_matmul(x, g, m))
        err = compare(f'mask_out_matmul {shape}', got, mask_out_matmul_plain(x.t(), g, m), **tol)
        if got[m == 0].any():
            raise AssertionError(f'mask_out_matmul {shape}: non-zero off the mask')
        h_cases.append(dict(shape=shape, path='ragged', max_abs_err=err, **tol,
                            exact_zero_off_mask=True, bitwise_twice=True))
    del flush
    torch.cuda.empty_cache()
    return g_cases, h_cases


def _f32_out_mm_ms(xb, gb):
    """Device ms of torch.mm(xb^T, gb, out_dtype=torch.float32): bf16
    operands and the f32 result that H writes, the library's own product
    with H's output bytes, where this PyTorch's mm takes out_dtype (it is
    timed, never used by the port); else None."""
    try:
        torch.mm(xb.t(), gb, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        log(f'[kernels] torch.mm(..., out_dtype=torch.float32) is not available here: {e}')
        return None
    return device_ms(lambda: torch.mm(xb.t(), gb, out_dtype=torch.float32), 200)


def int8_cases(rng, dev):
    """Kernels I and J vs their plain versions at every product of the
    quantized serving paths at serve_bs=64 (pixel_transformer's, the vqvae
    prior's, made's at hidden_size=1024, rnn's wh, which is the prior's fc1
    shape, wavenet's res1x1, and the diffusion UNet's: the ResBlocks' emb
    projections (64,256)->128, its embedding MLPs' (64,64)->256 and
    (64,256)->256 being the vqvae prior's shapes, and all three at M=128,
    where --fused_cfg=1 doubles the batch) and at four ragged shapes, the
    ragged ones untimed, and I alone at K=100000 (a deep split, sums of
    1.6e9 near int32's limit). I must be bitwise equal (integer sums; the
    plain version in float64 is exact); J within atol 1e-3 + rtol 1e-3 (the
    same bf16 x and int8 q on both sides, f32 sums of up to 1024 products
    in another order); both launched twice on the same inputs bitwise equal
    (their K splits are summed in a fixed order). ms_l2_cold for I at made's
    three products and for I and J at wavenet's res1x1 (320 x 320) and at
    the diffusion shapes: with L2 flushed before each launch, as in a made
    request, whose layers' weights pass through L2 in turn. Bound: I reads
    int8 x and q and writes int32, J reads
    f32 x (it rounds x to bf16 itself) and int8 q and writes f32; their
    operations at the int8 and the bf16 peak. library_ms: torch._int_mm for
    I (it takes M > 16 and K, N multiples of 8: the path shapes only), and
    for J torch.matmul on bf16 x and a bf16 weight widened ahead of time,
    the weight traffic w8a16 avoids."""
    from generative_models_tpu_torch.ops.int8 import (
        dequant_gemm, dequant_gemm_plain, int8_gemm, int8_gemm_plain,
    )

    shapes = (((64, 128, 128), 'pixel_transformer query/key/value/proj'),
              ((64, 128, 512), 'pixel_transformer fc1'), ((64, 512, 128), 'pixel_transformer fc2'),
              ((64, 64, 256), 'vqvae prior embed'),
              ((64, 256, 256), 'vqvae prior query/key/value/proj'),
              ((64, 256, 1024), 'vqvae prior fc1, rnn wh'), ((64, 1024, 256), 'vqvae prior fc2'),
              ((64, 256, 64), 'vqvae prior head'), ((64, 784, 1024), 'made layer 0'),
              ((64, 1024, 1024), 'made layers 1, 2'), ((64, 1024, 784), 'made layer 3'),
              ((64, 320, 320), 'wavenet res1x1'),
              ((64, 256, 128), 'diffusion emb projection'),
              ((128, 64, 256), 'diffusion time_embed dense0, fused_cfg'),
              ((128, 256, 256), 'diffusion embedding dense1, fused_cfg'),
              ((128, 256, 128), 'diffusion emb projection, fused_cfg'),
              ((10, 72, 136), 'ragged'), ((6, 130, 70), 'ragged'), ((80, 130, 70), 'ragged'),
              ((72, 40, 130), 'ragged'))
    i8 = lambda *s: torch.tensor(rng.randint(-127, 128, s), dtype=torch.int8, device=dev)
    tol_j = dict(atol=1e-3, rtol=1e-3)
    i_cases, j_cases = [], []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for (M, K, N), path in shapes:
        x8, q = i8(M, K), i8(K, N)
        xf = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        shape = f'x ({M},{K}) x q ({K},{N})'
        if not torch.equal(_twice_bitwise(f'int8_gemm {shape}', lambda: int8_gemm(x8, q)),
                           int8_gemm_plain(x8, q)):
            raise AssertionError(f'int8_gemm {shape}: not bitwise equal to its plain version')
        got = _twice_bitwise(f'dequant_gemm {shape}', lambda: dequant_gemm(xf, q))
        err = compare(f'dequant_gemm {shape}', got, dequant_gemm_plain(xf, q), **tol_j)
        ci = dict(shape=shape, path=path, max_abs_err=0.0, atol=0.0, rtol=0.0, bitwise=True,
                  bitwise_twice=True)
        cj = dict(shape=shape, path=path, max_abs_err=err, **tol_j, bitwise_twice=True)
        if path != 'ragged':
            xb, wb = xf.to(torch.bfloat16), q.to(torch.bfloat16)
            bms, by = bound(M * K + K * N + 4 * M * N, 2 * M * K * N, peak=H100_INT8_OPS)
            if path.startswith(('made', 'wavenet', 'diffusion')):
                ci['ms_l2_cold'] = l2_cold_ms(lambda: int8_gemm(x8, q), 'int8_gemm_kernel', flush)
            if path.startswith(('wavenet', 'diffusion')):
                cj['ms_l2_cold'] = l2_cold_ms(lambda: dequant_gemm(xf, q), 'dequant_gemm_kernel',
                                              flush)
            ci.update(bound_ms=bms, bound_by=by, library_covers='torch._int_mm', **timings(
                lambda: int8_gemm(x8, q), lambda: int8_gemm_plain(x8, q),
                lambda: torch._int_mm(x8, q), iters=50))
            bms, by = bound(4 * M * K + K * N + 4 * M * N, 2 * M * K * N)
            cj.update(bound_ms=bms, bound_by=by,
                      library_covers='torch.matmul, bf16 x and a bf16 weight widened ahead',
                      **timings(lambda: dequant_gemm(xf, q), lambda: dequant_gemm_plain(xf, q),
                                lambda: torch.matmul(xb, wb), iters=50))
        i_cases.append(ci)
        j_cases.append(cj)
    del flush
    M, K, N = 3, 100000, 16  # a deep K: 8 splits of 196 stages
    x8 = torch.full((M, K), -127, dtype=torch.int8, device=dev)
    x8[1] = i8(K)
    q = torch.full((K, N), 127, dtype=torch.int8, device=dev)
    q[:, 1:] = i8(K, N - 1)
    shape = f'x ({M},{K}) x q ({K},{N})'
    got = _twice_bitwise(f'int8_gemm {shape}', lambda: int8_gemm(x8, q))
    if not torch.equal(got, int8_gemm_plain(x8, q)):
        raise AssertionError(f'int8_gemm {shape}: not bitwise equal to its plain version')
    i_cases.append(dict(shape=shape, path='deep K', max_abs_err=0.0, atol=0.0, rtol=0.0,
                        bitwise=True, bitwise_twice=True, extreme=int(got.abs().max())))
    return i_cases, j_cases


def _counters():
    """Every kernel wrapper; each counts its own launches."""
    from generative_models_tpu_torch.ops.common import kernel_counters

    return kernel_counters()


def _reset(counters):
    for fn in counters:
        fn.launches = 0


def _read(counters):
    return {fn.__name__: fn.launches for fn in counters}


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.read()


def phase_slice():
    """The main path through its entry points, with exact launch counts."""
    from generative_models_tpu_torch.serve import _http_serve, load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(['--model=pixel_transformer', '--serve_bs=64'])
    model = server.model
    warm = server.warm()
    log(f'[slice] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    httpd = _http_serve(server, 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, png = _get(f'http://127.0.0.1:{port}/sample?n=16&seed=3')
        st2, health = _get(f'http://127.0.0.1:{port}/healthz')
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    x = torch.as_tensor(a, device=model.device).reshape(64, model.block_size, 1)
    t1 = time.time()
    nlogp = model.eval_loss(x)['nlogp']
    torch.cuda.synchronize()
    score_sec = time.time() - t1
    launches = _read(counters)
    log(f'[slice] launches {launches}')

    # warm (the eager pass and the capture) + 4 requests
    T, L, passes = model.block_size, int(G.n_layer), server.warm_passes + 4
    expected = {
        'ln_matmul': (L + 1) * T * passes,
        'block_tail': L * T * passes,
        'causal_attention_fwd': L,  # one scoring forward
        'flash_bwd_dq': 0, 'flash_bwd_dkv': 0,  # serving runs no backward
        'vq_one_hot': 0, 'masked_matmul': 0, 'mask_out_matmul': 0,
        'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'launch counts {launches} != expected {expected}')
    if th.is_alive():
        raise AssertionError('HTTP server thread did not stop')
    if st != 200 or png[:8] != b'\x89PNG\r\n\x1a\n' or st2 != 200:
        raise AssertionError(f'HTTP: /sample {st}, /healthz {st2}')
    stats = json.loads(health)
    if stats['requests'] != 4:
        raise AssertionError(f'/healthz requests {stats["requests"]} != 4')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'{name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('seed=7 twice gave different batches')
    if not np.isfinite(nlogp):
        raise AssertionError(f'nlogp {nlogp}')
    log(f'[slice] nlogp of the seed=7 batch {nlogp:.6f} (scoring {score_sec * 1e3:.1f} ms)')
    log(f'[slice] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    log(f'[slice] /healthz {json.dumps(stats)}')

    checks = teacher_force(model, x, nlogp)
    return dict(
        launches=launches, passes=passes, latencies=list(server.latencies),
        warm_sec=warm, score_ms=score_sec * 1e3, checks=checks,
        server=server, x=x,
    )


def teacher_force(model, x, nlogp):
    """Hold the sampled batch against the other ways of computing its
    logits."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        TransformerNet, teacher_forced_logits,
    )
    from generative_models_tpu_torch.utils.dists import Bernoulli

    net, T = model.net, model.block_size
    segments = 4  # the card's default, as the requests ran
    out = {}
    # the kernel decode chain at the request's segments and uniforms redraws
    # the request's tokens exactly: same ops on the same inputs
    u = torch.rand((T, 64, 1), generator=torch.Generator(model.device).manual_seed(7),
                   device=model.device)
    lk = teacher_forced_logits(net, x, segments)
    redrawn = Bernoulli(logits=lk).sample(uniforms=u.permute(1, 0, 2))
    flips = int((redrawn != x).sum())
    if flips:
        raise AssertionError(f'kernel decode redraws {flips} tokens differently')
    # bf16 tolerance: the logits pass ~10 bf16 roundings of O(1) values
    # (2^-8 relative each) in sequence; the two sides round at different
    # points (per-op chain vs kernels, dense attention vs decode cache)
    tol = dict(atol=5e-2, rtol=5e-2)
    net.use_fused_decode = False
    try:
        lp = teacher_forced_logits(net, x, segments)
    finally:
        net.use_fused_decode = True
    out['plain_decode_vs_kernel_decode'] = compare('plain vs kernel decode', lp, lk, **tol)
    with torch.no_grad():
        lf = net(x).logits
    out['full_forward_vs_kernel_decode'] = compare('full forward vs kernel decode', lf, lk, **tol)
    nlogp_decode = float(-Bernoulli(logits=lk).log_prob(x).mean())
    out['nlogp_forward_minus_decode'] = abs(nlogp - nlogp_decode)
    if out['nlogp_forward_minus_decode'] > 1e-3:
        raise AssertionError(f'nlogp forward {nlogp} vs decode {nlogp_decode}')
    # the card against the CPU's exact f32 forward, on four samples
    cpu = TransformerNet(1, T, net.n_embed, net.n_head, len(net.blocks))
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    with torch.no_grad():
        lc = cpu(x[:4].cpu()).logits
    out['card_vs_cpu_f32_forward'] = compare('card vs CPU forward', lf[:4].cpu(), lc, **tol)
    out.update(tol)
    log(f'[slice] teacher-forced checks {json.dumps(out)}')
    return out


def phase_train(seq=1):
    """The training path through main.main, with exact launch counts;
    seq > 1 runs it under --mesh=seq:<seq> (the seq_train phase), attention
    through the ring: Kernel K once a hop of every forward, L and M once a
    hop of every backward, and sampling on the per-op chain (no A or B)."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    label, logdir = ('train', TRAIN_DIR) if seq == 1 else ('seq_train', SEQ_TRAIN_DIR)
    train_n, test_n, bs, L, T = 640, 128, 64, 2, 784
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(logdir, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main([
        '--model=pixel_transformer', f'--bs={bs}', '--epochs=1', '--save_n=1',
        '--data_source=synthetic', f'--logdir={logdir}',
    ] + ([f'--mesh=seq:{seq}'] if seq > 1 else []))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[{label}] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = dict.fromkeys(launches, 0)
    if seq == 1:
        expected.update({
            'ln_matmul': (L + 1) * T * evals,  # evaluate samples 25 each epoch
            'block_tail': L * T * evals,
            'causal_attention_fwd': L * (eval_batches * evals + steps),
            'flash_bwd_dq': L * steps,
            'flash_bwd_dkv': L * steps,
        })
    else:
        expected.update({
            'ring_chunk_fwd': L * seq * (steps + eval_batches * evals),
            'ring_chunk_bwd_dq': L * seq * steps,
            'ring_chunk_bwd_dkv': L * seq * steps,
        })
    if launches != expected:
        raise AssertionError(f'{label} launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        if not (logdir / name).is_file():
            raise AssertionError(f'{label}: {name} was not written')
    if (logdir / 'sampling_process_0.gif').read_bytes()[:6] != b'GIF89a':
        raise AssertionError(f'{label}: sampling_process_0.gif is not a GIF')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'{label}: non-finite metrics at epoch {i}: {bad}')
    keys = {'eval/nlogp', 'eval/bits_per_dim', 'train/nlogp', 'dt/train', 'dt/eval', 'num_vars'}
    if not keys <= set(history[1]):
        raise AssertionError(f'{label}: epoch 1 logged {sorted(history[1])}, '
                             f'missing {keys - set(history[1])}')
    nlogp = [h['eval/nlogp'] for h in history]
    if not nlogp[1] < nlogp[0]:
        raise AssertionError(f'{label}: eval/nlogp did not fall: {nlogp}')
    log(f'[{label}] eval/nlogp {nlogp}, train/nlogp {history[1]["train/nlogp"]}, '
        f'dt/train {history[1]["dt/train"]:.3f}s for {steps} steps, dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def _cpu_copy(model, G, dtype=None, **over):
    """The same model on the CPU (f32 throughout) with the card's weights;
    over sets flags of the copy; dtype: wavenet's compute dtype, which the
    CPU copy otherwise takes as f32."""
    Gc = type(G)(G)
    Gc.device = 'cpu'
    Gc.update(over)
    cpu = type(model)(Gc)
    if dtype is not None:
        cpu.net = cpu.build(dtype)
    cpu.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    return cpu


def _copy_opt(dst, name, src):
    """The state of the optimizer src into dst's optimizer name, in dst's
    form (GM._laid_out_opt: the CPU's float Adam, the card's capturable
    one), sharing no tensor."""
    sd = copy.deepcopy(src.state_dict())
    sd['state'] = {i: {k: v.cpu() for k, v in st.items()} for i, st in sd['state'].items()}
    opt = dst.optimizers()[name]
    opt.load_state_dict(dst._laid_out_opt(opt, sd))


def grad_check(label, model, cpu, rel=5e-2, floor=1e-4):
    """Every parameter's gradient on the card (already in p.grad) against
    the CPU copy's: finite, non-zero, and within a bf16 tolerance."""
    ref = dict(cpu.net.named_parameters())
    total = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in ref.values()
                                 if p.grad is not None)))
    # bf16 operands round each product's inputs by up to 2^-8 relative, and
    # a gradient passes ~10 such products: its relative error sits near
    # 1e-2, so rel = 5e-2 of its own norm, plus floor = 1e-4 of the whole
    # gradient's norm for key.bias, whose exact gradient is 0 (softmax is
    # shift-invariant)
    out, off_graph, over = {}, [], []
    for name, p in model.net.named_parameters():
        g = p.grad
        if g is None and ref[name].grad is None:
            off_graph.append(name)  # on neither side's graph (the gated net's last ln_v)
            continue
        if g is None or not torch.isfinite(g).all() or not g.any():
            raise AssertionError(f'{label}: {name} has no finite non-zero gradient on the card')
        gr = ref[name].grad.double()
        err = float(torch.linalg.vector_norm(g.cpu().double() - gr))
        ref_norm = float(torch.linalg.vector_norm(gr))
        if err > rel * ref_norm + floor * total:
            over.append(f'{name} |card - cpu| {err:.3g} vs |cpu| {ref_norm:.3g}')
        out[name] = err / max(ref_norm, 1e-30)
    worst = max(out, key=out.get)
    log(f'[{label}] {len(out)} parameters finite and non-zero; relative error vs the CPU copy '
        f'max {out[worst]:.3g} ({worst}), median {sorted(out.values())[len(out) // 2]:.3g}; '
        f'tolerance {rel} of the norm + {floor} of |all grads| = {total:.4g}; worst: '
        f'{json.dumps({k: round(out[k], 5) for k in sorted(out, key=out.get)[-4:]})}'
        + (f'; no gradient on either side: {off_graph}' if off_graph else '')
        + (f'; every relative error: {json.dumps({k: float(f"{v:.4g}") for k, v in out.items()})}'
           if over else ''))
    if over:
        raise AssertionError(f'{label}: {over}')
    return dict(rel_err=out, rtol_norm=rel, atol_of_total=floor, off_graph=off_graph)


def phase_grads(seq=1):
    """One batch's gradients on the card against a CPU f32 copy; seq > 1
    (the seq_grads phase) from the seq_train phase's model.pt, whose
    hps.yaml keeps --mesh=seq:<seq>: the card's gradients through the ring
    against an unsharded CPU copy (the normal path, dense attention)."""
    from generative_models_tpu_torch.main import load_model_and_data

    logdir = TRAIN_DIR if seq == 1 else SEQ_TRAIN_DIR
    model, dataset, _, _, G = load_model_and_data([
        f'--weights_from={logdir / "model.pt"}', '--data_source=synthetic',
    ])
    if model.net.ring != seq:
        raise AssertionError(f'grads: the reloaded model runs a ring of {model.net.ring}, not {seq}')
    x = dataset.first_test_batch(0)[0][:8]
    model.backward(x)
    cpu = _cpu_copy(model, G, mesh='')
    cpu.backward(x.cpu())
    return model, dataset, grad_check('grads' if seq == 1 else 'seq_grads', model, cpu)


def phase_vq_serve():
    """vqvae's serving path through load_server, with exact launch counts:
    per pass the prior's T=49 decode steps, Kernels A and B only."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(['--model=vqvae', '--serve_bs=64'])
    warm = server.warm()
    log(f'[vq_serve] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[vq_serve] launches {launches}')
    # warm (the eager pass and the capture) + 3 requests
    T, L, passes = server.model.n_codes, int(G.n_layer), server.warm_passes + 3
    expected = {
        'ln_matmul': (L + 1) * T * passes, 'block_tail': L * T * passes,
        'causal_attention_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0, 'vq_one_hot': 0,
        'masked_matmul': 0, 'mask_out_matmul': 0, 'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'vqvae serve launch counts {launches} != expected {expected}')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'vqvae {name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('vqvae seed=7 twice gave different batches')
    log(f'[vq_serve] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = vq_teacher_force(server.model, a)
    return dict(launches=launches, passes=passes, latencies=list(server.latencies),
                warm_sec=warm, checks=checks, server=server)


def vq_teacher_force(model, batch):
    """Redraw the seed=7 request's codes and hold them against the other
    ways of computing the prior's logits."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        teacher_forced_logits, transformer_sample_scan,
    )
    from generative_models_tpu_torch.utils.dists import Categorical

    prior, T, K, n = model.net.prior, model.n_codes, int(model.G.vqK), 64
    u = torch.rand((T, n, K), generator=torch.Generator(model.device).manual_seed(7),
                   device=model.device)
    with torch.no_grad():
        tokens = transformer_sample_scan(
            prior, n, lambda logits, ut: Categorical(logits).sample(uniforms=ut), u)
        codes = tokens.permute(1, 0, 2).contiguous()  # (n, T, K)
        imgs = (torch.sigmoid(model.net.ae.decode_codes(codes)) > 0.5).float()
    # the request is this draw, decoded: the same images
    if not np.array_equal(imgs.cpu().numpy(), batch):
        raise AssertionError('vqvae: the seed=7 codes do not decode to the request')
    out = {}
    lk = teacher_forced_logits(prior, codes)
    redrawn = Categorical(lk).sample(uniforms=u.permute(1, 0, 2))
    flips = int((redrawn != codes).any(-1).sum())
    if flips:
        raise AssertionError(f'vqvae: kernel decode redraws {flips} codes differently')
    # bf16 tolerance, as for pixel_transformer's teacher-forced checks
    tol = dict(atol=5e-2, rtol=5e-2)
    with torch.no_grad():
        lf = prior(codes).logits
    out['full_forward_vs_kernel_decode'] = compare('vqvae full forward vs kernel decode',
                                                   lf, lk, **tol)
    cpu = _cpu_copy(model, model.G)
    with torch.no_grad():
        lc = cpu.net.prior(codes[:4].cpu()).logits
        dc = cpu.net.ae.decode_codes(codes[:4].cpu())
        dk = model.net.ae.decode_codes(codes[:4])
    out['card_vs_cpu_f32_prior'] = compare('vqvae card vs CPU prior', lf[:4].cpu(), lc, **tol)
    # the decoder in f32 on both sides (TF32 off): sums in another order
    out['card_vs_cpu_f32_decoder'] = compare('vqvae card vs CPU decoder', dk.cpu(), dc,
                                             atol=1e-4, rtol=1e-4)
    out.update(tol)
    log(f'[vq_serve] teacher-forced checks {json.dumps(out)}')
    return out


def phase_vq_train():
    """vqvae's training path through main.main, with exact launch counts."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    train_n, test_n, bs, L, T = 640, 128, 64, 2, 49
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(VQ_TRAIN_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main([
        '--model=vqvae', f'--bs={bs}', '--epochs=1', '--save_n=1',
        '--data_source=synthetic', f'--logdir={VQ_TRAIN_DIR}',
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[vq_train] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = {
        # a train step, an eval batch and evaluate's 8-image reconstruction
        # each quantize once
        'vq_one_hot': steps + eval_batches * evals + evals,
        'causal_attention_fwd': L * (steps + eval_batches * evals),
        'flash_bwd_dq': L * steps,
        'flash_bwd_dkv': L * steps,
        'ln_matmul': (L + 1) * T * evals,  # evaluate samples 25 each epoch
        'block_tail': L * T * evals,
        'masked_matmul': 0, 'mask_out_matmul': 0, 'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'vqvae train launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml'):
        if not (VQ_TRAIN_DIR / name).is_file():
            raise AssertionError(f'vqvae train: {name} was not written')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'vqvae train: non-finite metrics at epoch {i}: {bad}')
    keys = {f'vqvae/{split}/{k}' for split in ('train', 'test')
            for k in ('vq_vae_loss', 'recon_loss', 'embed_loss', 'perplexity', 'prior_loss')}
    if not keys <= set(history[1]):
        raise AssertionError(f'vqvae train: epoch 1 is missing {keys - set(history[1])}')
    recon = [h['vqvae/test/recon_loss'] for h in history]
    if not recon[1] < recon[0]:
        raise AssertionError(f'vqvae train: test recon_loss did not fall: {recon}')
    perp = [h[k] for h in history for k in h if k.endswith('/perplexity')]
    if not all(1.0 <= p <= 64.0 for p in perp):
        raise AssertionError(f'vqvae train: perplexity outside [1, 64]: {perp}')
    log(f'[vq_train] test recon_loss {recon}, perplexity {perp}, prior_loss '
        f'{[h["vqvae/test/prior_loss"] for h in history]}, dt/train '
        f'{history[1]["dt/train"]:.3f}s for {steps} steps, dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def phase_vq_grads():
    """One batch's gradients on the card, every AE and prior parameter,
    against a CPU f32 copy; and how many codes the two assign
    differently."""
    from generative_models_tpu_torch.main import load_model_and_data

    model, dataset, _, _, G = load_model_and_data([
        f'--weights_from={VQ_TRAIN_DIR / "model.pt"}', '--data_source=synthetic',
    ])
    x = dataset.first_test_batch(0)[0]
    model.backward(x)
    cpu = _cpu_copy(model, G)
    cpu.backward(x.cpu())
    with torch.no_grad():
        idx, idx_cpu = model.net.ae(x)[3], cpu.net.ae(x.cpu())[3]
    codes_differ = int((idx.cpu() != idx_cpu).sum())
    log(f'[vq_grads] codes that differ between the card and the CPU copy: '
        f'{codes_differ} of {idx.numel()}')
    out = grad_check('vq_grads', model, cpu)
    out['codes_differ'] = codes_differ
    return model, dataset, out


def phase_made_serve():
    """made's serving path at hidden_size=2048 through load_server, with
    exact launch counts: per pass 784 steps of one full forward, Kernel G
    once a layer, and nothing else."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(MADE_FLAGS + ['--serve_bs=64'])
    if not server.model.net.use_kernel:
        raise AssertionError('made at hidden_size=2048 did not take the kernel route')
    warm = server.warm()
    log(f'[made_serve] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[made_serve] launches {launches}')
    # warm (the eager pass and the capture) + 3 requests
    nin, layers, passes = server.model.nin, server.model.net.n_layers, server.warm_passes + 3
    expected = dict.fromkeys(launches, 0)
    expected['masked_matmul'] = nin * layers * passes
    if launches != expected:
        raise AssertionError(f'made serve launch counts {launches} != expected {expected}')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'made {name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('made seed=7 twice gave different batches')
    log(f'[made_serve] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = made_checks(server.model, a)
    return dict(launches=launches, passes=passes, per_pass=launches['masked_matmul'] // passes,
                latencies=list(server.latencies), warm_sec=warm, checks=checks, server=server)


def made_checks(model, batch):
    """Causality of the kernel route on the card, bitwise: changing inputs
    j >= i leaves logit i unchanged (the masks inside Kernel G, and its
    fixed summation order). Then the card's logits against a CPU f32 copy on
    the fold-the-mask route (the same function) on the seed=7 batch."""
    x = torch.as_tensor(batch, device=model.device).reshape(-1, model.nin)
    canvas = (torch.rand(x.shape, generator=torch.Generator(model.device).manual_seed(3),
                         device=model.device) < 0.5).float()
    out = {'causal_bitwise_at': [0, 1, 2, 100, 400, 600, 782, 783]}
    with torch.no_grad():
        ref = model.net(canvas)
        for i in out['causal_bitwise_at']:
            changed = canvas.clone()
            changed[:, i:] = 1 - changed[:, i:]
            logits = model.net(changed)
            if not torch.equal(logits[:, :i + 1], ref[:, :i + 1]):
                raise AssertionError(f'made: logits up to {i} moved when inputs >= {i} changed')
            # (near the end a flip may reach no later logit through a live unit)
            if i <= 600 and torch.equal(logits[:, i + 1:], ref[:, i + 1:]):
                raise AssertionError(f'made: logits past {i} did not move')
        cpu = _cpu_copy(model, model.G, premasked=0)
        lk = model.net(x[:8])
        lc = cpu.net(x[:8].cpu())
    # bf16 operands at four layers (2^-8 relative each), f32 sums
    tol = dict(atol=5e-2, rtol=5e-2)
    out['card_vs_cpu_f32_logits'] = compare('made card vs CPU logits', lk.cpu(), lc, **tol)
    out.update(tol)
    log(f'[made_serve] checks {json.dumps(out)}')
    return out


def phase_made_default():
    """One made serving pass at the default width, hidden_size=1024: the
    gate keeps the reference's premasked route there, so neither Kernel G
    nor H launches."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    server, _ = load_server(['--model=made', '--serve_bs=64'])
    if server.model.net.use_kernel or not server.model.net.premasked:
        raise AssertionError('made at hidden_size=1024 left the premasked route')
    s = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'made at hidden_size=1024 launched kernels: {launches}')
    if s.shape != (64, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
        raise AssertionError(f'made hidden_size=1024: shape {s.shape} or values outside {{0, 1}}')
    log(f'[made_default] hidden_size=1024: launches {launches}, request {server.latencies[-1]:.4f}s')
    return dict(launches=launches, request_sec=server.latencies[-1])


def phase_made_train():
    """made's training path through main.main at hidden_size=2048, with
    exact launch counts."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    train_n, test_n, bs, layers, nin = 640, 128, 64, 4, 784
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(MADE_TRAIN_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main(MADE_FLAGS + [
        f'--bs={bs}', '--epochs=1', '--save_n=1', '--data_source=synthetic',
        f'--logdir={MADE_TRAIN_DIR}',
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[made_train] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = dict.fromkeys(launches, 0)
    # a train step: G for each layer's forward and for the dX of every layer
    # but the first (its input is the data); H for each layer's dW. An eval
    # batch: the forward. evaluate: 25 samples, 784 forwards, each epoch.
    expected['masked_matmul'] = (steps * (2 * layers - 1) + eval_batches * evals * layers
                                 + evals * nin * layers)
    expected['mask_out_matmul'] = steps * layers
    if launches != expected:
        raise AssertionError(f'made train launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        if not (MADE_TRAIN_DIR / name).is_file():
            raise AssertionError(f'made train: {name} was not written')
    if (MADE_TRAIN_DIR / 'sampling_process_1.gif').read_bytes()[:6] != b'GIF89a':
        raise AssertionError('made train: sampling_process_1.gif is not a GIF')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'made train: non-finite metrics at epoch {i}: {bad}')
    keys = {'eval/nlogp', 'eval/bits_per_dim', 'train/nlogp', 'dt/train', 'dt/eval', 'num_vars'}
    if not keys <= set(history[1]):
        raise AssertionError(f'made train: epoch 1 is missing {keys - set(history[1])}')
    nlogp = [h['eval/nlogp'] for h in history]
    if not nlogp[1] < nlogp[0]:
        raise AssertionError(f'made train: eval/nlogp did not fall: {nlogp}')
    log(f'[made_train] eval/nlogp {nlogp}, train/nlogp {history[1]["train/nlogp"]}, '
        f'dt/train {history[1]["dt/train"]:.3f}s for {steps} steps, '
        f'dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def phase_made_grads():
    """One batch's gradients on the card (the kernel route: Kernels G and
    H) from the trained model.pt, against a CPU f32 copy on the
    fold-the-mask route (autograd through x @ (w * m)): finite, non-zero,
    within the bf16 tolerance, and dW exactly 0 off the mask on both."""
    from generative_models_tpu_torch.main import load_model_and_data

    model, dataset, _, _, G = load_model_and_data([
        f'--weights_from={MADE_TRAIN_DIR / "model.pt"}', '--data_source=synthetic',
    ])
    if not model.net.use_kernel:
        raise AssertionError('made grads: the reloaded model left the kernel route')
    x = dataset.first_test_batch(0)[0]
    model.backward(x)
    cpu = _cpu_copy(model, G, premasked=0)
    cpu.backward(x.cpu())
    for net, where in ((model.net, 'card'), (cpu.net, 'CPU copy')):
        for w, _, m in net.layers():
            if w.grad[m == 0].any():
                raise AssertionError(f'made grads: dW off the mask on the {where}')
    return model, dataset, grad_check('made_grads', model, cpu)


def _live_resblocks(model, seed=0):
    """Draw every ResBlock's output conv, which starts at zero (so that each
    block passes its input through and ignores the time and class
    embedding), with the lecun-normal scale of the other convs, from a
    CPU generator seeded with seed: random weights on which every layer of
    the UNet acts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for block in model.net.blocks:
            w = block.conv1.weight
            std = (1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5
            w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * std)


def _rel(got, ref):
    """Relative Frobenius error of got against ref (float64, on the CPU)."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def _check_samples(label, s, n):
    if s.shape != (n, 28, 28, 1) or not np.isfinite(s).all() or s.min() < 0 or s.max() > 1:
        raise AssertionError(f'{label}: shape {s.shape}, finite {np.isfinite(s).all()}, '
                             f'range [{s.min()}, {s.max()}] (want (n, 28, 28, 1) in [0, 1])')


def phase_diff_serve():
    """diffusion_model's class-conditional serving path at its default
    configuration (hidden_size=128, timesteps=250, v, ddim, bf16) through
    load_server at serve_bs=64, random weights from seed 0: warm, then
    guided 250-step DDIM requests with labels (64 mixed with -1, seed=7
    twice; 25 with y=3; 16 with y=3 over HTTP), bad labels refused, one
    request at --fused_cfg=1 and one at --sampler=dpm2m --sample_steps=25.
    No kernel of ops/ is launched. Then the card against a CPU f32 copy at
    batch 4 (diff_cpu_checks)."""
    from generative_models_tpu_torch.serve import _http_serve, load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(DIFF_FLAGS + ['--serve_bs=64'])
    _live_resblocks(server.model)
    warm = server.warm()
    log(f'[diff_serve] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    a = server.sample(64, y=DIFF_LABELS, seed=7)
    b = server.sample(64, y=DIFF_LABELS, seed=7)
    c = server.sample(25, y=[3])
    httpd = _http_serve(server, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, png = _get(f'http://127.0.0.1:{httpd.server_address[1]}/sample?n=16&y=3')
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    if st != 200 or png[:8] != b'\x89PNG\r\n\x1a\n' or th.is_alive():
        raise AssertionError(f'diff_serve HTTP: /sample {st}, thread alive {th.is_alive()}')
    for bad in ([10], [-2], [1, 2]):
        try:
            server.sample(4, y=bad)
        except ValueError:
            continue
        raise AssertionError(f'diff_serve: labels {bad} were not refused')
    for label, s, n in (('seed=7', a, 64), ('y=3', c, 25)):
        _check_samples(f'diff_serve {label}', s, n)
    if not np.array_equal(a, b):
        raise AssertionError('diff_serve: seed=7 twice gave different batches')
    if server.stats()['requests'] != 4 or not server.stats()['class_cond']:
        raise AssertionError(f'diff_serve stats {server.stats()}')
    lat = list(server.latencies)
    log(f'[diff_serve] request latencies (s): {[round(v, 4) for v in lat]}')

    other = {}
    for key, flags in (('fused_cfg', ['--fused_cfg=1']),
                       ('dpm2m_25', ['--sampler=dpm2m', '--sample_steps=25'])):
        srv, _ = load_server(DIFF_FLAGS + ['--serve_bs=64'] + flags)
        _live_resblocks(srv.model)
        w = srv.warm()
        s = srv.sample(64, y=DIFF_LABELS, seed=7)
        _check_samples(f'diff_serve {key}', s, 64)
        other[key] = dict(warm_sec=w, request_sec=list(srv.latencies),
                          max_abs_diff_vs_ddim=float(np.abs(s - a).max()), server=srv)
        log(f'[diff_serve] {key}: warm {w:.2f}s, request {srv.latencies[0]:.3f}s, '
            f'max |this - two-call ddim| {other[key]["max_abs_diff_vs_ddim"]:.4f}')
    torch.cuda.synchronize()
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'diff_serve launched kernels of ops/: {launches}')
    checks = diff_cpu_checks(server.model, G)
    return dict(latencies=lat, warm_sec=warm, other=other, checks=checks, server=server)


def diff_cpu_checks(model, G):
    """The card's bf16 UNet against a CPU f32 copy of the same weights at
    batch 4: one forward; a 10-step guided DDIM chain from the same noise
    and guidance weights; and on the card fused against two-call guidance,
    each as a relative Frobenius error within its bound."""
    from generative_models_tpu_torch.models.diffusion import GaussianDiffusion

    dev = model.device
    cpu = _cpu_copy(model, G, bf16=0)
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((4, 28, 28, 1), generator=gen)
    ls = torch.tensor([-15.0, -2.0, 3.0, 12.0])
    y = torch.tensor([1, -1, 5, 9], dtype=torch.int32)
    w = torch.rand(4, generator=gen)
    with torch.no_grad():
        card = model.net.eval()(z.to(dev), ls.to(dev), guide=y.to(dev))
        ref = cpu.net.eval()(z, ls, guide=y)
    out = {'forward': _rel(card, ref)}
    kw = dict(mean_type=G.mean_type, num_steps=int(G.timesteps), sample_steps=10,
              sample_cond_w=-1.0)
    chain = lambda m, d, dv: m.sample_chain(z.to(dv), y.to(dv), cond_w=0.5, w=w.to(dv),
                                            return_history=False, diffusion=d)
    two_call = chain(model, GaussianDiffusion(**kw), dev)
    out['chain_10_guided'] = _rel(two_call, chain(cpu, GaussianDiffusion(**kw), 'cpu'))
    out['fused_vs_two_call'] = _rel(chain(model, GaussianDiffusion(fused_cfg=True, **kw), dev),
                                    two_call)
    bounds = {'forward': DIFF_FWD_REL, 'chain_10_guided': DIFF_CHAIN_REL,
              'fused_vs_two_call': DIFF_FUSED_REL}
    log(f'[diff_serve] card vs CPU f32 (relative Frobenius): {json.dumps(out)}; '
        f'bounds {json.dumps(bounds)}')
    for k, v in out.items():
        if not v < bounds[k]:
            raise AssertionError(f'diff_serve {k}: relative error {v:.4g} >= {bounds[k]}')
    return dict(rel_err=out, bounds=bounds)


def phase_diff_train():
    """diffusion_model's training path through main.main at bs=64 for one
    epoch on the synthetic set cut to 640/128 images (10 steps), with
    --ema=0.999: no kernel of ops/ launched, finite losses, the grid's
    event file and the three chain GIFs of each epoch, a model.pt holding
    the EMA copy; then the model restored from it (Adam's step counters on
    the card, where the capturable form keeps them) takes one step."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import load_model_and_data
    from generative_models_tpu_torch.main import main as train_main

    train_n, test_n, bs = 640, 128, 64
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(DIFF_TRAIN_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main(DIFF_FLAGS + [
        f'--bs={bs}', '--epochs=1', '--save_n=1', '--ema=0.999', '--data_source=synthetic',
        f'--logdir={DIFF_TRAIN_DIR}',
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[diff_train] main.main {wall:.2f}s; launches {launches}')
    if any(launches.values()):
        raise AssertionError(f'diff_train launched kernels of ops/: {launches}')
    gifs = [f'{tag}_{e}.gif' for tag in ('sampling_process', 'diffusion_model_eps',
                                         'diffusion_model_x') for e in (0, 1)]
    for name in ['model.pt', 'hps.yaml'] + gifs:
        if not (DIFF_TRAIN_DIR / name).is_file():
            raise AssertionError(f'diff_train: {name} was not written')
    for name in gifs:
        if (DIFF_TRAIN_DIR / name).read_bytes()[:6] != b'GIF89a':
            raise AssertionError(f'diff_train: {name} is not a GIF')
    if not list(DIFF_TRAIN_DIR.glob('events.out.tfevents.*')):
        raise AssertionError('diff_train: no TensorBoard event file (the samples grid)')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'diff_train: non-finite metrics at epoch {i}: {bad}')
    keys = {'diffusion_model/test/loss', 'diffusion_model/train/loss', 'dt/train', 'dt/eval',
            'num_vars'}
    if set(history[1]) != keys:
        raise AssertionError(f'diff_train: epoch 1 logged {sorted(history[1])}')
    state = torch.load(DIFF_TRAIN_DIR / 'model.pt', map_location='cpu', weights_only=True)
    ema = state['extra'].get('ema', {})
    if set(ema) != set(state['net']) or all(torch.equal(ema[k], state['net'][k]) for k in ema):
        raise AssertionError('diff_train: model.pt holds no EMA copy apart from the weights')
    loss = [h['diffusion_model/test/loss'] for h in history]
    log(f'[diff_train] test loss {loss}, train loss {history[1]["diffusion_model/train/loss"]}, '
        f'dt/train {history[1]["dt/train"]:.3f}s for {train_n // bs} steps, '
        f'dt/eval {history[1]["dt/eval"]:.3f}s')

    model, dataset, _, _, G = load_model_and_data([
        f'--weights_from={DIFF_TRAIN_DIR / "model.pt"}', '--data_source=synthetic',
    ])
    on = {st['step'].device.type for st in model.opt.state.values()}
    if on != {'cuda'}:
        raise AssertionError(f'diff_train: restored Adam step counters on {on}')
    bx, by = dataset.epoch_batches(torch.Generator().manual_seed(0))
    restored_loss = float(model.train_step(bx[0], by[0])['loss'])
    if not np.isfinite(restored_loss):
        raise AssertionError(f'diff_train: restored step loss {restored_loss}')
    log(f'[diff_train] restored from model.pt (Adam steps on the card): one step, loss '
        f'{restored_loss:.5f}')
    return dict(launches=launches, wall_sec=wall, steps=train_n // bs, history=history,
                restored_loss=restored_loss, model=model, dataset=dataset, G=G)


def phase_diff_grads(model, dataset, G):
    """One train step's gradients on the card, bf16 and from an f32 copy,
    against a CPU f32 copy from the same batch and draws (grad_check with
    DIFF_GRAD_BF16's and DIFF_GRAD_F32's bounds); then one Adam step
    on each from the same optimizer state and the same (the CPU copy's)
    gradients, the updates' relative Frobenius error within DIFF_ADAM_REL.
    The same gradients, because Adam divides each element by its own RMS:
    an element whose exact gradient is 0 (a bias before a GroupNorm) steps
    by ~lr on rounding noise, in a direction of its own on each side. Last,
    bf16_conv_checks."""
    dev = model.device
    x, y = dataset.first_test_batch(0)
    x, y = x[:8], y[:8]
    gen = torch.Generator().manual_seed(1)
    draws = dict(drop=torch.rand(8, generator=gen), eps=torch.randn((8, 28, 28, 1), generator=gen),
                 u=torch.rand(8, generator=gen))
    cpu = _cpu_copy(model, G, bf16=0)
    _copy_opt(cpu, 'opt', model.opt)
    cpu.updates = model.updates
    card_f32 = type(model)(type(G)(G, bf16=0))
    card_f32.net.load_state_dict(model.net.state_dict())
    on_card = {k: v.to(dev) for k, v in draws.items()}
    model.backward(x, y, draws=on_card)
    card_f32.backward(x, y, draws=on_card)
    cpu.backward(x.cpu(), y.cpu(), draws=draws)
    out_f32 = grad_check('diff_grads f32', card_f32, cpu, *DIFF_GRAD_F32)
    out = grad_check('diff_grads', model, cpu, *DIFF_GRAD_BF16)
    out['f32_max_rel_err'] = max(out_f32['rel_err'].values())
    out['whole_rel_err'] = _rel(torch.cat([p.grad.flatten() for p in model.net.parameters()]),
                                torch.cat([p.grad.flatten() for p in cpu.net.parameters()]))
    log(f'[diff_grads] the whole bf16 gradient vs the CPU copy\'s, relative Frobenius '
        f'{out["whole_rel_err"]:.4g}')
    before = [p.detach().cpu().clone() for p in model.net.parameters()]
    for p, q in zip(model.net.parameters(), cpu.net.parameters()):
        p.grad = q.grad.to(dev)
    model.apply_grads()
    cpu.apply_grads()
    step = torch.cat([(p.detach().cpu() - b).flatten() for p, b in zip(model.net.parameters(), before)])
    ref = torch.cat([(p.detach() - b).flatten() for p, b in zip(cpu.net.parameters(), before)])
    out['adam_update_rel_err'] = _rel(step, ref)
    log(f'[diff_grads] one Adam step from the same gradients and state: update vs the CPU '
        f'copy\'s, relative Frobenius {out["adam_update_rel_err"]:.4g} (bound {DIFF_ADAM_REL})')
    if not out['adam_update_rel_err'] < DIFF_ADAM_REL:
        raise AssertionError(f'diff_grads: Adam update relative error {out["adam_update_rel_err"]}')
    out['bf16_convs'] = bf16_conv_checks(dev)
    return out


def bf16_conv_checks(dev):
    """Each conv shape of the UNet at bs=8 (and the 3x3 at bs=64), in bf16
    on the card against f32 arithmetic on the same bf16 operands on the CPU:
    the forward (bias included), dgrad, wgrad and bias gradient, each a
    relative Frobenius error within DIFF_CONV_REL."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    out = {}
    for cin, cout, k, B in ((1, 128, 3, 8), (128, 128, 3, 8), (256, 128, 3, 8), (256, 128, 1, 8),
                            (128, 1, 3, 8), (128, 128, 3, 64)):
        x = torch.randn((B, cin, 28, 28), generator=gen).bfloat16()
        w = (torch.randn((cout, cin, k, k), generator=gen) / (k * cin ** 0.5)).bfloat16()
        b = torch.randn(cout, generator=gen).bfloat16()
        g = torch.randn((B, cout, 28, 28), generator=gen).bfloat16()
        res = []
        for t, cast in ((dev, lambda a: a.to(dev)), ('cpu', lambda a: a.float())):
            args = [cast(a).detach().requires_grad_() for a in (x, w, b)]
            o = F.conv2d(*args, padding=k // 2)
            o.backward(cast(g))
            res.append([o] + [a.grad for a in args])
        errs = {name: _rel(c, r) for name, c, r in zip(('fwd', 'dgrad', 'wgrad', 'bias'), *res)}
        out[f'{cin}->{cout} {k}x{k} B={B}'] = errs
        if max(errs.values()) >= DIFF_CONV_REL:
            raise AssertionError(f'diff_grads: bf16 conv {cin}->{cout} {k}x{k}: {errs}')
    log(f'[diff_grads] bf16 convs vs f32 arithmetic on their bf16 operands: {json.dumps(out)} '
        f'(bound {DIFF_CONV_REL})')
    return out


def phase_arb_load():
    """The shipped arbiters (weights/autoencoder.pt, weights/classifier.pt)
    decoded by the port's msgpack reader and loaded on the card, their
    features and logits of 64 synthetic images at 28x28 and 32x32 against a
    CPU f32 copy of the same file (ARB_REL); no kernel of ops/."""
    from generative_models_tpu_torch.models.arbiters import load_arbiter

    counters = _counters()
    _reset(counters)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name in ('autoencoder', 'classifier'):
        path = ROOT / 'weights' / f'{name}.pt'
        t0 = time.time()
        card = load_arbiter(path, 'cuda')
        torch.cuda.synchronize()
        res = dict(load_sec=time.time() - t0)
        cpu = load_arbiter(path, 'cpu')
        for size in (28, 32):
            x = torch.clamp(torch.randn((64, size, size, 1), generator=gen), -1, 1)
            xd = x.cuda()
            got, ref = card.apply(xd), cpu.apply(x)
            res[str(size)] = dict(shape=list(got.shape), rel_err=_rel(got, ref),
                                  max_abs_err=float((got.cpu() - ref).abs().max()),
                                  forward_ms=eager_ms(lambda: card.apply(xd), 20))
            if not res[str(size)]['rel_err'] <= ARB_REL:
                raise AssertionError(f'arb_load {name} {size}x{size}: {res[str(size)]}')
        out[name] = res
        log(f'[arb_load] {name}: {json.dumps(res)} (bound {ARB_REL})')
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'arb_load launched kernels of ops/: {launches}')
    return out


def _fid64(x, y, mean_of_sq):
    """FID in float64: scipy's sqrtm of the covariance product (the
    reference's formula), the mean of squares or the sum of squares."""
    from scipy import linalg

    diff = x.mean(0) - y.mean(0)
    c1, c2 = np.cov(x, rowvar=False), np.cov(y, rowvar=False)
    covmean = np.real(linalg.sqrtm(c1 @ c2))
    mean_term = np.mean(diff ** 2) if mean_of_sq else np.sum(diff ** 2)
    return float(mean_term + np.trace(c1) + np.trace(c2) - 2 * np.trace(covmean))


def _prf64(real, gen, k=3):
    """k-NN precision / recall in float64 (scipy's cdist)."""
    from scipy.spatial.distance import cdist

    def est(a, b):
        radii = np.sort(cdist(a, a), axis=1)[:, k:k + 1]
        return float(np.mean(np.any(cdist(a, b) < radii, axis=0)))
    return {'precision': est(real, gen), 'recall': est(gen, real)}


def phase_eval_heavy():
    """diffusion_model at its defaults (--eval_heavy=1, --class_cond=1,
    hidden_size=128, bf16, random weights from seed 0 with live ResBlocks)
    through main's load_model_and_data and train with --epochs=0, the
    shipped arbiters, --eval_sampler=dpm2m --eval_sample_steps=25 and
    EH_TEST_N test images: all 8 rounds of a conditional and an
    unconditional batch of 64 (512 samples a side). Every eval/* value
    finite, FID >= 0; the FIDs within EH_FID_REL of a float64
    recomputation from the phase's own features, precision and recall
    beside theirs; the seconds split into sampling, arbiter forwards and
    metrics (each timed call synchronised); no kernel of ops/."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import load_model_and_data, train

    mnist.TRAIN_N, mnist.TEST_N = 640, EH_TEST_N
    shutil.rmtree(EH_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    model, dataset, ae, cls, G = load_model_and_data(EH_FLAGS + [
        '--epochs=0', '--data_source=synthetic', f'--logdir={EH_DIR}'])
    if not (G.eval_heavy and G.class_cond and ae is not None and cls is not None):
        raise AssertionError(f'eval_heavy: defaults eval_heavy={G.eval_heavy} '
                             f'class_cond={G.class_cond}, arbiters {ae}, {cls}')
    _live_resblocks(model)
    spent, feats = dict(sampling=0.0, arbiters=0.0), dict(autoencoder=[], classifier=[])

    def timed_call(key, fn, keep=None):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.time() - t0
            if keep is not None:
                keep.append(out)
            return out
        return call

    model.sample_images = timed_call('sampling', model.sample_images)
    ae.apply = timed_call('arbiters', ae.apply, feats['autoencoder'])
    cls.apply = timed_call('arbiters', cls.apply, feats['classifier'])
    history = train(model, dataset, ae, cls, G)
    torch.cuda.synchronize()
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'eval_heavy launched kernels of ops/: {launches}')
    h = history[0]
    keys = ['fid', 'ignite_fid', 'precision', 'recall', 'f1', 'classifier_loss', 'cond_fid',
            'cond_precision', 'cond_recall', 'cond_f1']
    vals = {k: h.get(f'eval/{k}') for k in keys}
    if any(v is None or not np.isfinite(v) for v in vals.values()) or vals['fid'] < 0:
        raise AssertionError(f'eval_heavy: {vals}')
    rounds = len(feats['classifier'])
    if rounds != 8 or len(feats['autoencoder']) != 3 * rounds:
        raise AssertionError(f'eval_heavy: {rounds} rounds, {len(feats["autoencoder"])} '
                             'autoencoder calls (want 8 and 24)')
    # a round's autoencoder calls: the conditional samples, the test batch,
    # the unconditional samples
    z_cond, z_real, z_samp = (torch.cat(feats['autoencoder'][i::3]).double().cpu().numpy()
                              for i in range(3))
    ref = dict(fid=_fid64(z_samp, z_real, True), ignite_fid=_fid64(z_samp, z_real, False),
               cond_fid=_fid64(z_cond, z_real, True), **_prf64(z_real, z_samp),
               **{f'cond_{k}': v for k, v in _prf64(z_real, z_cond).items()})
    diff = {k: vals[k] - v for k, v in ref.items()}
    sec = h['dt/eval_heavy']
    split = dict(total=sec, sampling=spent['sampling'], arbiters=spent['arbiters'],
                 metrics_and_rest=sec - spent['sampling'] - spent['arbiters'])
    log(f'[eval_heavy] {rounds} rounds, {z_samp.shape[0]} samples a side; '
        f'{json.dumps({k: vals[k] for k in keys})}')
    log(f'[eval_heavy] float64 recomputation {json.dumps(ref)}; this minus it {json.dumps(diff)}')
    log(f'[eval_heavy] seconds {json.dumps(split)}; dt/eval {h["dt/eval"]:.2f}')
    for k in ('fid', 'ignite_fid', 'cond_fid'):
        if not abs(diff[k]) <= EH_FID_REL * abs(ref[k]):
            raise AssertionError(f'eval_heavy {k}: {vals[k]} vs float64 {ref[k]}')
    return dict(values=vals, float64=ref, diff=diff, seconds=split, rounds=rounds,
                samples_a_side=int(z_samp.shape[0]), launches=launches)


def _sha256(path):
    import hashlib

    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@contextlib.contextmanager
def _checked_students(checked):
    """Within it main.train first holds a distilled student at step 0
    against its teacher's model.pt (every weight the teacher has, in the
    student, its frozen teacher and its EMA, bitwise; only a step1
    student's cond_w_embed apart) and after training its frozen teacher
    bitwise unchanged; every stage has an EMA (CHAIN_STAGE_FLAGS' --ema).
    It records each run's stage, step count and timesteps in checked."""
    import generative_models_tpu_torch.main as main_mod
    from generative_models_tpu_torch.models.base import read_checkpoint

    plain = main_mod.train

    def train(model, dataset, ae, cls, G):
        stage = Path(G.logdir).name
        if model.ema_net is None:
            raise AssertionError(f'chain {stage}: no EMA (--ema={G.get("ema")})')
        teacher = read_checkpoint(G.teacher_path)['net'] if model.has_teacher else None
        nets = [('student', model.net), ('teacher', model.teacher_net), ('ema', model.ema_net)]
        for name, net in (nets if teacher is not None else []):
            sd = net.state_dict()
            own = set(sd) - set(teacher)
            if (set(teacher) - set(sd) or (own and G.teacher_mode != 'step1')
                    or any(not k.startswith('cond_w_embed.') for k in own)):
                raise AssertionError(f'chain {stage}: the {name} has {sorted(own)[:4]} beyond '
                                     'the teacher, or lacks some of its weights')
            bad = [k for k, v in teacher.items() if not torch.equal(sd[k].cpu(), v)]
            if bad:
                raise AssertionError(f'chain {stage}: the {name} differs from the teacher at '
                                     f'step 0: {bad[:4]}')
        history = plain(model, dataset, ae, cls, G)
        if teacher is not None:
            sd = model.teacher_net.state_dict()
            moved = [k for k, v in teacher.items() if not torch.equal(sd[k].cpu(), v)]
            if moved:
                raise AssertionError(f'chain {stage}: the frozen teacher moved at {moved[:4]}')
        checked.append(dict(stage=stage, steps=model.step, timesteps=int(G.timesteps),
                            teacher_checked=teacher is not None))
        return history

    main_mod.train = train
    try:
        yield
    finally:
        main_mod.train = plain


def phase_chain():
    """The orchestration layer (generative_models_tpu_torch/scripts/) in
    one process, each stage through main.main, diffusion at its defaults
    (hidden_size=128, bf16, --class_cond=1; no cut in width or depth) on
    the synthetic set cut to CHAIN_TRAIN_N / CHAIN_TEST_N, CHAIN_FLAGS
    passed on to every stage, under a fresh CHAIN_DIR:
      1. train_arbiters with EPOCHS=1 (autoencoder and classifier at their
         default widths, 3 steps each): finite metrics, an event file, both
         model.jit.pt installed under the phase's WEIGHTS_DIR and read back
         by load_arbiter on the card, features of 64 images within ARB_REL
         of a CPU copy's;
      2. progressive_distillation with EPOCHS_TEACHER=EPOCHS_STUDENT=1 and
         CHAIN_STAGE_FLAGS (--eval_heavy=0, --ema): ten stages, each with
         model.pt and hps.yaml at timesteps 256, 256, 128, ..., 1, 3 steps
         each, finite losses; each student, its frozen teacher and its EMA
         at step 0 equal to its teacher's model.pt but for a step1
         student's cond_w_embed, and its frozen teacher bitwise unchanged
         after training (_checked_students);
      3. eval_distill_chain with the arbiters of 1 and CHAIN_EVAL_FLAGS,
         each stage reloaded with its EMA: every stage's eval/* (fid,
         ignite_fid, precision, recall, f1, classifier_loss, cond_*)
         finite, from 128 samples a side;
      4. collect_distill, then distill_latency with CHAIN_LATENCY_FLAGS:
         the JSON holds the ten stages, each with its metrics and its
         latency; the curve from the 256-step teacher to the 1-step
         student logged.
    The shipped weights/*.pt keep their sha256, and no kernel of ops/ is
    launched. The whole run runs this phase as chip_smoke.py --only=chain,
    a process of its own beside the phases from resume to train_flags, so
    its seconds and its curve are those of a shared card and host (alone,
    --only=chain, the card is idle). eval_no_progressive runs the entry of 3 (--weights_from --epochs=0
    --eval_heavy=1) at a given --timesteps; it is held on the CPU only
    (tests/test_torch_scripts.py), to spare chip time."""
    import yaml

    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.models.arbiters import load_arbiter
    from generative_models_tpu_torch.scripts import (
        CHAIN_STAGES, collect_distill, distill_latency, eval_distill_chain,
        progressive_distillation, train_arbiters,
    )

    shutil.rmtree(CHAIN_DIR, ignore_errors=True)
    mnist.TRAIN_N, mnist.TEST_N = CHAIN_TRAIN_N, CHAIN_TEST_N
    shipped = [_sha256(p) for p in SHIPPED_ARBITERS]
    counters = _counters()
    _reset(counters)
    sec, out = {}, {}

    t0 = time.time()
    weights = CHAIN_DIR / 'weights'
    arb_env = dict(LOGROOT=str(CHAIN_DIR / 'arbiters'), EPOCHS='1', WEIGHTS_DIR=str(weights))
    arb_hist, arbiters = train_arbiters.main(CHAIN_FLAGS, arb_env)
    torch.cuda.synchronize()
    sec['arbiters'] = time.time() - t0
    x = torch.clamp(torch.randn((64, 28, 28, 1), generator=torch.Generator().manual_seed(1)),
                    -1, 1)
    for name, history in zip(train_arbiters.ARBITERS, arb_hist):
        logdir = CHAIN_DIR / 'arbiters' / name
        bad = {k: v for h in history for k, v in h.items() if not np.isfinite(v)}
        if bad or not any(k.startswith(f'{name}/train/') for k in history[1]):
            raise AssertionError(f'chain arbiters {name}: metrics {history[1]}')
        if not list(logdir.glob('events.out.tfevents.*')):
            raise AssertionError(f'chain arbiters {name}: no event file')
        path = weights / f'{name}.pt'
        rel = _rel(load_arbiter(path, 'cuda').apply(x.cuda()), load_arbiter(path, 'cpu').apply(x))
        if not rel <= ARB_REL:
            raise AssertionError(f'chain arbiters {name}: {path} on the card vs CPU {rel}')
        out[name] = dict(epoch_1=history[1], rel_err=rel)
        log(f'[chain] {name}: epoch 1 {json.dumps(history[1])}; {path.name} on the card vs a '
            f'CPU copy {rel:.3g} (bound {ARB_REL})')

    env = dict(LOGROOT=str(CHAIN_DIR / 'distillation'), EPOCHS_TEACHER='1', EPOCHS_STUDENT='1')
    root = Path(env['LOGROOT'])
    checked = []
    t0 = time.time()
    with _checked_students(checked):
        histories = progressive_distillation.main(CHAIN_STAGE_FLAGS, env)
    torch.cuda.synchronize()
    sec['chain'] = time.time() - t0
    steps = [256, 256] + [int(s.split('_')[1]) for s in CHAIN_STAGES[2:]]
    hps = [yaml.safe_load((root / s / 'hps.yaml').read_text()) for s in CHAIN_STAGES]
    if [h['timesteps'] for h in hps] != steps or [c['timesteps'] for c in checked] != steps:
        raise AssertionError(f'chain: timesteps {[h["timesteps"] for h in hps]} (want {steps})')
    if [c['stage'] for c in checked] != list(CHAIN_STAGES) or any(
            c['steps'] != CHAIN_TRAIN_N // 64 or c['teacher_checked'] != (c['stage'] != 'teacher')
            for c in checked):
        raise AssertionError(f'chain: stages run {checked}')
    losses = {s: [h[k] for h in hist for k in h if k.endswith('/loss')]
              for s, hist in zip(CHAIN_STAGES, histories)}
    if any(len(v) != 3 or not np.all(np.isfinite(v)) for v in losses.values()):
        raise AssertionError(f'chain: losses {losses}')
    log(f'[chain] ten stages in {sec["chain"]:.1f}s; test and train losses {json.dumps(losses)}')

    t0 = time.time()
    evals = eval_distill_chain.main(arbiters + CHAIN_EVAL_FLAGS, env)
    torch.cuda.synchronize()
    sec['eval_chain'] = time.time() - t0
    keys = ['fid', 'ignite_fid', 'precision', 'recall', 'f1', 'classifier_loss', 'cond_fid',
            'cond_precision', 'cond_recall', 'cond_f1']
    heavy = {s: {k: h[0].get(f'eval/{k}') for k in keys} for s, h in zip(CHAIN_STAGES, evals)}
    for s, vals in heavy.items():
        if any(vals.get(k) is None or not np.isfinite(vals[k]) for k in keys):
            raise AssertionError(f'chain eval {s}: {vals}')
    dt_heavy = {s: h[0]['dt/eval_heavy'] for s, h in zip(CHAIN_STAGES, evals)}
    log(f'[chain] eval chain {sec["eval_chain"]:.1f}s (dt/eval_heavy {json.dumps(dt_heavy)}); '
        f'{json.dumps(heavy)}')

    t0 = time.time()
    collect_distill.main([], env)
    sec['collect'] = time.time() - t0
    t0 = time.time()
    record = distill_latency.main(CHAIN_LATENCY_FLAGS, env)
    sec['latency'] = time.time() - t0
    lat = record.get('sample_latency', {})
    if list(record.get('stages', {})) != list(CHAIN_STAGES) or list(lat) != list(CHAIN_STAGES):
        raise AssertionError(f'chain: DISTILL.json stages {list(record.get("stages", {}))}, '
                             f'latencies {list(lat)}')
    if any(lat[s]['timesteps'] != n or not lat[s]['sample64_sec'] > 0
           for s, n in zip(CHAIN_STAGES, steps)):
        raise AssertionError(f'chain: latencies {lat}')
    ratio = lat['teacher']['sample64_sec'] / lat['step2_1']['sample64_sec']
    log('[chain] 64-image latency by stage (timesteps: s): ' + ', '.join(
        f'{s} ({lat[s]["timesteps"]}): {lat[s]["sample64_sec"]:.4f}' for s in CHAIN_STAGES)
        + f'; teacher / step2_1 = {ratio:.1f}; {record["sample_latency_device"]}')

    if [_sha256(p) for p in SHIPPED_ARBITERS] != shipped:
        raise AssertionError('chain: the shipped weights/*.pt changed')
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'chain launched kernels of ops/: {launches}')
    log(f'[chain] seconds {json.dumps(sec)}')
    return dict(arbiters=out, losses=losses, eval_heavy=heavy, dt_eval_heavy=dt_heavy,
                sample_latency=lat, teacher_over_1step=ratio, seconds=sec,
                distill_json=str(root / 'DISTILL.json'), launches=launches)


def start_only(phase, log_path):
    """python3 chip_smoke.py --only=<phase> in a process of its own, beside
    this one, its output into log_path: (the process, log_path, its start
    time). It reuses the kernels this process built. A process still
    running when this one exits is killed."""
    import atexit

    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, 'w') as out:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), f'--only={phase}'],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc, log_path, t0


def join_only(started, phase, relog=None, timeout=1800):
    """Wait for start_only's process; raise with its log's tail where it
    failed; log its lines that start with relog (a prefix or a tuple of
    them); return the phase's result from its last line ({phase: result}
    for phases joined by commas), with the process's wall and the seconds
    this process waited for it."""
    proc, log_path, t0 = started
    t_wait = time.time()
    rc = proc.wait(timeout=timeout)
    text = log_path.read_text()
    if rc:
        raise AssertionError(f'{phase}: its process exited {rc}: {text[-4000:]}')
    for line in text.splitlines():
        if relog and line.startswith(relog):
            log(line)
    res = json.loads(text.strip().splitlines()[-1])
    res = {p: res[p] for p in phase.split(',')} if ',' in phase else res[phase]
    wall, waited = time.time() - t0, time.time() - t_wait
    log(f'[{phase}] its process {wall:.1f}s; waited for it {waited:.1f}s')
    return res, wall, waited


def _remat_pair(name, flags):
    """name trained 3 steps at bs=64 with --remat=0, then --remat=1, through
    load_model_and_data and train from seed 0: each run's net (float64,
    CPU), history, launches and lr; and the init's net."""
    from generative_models_tpu_torch.main import load_model_and_data, train

    counters = _counters()
    runs, init = {}, None
    for remat in (0, 1):
        logdir = TRAIN_FLAGS_DIR / f'{name}_remat{remat}'
        _reset(counters)
        model, dataset, _, _, G = load_model_and_data(flags + [
            '--bs=64', '--epochs=1', '--save_n=1', '--data_source=synthetic', f'--remat={remat}',
            f'--logdir={logdir}'])
        if init is None:
            init = {k: v.detach().double().cpu() for k, v in model.net.state_dict().items()}
        t0 = time.time()
        history = train(model, dataset, None, None, G)
        torch.cuda.synchronize()
        runs[remat] = dict(net=_net(logdir / 'model.pt'), history=history,
                           launches=_read(counters), wall_sec=time.time() - t0, lr=float(G.lr))
    return runs, init


MADE_FLAGS_ARGV = MADE_FLAGS + MADE_SCHEDULE + ['--bs=64', '--epochs=2', '--save_n=1',
                                                '--data_source=synthetic']
MADE_CPU_LOG = ROOT / 'build' / 'chip_smoke_made_cpu.log'


def phase_made_cpu():
    """The CPU run of train_flags' made command, main.main on 2 of the
    host's 8 cores under TRAIN_FLAGS_DIR/made_cpu: its history. The whole
    run starts it (start_only) before the export phase, whose tracing
    workers already share the host, so that it ends before train_flags
    needs it; it holds the cores for about two minutes."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    torch.set_num_threads(2)
    logdir = TRAIN_FLAGS_DIR / 'made_cpu'
    shutil.rmtree(logdir, ignore_errors=True)
    mnist.TRAIN_N, mnist.TEST_N = TRAIN_FLAGS_N['made']
    return train_main(MADE_FLAGS_ARGV + ['--device=cpu', f'--logdir={logdir}'])


def _made_flags_card(logdir):
    """made's train_flags command on the card, through load_model_and_data
    and train, recording for each micro-step whether the parameters moved,
    and each update's global gradient norm before and after clipping and
    its lr."""
    from generative_models_tpu_torch.main import load_model_and_data, train

    # the per-step loop: the hooks below run at every micro-step (a graph
    # replays no Python; the graphs phase holds the graphed epoch bitwise)
    model, dataset, _, _, G = load_model_and_data(MADE_FLAGS_ARGV + [f'--logdir={logdir}',
                                                                     '--jit_epoch=0'])
    rec = dict(moved=[], norms=[], clipped=[], lrs=[])
    norm = lambda grads: torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    params = [p for g in model.opt.param_groups for p in g['params']]
    step, clip = model.train_step, model._clip_

    def train_step(*a, **kw):
        before = [p.detach().clone() for p in params]
        m = step(*a, **kw)
        rec['moved'].append(torch.stack([(p != b).any() for p, b in zip(params, before)]).any())
        return m

    def clip_(grads):
        rec['norms'].append(norm(grads))
        rec['lrs'].append(model.lr_at(model.updates))
        clip(grads)
        rec['clipped'].append(norm(grads))

    model.train_step, model._clip_ = train_step, clip_
    t0 = time.time()
    history = train(model, dataset, None, None, G)
    torch.cuda.synchronize()
    return dict(history=history, wall_sec=time.time() - t0, lr=float(G.lr),
                moved=[bool(v) for v in rec['moved']], norms=[float(v) for v in rec['norms']],
                clipped=[float(v) for v in rec['clipped']], lrs=rec['lrs'])


def phase_train_flags(cpu_run=None):
    """The trainer flags no other phase names, through main's
    load_model_and_data and train (main.main's body) at bs=64:
      * --remat=1 against --remat=0 for pixel_transformer and for diffusion
        (--eval_heavy=0; --sample_steps=10, evaluate's chain, as the check
        is of training), 3 steps each from seed 0: model.pt bitwise, else
        its distance over the update within REMAT_BOUND (_run_diff; the
        attention key biases, of exact gradient 0, held apart within 2 lr a
        step); pixel_transformer's Kernel C launched L x 3 more times (each
        Block's forward recomputed in its backward), no other count moved;
      * made at 2048 with MADE_SCHEDULE (--grad_clip=MADE_CLIP,
        --grad_accum=2, --lr_scheduler=cosine --warmup_steps=2
        --lr_decay_steps=8, --keep_best=eval/nlogp) for 2 epochs of 4
        micro-steps: the parameters bitwise unchanged by the first
        micro-step of each window and by the first update (lr 0, optax's
        warmup), moved by the other three; each update's lr the schedule's
        and its gradient norm above MADE_CLIP (the clip bites), after
        clipping MADE_CLIP within CLIP_RTOL; best.json's
        value the least logged eval/nlogp, model_best.pt written; the
        card's final weights within MADE_FLAGS_BOUND of a CPU run of the
        same command (phase_made_cpu in a process of its own, cpu_run
        from start_only, else started here), over the CPU run's
        update, both as w * m (the kernel
        route keeps its unmasked init off the mask, unread; the CPU's
        premasked route zeroes it).
    No kernel but C, E, D (pixel_transformer) and G, H (made)."""
    import generative_models_tpu_torch.data.mnist as mnist

    cpu_run = cpu_run or start_only('made_cpu', MADE_CPU_LOG)
    try:
        return _train_flags(mnist, cpu_run)
    finally:
        if cpu_run[0].poll() is None:
            cpu_run[0].kill()
            cpu_run[0].wait()


def _train_flags(mnist, cpu_run):
    """phase_train_flags' checks, the made CPU run start_only's cpu_run."""
    cpu_dir = TRAIN_FLAGS_DIR / 'made_cpu'
    for d in TRAIN_FLAGS_DIR.glob('*'):  # this phase's runs of an earlier call
        if d.is_dir() and d != cpu_dir:
            shutil.rmtree(d)
    out = {}
    mnist.TRAIN_N, mnist.TEST_N = TRAIN_FLAGS_N['remat']
    cases = (('pixel_transformer', ['--model=pixel_transformer'], ZERO_GRAD),
             ('diffusion', DIFF_FLAGS + ['--sample_steps=10'], ()))
    for name, flags, free in cases:
        runs, init = _remat_pair(name, flags)
        d = _run_diff(runs[0], runs[1], init, free=free, lr=runs[0]['lr'])
        bitwise = all(torch.equal(runs[0]['net'][k], runs[1]['net'][k]) for k in init)
        extra = {k: runs[1]['launches'][k] - v for k, v in runs[0]['launches'].items()}
        want = {k: (2 * 3 if (name, k) == ('pixel_transformer', 'causal_attention_fwd') else 0)
                for k in extra}
        out[name] = dict(bitwise=bitwise, diff=d, bound=REMAT_BOUND[name],
                         launches=runs[0]['launches'], remat_extra_launches=extra,
                         wall_sec=[runs[0]['wall_sec'], runs[1]['wall_sec']])
        log(f'[train_flags] {name} --remat=1 vs 0: bitwise {bitwise}; {json.dumps(d)} (bound '
            f'{REMAT_BOUND[name]}); launches {json.dumps(runs[0]["launches"])}, remat adds '
            f'{json.dumps({k: v for k, v in extra.items() if v})}; walls {out[name]["wall_sec"]}')
        if not (bitwise or (d['rel_to_update'] <= REMAT_BOUND[name] and d.get('free_ok', True)
                            and d['metrics_max_abs'] <= MESH_METRIC_BOUND)):
            raise AssertionError(f'train_flags {name}: --remat=1 apart from --remat=0: {d}')
        if extra != want:
            raise AssertionError(f'train_flags {name}: --remat=1 adds launches {extra}, '
                                 f'want {want}')

    mnist.TRAIN_N, mnist.TEST_N = TRAIN_FLAGS_N['made']
    counters = _counters()
    _reset(counters)
    card = _made_flags_card(TRAIN_FLAGS_DIR / 'made')
    launches = _read(counters)
    cpu_hist, cpu_wall, _ = join_only(cpu_run, 'made_cpu', timeout=900)
    cpu = dict(history=cpu_hist, wall_sec=cpu_wall)
    micro = 2 * TRAIN_FLAGS_N['made'][0] // 64
    want_moved = [i % 2 == 1 and i > 1 for i in range(micro)]
    lr = card['lr']
    want_lr = [0.0, lr / 2, lr, lr * 0.5 * (1 + np.cos(np.pi / 8))]
    best = json.loads((TRAIN_FLAGS_DIR / 'made' / 'best.json').read_text())
    nlogp = [h['eval/nlogp'] for h in card['history']]
    # the CPU run's update, from the init both runs share (seed 0), in the
    # weights each route computes with, w * m: the kernel route keeps the
    # unmasked init off the mask, which it never reads, where the CPU's
    # premasked route zeroes it
    from generative_models_tpu_torch.main import load_model_and_data
    fresh, *_ = load_model_and_data(MADE_FLAGS + ['--device=cpu', '--data_source=synthetic'])
    names = {id(p): n for n, p in fresh.net.named_parameters()}
    masks = {names[id(w)]: m.double().cpu() for w, _, m in fresh.net.layers()}
    masked = lambda net: {k: v * masks[k] if k in masks else v for k, v in net.items()}
    init = masked({k: v.detach().double() for k, v in fresh.net.state_dict().items()})
    d = _run_diff(dict(net=masked(_net(cpu_dir / 'model.pt')),
                       history=cpu['history']),
                  dict(net=masked(_net(TRAIN_FLAGS_DIR / 'made' / 'model.pt')),
                       history=card['history']), init)
    out['made'] = dict(moved=card['moved'], grad_norms=card['norms'],
                       clipped_norms=card['clipped'], lrs=card['lrs'], best=best,
                       eval_nlogp=nlogp, vs_cpu=d, bound=MADE_FLAGS_BOUND, launches=launches,
                       wall_sec=card['wall_sec'], cpu_wall_sec=cpu['wall_sec'])
    log(f'[train_flags] made 2048 {" ".join(MADE_SCHEDULE)}: moved by micro-step '
        f'{card["moved"]}; update grad norms {card["norms"]}, clipped {card["clipped"]} '
        f'(clip {MADE_CLIP}, rtol {CLIP_RTOL}); lr '
        f'{card["lrs"]}; eval/nlogp {nlogp}; best.json {json.dumps(best)}; vs the CPU run '
        f'{json.dumps(d)} (bound {MADE_FLAGS_BOUND}); launches {json.dumps(launches)}; walls '
        f'{card["wall_sec"]:.2f}s, the CPU process {cpu["wall_sec"]:.2f}s from its start')
    faults = []
    if card['moved'] != want_moved:
        faults.append(f'moved {card["moved"]}, want {want_moved}')
    if len(card['lrs']) != 4 or not np.allclose(card['lrs'], want_lr, rtol=1e-12, atol=0):
        faults.append(f'lr {card["lrs"]}, want {want_lr}')
    if len(card['norms']) != 4 or not min(card['norms']) > MADE_CLIP:
        faults.append(f'gradient norms {card["norms"]} do not all exceed the clip {MADE_CLIP}')
    if len(card['clipped']) != 4 or not np.allclose(card['clipped'], MADE_CLIP, rtol=CLIP_RTOL,
                                                    atol=0):
        faults.append(f'clipped gradient norms {card["clipped"]}, want {MADE_CLIP}')
    if best.get('value') != min(nlogp) or best.get('epoch') != int(np.argmin(nlogp)) or \
            not (TRAIN_FLAGS_DIR / 'made' / 'model_best.pt').is_file():
        faults.append(f'best.json {best} vs eval/nlogp {nlogp}, or no model_best.pt')
    if not d['rel_to_update'] <= MADE_FLAGS_BOUND:
        faults.append(f'card vs CPU {d}')
    if launches['masked_matmul'] == 0 or launches['mask_out_matmul'] == 0 or any(
            v for k, v in launches.items() if k not in ('masked_matmul', 'mask_out_matmul')):
        faults.append(f'launches {launches}')
    if faults:
        raise AssertionError('train_flags made: ' + '; '.join(faults))
    return out


def _train_and_serve(name, flags=(), tag=None):
    """name at its default width: one epoch through main.main at bs=64 on
    the synthetic set cut to 640/128 (10 steps), its model.pt, hps.yaml and
    event file (the grids) and finite metrics; then load_server from the
    model.pt at serve_bs=64: warm, seed=7 twice equal, 25 unseeded, each in
    [0, 1]; no kernel of ops/ launched in any of it. flags: more training
    flags; tag: the logdir's and the log's name (default name). Returns
    (logdir, history, wall seconds, server, warm seconds, the seed=7
    batch)."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main
    from generative_models_tpu_torch.serve import load_server

    tag = tag or name
    logdir = ROOT / 'build' / f'chip_smoke_{tag}'
    mnist.TRAIN_N, mnist.TEST_N = 640, 128
    shutil.rmtree(logdir, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main([f'--model={name}', '--bs=64', '--epochs=1', '--save_n=1',
                          '--data_source=synthetic', f'--logdir={logdir}', *flags])
    torch.cuda.synchronize()
    wall = time.time() - t0
    for f in ('model.pt', 'hps.yaml'):
        if not (logdir / f).is_file():
            raise AssertionError(f'{name}: {f} was not written')
    if not list(logdir.glob('events.out.tfevents.*')):
        raise AssertionError(f'{name}: no TensorBoard event file (the grids)')
    bad = {k: v for h in history for k, v in h.items() if not np.isfinite(v)}
    if bad or not any(k.startswith((f'{name}/train/', 'train/')) for k in history[1]):
        raise AssertionError(f'{name}: metrics {history[1]}')
    log(f'[{name}] main.main {wall:.2f}s; epoch 1 {json.dumps(history[1])}')

    server, _ = load_server([f'--weights_from={logdir / "model.pt"}', '--serve_bs=64'])
    warm = server.warm()
    a, b, c = server.sample(64, seed=7), server.sample(64, seed=7), server.sample(25)
    for label, s, n in (('seed=7', a, 64), ('n=25', c, 25)):
        _check_samples(f'{name} {label}', s, n)
    if not np.array_equal(a, b):
        raise AssertionError(f'{name}: seed=7 twice gave different batches '
                             f'(max |a - b| {float(np.abs(a - b).max()):.3g})')
    log(f'[{name}] served: warm {warm:.3f}s, requests (s) '
        f'{[round(v, 5) for v in server.latencies]}')
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'{name} launched kernels of ops/: {launches}')
    return logdir, history, wall, server, warm, a


def phase_small_model(name, flags=(), tag=None):
    """vae or gan at its default width (hidden_size=256; vae z_size=128,
    gan noise_size=128) through _train_and_serve (gan's samples mapped from
    [-1, 1]; vae's in {0, 1}); from the trained model.pt one step's
    gradients against a CPU copy from the same batch, noise and optimizer
    state (vae: f32, SMALL_GRAD; gan: the twin step's, and the batch
    statistics after it, against a float64 copy, GAN_GRAD, the CPU f32
    copy's own error and the card's float64 twin step's logged beside); a
    profiled train step and request. No kernel of ops/. flags, tag: as _train_and_serve's (gan_sn: --spectral_norm=1,
    whose u and sigma are held with the batch statistics)."""
    from generative_models_tpu_torch.main import load_model_and_data

    logdir, history, wall, server, warm, a = _train_and_serve(name, flags, tag)
    tag = tag or name
    if name == 'vae' and not set(np.unique(a)) <= {0.0, 1.0}:
        raise AssertionError('vae: samples not in {0, 1}')
    lat = list(server.latencies)

    model, dataset, _, _, G = load_model_and_data([f'--weights_from={logdir / "model.pt"}',
                                                   '--data_source=synthetic'])
    cpu = _cpu_copy(model, G)
    for key, o in model.optimizers().items():
        _copy_opt(cpu, key, o)
    x = dataset.first_test_batch(0)[0]
    gen = torch.Generator().manual_seed(1)
    if name == 'vae':
        eps = torch.randn((64, int(G.z_size)), generator=gen)
        model.backward(x, eps=eps.cuda())
        cpu.backward(x.cpu(), eps=eps)
        grads = grad_check(f'{name}_grads', model, cpu, *SMALL_GRAD)
    else:
        cpu64 = _cpu_copy(model, G)
        cpu64.net.double()
        for key, o in model.optimizers().items():  # the moments cast to float64
            _copy_opt(cpu64, key, o)
        cpu64._as_input = lambda a: torch.as_tensor(a).double()
        # the same twin step in float64 on the card: its distance from the
        # CPU float64 copy's is the card's arithmetic apart from f32's
        card64 = _cpu_copy(model, G, device='cuda')
        card64.net.double()
        for key, o in model.optimizers().items():
            _copy_opt(card64, key, o)
        card64._as_input = lambda a: torch.as_tensor(a).double().cuda()
        noise = torch.randn((64, int(G.noise_size)), generator=gen)
        model.train_step(x, noise=noise.cuda())
        cpu.train_step(x.cpu(), noise=noise)
        cpu64.train_step(x.cpu(), noise=noise.double())
        card64.train_step(x, noise=noise.double().cuda())
        # the card's f32 gradients are held against float64; the CPU f32
        # copy's own error and the card's float64 step's are logged beside
        cpu_f32 = grad_check(f'{tag}_grads CPU f32 vs float64 (logged, not bounded)', cpu, cpu64,
                             float('inf'), 0.0)
        card_f64 = grad_check(f'{tag}_grads card float64 vs CPU float64 (logged, not bounded)',
                              card64, cpu64, float('inf'), 0.0)
        grads = grad_check(f'{tag}_grads card vs float64', model, cpu64, *GAN_GRAD)
        grads['cpu_f32_rel_err'] = cpu_f32['rel_err']
        grads['card_f64_rel_err'] = card_f64['rel_err']
        grads['cpu_f32_max_rel_err'] = max(cpu_f32['rel_err'].values())
        ref = cpu64.net.state_dict()
        stats = {k: _rel(v, ref[k]) for k, v in model.net.state_dict().items()
                 if k.endswith(('.mean', '.var', '.u', '.sigma'))}
        log(f'[{tag}_grads] batch statistics (and spectral norm state) after the step vs the '
            f'float64 copy\'s (relative Frobenius): {json.dumps(stats)} (bound {GAN_STATS_REL})')
        if max(stats.values()) > GAN_STATS_REL:
            raise AssertionError(f'{tag}: batch statistics {stats}')
        grads['batch_stats_rel_err'] = stats

    bx = dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    model.train_step(bx[0])
    torch.cuda.synchronize()
    prof = dict(train_step=_profile(f'one {tag} train step', lambda: model.train_step(bx[1]), 10),
                request=_profile(f'one {tag} request', lambda: server.sample(64, seed=11), 10))
    return dict(wall_sec=wall, steps=640 // 64, history=history, warm_sec=warm, request_sec=lat,
                grads_rel_err=grads['rel_err'],
                **{k: grads[k] for k in ('batch_stats_rel_err', 'cpu_f32_max_rel_err',
                                         'cpu_f32_rel_err', 'card_f64_rel_err')
                   if k in grads}, profile=prof)


def phase_raster_model(name):
    """rnn, wavenet, pixel_cnn or gated_pixel_cnn at its default width
    through _train_and_serve (the samples in {0, 1}, a sampling GIF each
    epoch); from the trained model.pt, on 8 test images, the full forward's
    logits and one step's gradients against a CPU copy (RASTER_FWD_REL,
    RASTER_GRAD; wavenet's against the port's CPU bf16 net, its error
    against CPU f32 logged beside; the pixel CNNs' gradients against a
    float64 copy, the CPU f32 copy's error logged beside); a profiled train step, and a request's
    launches and device time (CUDA activity alone: a request is 784 decode
    steps, tens of thousands of launches). No kernel of ops/."""
    from generative_models_tpu_torch.main import load_model_and_data

    logdir, history, wall, server, warm, a = _train_and_serve(name)
    lat = list(server.latencies)
    if not set(np.unique(a)) <= {0.0, 1.0}:
        raise AssertionError(f'{name}: samples not in {{0, 1}}')
    for epoch in (0, 1):
        if not (logdir / f'sampling_process_{epoch}.gif').is_file():
            raise AssertionError(f'{name}: no sampling_process_{epoch}.gif')

    model, dataset, _, _, G = load_model_and_data([f'--weights_from={logdir / "model.pt"}',
                                                   '--data_source=synthetic'])
    x = dataset.first_test_batch(0)[0][:8]
    bf16_ref = name == 'wavenet'  # the card computes it in bf16
    cpu = _cpu_copy(model, G, dtype=torch.bfloat16 if bf16_ref else None)
    cpu32 = _cpu_copy(model, G) if bf16_ref else cpu
    with torch.no_grad():
        got = model.logits(x)
        fwd = dict(rel_err=_rel(got, cpu.logits(x.cpu())), bound=RASTER_FWD_REL[name],
                   reference='CPU bf16' if bf16_ref else 'CPU f32',
                   rel_err_vs_cpu_f32=_rel(got, cpu32.logits(x.cpu())))
    log(f'[{name}] full forward on 8 test images vs the CPU copy: {json.dumps(fwd)}')
    if not fwd['rel_err'] <= RASTER_FWD_REL[name]:
        raise AssertionError(f'{name}: logits {fwd}')
    model.backward(x)
    cpu.backward(x.cpu())
    if name in RASTER_GRAD_F64:
        # the pixel CNNs' gradients against a float64 copy: a LayerNorm at
        # a context-free position normalises a near-constant vector (eps
        # 1e-6), which amplifies f32 rounding; the CPU f32 copy's error and
        # the card's with cuDNN's TF32 on (which the port turns off) are
        # logged beside
        ref = _cpu_copy(model, G)
        ref.net.double()
        ref._as_input = lambda a: torch.as_tensor(a).double()
        ref.backward(x.cpu().double())
        grads = grad_check(f'{name}_grads vs CPU float64', model, ref, *RASTER_GRAD[name])
        grads['cpu_f32_rel_err'] = grad_check(
            f'{name}_grads CPU f32 vs float64 (logged, not bounded)', cpu, ref,
            float('inf'), 0.0)['rel_err']
        torch.backends.cudnn.allow_tf32 = True
        try:
            model.backward(x)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        grads['card_tf32_rel_err'] = grad_check(
            f'{name}_grads card with cuDNN TF32 on vs float64 (logged, not bounded)', model, ref,
            float('inf'), 0.0)['rel_err']
    else:
        grads = grad_check(f'{name}_grads vs {fwd["reference"]}', model, cpu, *RASTER_GRAD[name])
    out = dict(grads_rel_err=grads['rel_err'], grads_off_graph=grads['off_graph'],
               **{k: grads[k] for k in ('cpu_f32_rel_err', 'card_tf32_rel_err') if k in grads})
    if bf16_ref:
        cpu32.backward(x.cpu())
        out['grads_rel_err_vs_cpu_f32'] = grad_check(
            f'{name}_grads vs CPU f32 (logged, not bounded)', model, cpu32,
            float('inf'), 0.0)['rel_err']

    bx = dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    model.train_step(bx[0])
    torch.cuda.synchronize()
    prof = dict(train_step=_profile(f'one {name} train step', lambda: model.train_step(bx[1]), 10),
                request=_count_launches(f'one {name} request',
                                        lambda: server.sample(64, seed=11)))
    return dict(wall_sec=wall, steps=640 // 64, history=history, warm_sec=warm, request_sec=lat,
                forward=fwd, profile=prof, **out)


def _guided_step(model, n=64):
    """One guided DDIM step of a request at serve_bs=n (the two UNet
    forwards and the guidance math), on fixed inputs."""
    gen = torch.Generator(model.device).manual_seed(0)
    z = torch.randn((n, 28, 28, 1), generator=gen, device=model.device)
    y = torch.as_tensor(DIFF_LABELS[:n], dtype=torch.int32, device=model.device)
    cond_w = 4.0 * torch.rand(n, generator=gen, device=model.device)
    net = model._make_net(model._sample_net(), y)
    ls = model.diffusion.logsnr_schedule_fn(torch.tensor([0.5, 0.496], device=model.device))

    @torch.no_grad()
    def run():
        model.diffusion.ddim_step(net=net, z_t=z, logsnr_t=ls[0], logsnr_s=ls[1], cond_w=cond_w)
    return run


# each kernel wrapper's kernel functions (ops/csrc), by the wrapper's name:
# one launch a count
KERNEL_FUNCTIONS = {
    'ln_matmul': ('ln_matmul_kernel', 'ln_matmul_dot_kernel'),
    'block_tail': ('block_tail_kernel',),
    'causal_attention_fwd': ('flash_fwd_kernel',),
    'flash_bwd_dq': ('flash_bwd_dq_kernel',),
    'flash_bwd_dkv': ('flash_bwd_dkv_kernel',),
    'vq_one_hot': ('vq_one_hot_kernel',),
    'masked_matmul': ('masked_matmul_kernel',),
    'mask_out_matmul': ('mask_out_matmul_kernel',),
    'int8_gemm': ('int8_gemm_kernel',),
    'dequant_gemm': ('dequant_gemm_kernel',),
    'ring_chunk_fwd': ('ring_fwd_kernel',),
    'ring_chunk_bwd_dq': ('ring_bwd_dq_kernel',),
    'ring_chunk_bwd_dkv': ('ring_bwd_dkv_kernel',),
}
WRAPPER_OF = {fn: name for name, fns in KERNEL_FUNCTIONS.items() for fn in fns}


def _kernel_function(event_name):
    """The function name of a traced kernel: 'flash_fwd_kernel' of 'void
    flash_fwd_kernel<32>(...)' or of its mangled '_Z16flash_fwd_kernel...'."""
    mangled = re.match(r'_Z(\d+)', event_name)
    if mangled:
        start = mangled.end()
        return event_name[start:start + int(mangled.group(1))]
    m = re.match(r'(?:void\s+)?([A-Za-z_]\w*)', event_name)
    return m.group(1) if m else event_name


LEAD_NODES = 64  # the erfinv_ launches that lead each _count_launches trace
LEAD = []  # the lead's graph and tensor, made at the first trace


def _lead():
    """A graph of LEAD_NODES erfinv_ kernels (an op no path of the port
    runs), replayed at the start of each _count_launches trace and dropped
    from its events: a trace loses its first few events now and then (a
    pause before them did not stop it: made at 2048 lost 1-2 of its first
    G launches in every retake within one process, of an eager step and of
    a graph's replays), and then it loses these."""
    if not LEAD:
        from generative_models_tpu_torch.utils.graphs import CapturedGraph

        x = torch.zeros(LEAD_NODES, device='cuda')
        LEAD.append((CapturedGraph(lambda: [x[i:i + 1].erfinv_() for i in range(LEAD_NODES)]),
                     x))
    return LEAD[0][0]


def _count_launches(label, fn):
    """The device kernels and copies of one call of fn, counted under
    torch.profiler's CUDA activity alone (no op events): for a whole
    request. kernels: the launches of each kernel wrapper's functions
    (KERNEL_FUNCTIONS) on the trace."""
    from torch.profiler import ProfilerActivity, profile

    lead = _lead()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a pause, then the lead's kernels, before the first launch: traces
        # that launched at once now and then lost their first few launches
        time.sleep(0.05)
        lead.replay()
        torch.cuda.synchronize()
        t1 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t1
    events = [(name, us) for name, us in _raw_device_events(prof) if 'erfinv' not in name]
    busy = sum(us for _, us in events) / 1e3
    kernels = {}
    for name, _ in events:
        wrapper = WRAPPER_OF.get(_kernel_function(name))
        if wrapper is not None:
            kernels[wrapper] = kernels.get(wrapper, 0) + 1
    out = dict(wall_ms=wall * 1e3, device_ms=busy, launches=len(events),
               busy_share=busy / (wall * 1e3), traced_sec=time.time() - t0, kernels=kernels)
    log(f'[profile] {label}: wall {out["wall_ms"]:.1f} ms, device {busy:.1f} ms, '
        f'{len(events)} launches, busy share {out["busy_share"]:.3f}; traced in '
        f'{out["traced_sec"]:.1f}s')
    return out


def _healthz(server):
    """GET /healthz from the server's HTTP front, started and stopped here."""
    from generative_models_tpu_torch.serve import _http_serve

    httpd = _http_serve(server, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, body = _get(f'http://127.0.0.1:{httpd.server_address[1]}/healthz')
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    if st != 200 or th.is_alive():
        raise AssertionError(f'/healthz {st}, server thread alive {th.is_alive()}')
    return json.loads(body)


def phase_quant_serve():
    """--quantize serving of each model at its default width in both modes;
    returns {'<model>_<mode>': result}. The unquantized chains each mode is
    held against do not depend on the mode: they are computed once a model,
    on the first mode's request, and shared."""
    out = {}
    for name in ('pixel_transformer', 'vqvae', 'made', 'rnn', 'wavenet'):
        ref = {}
        for mode in QUANT_MODES:
            out[f'{name}_{mode}'] = quant_serve_one(name, mode, ref)
    return out


def quant_serve_one(name, mode, ref):
    """One model in one mode through load_server (seed=7, whose batch
    quant_checks redraws through the quantized chain; no warm pass),
    with exact launch counts: the mode's kernel once a quantized weight a
    step (a decode step, or a made forward), every other kernel 0 times: no
    Kernel A or B in the decode steps, no G in made's forwards; rnn's wh
    once a step and wavenet's nine res1x1 nine times. ref: the
    model's unquantized chains, shared between its modes (quant_checks)."""
    from generative_models_tpu_torch.serve import load_server

    label = f'quant_serve {name} {mode}'
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server([f'--model={name}', '--serve_bs=64', f'--quantize={mode}'])
    a = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[{label}] load_server + the request {time.time() - t0:.2f}s; launches {launches}')
    steps = {'pixel_transformer': 784, 'vqvae': 49, 'made': 784, 'rnn': 784, 'wavenet': 784}[name]
    n_q = {'pixel_transformer': 12, 'vqvae': 14, 'made': 4, 'rnn': 1, 'wavenet': 9}[name]
    passes = 1  # the request (its batch is redrawn by quant_checks)
    if server.quant_kernels != n_q or server.quant_mode != mode:
        raise AssertionError(f'{label}: {server.quant_kernels} quantized weights in mode '
                             f'{server.quant_mode}, expected {n_q} in {mode}')
    expected = dict.fromkeys(launches, 0)
    expected[QUANT_KERNEL[mode]] = n_q * steps * passes
    if launches != expected:
        raise AssertionError(f'{label} launch counts {launches} != expected {expected}')
    stats = _healthz(server)
    if (stats['quantize'], stats['quantized_kernels'], stats['requests']) != (mode, n_q, 1):
        raise AssertionError(f'{label}: /healthz {stats}')
    if a.shape != (64, 28, 28, 1) or not np.isin(a, (0.0, 1.0)).all():
        raise AssertionError(f'{label} seed=7: shape {a.shape} or values outside {{0, 1}}')
    log(f'[{label}] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = quant_checks(name, mode, server, G, a, ref)
    return dict(launches=launches, passes=passes, per_pass=n_q * steps,
                latencies=list(server.latencies), warm_sec=None, checks=checks, server=server)


def quant_checks(name, mode, server, G, batch, ref):
    """The seed=7 request redrawn through the quantized chain from its
    uniforms (the same tokens); the card's table bitwise equal to a CPU
    copy's (the weights copied, quantized there again); then teacher-forced
    logits, quantized on the card, on the model's first mode's request
    (ref['x']: the unquantized chains on it, ref['lu'] on the card and
    ref['lf'] on a CPU f32 copy, are computed at the first mode and reused
    at the second):
      * against the unquantized chain on a CPU f32 copy, on 8 samples: the
        relative error (Frobenius) < 0.05, the JAX package's bound for its
        quantized forward against the exact f32 one (tests/test_int8.py);
      * against the unquantized chain on the card (bf16 operands, so its
        own rounding adds in), on all 64: reported, not bounded; and that
        chain itself against the CPU f32 one (reported: the card's own
        bf16 rounding, once a model);
      * against the same quantized chain on the CPU copy, on 8 samples, at
        the bf16 tolerance of the other teacher-forced checks: the card
        rounds the KV cache (and under w8a16 the activations) to bf16. Under
        w8a8 that rounding can also move an activation across a
        quantization level, which moves its products by sx * scale * |q| and
        every logit downstream: those logits are counted, and at most 0.5 %
        of them may lie outside the tolerance (none under w8a16).
    made: causality under w8a16 bitwise, and under w8a8 the count of logits
    <= i that move when inputs >= i change. rnn and wavenet: the chain is
    their decode chain (teacher_forced_logits); the CPU f32 reference is
    the full forward, which the CPU tests hold equal to the chain; wavenet's
    CPU copy of the quantized chain computes in bf16, as the card does."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        teacher_forced_logits, transformer_sample_scan,
    )
    from generative_models_tpu_torch.ops.int8 import build_quant_table
    from generative_models_tpu_torch.utils.dists import Bernoulli, Categorical

    model, quant = server.model, server.quant
    dev, gen = model.device, torch.Generator(model.device).manual_seed(7)
    cpu = _cpu_copy(model, G)
    cquant, _ = build_quant_table(cpu, mode)
    if (quant.dense.keys(), quant.masked.keys()) != (cquant.dense.keys(), cquant.masked.keys()):
        raise AssertionError(f'{name} {mode}: the card and the CPU quantize other layers')
    pairs = [(k, quant.dense[k], cquant.dense[k]) for k in quant.dense] + [
        (f'{k} layer {i}', a, b) for k in quant.masked
        for i, (a, b) in enumerate(zip(quant.masked[k], cquant.masked[k]))]
    for key, (q, sc), (cq, csc) in pairs:
        if not (torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), csc)):
            raise AssertionError(f'{name} {mode}: {key} quantized apart on the card and the CPU')
    tol = dict(atol=5e-2, rtol=5e-2)
    out = {}
    with torch.no_grad():
        if name == 'pixel_transformer':
            T = model.block_size
            x = torch.as_tensor(batch, device=dev).reshape(64, T, 1)
            u = torch.rand((T, 64, 1), generator=gen, device=dev)
            lq = teacher_forced_logits(model.net, x, 4, quant)
            redrawn = Bernoulli(logits=lq).sample(uniforms=u.permute(1, 0, 2))
            flips = int((redrawn != x).sum())
            if not ref:
                ref.update(x=x, lu=teacher_forced_logits(model.net, x, 4),
                           lf=teacher_forced_logits(cpu.net, x[:8].cpu()))
            else:
                lq = teacher_forced_logits(model.net, ref['x'], 4, quant)
            lc = teacher_forced_logits(cpu.net, ref['x'][:8].cpu(), 1, cquant)
        elif name == 'vqvae':
            prior, pq, T, K = model.net.prior, quant.sub('prior'), model.n_codes, int(G.vqK)
            u = torch.rand((T, 64, K), generator=gen, device=dev)
            tokens = transformer_sample_scan(
                prior, 64, lambda logits, ut: Categorical(logits).sample(uniforms=ut), u, quant=pq)
            x = tokens.permute(1, 0, 2).contiguous()
            imgs = (torch.sigmoid(model.net.ae.decode_codes(x)) > 0.5).float()
            if not np.array_equal(imgs.cpu().numpy(), batch):
                raise AssertionError(f'vqvae {mode}: the seed=7 codes do not decode to the request')
            lq = teacher_forced_logits(prior, x, 1, pq)
            flips = int((Categorical(lq).sample(uniforms=u.permute(1, 0, 2)) != x).any(-1).sum())
            if not ref:
                ref.update(x=x, lu=teacher_forced_logits(prior, x),
                           lf=teacher_forced_logits(cpu.net.prior, x[:8].cpu()))
            else:
                lq = teacher_forced_logits(prior, ref['x'], 1, pq)
            lc = teacher_forced_logits(cpu.net.prior, ref['x'][:8].cpu(), 1, cquant.sub('prior'))
        elif name == 'made':
            x = torch.as_tensor(batch, device=dev).reshape(64, model.nin)
            if not ref:
                ref.update(x=x, lu=model.net(x), lf=cpu.net(x[:8].cpu()))
            lq = model.net(ref['x'], quant=quant)
            lc = cpu.net(ref['x'][:8].cpu(), quant=cquant)
            flips = 0  # each forward is one step of sampling: nothing to redraw
            out['causality'] = made_quant_causality(model, quant, mode)
        else:  # rnn, wavenet
            T = model.canvas_size
            x = torch.as_tensor(batch, device=dev)
            u = torch.rand((T, 64), generator=gen, device=dev)
            lq = model.teacher_forced_logits(x, quant)
            flips = int((Bernoulli(logits=lq).sample(uniforms=u.t()) != x.reshape(64, T)).sum())
            if not ref:
                ref.update(x=x, lu=model.teacher_forced_logits(x), lf=cpu.logits(x[:8].cpu()))
            else:
                lq = model.teacher_forced_logits(ref['x'], quant)
            if name == 'wavenet':
                cpu = _cpu_copy(model, G, dtype=torch.bfloat16)
            lc = cpu.logits(ref['x'][:8].cpu(), cquant)
    if flips:
        raise AssertionError(f'{name} {mode}: the quantized chain redraws {flips} tokens differently')
    lu, lf = ref['lu'], ref['lf']
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    out['rel_err_vs_cpu_f32_unquantized'] = rel(lq[:8].cpu(), lf)
    out['rel_err_vs_card_unquantized'] = rel(lq, lu)
    out['rel_err_cpu_quantized_vs_cpu_f32'] = rel(lc, lf)
    out['rel_err_card_unquantized_vs_cpu_f32'] = rel(lu[:8].cpu(), lf)
    if not out['rel_err_vs_cpu_f32_unquantized'] < 0.05:
        raise AssertionError(f'{name} {mode}: relative error {out["rel_err_vs_cpu_f32_unquantized"]:.4g}'
                             ' vs the unquantized f32 chain')
    got = lq[:8].cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name} {mode}: non-finite quantized logits')
    err = (got - lc).abs()
    outside = int((err > tol['atol'] + tol['rtol'] * lc.abs()).sum())
    out.update(card_vs_cpu_quantized=float(err.max()), outside_tolerance=outside,
               compared=err.numel(), max_share_outside=0.005 if mode == 'w8a8' else 0.0, **tol)
    if outside > out['max_share_outside'] * err.numel():
        raise AssertionError(f'{name} {mode} card vs CPU quantized: {outside} of {err.numel()} '
                             f'logits outside atol {tol["atol"]} + rtol {tol["rtol"]}; '
                             f'max abs err {out["card_vs_cpu_quantized"]:.3g}')
    log(f'[quant_serve {name} {mode}] checks {json.dumps(out)}')
    return out


def made_quant_causality(model, quant, mode):
    """made's quantized forward on a random canvas with the inputs >= i
    flipped: under w8a16 logits <= i bitwise unchanged (the folded int8
    weights are exactly 0 off the masks, and Kernel J sums in a fixed
    order); under w8a8 the number of them that move (the row's absmax
    scale sees every unit)."""
    canvas = (torch.rand((64, model.nin), generator=torch.Generator(model.device).manual_seed(3),
                         device=model.device) < 0.5).float()
    ref = model.net(canvas, quant=quant)
    moved = {}
    for i in (0, 1, 2, 100, 400, 600, 782, 783):
        changed = canvas.clone()
        changed[:, i:] = 1 - changed[:, i:]
        logits = model.net(changed, quant=quant)
        moved[i] = int((logits[:, :i + 1] != ref[:, :i + 1]).sum())
        if mode == 'w8a16' and moved[i]:
            raise AssertionError(f'made w8a16: logits up to {i} moved when inputs >= {i} changed')
    return dict(logits_moved_at_or_before_i=moved, bitwise=mode == 'w8a16')


def _profile(label, fn, top_n, device_only=False):
    """Wall and device time of one call of fn under torch.profiler, and the
    kernels that took the most device time; traced_sec is the whole cost,
    the trace's processing included. device_only: CUDA activity alone (no
    host op events), a several times smaller trace to process."""
    from torch.profiler import ProfilerActivity, profile

    t_trace = time.time()
    acts = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for name, us in _raw_device_events(prof):
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + us)
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    launches = sum(n for n, _ in by_name.values())
    traced = time.time() - t_trace
    log(f'[profile] {label}: wall {wall * 1e3:.1f} ms, device kernels '
        f'{busy_ms:.1f} ms ({launches} launches), busy share {busy_ms / (wall * 1e3):.3f}; '
        f'traced in {traced:.1f}s')
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]:
        log(f'[profile]   {us / 1e3:9.2f} ms  {n:6d}x  {name[:110]}')
    return dict(wall_ms=wall * 1e3, device_ms=busy_ms, launches=launches, traced_sec=traced)


def _dtoh_copies(label, fn, top_n=12):
    """The device-to-host copies of one call of fn under torch.profiler with
    Python stacks: their count on the card's timeline, and each one's
    source, the aten op that issued it with its parents and the innermost
    frames of the repo or of torch.optim in its stack, counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    copies = sum(1 for e in events if _on_device(e) and 'DtoH' in e.name)
    sources = {}
    for e in events:
        n = sum('DtoH' in k.name for k in getattr(e, 'kernels', ())) if e.device_type == DeviceType.CPU else 0
        if not n:
            continue
        ops, up = [], e
        while up is not None and len(ops) < 4:
            ops.append(up.name)
            up = up.cpu_parent
        frames = [f for f in (e.stack or ()) if 'generative_models_tpu_torch' in f
                  or 'torch/optim' in f][:3]
        key = ' < '.join(ops) + ' @ ' + ' < '.join(frames or (e.stack or ['?'])[:2])
        sources[key] = sources.get(key, 0) + n
    top = sorted(sources.items(), key=lambda kv: -kv[1])
    log(f'[profile] {label}: {copies} device-to-host copies on the card, '
        f'{sum(sources.values())} traced to an op')
    for key, n in top[:top_n]:
        log(f'[profile]   {n:5d}x  {key[:300]}')
    return dict(copies=copies, traced=sum(sources.values()), sources=dict(top[:top_n]))


def _decode_window(server, steps):
    """A call running the quantized decode steps `steps` of a request at
    serve_bs=64 (server.model.net with server.quant, on a fresh KV cache,
    LSTM state or set of wavenet rings), as sampling runs them, without the
    rest of the request."""
    model, quant = server.model, server.quant
    net, name, dev = model.net, model.G.model, model.device
    if name == 'pixel_transformer':
        caches, prev = net.init_cache(64), torch.zeros((64, net.in_size), device=dev)
        step = lambda t: net.decode_step(prev, caches, t, None, quant)
    elif name == 'rnn':
        products = net.products(quant)
        h = torch.zeros((64, net.hidden), device=dev)
        x = torch.zeros((64, model.in_channels), device=dev)
        step = lambda t: net.step(h, h, x, products)
    else:
        buffers, s = net.init_buffers(64), torch.zeros((64, 3), device=dev)
        step = lambda t: net.decode_step(buffers, s, t, quant)

    @torch.no_grad()
    def run():
        for t in steps:
            step(t)
    return run


def phase_profile(server, x, model, dataset, vq_server, vq_model, vq_dataset,
                  made_server, made_model, made_dataset, quant, seq_model, seq_dataset, diff):
    """Device time by kernel over one seeded request, one (warm) scoring
    forward and one (warm) train step at bs=64, for pixel_transformer, for
    vqvae and for made at hidden_size=2048; one (warm) pixel_transformer
    train step under --mesh=seq:4; one seeded quantized request of vqvae and
    made in each mode; and a window of PT_DECODE_WINDOW decode steps of a
    quantized pixel_transformer, rnn and wavenet request in each mode (a
    whole request's trace, 100k-250k launches, took 40-100 s to process). For diffusion
    (diff: its server, and its restored model and dataset): one guided
    DDIM step of a request (two UNet forwards: a 250-step request is 250
    of them, plus 21 launches), a whole 25-step dpm2m request's launches
    and device time (CUDA activity alone; a 250-step request's trace, 367k
    launches, took 73 s to process), and one train step, whose
    device-to-host copies, like the vqvae step's, include none from
    Adam.step: both models' optimizers were restored from a model.pt."""
    bx = dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    model.train_step(bx[0])
    seq_bx = seq_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    seq_model.train_step(seq_bx[0])
    vq_bx = vq_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    vq_model.train_step(vq_bx[0])
    made_bx = made_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    made_model.train_step(made_bx[0])
    diff_bx, diff_by = diff['dataset'].epoch_batches(torch.Generator().manual_seed(0))
    diff['model'].train_step(diff_bx[0], diff_by[0])
    torch.cuda.synchronize()
    out = dict(
        request=_profile('one request', lambda: server.sample(64, seed=11), 15,
                         device_only=True),
        scoring=_profile('one scoring forward', lambda: server.model.eval_loss(x), 10),
        train_step=_profile('one train step', lambda: model.train_step(bx[1]), 15),
        seq_train_step=_profile(f'one seq:{SEQ} train step',
                                lambda: seq_model.train_step(seq_bx[1]), 15),
        vqvae_request=_profile('one vqvae request', lambda: vq_server.sample(64, seed=11), 15),
        vqvae_train_step=_profile('one vqvae train step',
                                  lambda: vq_model.train_step(vq_bx[1]), 15),
        vqvae_train_step_dtoh=_dtoh_copies('one vqvae train step',
                                           lambda: vq_model.train_step(vq_bx[2])),
        made_request=_profile('one made request', lambda: made_server.sample(64, seed=11), 10),
        made_train_step=_profile('one made train step',
                                 lambda: made_model.train_step(made_bx[1]), 15),
        **{f'{key}_request': _profile(f'one {key} request',
                                      lambda srv=q['server']: srv.sample(64, seed=11), 12,
                                      device_only=True)
           for key, q in quant.items() if key.startswith(('vqvae', 'made'))},
        **{f'{key}_decode_window': dict(
            steps=[PT_DECODE_WINDOW.start, PT_DECODE_WINDOW.stop],
            **_profile(f'{len(PT_DECODE_WINDOW)} decode steps of a {key} request',
                       _decode_window(q['server'], PT_DECODE_WINDOW), 12))
           for key, q in quant.items() if key.startswith(('pixel_transformer', 'rnn', 'wavenet'))},
        diffusion_guided_step=_profile('one guided DDIM step of a diffusion request '
                                       '(two UNet forwards)', _guided_step(diff['server'].model), 15),
        diffusion_dpm2m_request=_count_launches(
            'one diffusion request at --sampler=dpm2m --sample_steps=25 (25 guided steps)',
            lambda: diff['dpm2m_server'].sample(64, y=DIFF_LABELS, seed=11)),
        diffusion_train_step=_profile('one diffusion train step',
                                      lambda: diff['model'].train_step(diff_bx[1], diff_by[1]), 15),
        diffusion_train_step_dtoh=_dtoh_copies('one diffusion train step',
                                               lambda: diff['model'].train_step(diff_bx[2],
                                                                                diff_by[2])),
    )
    for key in ('vqvae_train_step_dtoh', 'diffusion_train_step_dtoh'):
        adam = {k: n for k, n in out[key]['sources'].items() if 'adam' in k.lower()}
        if adam:
            raise AssertionError(f'{key}: device-to-host copies in Adam.step: {adam}')
    return out


# ---------------------------------------------------------------------- #
# --resume, a JAX package's TrainState, --stream_data, --profile,
# --spectral_norm=1, diffusion --quantize and the reference's loss curves
# ---------------------------------------------------------------------- #
RESUME_DIR = ROOT / 'build' / 'chip_smoke_resume'
JAX_CKPT_DIR = ROOT / 'build' / 'chip_smoke_jax_ckpt'
STREAM_DIR = ROOT / 'build' / 'chip_smoke_stream'
CLI_PROFILE_DIR = ROOT / 'build' / 'chip_smoke_cli_profile'
# a quantized UNet forward against the CPU f32 unquantized one (relative
# Frobenius): the bound of the other quantized paths, the JAX package's
DIFF_QUANT_REL = 0.05
# the UNet's Linears that --quantize holds at the default width (time_embed's
# two, guide_embed's second, the twelve ResBlock emb projections), and the
# UNet calls of a guided dpm2m request at 25 steps (two a step)
DIFF_QUANT_N, DPM2M_25_CALLS = 15, 50


def _run_main(argv):
    """main.main(argv) with its printed lines kept: (history, the text)."""
    import contextlib
    import io

    from generative_models_tpu_torch.main import main as train_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = train_main(argv)
    return history, out.getvalue()


def _state_diff(a, b):
    """Entries of two model.pt dicts (net, optimizer states, counters,
    generator state) that are not bitwise equal, as {key: max |a - b|}."""
    out = {}
    for k, v in a['net'].items():
        if not torch.equal(v, b['net'][k]):
            out[f'net.{k}'] = float((v.double() - b['net'][k].double()).abs().max())
    for i, (sa, sb) in enumerate(zip(a['opt']['state'].values(), b['opt']['state'].values())):
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            if not torch.equal(sa[key], sb[key]):
                out[f'opt.{i}.{key}'] = float((sa[key].double() - sb[key].double()).abs().max())
    for key in ('step', 'updates', 'mini_step'):
        if a[key] != b[key]:
            out[key] = abs(a[key] - b[key])
    if not torch.equal(a['gen_state'], b['gen_state']):
        out['gen_state'] = 1.0
    return out


def phase_resume():
    """--resume=1 through main.main, made at --hidden_size=2048 (Kernels G
    and H), 10 steps an epoch at bs=64: one epoch into a logdir, then the
    same command with --epochs=2, against an uninterrupted two-epoch run:
    RESUMED at step 10 and RESUMING at epoch 1 printed, the params, every
    Adam state, the counters and the generator state bitwise equal, the
    eval metrics of epochs 1 and 2 equal. Then the model restored by
    load_model_and_data(--resume=1) takes its first step with no
    device-to-host copy, and a step of it and of a fresh model are
    profiled."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import epoch_generator, load_model_and_data

    mnist.TRAIN_N, mnist.TEST_N = 640, 128
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    flags = MADE_FLAGS + ['--bs=64', '--save_n=1', '--data_source=synthetic']
    straight, cut = RESUME_DIR / 'straight', RESUME_DIR / 'cut'
    t0 = time.time()
    ref, _ = _run_main(flags + ['--epochs=2', f'--logdir={straight}'])
    t_straight = time.time() - t0
    _, out1 = _run_main(flags + ['--epochs=1', '--resume=1', f'--logdir={cut}'])
    t1 = time.time()
    hist, out2 = _run_main(flags + ['--epochs=2', '--resume=1', f'--logdir={cut}'])
    t_resumed = time.time() - t1
    said = [ln for ln in out2.splitlines() if ln.startswith(('RESUMED', 'RESUMING'))]
    log(f'[resume] uninterrupted 2 epochs {t_straight:.2f}s; resumed run {t_resumed:.2f}s: {said}')
    if 'RESUMED' in out1 or said != [f'RESUMED {cut} at step 10', 'RESUMING at epoch 1']:
        raise AssertionError(f'resume: printed {said} (first run resumed: {"RESUMED" in out1})')
    diff = _state_diff(torch.load(straight / 'model.pt', weights_only=True),
                       torch.load(cut / 'model.pt', weights_only=True))
    if diff:
        raise AssertionError(f'resume: the resumed run differs from the uninterrupted one: '
                             f'{json.dumps(dict(list(diff.items())[:8]))}')
    evals = lambda h: {k: v for k, v in h.items() if k.startswith('eval/')}
    if [evals(h) for h in hist] != [evals(h) for h in ref[1:]]:
        raise AssertionError(f'resume: eval metrics {hist} vs {ref[1:]}')

    model, dataset, _, _, G = load_model_and_data(flags + ['--resume=1', f'--logdir={cut}'])
    if model.step != 20 or {st['step'].device.type for st in model.opt.state.values()} != {'cuda'}:
        raise AssertionError(f'resume: restored step {model.step}, Adam step counters not on '
                             'the card')
    bx, _ = dataset.epoch_batches(epoch_generator(0, 2))
    dtoh = _dtoh_copies('the first resumed made step', lambda: model.train_step(bx[0]))
    if dtoh['copies']:
        raise AssertionError(f'resume: the first resumed step made {dtoh["copies"]} '
                             'device-to-host copies')
    fresh = type(model)(G)
    fresh.train_step(bx[0])
    prof = dict(resumed=_profile('a resumed made step', lambda: model.train_step(bx[1]), 6),
                fresh=_profile('a fresh made step', lambda: fresh.train_step(bx[1]), 6))
    return dict(uninterrupted_sec=t_straight, resumed_run_sec=t_resumed, printed=said,
                bitwise=True, first_step_dtoh=dtoh['copies'], profile=prof)


def _flax_tree(d):
    """A dict of port tensors (already in flax's names) as flax writes it:
    numpy leaves, every dict's keys sorted."""
    if isinstance(d, dict):
        return {k: _flax_tree(d[k]) for k in sorted(d)}
    return d.detach().cpu().float().numpy() if isinstance(d, torch.Tensor) else d


def made_params_to_flax(sd):
    """MADE: w0..w3 (in, out) and b0..b3, flax's own names and layout."""
    return _flax_tree(dict(sd))


def pixel_transformer_params_to_flax(sd):
    """The inverse of convert.params_from_jax: Linear weight (out, in) ->
    Dense kernel (in, out) (the transpose), LayerNorm weight -> scale,
    blocks.{i} -> block{i}, head_layer.dense -> head_layer/Dense_0."""
    tree = {}
    for key, v in sd.items():
        parts = key.split('.')
        if parts[0] == 'blocks':
            parts = [f'block{parts[1]}'] + parts[2:]
        if parts[:2] == ['head_layer', 'dense']:
            parts = ['head_layer', 'Dense_0'] + parts[2:]
        *mods, leaf = parts
        if not mods:  # pos_emb
            tree[leaf] = v
            continue
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        norm = mods[-1] in ('ln1', 'ln2', 'ln_f')
        if leaf == 'weight':
            node['scale' if norm else 'kernel'] = v if norm else v.t()
        else:
            node[leaf] = v
    return _flax_tree(tree)


def flax_train_state_bytes(model, params_to_flax, rng=(0, 0)):
    """The port model's train state as the JAX package's save writes a
    TrainState (flax's to_bytes: params, opt_state, step, rng, extra in
    that order; optax.adam's state as (ScaleByAdamState(count, mu, nu),
    EmptyState)), encoded by the port's msgpack writer. model trains with
    plain Adam (no --grad_clip, no --grad_accum); rng: the TrainState's
    raw key (two uint32), which the port does not carry."""
    from generative_models_tpu_torch.utils import msgpack

    names = {id(p): n for n, p in model.net.named_parameters()}
    params = [p for g in model.opt.param_groups for p in g['params']]
    st = model.opt.state
    counts = {int(st[p]['step']) for p in params}
    if len(counts) != 1:
        raise ValueError(f'Adam step counters differ: {counts}')
    moment = lambda key: params_to_flax({names[id(p)]: st[p][key] for p in params})
    tree = {
        'params': params_to_flax(model.net.state_dict()),
        'opt_state': {'0': {'count': np.array(counts.pop(), np.int32),
                            'mu': moment('exp_avg'), 'nu': moment('exp_avg_sq')},
                      '1': {}},
        'step': np.array(model.step, np.int32),
        'rng': np.array(rng, np.uint32),
        'extra': None,
    }
    return msgpack.encode(tree, sort_keys=False)


def phase_jax_ckpt():
    """A JAX package's TrainState read on the card: made at 2048 (the
    kernel route) and pixel_transformer at its default width take two
    steps on the card; their state is written as the JAX package's save
    writes it (flax_train_state_bytes; a CPU test holds those bytes equal
    to the JAX package's for the same weights) and read into a fresh model
    by load_weights. Every param and moment equal to the source's, bitwise,
    on the card; Adam's step counters on the card, equal to the count; the
    first step of the restored model makes no device-to-host copy and
    lands on the source's next step bitwise."""
    from generative_models_tpu_torch.utils.config import parse_args

    out = {}
    for name, flags, to_flax in (('made', MADE_FLAGS, made_params_to_flax),
                                 ('pixel_transformer', ['--model=pixel_transformer'],
                                  pixel_transformer_params_to_flax)):
        G, Model = parse_args(flags + ['--bs=64'])
        src = Model(G)
        gen = torch.Generator().manual_seed(3)
        xs = (torch.rand((3, 64, 28, 28, 1), generator=gen) > 0.5).float().cuda()
        src.train_step(xs[0])
        src.train_step(xs[1])
        path = JAX_CKPT_DIR / name / 'model.pt'
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = flax_train_state_bytes(src, to_flax, rng=(0, 17))
        path.write_bytes(blob)
        got = Model(G)
        got.load_weights(path)
        if (got.step, got.updates) != (2, 2):
            raise AssertionError(f'jax_ckpt {name}: restored step {got.step}, {got.updates}')
        for (k, p), q in zip(src.net.named_parameters(), got.net.parameters()):
            sa, sb = src.opt.state[p], got.opt.state[q]
            if q.device.type != 'cuda' or sb['exp_avg'].device.type != 'cuda':
                raise AssertionError(f'jax_ckpt {name}: {k} restored off the card')
            if sb['step'].device.type != 'cuda' or float(sb['step']) != 2:
                raise AssertionError(f'jax_ckpt {name}: {k} Adam step {sb["step"]}')
            if not (torch.equal(p, q) and torch.equal(sa['exp_avg'], sb['exp_avg'])
                    and torch.equal(sa['exp_avg_sq'], sb['exp_avg_sq'])):
                raise AssertionError(f'jax_ckpt {name}: {k} or its moments differ')
        dtoh = _dtoh_copies(f'the first step of a {name} read from a JAX TrainState',
                            lambda: got.train_step(xs[2]))
        src.train_step(xs[2])
        moved = {k: float((p - q).abs().max()) for (k, p), q in
                 zip(src.net.named_parameters(), got.net.parameters()) if not torch.equal(p, q)}
        log(f'[jax_ckpt] {name}: {len(blob)} bytes of flax msgpack read, '
            f'{len(list(got.net.parameters()))} params and moments on the card, bitwise; first '
            f'step {dtoh["copies"]} device-to-host copies; next step vs the source: '
            f'{"bitwise" if not moved else moved}')
        if dtoh['copies'] or moved:
            raise AssertionError(f'jax_ckpt {name}: {dtoh["copies"]} copies, moved {moved}')
        out[name] = dict(bytes=len(blob), first_step_dtoh=dtoh['copies'], next_step='bitwise')
    return out


def _stream_run(flags, chunk, tag):
    """One epoch of a fresh model (seed 0) through load_model_and_data and
    the epoch functions main.train calls: on the device's split (chunk
    None) or streamed at chunk. Returns (state dict after, before, metrics,
    epoch wall seconds)."""
    from generative_models_tpu_torch.main import (
        epoch_generator, load_model_and_data, train_epoch_streamed,
    )

    extra = [] if chunk is None else ['--stream_data=1', f'--stream_chunk={chunk}']
    model, dataset, _, _, G = load_model_and_data(
        flags + ['--bs=64', '--data_source=synthetic', f'--logdir={STREAM_DIR / tag}'] + extra)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    gen = epoch_generator(int(G.seed) + 2000, 0)
    threads = threading.active_count()
    torch.cuda.synchronize()
    t0 = time.time()
    if chunk is None:
        metrics = model.train_epoch(*dataset.epoch_batches(gen, train=True))
    else:
        metrics = train_epoch_streamed(model, dataset, gen, chunk)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if threading.active_count() != threads:
        raise AssertionError(f'stream {tag}: the producer thread was not joined')
    return model.net.state_dict(), before, metrics, wall


def phase_stream():
    """--stream_data=1 on the card (data/stream.py: pinned host batches
    copied on a side stream, the step's stream waiting on each copy's
    event): made at 2048 and diffusion at its defaults, one epoch of 20
    steps at bs=64 from a fresh model (seed 0) on the device's split, then
    streamed at --stream_chunk 1 and 16 (16 and a partial 4), then on the
    device's split again. The streamed runs' params against the first
    on-device run's, as the relative Frobenius distance over every
    parameter against that run's update: within twice the second on-device
    run's own distance (bitwise where the card repeats a run bitwise);
    every producer thread joined. The epochs' walls printed side by
    side."""
    import generative_models_tpu_torch.data.mnist as mnist

    mnist.TRAIN_N, mnist.TEST_N = 1280, 128
    out = {}
    for name, flags in (('made', MADE_FLAGS), ('diffusion', DIFF_FLAGS)):
        runs = {key: _stream_run(flags, chunk, f'{name}_{key}') for key, chunk in
                (('device', None), ('stream_1', 1), ('stream_16', 16), ('device_again', None))}
        ref, init, ref_m, _ = runs['device']
        upd = float(torch.sqrt(sum(((ref[k].double() - init[k].double()) ** 2).sum()
                                   for k in ref)))
        dist = {key: float(torch.sqrt(sum(((r[0][k].double() - ref[k].double()) ** 2).sum()
                                          for k in ref))) / upd
                for key, r in runs.items() if key != 'device'}
        wall = {key: r[3] for key, r in runs.items()}
        log(f'[stream] {name}: params vs the on-device run (relative to its update) '
            f'{json.dumps(dist)}; epoch wall (s) {json.dumps(wall)}; metrics '
            f'{json.dumps({k: r[2] for k, r in runs.items()})}')
        for key in ('stream_1', 'stream_16'):
            if dist[key] > 2 * dist['device_again']:
                raise AssertionError(f'stream {name} {key}: {dist[key]:.3g} from the on-device '
                                     f'run, which repeats within {dist["device_again"]:.3g}')
        out[name] = dict(rel_dist=dist, epoch_wall_sec=wall, steps=20)
    return out


def phase_cli_profile():
    """--profile=1 through main.main: made at 2048, one epoch (10 steps at
    bs=64, a save and evaluate each epoch): a Chrome trace under
    logdir/profile/ whose kernel events name Kernels G and H, counted."""
    import generative_models_tpu_torch.data.mnist as mnist

    mnist.TRAIN_N, mnist.TEST_N = 640, 128
    shutil.rmtree(CLI_PROFILE_DIR, ignore_errors=True)
    t0 = time.time()
    _, text = _run_main(MADE_FLAGS + ['--bs=64', '--epochs=1', '--save_n=1', '--profile=1',
                                      '--data_source=synthetic', f'--logdir={CLI_PROFILE_DIR}'])
    wall = time.time() - t0
    traces = sorted((CLI_PROFILE_DIR / 'profile').glob('*.json'))
    if len(traces) != 1:
        raise AssertionError(f'cli_profile: traces {traces}; printed {text[-400:]}')
    events = json.loads(traces[0].read_text())['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    counts = {k: sum(k in n for n in kernels) for k in ('masked_matmul_kernel',
                                                        'mask_out_matmul_kernel')}
    size = traces[0].stat().st_size
    log(f'[cli_profile] main.main with --profile=1 {wall:.2f}s; trace {size / 2**20:.1f} MiB, '
        f'{len(events)} events, {len(kernels)} kernels; Kernels G and H in it: {counts}')
    if not all(counts.values()):
        raise AssertionError(f'cli_profile: the trace does not name Kernels G and H: {counts}')
    return dict(wall_sec=wall, trace_mib=size / 2**20, events=len(events),
                kernel_events=len(kernels), named=counts)


def phase_diff_quant():
    """diffusion_model's --quantize on the card, w8a8 (Kernel I) and w8a16
    (Kernel J), from diff_train's model.pt (10 trained steps, --ema):
      * one UNet forward at batch 4 through a table over the trained net,
        against a CPU f32 copy's unquantized forward (DIFF_QUANT_REL): on
        the weights as trained, and with every ResBlock's output conv drawn
        (_live_resblocks: the time and class embeddings reach the output
        only through it, so on the trained weights, 10 steps from zero, the
        quantized layers can barely show); the card's quantized forward
        against its own unquantized one reported;
      * load_server at serve_bs=64 with --sampler=dpm2m --sample_steps=25:
        warm and one guided request with labels, I or J exactly
        DIFF_QUANT_N x DPM2M_25_CALLS launches a pass and nothing else, the
        table over the EMA copy that sampling reads; a request profiled."""
    from generative_models_tpu_torch.main import load_model_and_data
    from generative_models_tpu_torch.ops.int8 import QuantTable, quantize_dense_modules
    from generative_models_tpu_torch.serve import load_server

    model, _, _, _, G = load_model_and_data([f'--weights_from={DIFF_TRAIN_DIR / "model.pt"}',
                                             '--data_source=synthetic'])
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((4, 28, 28, 1), generator=gen)
    ls = torch.tensor([-15.0, -2.0, 3.0, 12.0])
    y = torch.tensor([1, -1, 5, 9], dtype=torch.int32)
    dev = model.device
    out = {}
    for weights in ('trained', 'live_resblocks'):
        if weights == 'live_resblocks':
            _live_resblocks(model)
        cpu = _cpu_copy(model, G, bf16=0)
        with torch.no_grad():
            ref = cpu.net.eval()(z, ls, guide=y)
            plain = model.net.eval()(z.to(dev), ls.to(dev), guide=y.to(dev))
        for mode in QUANT_MODES:
            quant = QuantTable(mode, quantize_dense_modules(model.net))
            if len(quant) != DIFF_QUANT_N:
                raise AssertionError(f'diff_quant: {len(quant)} quantized Linears')
            with torch.no_grad():
                got = model.net(z.to(dev), ls.to(dev), guide=y.to(dev), quant=quant)
            out[f'{weights}_{mode}'] = dict(vs_cpu_f32=_rel(got, ref),
                                            vs_card_plain=_rel(got, plain))
        out[f'{weights}_card_plain_vs_cpu_f32'] = _rel(plain, ref)
    log(f'[diff_quant] UNet forward, quantized on the card, vs a CPU f32 unquantized one '
        f'(relative Frobenius; bound {DIFF_QUANT_REL}): {json.dumps(out)}')
    for key, v in out.items():
        if isinstance(v, dict) and not v['vs_cpu_f32'] < DIFF_QUANT_REL:
            raise AssertionError(f'diff_quant {key}: {v}')

    serve = {}
    counters = _counters()
    for mode in QUANT_MODES:
        _reset(counters)
        srv, _ = load_server([f'--weights_from={DIFF_TRAIN_DIR / "model.pt"}', '--serve_bs=64',
                              '--sampler=dpm2m', '--sample_steps=25', f'--quantize={mode}'])
        warm = srv.warm()
        s = srv.sample(64, y=DIFF_LABELS, seed=7)
        torch.cuda.synchronize()
        launches = _read(counters)
        per_pass = DIFF_QUANT_N * DPM2M_25_CALLS
        expected = dict.fromkeys(launches, 0)
        expected[QUANT_KERNEL[mode]] = (srv.warm_passes + 1) * per_pass  # warm + the request
        _check_samples(f'diff_quant {mode}', s, 64)
        if srv.quant_kernels != DIFF_QUANT_N or launches != expected:
            raise AssertionError(f'diff_quant {mode}: {srv.quant_kernels} quantized, launches '
                                 f'{launches} != {expected}')
        prof = _profile(f'a quantized ({mode}) guided dpm2m-25 diffusion request',
                        lambda: srv.sample(64, y=DIFF_LABELS, seed=8), 8, device_only=True)
        serve[mode] = dict(warm_sec=warm, request_sec=list(srv.latencies), launches=launches,
                           launches_per_request=per_pass, profile=prof)
        log(f'[diff_quant] {mode}: warm {warm:.2f}s, requests (s) '
            f'{[round(v, 4) for v in srv.latencies]}; {QUANT_KERNEL[mode]} {per_pass} a request')
    return dict(forward=out, serve=serve)


def phase_parity():
    """The original reference's loss curves (reference_cpu_baseline.json:
    twelve models, 20-48 steps at bs=32) against the port's on the card:
    each port model at its registry defaults (and the recorder's
    overrides), seed 0, trained on the same sequential digits batches
    (data/parity.py parity_batches) for the reference's whole length, and
    held to the JAX package's parity contract (check_parity: learns and
    descends where the reference does, the converged window within TOL of
    the reference's, gan inside BAND). Each model's converged-window excess
    is printed beside its tolerance. A model of parity.TRACED is run from
    each of parity.SEEDS and held to the whole contract with
    parity.TRACED_BOUND in place of TOL; its readings' spread is printed.
    Any curve outside the contract fails the phase."""
    from generative_models_tpu_torch.data import parity

    refs = parity.reference_curves()
    out, failed = {}, {}
    for name in sorted(refs):
        seeds = parity.SEEDS if name in parity.TRACED else (0,)
        lim = parity.BAND.get(name, parity.TRACED_BOUND.get(name, parity.TOL.get(name)))
        runs = []
        for seed in seeds:
            t0 = time.time()
            ours, ref = parity.run_curve(name, 'cuda', refs, seed=seed)
            ex = parity.excess(name, ours, ref)
            try:
                parity.check_parity(name, ours, ref, tol=parity.TRACED_BOUND.get(name))
            except AssertionError as e:
                failed[f'{name}@{seed}'] = str(e)[:300]
            runs.append(dict(seed=seed, steps=len(ours), excess=ex, sec=time.time() - t0,
                             first=ours[0], last_window=parity.window_mean(ours),
                             within_tol=ex <= parity.TOL[name] if name in parity.TOL else None))
            log(f'[parity] {name} seed {seed}: {len(ours)} steps in {runs[-1]["sec"]:.1f}s; '
                f'converged window {runs[-1]["last_window"]:.4f} vs the reference\'s '
                f'{parity.window_mean(ref):.4f} ({"ratio" if name in parity.BAND else "excess"} '
                f'{ex:+.4f}, limit {lim}{", TOL " + str(parity.TOL[name]) if name in parity.TRACED else ""}); '
                f'{"OUTSIDE" if f"{name}@{seed}" in failed else "within"} the contract')
        out[name] = dict(runs=runs, limit=lim, ref_last_window=parity.window_mean(ref),
                         traced=name in parity.TRACED)
        if len(runs) > 1:
            exs = [r['excess'] for r in runs]
            log(f'[parity] {name}: excess over seeds {list(seeds)} from {min(exs):+.4f} to '
                f'{max(exs):+.4f} (mean {np.mean(exs):+.4f}), bound {lim}, TOL '
                f'{parity.TOL[name]}; traced: {parity.TRACED[name]}')
    if failed:
        raise AssertionError(f'parity: outside the contract: {json.dumps(failed)}')
    return out


# the export phase's artifacts: (label, load_server flags, labels of a
# request, the kernels a request must launch); each model at its serve
# phase's width, pixel_transformer and rnn also in both quantized modes,
# diffusion at its default (guided 250-step DDIM) and at dpm2m-25; in the
# order their artifacts come from EXPORT_WORKERS, the quick ones first
EXPORT_DIR = ROOT / 'build' / 'chip_smoke_export'
EXPORT_CASES = (
    ('rnn', ['--model=rnn'], None, ()),
    ('made_2048', MADE_FLAGS, None, ('masked_matmul',)),
    ('vqvae', ['--model=vqvae'], None, ('ln_matmul', 'block_tail')),
    *((f'rnn_{m}', ['--model=rnn', f'--quantize={m}'], None, (QUANT_KERNEL[m],))
      for m in QUANT_MODES),
    ('gan', ['--model=gan'], None, ()),
    ('vae', ['--model=vae'], None, ()),
    ('pixel_cnn', ['--model=pixel_cnn'], None, ()),
    ('gated_pixel_cnn', ['--model=gated_pixel_cnn'], None, ()),
    ('wavenet', ['--model=wavenet'], None, ()),
    ('pixel_transformer', ['--model=pixel_transformer'], None, ('ln_matmul', 'block_tail')),
    *((f'pixel_transformer_{m}', ['--model=pixel_transformer', f'--quantize={m}'], None,
       (QUANT_KERNEL[m],)) for m in QUANT_MODES),
    ('diffusion', DIFF_FLAGS, DIFF_LABELS, ()),
    ('diffusion_dpm2m_25', DIFF_FLAGS + ['--sampler=dpm2m', '--sample_steps=25'], DIFF_LABELS,
     ()),
)
# the export phase's exporting processes, each its artifacts in order: the
# tracing is host work (0.4 to ~50 s an artifact), so five processes trace
# beside the phase's requests, each the quick ones first; each builds the
# case's server from the same flags and seed, so the same weights, as the
# phase's live one
EXPORT_WORKERS = (
    ('rnn', 'pixel_cnn', 'pixel_transformer'),
    ('made_2048', 'gated_pixel_cnn', 'pixel_transformer_w8a8'),
    ('vqvae', 'wavenet', 'pixel_transformer_w8a16'),
    ('rnn_w8a8', 'rnn_w8a16', 'gan', 'vae', 'diffusion_dpm2m_25'),
    ('diffusion',),
)
# the serving shapes of the five gmt:: ops, for their dispatch cost: A and
# B at pixel_transformer's decode step, G at made's 2048 layer, I and J at
# its w8a8 / w8a16 fc1 product
EXPORT_OP_SHAPES = dict(ln_matmul=(64, 128, 384), block_tail=(64, 128),
                        masked_matmul=(64, 2048, 2048), int8_gemm=(64, 128, 512),
                        dequant_gemm=(64, 128, 512))


def _op_dispatch_us(reps=5, calls=300):
    """Host microseconds a call of each gmt:: op through the dispatcher
    (torch.ops.gmt.<op>, what the live and exported paths call) and of its
    CUDA implementation called directly, at the serving shapes, alternated
    reps times; the median of each and their difference."""
    from generative_models_tpu_torch.ops import decode_fused as df
    from generative_models_tpu_torch.ops import int8 as i8
    from generative_models_tpu_torch.ops import masked_dense as md

    g = torch.Generator(device='cuda').manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device='cuda')
    q = lambda *s: torch.randint(-127, 128, s, generator=g, device='cuda', dtype=torch.int8)
    B, C, N = EXPORT_OP_SHAPES['ln_matmul']
    bt_w = [r(C, C).bfloat16(), r(C), r(C), r(C), r(C, 4 * C).bfloat16(), r(4 * C),
            r(4 * C, C).bfloat16(), r(C)]
    M, K, Nm = EXPORT_OP_SHAPES['masked_matmul']
    Mi, Ki, Ni = EXPORT_OP_SHAPES['int8_gemm']
    cases = {
        'ln_matmul': (torch.ops.gmt.ln_matmul, df._ln_matmul_cuda,
                      (r(B, C), r(C), r(C), r(C, N).bfloat16(), r(N))),
        'block_tail': (torch.ops.gmt.block_tail, df._block_tail_cuda, (r(B, C), r(B, C), *bt_w)),
        'masked_matmul': (torch.ops.gmt.masked_matmul, md._masked_matmul_cuda,
                          (r(M, K), r(K, Nm), (r(K, Nm) > 0).to(torch.uint8), False)),
        'int8_gemm': (torch.ops.gmt.int8_gemm, i8._int8_gemm_cuda, (q(Mi, Ki), q(Ki, Ni))),
        'dequant_gemm': (torch.ops.gmt.dequant_gemm, i8._dequant_gemm_cuda,
                         (r(Mi, Ki), q(Ki, Ni))),
    }
    out = {}
    for name, (op, direct, args) in cases.items():
        times = {'op': [], 'direct': []}
        for _ in range(reps):
            for key, fn in (('op', op), ('direct', direct)):
                fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                times[key].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
        op_us, direct_us = float(np.median(times['op'])), float(np.median(times['direct']))
        out[name] = dict(op_us=op_us, direct_us=direct_us, overhead_us=op_us - direct_us,
                         shape=EXPORT_OP_SHAPES[name])
        log(f'[export] dispatch {name} {EXPORT_OP_SHAPES[name]}: torch.ops.gmt {op_us:.2f} us '
            f'a call, its CUDA implementation directly {direct_us:.2f} us '
            f'(+{op_us - direct_us:.2f} us)')
    return out


def _syncs(fn, stacks=None):
    """(fn's result, where each synchronizing CUDA call it made was
    issued): each one warns
    under torch.cuda.set_sync_debug_mode('warn'), every device-to-host
    copy among them; the count costs a request nothing, where a profiler
    trace of a 250-step guided request takes a minute to process.
    stacks: a list that takes each synchronizing call's Python stack. A
    warning that the mode's switch itself raises (the first switch of a
    process on the card raised one) is not fn's."""
    import traceback
    import warnings

    caught, running = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if running and 'synchronizing' in str(message):
            caught.append(f'{Path(filename).name}:{lineno}')
            if stacks is not None:
                stacks.append(''.join(traceback.format_stack(limit=14)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        running.append(True)
        try:
            out = fn()
        finally:
            running.clear()
            torch.cuda.set_sync_debug_mode(0)
    return out, caught


# the artifacts whose request is traced with Python stacks for its
# device-to-host copies (_dtoh_copies): a few thousand launches
# (pixel_transformer's 34k took ~25 s), and long enough that the trace
# keeps its events (vae's 3 ms request came back without its copy)
EXPORT_TRACED = ('vqvae', 'made_2048')


def export_worker(labels, cases=None, out_dir=None):
    """An exporting process (EXPORT_WORKERS): for each label, its case's
    server from load_server at serve_bs=64 and export_serving into out_dir
    (EXPORT_DIR), then <label>.json: the export's seconds and bytes (or the
    error). cases: {label: flags} (EXPORT_CASES')."""
    import traceback

    from generative_models_tpu_torch.serve import load_server

    cases = cases or {label: flags for label, flags, _, _ in EXPORT_CASES}
    out_dir = Path(out_dir or EXPORT_DIR)
    for label in labels:
        try:
            server, _ = load_server(cases[label] + ['--serve_bs=64'])
            t0 = time.time()
            nbytes = server.export_serving(out_dir / f'{label}.pt2')
            res = dict(export_sec=time.time() - t0, bytes=nbytes)
        except BaseException:  # argparse's refusals are SystemExit
            res = dict(error=traceback.format_exc())
        tmp = out_dir / f'{label}.json.tmp'
        tmp.write_text(json.dumps(res))
        tmp.rename(out_dir / f'{label}.json')  # whole, or not there
        if 'error' in res:
            sys.exit(1)


def _exported(label, worker, timeout=900, out_dir=EXPORT_DIR):
    """The result of label's exporting process (a Popen), waited for."""
    t0 = time.time()
    done = out_dir / f'{label}.json'
    while not done.exists():
        if time.time() - t0 > timeout or worker.poll() is not None:
            if done.exists():
                break
            raise AssertionError(f'export {label}: no artifact from its exporting process '
                                 f'(exit {worker.poll()})')
        time.sleep(0.1)
    res = json.loads(done.read_text())
    if 'error' in res:
        raise AssertionError(f'export {label} failed:\n{res["error"]}')
    return res, time.time() - t0


def export_one(label, flags, y, kernels, workers):
    """One artifact: a live server from load_server at serve_bs=64 (random
    weights from seed 0), its seed=7 request (timed, launches counted);
    the artifact its exporting process wrote from the same flags
    (export_sec, bytes; waited for), ExportedServer (load timed), and the
    artifact's seed=7 request (timed): bitwise the live batch, each
    kernel's launches the live request's and > 0 for the kernels given,
    and one synchronizing call (the batch's copy to the host); for the
    EXPORT_TRACED artifacts a second request under the profiler: one
    device-to-host copy on the card's timeline."""
    from generative_models_tpu_torch.serve import ExportedServer, load_server

    counters = _counters()
    server, _ = load_server(flags + ['--serve_bs=64'])
    _reset(counters)
    t0 = time.time()
    live, live_syncs = _syncs(lambda: server.sample(64, y=y, seed=7))
    live_sec = time.time() - t0
    live_launches = _read(counters)
    path = EXPORT_DIR / f'{label}.pt2'
    owner = next(w for w, labels in zip(workers, EXPORT_WORKERS) if label in labels)
    exported, waited = _exported(label, owner)
    t0 = time.time()
    ex = ExportedServer(path)
    load_sec = time.time() - t0
    _reset(counters)
    t0 = time.time()
    got, syncs = _syncs(lambda: ex.sample(64, y=y, seed=7))
    request_sec = time.time() - t0
    launches = _read(counters)
    if not np.array_equal(got, live):
        raise AssertionError(f'export {label}: the artifact\'s seed=7 batch is not the live '
                             f'one (max |diff| {float(np.abs(got - live).max()):.3g})')
    if launches != live_launches or any(launches[k] == 0 for k in kernels):
        raise AssertionError(f'export {label}: launches {launches}, live {live_launches}, '
                             f'expected > 0 for {kernels}')
    if len(syncs) != 1:
        raise AssertionError(f'export {label}: {len(syncs)} synchronizing calls in a request '
                             f'({syncs}; the live request\'s: {live_syncs}), expected 1 (the '
                             'batch\'s copy to the host)')
    res = dict(exported, waited_sec=waited, load_sec=load_sec, live_request_sec=live_sec,
               request_sec=request_sec, launches={k: v for k, v in launches.items() if v},
               syncs=len(syncs), live_syncs=len(live_syncs))
    if label in EXPORT_TRACED:
        copies = _dtoh_copies(f'export {label} request', lambda: ex.sample(64, y=y, seed=9), 4)
        if copies['copies'] != 1:
            raise AssertionError(f'export {label}: {copies["copies"]} device-to-host copies in '
                                 'a request, expected 1 (the batch)')
        res['dtoh_copies'] = copies['copies']
    log(f'[export] {label}: {json.dumps(res)}')
    return res, server, ex


def phase_export():
    """Every model's deployment artifact (EXPORT_CASES, export_one),
    exported by EXPORT_WORKERS' processes while this one serves; the
    pixel_transformer artifact's request profiled beside the live one's
    (the out-of-place cache writes' cost, predicted 24 ms of device time);
    vae's artifact served by a --from_export CLI subprocess on the card (a
    PNG); the gmt:: ops' dispatch cost (_op_dispatch_us)."""
    import warnings

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):  # the mode's first setting warns once
        torch.cuda.set_sync_debug_mode('warn')
        torch.cuda.set_sync_debug_mode(0)
    out = {}
    logs = [open(EXPORT_DIR / f'worker{i}.log', 'w') for i in range(len(EXPORT_WORKERS))]
    workers = [subprocess.Popen(
        [sys.executable, '-c', f'import chip_smoke; chip_smoke.export_worker({list(labels)!r})'],
        cwd=ROOT, stdout=f, stderr=subprocess.STDOUT) for labels, f in zip(EXPORT_WORKERS, logs)]
    others = []  # the CLI's process, started by _export_cases
    try:
        out.update(_export_cases(workers, others))
    finally:
        for w in workers + others:
            if w.poll() is None:
                w.kill()
            w.wait()
        for f in logs:
            f.close()
    if any(w.returncode for w in workers):
        raise AssertionError(f'export: exporting processes exited {[w.returncode for w in workers]}')
    out['dispatch'] = _op_dispatch_us()
    return out


def _export_cases(workers, others):
    """export_one over EXPORT_CASES; the pixel_transformer artifact's
    request profiled beside the live one's; vae's artifact through the
    --from_export CLI, whose process joins others."""
    out, png, cli = {}, EXPORT_DIR / 'cli.png', None
    for label, flags, y, kernels in EXPORT_CASES:
        out[label], server, ex = export_one(label, flags, y, kernels, workers)
        if label == 'vae':  # the CLI serves vae's artifact beside the next cases
            t_cli = time.time()
            cli = subprocess.Popen([sys.executable, '-m', 'generative_models_tpu_torch.serve',
                                    f'--from_export={EXPORT_DIR / "vae.pt2"}', '--n=4',
                                    f'--out={png}'], cwd=ROOT, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            others.append(cli)
        if label == 'pixel_transformer':
            prof = dict(live=_profile('live pixel_transformer request',
                                      lambda: server.sample(64, seed=11), 8, True),
                        exported=_profile('exported pixel_transformer request',
                                          lambda: ex.sample(64, seed=11), 8, True))
            prof['added_device_ms'] = prof['exported']['device_ms'] - prof['live']['device_ms']
            log(f'[export] pixel_transformer: the artifact\'s request takes '
                f'{prof["added_device_ms"]:.1f} ms more device time than the live one '
                f'(predicted 24 ms: 2 layers x 784 steps x 51.4 MB copied)')
            out[label]['profile'] = prof
        del server, ex
    stdout, stderr = cli.communicate(timeout=300)
    if cli.returncode != 0 or png.read_bytes()[:8] != b'\x89PNG\r\n\x1a\n':
        raise AssertionError(f'export: --from_export CLI rc {cli.returncode}: {stderr[-2000:]}')
    out['cli_sec'] = time.time() - t_cli
    log(f'[export] --from_export CLI subprocess {out["cli_sec"]:.1f}s (beside the cases after '
        f'vae): {stdout.strip().splitlines()[-2]}')
    return out



# ---------------------------------------------------------------------- #
# moe: --moe_experts at pixel_transformer's default width
# ---------------------------------------------------------------------- #
MOE_DIR = ROOT / 'build' / 'chip_smoke_moe'
MOE_FLAGS = ['--model=pixel_transformer', '--moe_experts=8']
# the quant table's thresholds take q, k, v and proj (128 x 128) of each of
# the 2 layers and leave out the router (128 x 8) and the stacked experts
MOE_QUANT = 8


def phase_moe():
    """pixel_transformer --moe_experts=8 trained, served, quantized and
    exported through its entry points, with exact launch counts; the
    artifact is traced by a process of its own (export_worker) while this
    one serves, and its seed=7 batch held bitwise to the live server's."""
    import generative_models_tpu_torch.data.mnist as mnist

    train_n, test_n, bs, L, T = 640, 128, 64, 2, 784
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history, _ = _run_main(MOE_FLAGS + [f'--bs={bs}', '--epochs=1', '--save_n=1',
                                        '--data_source=synthetic', f'--logdir={MOE_DIR}'])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    steps, eval_batches, evals = train_n // bs, test_n // bs, 2
    expected = dict.fromkeys(launches, 0)
    expected.update(causal_attention_fwd=L * (eval_batches * evals + steps),
                    flash_bwd_dq=L * steps, flash_bwd_dkv=L * steps)
    if launches != expected:
        raise AssertionError(f'moe train launch counts {launches} != expected {expected}')
    nlogp = [h['eval/nlogp'] for h in history]
    aux = history[1].get('pixel_transformer/train/moe_aux')
    if not nlogp[1] < nlogp[0] or aux is None or not np.isfinite(aux):
        raise AssertionError(f'moe train: eval/nlogp {nlogp}, train moe_aux {aux}')
    for name in ('model.pt', 'hps.yaml', 'sampling_process_1.gif'):
        if not (MOE_DIR / name).is_file():
            raise AssertionError(f'moe train: {name} was not written')
    log(f'[moe] main.main {wall:.2f}s; launches {launches}; eval/nlogp {nlogp}; train moe_aux '
        f'{aux}; dt/train {history[1]["dt/train"]:.3f}s for {steps} steps')

    ckpt = MOE_DIR / 'model.pt'
    cases = {'moe_serve': [f'--weights_from={ckpt}']}
    with open(MOE_DIR / 'exporter.log', 'w') as f:
        exporter = subprocess.Popen(
            [sys.executable, '-c', 'import chip_smoke; chip_smoke.export_worker('
             f'["moe_serve"], {cases!r}, {str(MOE_DIR)!r})'],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        try:
            served = _moe_serve(ckpt, counters, exporter, L, T)
        finally:
            if exporter.poll() is None:
                exporter.kill()
            exporter.wait()
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history, **served)


def _moe_serve(ckpt, counters, exporter, L, T):
    """phase_moe from its model.pt on: served, quantized, gradients, the
    artifact that exporter wrote, then profiles."""
    from generative_models_tpu_torch.main import load_model_and_data
    from generative_models_tpu_torch.serve import ExportedServer, load_server

    _reset(counters)
    server, G = load_server([f'--weights_from={ckpt}', '--serve_bs=64'])
    warm = server.warm()
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    x = torch.as_tensor(a, device=server.model.device).reshape(64, T, 1)
    score = server.model.eval_loss(x)
    torch.cuda.synchronize()
    serve_launches = _read(counters)
    expected = dict.fromkeys(serve_launches, 0)
    expected['causal_attention_fwd'] = L  # the scoring forward; the decode runs no kernel
    if serve_launches != expected:
        raise AssertionError(f'moe serve launch counts {serve_launches} != expected {expected}')
    if not np.array_equal(a, b) or a.shape != (64, 28, 28, 1) or not np.isin(a, (0., 1.)).all():
        raise AssertionError('moe serve: seed=7 twice differs, or the batch is malformed')
    if not all(np.isfinite(v) for v in score.values()):
        raise AssertionError(f'moe serve: scoring {score}')
    log(f'[moe] served: warm {warm:.2f}s, requests {[round(v, 4) for v in server.latencies]}; '
        f'seed=7 scored {score}')

    quant = {}
    for mode in QUANT_MODES:
        qs, _ = load_server([f'--weights_from={ckpt}', '--serve_bs=64', f'--quantize={mode}'])
        _reset(counters)
        q = qs.sample(64, seed=7)
        torch.cuda.synchronize()
        ql = _read(counters)
        want = dict.fromkeys(ql, 0)
        want[QUANT_KERNEL[mode]] = MOE_QUANT * T
        if qs.quant_kernels != MOE_QUANT or ql != want:
            raise AssertionError(f'moe {mode}: {qs.quant_kernels} quantized, launches {ql} != '
                                 f'{want}')
        if not np.isin(q, (0., 1.)).all():
            raise AssertionError(f'moe {mode}: values outside {{0, 1}}')
        quant[mode] = dict(launches=ql, per_request=MOE_QUANT * T,
                           request_sec=qs.latencies[-1], differs_from_plain=float((q != a).mean()))
        log(f'[moe] {mode}: {json.dumps(quant[mode])}')

    model, dataset, _, _, G = load_model_and_data([f'--weights_from={ckpt}',
                                                   '--data_source=synthetic'])
    xb = dataset.first_test_batch(0)[0][:8]
    model.backward(xb)
    cpu = _cpu_copy(model, G)
    cpu.backward(xb.cpu())
    grads = grad_check('moe_grads', model, cpu)

    export, waited = _exported('moe_serve', exporter, out_dir=MOE_DIR)
    t0 = time.time()
    ex = ExportedServer(MOE_DIR / 'moe_serve.pt2', 'cuda')
    export_equal = bool(np.array_equal(ex.sample(64, seed=7), a))
    if not export_equal:
        raise AssertionError('moe export: the artifact\'s seed=7 batch is not the live one')
    export.update(waited_sec=waited, load_and_request_sec=time.time() - t0, bitwise=export_equal)
    log(f'[moe] export {json.dumps(export)}')

    # profiled once the exporting process has ended: its tracing shares the host
    bx = dataset.first_test_batch(1)[0]
    prof = dict(train_step=_profile('moe train step', lambda: model.train_step(bx), 10),
                request=_count_launches('one moe request', lambda: server.sample(64, seed=11)),
                decode_window=_profile(
                    f'{len(PT_DECODE_WINDOW)} decode steps of a moe request',
                    _decode_window(server, PT_DECODE_WINDOW), 10))
    return dict(serve_launches=serve_launches, latencies=list(server.latencies), warm_sec=warm,
                export=export, quant=quant, grads_max_rel_err=max(grads['rel_err'].values()),
                profile=prof)


# ---------------------------------------------------------------------- #
# mesh: the process group's code path on one card
# ---------------------------------------------------------------------- #
MESH_DIR = ROOT / 'build' / 'chip_smoke_mesh'
MESH_CASES = (  # (label, flags, mesh); 3 steps at bs=64, one eval batch
    ('pixel_transformer', ['--model=pixel_transformer'], 'data:1,model:1'),
    ('diffusion', DIFF_FLAGS + ['--sampler=dpm2m', '--sample_steps=25'], 'data:1,model:1'),
    ('gan', ['--model=gan'], 'data:1,model:1'),
)
# the pipe and expert axes: each run once with no group here and once in
# the torchrun process (pipe with --fsdp=1), not twice with no group
MESH_AXIS_CASES = (
    ('pixel_transformer_pipe', ['--model=pixel_transformer'], 'data:1,pipe:1,model:1'),
    ('moe', MOE_FLAGS, 'data:1,expert:1'),
)
MESH_TRAIN_N, MESH_TEST_N = 192, 64
# the largest distance allowed between a mesh run's trained weights and the
# no-group run's, over the norm of the no-group run's update (0: bitwise,
# the metrics too; MESH_METRIC_BOUND the metrics' largest difference
# elsewhere). On an NVIDIA H100 80GB HBM3 (700.00 W): two no-group runs of
# gan lie 2.0e-4 apart (cuDNN's weight-gradient algorithms are not
# deterministic), its group runs 6.3e-4; diffusion's no-group runs are
# bitwise and its group runs 2.2e-3 off: the group's _Copy nodes change the
# order in which autograd sums a gradient with three consumers (on the CPU
# in f32: bitwise at step 0, not from step 1 on), which bf16 and Adam's
# near-zero-gradient elements widen. A stale or dropped gradient moves it
# by a sizeable part of 1. moe's router reads the input that the expert
# axis's _Copy also takes: the same reordering.
MESH_BOUND = dict(pixel_transformer=0.0, diffusion=1e-2, gan=1e-2, pixel_transformer_pipe=0.0,
                  moe=1e-2)
MESH_METRIC_BOUND = 1e-3
# pipe:1 against no pipe axis: M = 4 microbatches sum each weight's
# gradient in another order than one product over the 64 rows, and the
# products of 16 rows round apart from those of 64 (bf16 operands), the
# gap a diffusion group run shows; held as MESH_BOUND's 1e-2. The attention
# key biases, whose exact gradient is 0 (softmax does not see a constant
# added to a row's scores), move by Adam's sign of their rounding: held
# apart, each element within 2 lr a step, as the CPU tests hold them
PIPE_BOUND = 1e-2
ZERO_GRAD = ('attn.key.bias',)
MESH_SERVE = (  # (label, the run whose model.pt serves, flags); serve_bs=64, seed=7
    ('pixel_transformer', 'pixel_transformer', []),
    ('pixel_transformer_w8a16', 'pixel_transformer', ['--quantize=w8a16']),
    ('diffusion', 'diffusion', []),
)
MESH_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as cs
import generative_models_tpu_torch.data.mnist as mnist
from generative_models_tpu_torch.parallel.mesh import get_mesh

args = json.loads(sys.argv[2])
counters = cs._counters()
for run in args['runs']:
    mnist.TRAIN_N, mnist.TEST_N = args['train_n'], args['test_n']
    out = cs.mesh_run(run['argv'], counters, run['label'], timed=run['timed'])
    mesh = get_mesh()
    out.update(backend=dist.get_backend(), world=dist.get_world_size(), grouped=mesh.grouped,
               sizes=mesh.sizes, device=torch.cuda.current_device())
    with open(run['out'], 'w') as f:
        json.dump(out, f)
for run in args['serve']:
    out = cs.mesh_serve(run['argv'], counters)
    np.save(run['out'] + '.npy', out.pop('batch'))
    out.update(backend=dist.get_backend(), world=dist.get_world_size())
    with open(run['out'], 'w') as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def mesh_run(argv, counters, label, steps=5, timed=True):
    """main.main's load and train on argv, its launches counted and the
    initial weights written beside model.pt (init.pt); where timed, the
    median wall of `steps` more train steps, each synchronised (the
    epoch's dt/train holds the first steps' warm-up: NCCL's and the
    libraries'), and one more profiled. Returns launches, wall seconds,
    the history, the step ms and the profile."""
    import contextlib
    import io

    from generative_models_tpu_torch.main import load_model_and_data, train

    _reset(counters)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        model, dataset, ae, cls, G = load_model_and_data(argv)
        init = model.net_state()
        if model.mesh.is_main:
            Path(G.logdir).mkdir(parents=True, exist_ok=True)
            torch.save(init, Path(G.logdir) / 'init.pt')
        history = train(model, dataset, ae, cls, G)
    torch.cuda.synchronize()
    out = dict(launches=_read(counters), wall_sec=time.time() - t0, history=history)
    if not timed:
        return out
    bx, by = dataset.epoch_batches(torch.Generator().manual_seed(0))
    times = []
    for i in range(steps + 1):  # the first warms
        t1 = time.time()
        model.train_step(bx[i % len(bx)], by[i % len(bx)])
        torch.cuda.synchronize()
        times.append((time.time() - t1) * 1e3)
    out['step_ms'] = sorted(times[1:])[steps // 2]
    out['profile'] = _profile(f'{label} train step', lambda: model.train_step(bx[0], by[0]), 8)
    return out


def mesh_serve(argv, counters):
    """load_server on argv and one seed=7 request of 64 (no warm pass),
    its launches counted; under a process group rank 0 then sends the
    stop message (a world of one has no follower). Returns the batch,
    the launches, the request's seconds and whether the server ran over
    ranks."""
    from generative_models_tpu_torch.serve import load_server

    server, _ = load_server(argv + ['--serve_bs=64'])
    _reset(counters)
    batch = server.sample(64, seed=7)
    torch.cuda.synchronize()
    out = dict(batch=batch, launches=_read(counters), request_sec=server.latencies[-1],
               ranks=bool(getattr(server, 'ranks', False)))
    if out['ranks']:
        server.stop()
    return out


def _torchrun(script, args, timeout=600):
    """python -m torch.distributed.run --standalone --nproc_per_node=1
    script ROOT json(args), in its own process group, killed whole on a
    timeout; returns its output, raising on a non-zero exit."""
    import os
    import signal

    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node=1',
           str(script), str(ROOT), json.dumps(args)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, cwd=ROOT)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f'torchrun {script.name} did not end in {timeout}s')
    if proc.returncode:
        raise AssertionError(f'torchrun {script.name} exited {proc.returncode}: {out[-4000:]}')
    return out


def _net(path):
    """A model.pt's (or init.pt's) net as float64 tensors on the CPU."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return {k: v.double() for k, v in sd.get('net', sd).items()}


def _run_diff(ref, run, init, free=(), lr=1e-3, steps=3):
    """How far run's trained weights and metrics lie from ref's (mesh_run
    results, nets from _net): the largest element difference, the norm of
    the difference over the norm of ref's update from init (a dropped or
    stale reduction moves it by a sizeable part of 1), and the metrics'
    largest difference. The entries ending in one of free (an exact
    gradient of 0) are left out of the norms and held elementwise within
    2 lr a step (free_max_abs, free_ok)."""
    a, b = ref['net'], run['net']
    if set(a) != set(b) or any(a[k].shape != b[k].shape for k in a):
        raise AssertionError('model.pt entries differ in names or shapes')
    if not all(torch.isfinite(v).all() for v in b.values()):
        raise AssertionError('non-finite parameters')
    held = [k for k in a if not k.endswith(tuple(free))] if free else list(a)
    sq = lambda d: float(sum(float(v.square().sum()) for v in d))
    delta = sq(a[k] - b[k] for k in held) ** 0.5
    update = sq(a[k] - init[k] for k in held) ** 0.5
    metrics = [abs(v - run['history'][i][k]) for i, h in enumerate(ref['history'])
               for k, v in h.items() if not k.startswith('dt/') and isinstance(v, float)]
    out = dict(max_abs=max(float((a[k] - b[k]).abs().max()) for k in held),
               rel_to_update=delta / update, update_norm=update,
               metrics_max_abs=max(metrics, default=0.0))
    if free:
        gap = max((float((a[k] - b[k]).abs().max()) for k in a if k not in held), default=0.0)
        out.update(free_max_abs=gap, free_ok=gap <= 2 * lr * steps * (1 + 1e-6))
    return out


def phase_mesh():
    """Each of MESH_CASES through main.main under torchrun
    --nproc_per_node=1 with --mesh=data:1,model:1, with --fsdp=1 (timed)
    and without (the data axis's all-reduce in place of FSDP2's
    reduce-scatter), against the same flags with no group in this
    process, twice: the second no-group run measures how far two runs of
    one program lie apart on the card (MESH_BOUND). Then the pipe and
    expert axes (MESH_AXIS_CASES), each once with no group and once in the
    group: pixel_transformer at pipe:1 against its no-pipe run (C, E and D
    four times its launches: M = 4 microbatches; no A or B: the pipeline's
    decode is the per-op chain; PIPE_BOUND), its seed=7 batch served from
    its model.pt bitwise the --fused_decode=0 one-process server's, and
    moe at expert:1. Last, servers in the group at data:1,model:1
    (MESH_SERVE: pixel_transformer plain and w8a16, diffusion dpm2m-25)
    against the one-process servers of the same model.pt: the seed=7
    batch (bitwise for pixel_transformer, diffusion within
    DIFF_CHAIN_REL), every kernel's launches equal."""
    import generative_models_tpu_torch.data.mnist as mnist

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    worker = MESH_DIR / 'mesh_worker.py'
    worker.write_text(MESH_WORKER)
    counters = _counters()
    flags = lambda fl, mesh: fl + ['--bs=64', '--epochs=1', '--save_n=1',
                                   '--data_source=synthetic', f'--mesh={mesh}']
    cases = [(label, flags(fl, mesh)) for label, fl, mesh in MESH_CASES]
    axis_cases = [(label, flags(fl, mesh)) for label, fl, mesh in MESH_AXIS_CASES]
    runs = {}
    in_process = [(label, base, run, timed) for label, base in cases
                  for run, timed in (('plain', True), ('plain_again', False))]
    in_process += [(label, base, 'plain', label == 'pixel_transformer_pipe')
                   for label, base in axis_cases]
    for label, base, run, timed in in_process:  # no group, in this process
        mnist.TRAIN_N, mnist.TEST_N = MESH_TRAIN_N, MESH_TEST_N
        runs[label, run] = mesh_run(base + [f'--logdir={MESH_DIR / label / run}'], counters,
                                    f'mesh {label}, no group,', timed=timed)
    # every group run and server in one torchrun process: one group, one NCCL start
    group_runs = [(label, run, base + flags) for label, base in cases
                  for run, flags in (('fsdp', ['--fsdp=1']), ('group', []))]
    group_runs += [(label, 'group', base + (['--fsdp=1'] if 'pipe' in label else []))
                   for label, base in axis_cases]
    serve_argv = {label: [f'--weights_from={MESH_DIR / src / "plain" / "model.pt"}', *fl]
                  for label, src, fl in MESH_SERVE}
    t0 = time.time()
    worker_out = _torchrun(worker, dict(train_n=MESH_TRAIN_N, test_n=MESH_TEST_N, runs=[
        dict(argv=argv + [f'--logdir={MESH_DIR / label / run}'], timed=run == 'fsdp',
             out=str(MESH_DIR / f'{label}_{run}.json'), label=f'mesh {label}, world-1 group,')
        for label, run, argv in group_runs], serve=[
        dict(argv=argv + ['--mesh=data:1,model:1'], out=str(MESH_DIR / f'serve_{label}.json'))
        for label, argv in serve_argv.items()]))
    subprocess_sec = time.time() - t0
    for line in worker_out.splitlines():
        if line.startswith('[profile]'):
            log(line)  # the group's profiled steps
    faults, out = [], {}
    for label, _ in cases + axis_cases:
        names = ('plain', 'plain_again', 'fsdp', 'group') if (label, 'plain_again') in runs else (
            'plain', 'group')
        for run in names:
            r = runs.setdefault((label, run), {})
            if run in ('fsdp', 'group'):
                r.update(json.loads((MESH_DIR / f'{label}_{run}.json').read_text()))
                if r['backend'] != 'nccl' or r['world'] != 1 or not r['grouped']:
                    faults.append(f'mesh {label} {run}: backend {r["backend"]}, world '
                                  f'{r["world"]}, grouped {r["grouped"]}')
            if r['launches'] != runs[label, 'plain']['launches']:
                faults.append(f'mesh {label}: launches {r["launches"]} in the {run} run, '
                              f'{runs[label, "plain"]["launches"]} in the no-group run')
            if not all(np.isfinite(v) for h in r['history'] for v in h.values()):
                faults.append(f'mesh {label} {run}: non-finite metrics')
            r['net'] = _net(MESH_DIR / label / run / 'model.pt')
        init = _net(MESH_DIR / label / 'plain' / 'init.pt')
        plain, bound = runs[label, 'plain'], MESH_BOUND[label]
        free = ZERO_GRAD if bound else ()
        diffs = {run: _run_diff(plain, runs[label, run], init, free) for run in names[1:]}
        for run, d in diffs.items():
            if (d['rel_to_update'] > bound or d['metrics_max_abs'] > (bound and MESH_METRIC_BOUND)
                    or not d.get('free_ok', True)):
                faults.append(f'mesh {label}: the {run} run lies {d} from the no-group run, over '
                              f'the bound {bound} (metrics {bound and MESH_METRIC_BOUND})')
        timed = runs[label, 'fsdp' if 'fsdp' in names else 'plain']
        res = dict(
            launches=plain['launches'], backend=runs[label, 'group']['backend'], bound=bound,
            diffs=diffs, params_bitwise={run: d['max_abs'] == 0 for run, d in diffs.items()},
            # the group's wall and step times both from its timed (FSDP) run where there is one
            wall_sec_group=runs[label, 'fsdp' if 'fsdp' in names else 'group']['wall_sec'],
            wall_sec_plain=plain['wall_sec'],
            subprocess_sec=subprocess_sec,
            **({'step_ms_group': timed['step_ms'], 'profile_group': timed['profile'],
                'step_ms_plain': plain['step_ms'], 'profile_plain': plain['profile']}
               if 'fsdp' in names else {}))
        log(f'[mesh] {label}: {json.dumps(res)}')
        out[label] = res

    # pipe:1 against no pipe: four times C, E and D (M = 4), no A or B
    dense, pipe = runs['pixel_transformer', 'plain'], runs['pixel_transformer_pipe', 'plain']
    fourfold = ('causal_attention_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')
    want = {k: 4 * v if k in fourfold else 0 if k in ('ln_matmul', 'block_tail') else v
            for k, v in dense['launches'].items()}
    if pipe['launches'] != want:
        faults.append(f'mesh pipe:1 launches {pipe["launches"]} != {want}')
    d = _run_diff(dense, pipe, _net(MESH_DIR / 'pixel_transformer' / 'plain' / 'init.pt'),
                  ZERO_GRAD)
    if d['rel_to_update'] > PIPE_BOUND or d['metrics_max_abs'] > MESH_METRIC_BOUND or (
            not d['free_ok']):
        faults.append(f'mesh pipe:1 lies {d} from the no-pipe run, over {PIPE_BOUND}')
    out['pixel_transformer_pipe'].update(
        vs_no_pipe=d, launches_vs_no_pipe=want, step_ms_no_pipe=dense['step_ms'],
        step_ms_pipe=pipe['step_ms'], profile_pipe=pipe['profile'])
    log(f'[mesh] pipe:1 vs no pipe: {json.dumps(d)}; step ms {pipe["step_ms"]:.3f} vs '
        f'{dense["step_ms"]:.3f}')

    # the servers: pipe:1's model.pt (its decode the per-op chain) against
    # the --fused_decode=0 one-process server, then each group server
    # against the one-process server of its model.pt
    ckpt = MESH_DIR / 'pixel_transformer_pipe' / 'plain' / 'model.pt'
    served = {k: mesh_serve([f'--weights_from={ckpt}', *fl], counters)
              for k, fl in (('pipe', []), ('fused_decode_0', ['--mesh=', '--fused_decode=0']))}
    if not np.array_equal(served['pipe']['batch'], served['fused_decode_0']['batch']) or any(
            v for r in served.values() for v in r['launches'].values()):
        faults.append(f'mesh pipe:1 server: batch bitwise '
                      f'{np.array_equal(served["pipe"]["batch"], served["fused_decode_0"]["batch"])}'
                      f', launches {[r["launches"] for r in served.values()]}')
    out['pixel_transformer_pipe']['serve'] = {k: dict(request_sec=r['request_sec'],
                                                      launches=r['launches'])
                                              for k, r in served.items()}
    for label, argv in serve_argv.items():
        group = json.loads((MESH_DIR / f'serve_{label}.json').read_text())
        group_batch = np.load(MESH_DIR / f'serve_{label}.json.npy')
        one = mesh_serve(argv, counters)
        bitwise = bool(np.array_equal(group_batch, one['batch']))
        rel = _rel(torch.from_numpy(group_batch), torch.from_numpy(one['batch']))
        ok = bitwise or (label == 'diffusion' and rel <= DIFF_CHAIN_REL)
        if not ok or group['launches'] != one['launches'] or not group['ranks'] or (
                group['backend'] != 'nccl' or one['ranks']):
            faults.append(f'mesh serve {label}: bitwise {bitwise}, rel {rel}, launches '
                          f'{group["launches"]} vs {one["launches"]}, group {group}')
        res = dict(bitwise=bitwise, rel_err=rel, launches=group['launches'],
                   request_sec_group=group['request_sec'], request_sec_plain=one['request_sec'])
        log(f'[mesh] serve {label} at data:1,model:1 vs one process: {json.dumps(res)}')
        out[f'serve_{label}'] = res
    if faults:
        raise AssertionError('; '.join(faults))
    return out


GRAPHS_DIR = ROOT / 'build' / 'chip_smoke_graphs'
GRAPH_STEPS = 6  # an epoch: the warm-up step, the capture and 4 replays
GRAPH_CASES = (  # (label, flags, steps): every registry name at its default width, bs=64
    ('pixel_transformer', ['--model=pixel_transformer'], GRAPH_STEPS),
    ('vqvae', ['--model=vqvae'], GRAPH_STEPS),
    ('made', ['--model=made'], GRAPH_STEPS),
    ('rnn', ['--model=rnn'], GRAPH_STEPS),
    ('wavenet', ['--model=wavenet'], GRAPH_STEPS),
    ('pixel_cnn', ['--model=pixel_cnn'], GRAPH_STEPS),
    ('gated_pixel_cnn', ['--model=gated_pixel_cnn'], GRAPH_STEPS),
    ('diffusion_model', DIFF_FLAGS, GRAPH_STEPS),
    ('vae', ['--model=vae'], GRAPH_STEPS),
    ('gan', ['--model=gan'], GRAPH_STEPS),
    ('autoencoder', ['--model=autoencoder'], GRAPH_STEPS),
    ('classifier', ['--model=classifier'], GRAPH_STEPS),
    ('diffusion_ema', DIFF_FLAGS + ['--ema=0.999', '--dropout=0.1'], GRAPH_STEPS),
    ('diffusion_student', DIFF_FLAGS + ['--timesteps=128', '--teacher_mode=step2', '--lr=1e-4'],
     GRAPH_STEPS),
    ('made_2048_schedule', MADE_FLAGS + MADE_SCHEDULE, 8),  # two micro-step kinds
    ('pixel_transformer_seq4', ['--model=pixel_transformer', f'--mesh=seq:{SEQ}'], GRAPH_STEPS),
    ('pixel_transformer_moe', ['--model=pixel_transformer', '--moe_experts=8'], GRAPH_STEPS),
    ('pixel_transformer_remat', ['--model=pixel_transformer', '--remat=1'], GRAPH_STEPS),
    ('gan_sn', ['--model=gan', '--spectral_norm=1'], GRAPH_STEPS),
)
GRAPH_UNROLLS = (1, 8)  # pixel_transformer's --decode_unroll against 0, the per-step loop


def _opt_states(model):
    """Every optimizer's state tensors, by optimizer name and index."""
    return {f'{name}.{i}.{k}': v for name, o in model.optimizers().items()
            for i, st in enumerate(o.state.values()) for k, v in st.items()}


def _graph_diff(eager, graphed):
    """What differs between two models trained the two ways: net entries,
    optimizer states, host counters, the training draws' generator."""
    out = [f'net.{k}' for (k, a), b in zip(eager.net.state_dict().items(),
                                           graphed.net.state_dict().values())
           if not torch.equal(a, b)]
    ea, ga = _opt_states(eager), _opt_states(graphed)
    out += [k for k in ea if k not in ga or not torch.equal(ea[k], ga[k])]
    out += [k for k in ('step', 'updates', 'mini_step')
            if getattr(eager, k) != getattr(graphed, k)]
    if not torch.equal(eager._gen.get_state(), graphed._gen.get_state()):
        out.append('_gen')
    return out


def _graph_pair(label, flags, steps, teacher=None):
    """One epoch of `steps` at bs=64 two ways from the same init, batches
    and CUDA seed: the per-step loop (--jit_epoch=0: train_step a step,
    mean_metrics) and train_epoch (--jit_epoch=1: CUDA graphs), both on
    cuDNN's deterministic algorithms (a conv model's eager step is not
    bitwise repeatable on the default ones: its weight gradients sum in
    another order from run to run). Bitwise: params and buffers, every
    optimizer's state, host counters, the epoch's metric floats, the
    training generator's state, the default CUDA generator's state; every
    kernel counter equal. Where they differ, a second per-step run says
    whether the eager path itself repeats. Then steps each way on the
    default algorithms, the graphs captured anew, timed (host clock around
    a synchronised step, the median of 3) and traced (device ms,
    kernels)."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch import data as data_lib
    from generative_models_tpu_torch.models.base import mean_metrics
    from generative_models_tpu_torch.ops.common import deterministic_convs
    from generative_models_tpu_torch.utils.config import parse_args

    if teacher is not None:
        flags = flags + [f'--teacher_path={teacher}']
    G, Model = parse_args(flags + ['--bs=64', '--data_source=synthetic'])
    mnist.TRAIN_N, mnist.TEST_N = 64 * (steps + 1), 64
    dataset = data_lib.load_mnist(G, torch.device('cuda'))
    bx, by = dataset.epoch_batches(torch.Generator().manual_seed(1))
    counters = _counters()

    def run(mode):
        torch.cuda.manual_seed(0)
        model = Model(G)
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.time()
        if mode == 'eager':
            metrics = mean_metrics([model.train_step(bx[i], by[i]) for i in range(steps)])
        else:
            metrics = model.train_epoch(bx[:steps], by[:steps])
        torch.cuda.synchronize()
        return dict(model=model, metrics=metrics, launches=_read(counters),
                    epoch_sec=time.time() - t0, rng=torch.cuda.get_rng_state())

    with deterministic_convs():
        eager, graphed = run('eager'), run('graphed')
        faults = _graph_diff(eager['model'], graphed['model'])
        if faults:
            again = _graph_diff(eager['model'], run('eager')['model'])
            faults.append(f'eager vs eager: {again[:4] or "bitwise"}')
    if eager['metrics'] != graphed['metrics']:
        faults.append(f'metrics {eager["metrics"]} vs {graphed["metrics"]}')
    if eager['launches'] != graphed['launches']:
        faults.append(f'launches {eager["launches"]} vs {graphed["launches"]}')
    if not torch.equal(eager['rng'], graphed['rng']):
        faults.append('the default CUDA generator')
    if faults:
        raise AssertionError(f'graphs {label}: the graphed epoch differs from the per-step '
                             f'loop: {faults[:8]}')
    # one more step each way, as the path runs: on cuDNN's default
    # algorithms, the graphs captured anew on them (a warm-up step and a
    # capture first), then the first micro-step kind's graph replayed
    i = steps
    em, gm = eager['model'], graphed['model']
    gm._graphs = None
    step_eager = lambda: mean_metrics([em.train_step(bx[i], by[i])])
    step_graphed = lambda: gm.train_epoch(bx[i:i + 1], by[i:i + 1])
    for _ in range(2 * gm.accum()):
        step_graphed()
    out = dict(steps=steps, metrics=eager['metrics'],
               launches={k: v for k, v in eager['launches'].items() if v},
               epoch_sec=dict(eager=eager['epoch_sec'], graphed=graphed['epoch_sec']))
    for mode, fn in (('eager', step_eager), ('graphed', step_graphed)):
        wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall.append((time.time() - t0) * 1e3)
        out[mode] = dict(step_wall_ms=sorted(wall)[1],
                         trace=_traced_counts(f'graphs {label} {mode} step', fn))
    log(f'[graphs] {label}: {steps} steps bitwise; step wall {out["eager"]["step_wall_ms"]:.2f} '
        f'ms eager, {out["graphed"]["step_wall_ms"]:.2f} ms graphed; device '
        f'{out["eager"]["trace"]["device_ms"]:.2f} / {out["graphed"]["trace"]["device_ms"]:.2f} '
        f'ms; kernels {out["eager"]["trace"]["launches"]} / '
        f'{out["graphed"]["trace"]["launches"]}; launches {out["launches"]}; traced a step '
        f'{out["graphed"]["trace"]["kernels"]} graphed, as counted')
    return out


TRACE_TRIES = 5  # traces of a check taken before it fails (a trace may lose launches)


def _traced_counts(label, fn):
    """fn traced (_count_launches) from counters at 0: the trace's launches
    of each wrapper's kernel functions must equal its counter, which a
    graph's replay advances by its capture's increments
    (utils/graphs.py), not by running the wrapper. A trace that disagrees
    is taken again, up to TRACE_TRIES times; then raises."""
    counters = _counters()
    for attempt in range(TRACE_TRIES):
        _reset(counters)
        out = _count_launches(label, fn)
        counted = {k: v for k, v in _read(counters).items() if v}
        if out['kernels'] == counted:
            return out
        log(f'[graphs] {label}: counted {counted}, traced {out["kernels"]} '
            f'({attempt + 1} of {TRACE_TRIES})')
    raise AssertionError(f'graphs {label}: the counters {counted} are not the kernels on the '
                         f'trace {out["kernels"]}')


def _replays_as_counted(label, step_graphs, prepare, replays=3):
    """Each graph of a StepGraphs replayed `replays` times under the trace,
    prepare(its key) before each replay (a decode graph's t set to its
    group's first step): its launches of each wrapper's kernel functions
    must be its capture's increments, which each replay adds to the
    counters, times replays (a trace that disagrees taken again, up to
    TRACE_TRIES times). Returns {key: the wrappers' launches a replay}."""
    out = {}
    for key, (graph, delta) in step_graphs.graphs.items():
        want = {c.__name__: n * replays for c, n in delta}

        def run(key=key, graph=graph, times=replays):
            for _ in range(times):
                prepare(key)
                graph.replay()

        for attempt in range(TRACE_TRIES):
            traced = _count_launches(f'{label} graph {key} x{replays}', run)['kernels']
            if traced == want:
                break
            once = _count_launches(f'{label} graph {key} x1', lambda: run(times=1))
            log(f'[graphs] {label} graph {key}: increments {want}, traced {traced}; one replay '
                f'traced {once["kernels"]} of {once["launches"]} events '
                f'({attempt + 1} of {TRACE_TRIES})')
        else:
            raise AssertionError(f'graphs {label} graph {key}: its replays launched {traced}, '
                                 f'its increments say {want}')
        out[str(key)] = {c.__name__: n for c, n in delta}
    if not out:
        raise AssertionError(f'graphs {label}: no graph to replay')
    return out


def _graph_resume():
    """diffusion (its training draws from the model's generator), a graphed
    epoch of GRAPH_STEPS, saved and restored into a fresh model that takes
    a second graphed epoch: model.pt bitwise an uninterrupted model's two
    graphed epochs (_state_diff: net, Adam, counters, generator)."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch import data as data_lib
    from generative_models_tpu_torch.utils.config import parse_args

    G, Model = parse_args(DIFF_FLAGS + ['--bs=64', '--data_source=synthetic'])
    mnist.TRAIN_N, mnist.TEST_N = 64 * GRAPH_STEPS, 64
    dataset = data_lib.load_mnist(G, torch.device('cuda'))
    epochs = [dataset.epoch_batches(torch.Generator().manual_seed(e)) for e in (1, 2)]
    straight, first = Model(G), Model(G)
    for bx, by in epochs:
        straight.train_epoch(bx, by)
    first.train_epoch(*epochs[0])
    first.save(GRAPHS_DIR / 'cut')
    resumed = Model(G)
    resumed.load_weights(GRAPHS_DIR / 'cut' / 'model.pt')
    resumed.train_epoch(*epochs[1])
    straight.save(GRAPHS_DIR / 'straight')
    resumed.save(GRAPHS_DIR / 'resumed')
    diff = _state_diff(torch.load(GRAPHS_DIR / 'straight' / 'model.pt', weights_only=True),
                       torch.load(GRAPHS_DIR / 'resumed' / 'model.pt', weights_only=True))
    if diff:
        raise AssertionError(f'graphs resume: the resumed graphed run differs: '
                             f'{json.dumps(dict(list(diff.items())[:8]))}')
    log(f'[graphs] resume: diffusion restored after a graphed epoch, its second graphed epoch '
        f'bitwise the uninterrupted run (step {resumed.step})')
    return dict(steps=resumed.step, bitwise=True)


def _graph_requests(flags, train=False):
    """pixel_transformer's request at serve_bs=64, seed=7, through
    SampleServer at --decode_unroll 0 (the per-step loop), then each of
    GRAPH_UNROLLS: each batch bitwise the per-step loop's, every kernel
    counter equal; each request's wall, the graphed ones three times (a
    new unroll's first pass steps eagerly and its second captures,
    utils/graphs.py PassGraphs), and a request of each mode traced. With train, one train step moves the weights and each mode
    serves again: bitwise again, and unlike the batch before."""
    from generative_models_tpu_torch.serve import load_server

    server, G = load_server(['--model=pixel_transformer', '--serve_bs=64', *flags])
    counters = _counters()

    def request(unroll):
        server.model.G.decode_unroll = unroll
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.time()
        batch = server.sample(64, seed=7)
        torch.cuda.synchronize()
        return batch, _read(counters), time.time() - t0

    server.warm()
    out, faults, before = {}, [], None
    for moved in ((False, True) if train else (False,)):
        if moved:
            x = (torch.rand((64, 28, 28, 1), generator=torch.Generator().manual_seed(5)) > 0.5)
            server.model.train_step(x.float().cuda())
        ref, ref_launches, ref_sec = request(0)
        if moved and np.array_equal(ref, before):
            faults.append('the train step did not move the batch')
        res = dict(eager_sec=ref_sec, launches={k: v for k, v in ref_launches.items() if v},
                   graphed_requests=3 * len(GRAPH_UNROLLS))
        for k in GRAPH_UNROLLS:
            walls = []
            for _ in range(3):
                batch, launches, sec = request(k)
                walls.append(sec)
                if not np.array_equal(batch, ref):
                    faults.append(f'unroll {k}: the batch differs from the per-step loop'
                                  + (' after a train step' if moved else ''))
                if launches != ref_launches:
                    faults.append(f'unroll {k}: launches {launches} vs {ref_launches}')
            res[f'unroll_{k}_sec'] = walls
        if not moved:
            # a request of each mode traced (device ms, kernels: a trace of
            # 30k-110k launches loses some now and then, so it is not held
            # to the counters), then each decode graph's replays traced
            # alone and held to its capture's increments
            label = f'graphs request ({" ".join(flags) or "default"})'
            for k in (0, *GRAPH_UNROLLS):
                res[f'trace_unroll_{k}'] = _count_launches(f'{label} unroll {k}',
                                                           lambda k=k: request(k))
            res['replays'] = {
                f'n={bufs.prev.shape[0]} unroll={bufs.unroll}': _replays_as_counted(
                    label, bufs.graphs, lambda gkey, t=bufs.t: t.fill_(gkey[0]))
                for bufs in server.model._pass_graphs.values()}
        before = ref
        out['after_train_step' if moved else 'fresh'] = res
    if faults:
        raise AssertionError(f'graphs requests {flags}: {faults[:6]}')
    label = ' '.join(flags) or 'default'
    for key, res in out.items():
        log(f'[graphs] request ({label}, {key}): eager {res["eager_sec"]:.3f}s, '
            + ', '.join(f'unroll {k} ' + '/'.join(f'{w:.3f}' for w in res[f'unroll_{k}_sec']) + 's'
                        for k in GRAPH_UNROLLS) + f'; launches {res["launches"]} in each mode')
    return out


SAMPLER_CASES = (  # (label, serving flags): every sampler at serve_bs=64, its default width
    ('diffusion', DIFF_FLAGS),  # guided DDIM-250, two UNet calls a step
    ('diffusion_dpm2m', DIFF_FLAGS + ['--sampler=dpm2m', '--sample_steps=25']),
    ('diffusion_noisy', DIFF_FLAGS + ['--sampler=noisy', '--sample_steps=25']),
    ('diffusion_fused_cfg', DIFF_FLAGS + ['--fused_cfg=1', '--sample_steps=25']),
    ('diffusion_student', DIFF_FLAGS + ['--timesteps=128', '--sample_steps=25']),
    ('diffusion_teacher_test', DIFF_FLAGS + ['--sampler=teacher_test', '--sample_steps=25']),
    ('diffusion_w8a8', DIFF_FLAGS + ['--sampler=dpm2m', '--sample_steps=25', '--quantize=w8a8']),
    ('diffusion_w8a16', DIFF_FLAGS + ['--sampler=dpm2m', '--sample_steps=25',
                                      '--quantize=w8a16']),
    ('made', MADE_FLAGS),  # Kernel G
    ('made_w8a8', MADE_FLAGS + ['--quantize=w8a8']),  # Kernel I
    ('made_w8a16', MADE_FLAGS + ['--quantize=w8a16']),  # Kernel J
    ('vqvae', ['--model=vqvae']),  # Kernels A and B
    ('rnn', ['--model=rnn']),
    ('wavenet', ['--model=wavenet']),
    ('pixel_cnn', ['--model=pixel_cnn']),
    ('gated_pixel_cnn', ['--model=gated_pixel_cnn']),
    ('vae', ['--model=vae']),
    ('gan', ['--model=gan']),
)
SAMPLER_TEACHER = ('diffusion_student', 'diffusion_teacher_test')  # built on a teacher


def _pass_replays(label, model):
    """Each graph of the model's graphed sampling passes (its PassGraphs,
    vqvae's DecodeGraphs) replayed under the trace: a graph whose capture
    counted kernels three times alone (_replays_as_counted), its t set to
    the first step of its group; the others once each, in one trace, in
    which no counted kernel may run. Returns {pass key: {graph key: the
    wrappers' launches a replay}}."""
    import types

    out = {}
    for pkey, holder in model._pass_graphs.items():
        # a group's t at its first step (a graph of a device t indexes its
        # tables at t: past their end it would fault)
        prepare = lambda gkey, t=holder.t: t.fill_(gkey[0]) if isinstance(gkey, tuple) else None
        counted = {k: v for k, v in holder.graphs.graphs.items() if v[1]}
        rest = {k: g for k, (g, delta) in holder.graphs.graphs.items() if not delta}
        res = {}
        if counted:
            res = _replays_as_counted(f'{label} {pkey}', types.SimpleNamespace(graphs=counted),
                                      prepare)
        if rest:
            traced = _count_launches(f'{label} {pkey}: {len(rest)} kernel-free graphs',
                                     lambda: [(prepare(k), g.replay()) for k, g in rest.items()]
                                     )['kernels']
            if traced:
                raise AssertionError(f'graphs {label} {pkey}: graphs that counted no kernel '
                                     f'launched {traced}')
        res['kernel_free_graphs'] = len(rest)
        out[str(pkey)] = res
    if not out:
        raise AssertionError(f'graphs {label}: no sampling pass was graphed')
    return out


def _sampler_pair(label, flags, teacher):
    """One sampler's request at serve_bs=64, seed=7, through SampleServer:
    warm (the eager pass, then the capture), the graphed request three times
    (wall: the median), once more with its synchronizing calls counted
    (_syncs: the batch's copy to the host alone), and the per-step loop's once
    (graph_sampling off): each batch bitwise the per-step loop's, every
    kernel counter equal; then a graphed request traced (device ms,
    kernels). The counters run from before warm to after the traced
    request, unreset: their total (launches_total) must be the per-step
    request's times the passes run. Then each graph's replays as its
    capture counted (_pass_replays) and, for SAMPLER_STREAM, the model's
    own sample() (_sample_stream)."""
    from generative_models_tpu_torch.serve import load_server

    if label in SAMPLER_TEACHER:
        flags = flags + [f'--teacher_path={teacher}']
    server, G = load_server(flags + ['--serve_bs=64'])
    model, counters = server.model, _counters()
    y = DIFF_LABELS if server.class_cond else None

    def request(graphed):
        model.graph_sampling = graphed
        before = _read(counters)
        torch.cuda.synchronize()
        t0 = time.time()
        batch = server.sample(64, y=y, seed=7)
        torch.cuda.synchronize()
        sec = time.time() - t0
        return batch, {k: v - before[k] for k, v in _read(counters).items()}, sec

    _reset(counters)
    warm = server.warm()
    graphed = [request(True) for _ in range(3)]
    stacks = []
    synced, syncs = _syncs(lambda: server.sample(64, y=y, seed=7), stacks)
    ref, ref_launches, eager_sec = request(False)
    model.graph_sampling = True
    faults = [f'request {i}: ' + ('the batch differs from the per-step loop'
                                  if not np.array_equal(b, ref) else f'launches {n}')
              for i, (b, n, _) in enumerate(graphed)
              if not np.array_equal(b, ref) or n != ref_launches]
    if not np.array_equal(synced, ref):
        faults.append('the request counted for its syncs differs from the per-step loop')
    if len(syncs) != 1:
        faults.append(f'{len(syncs)} synchronizing calls in a graphed request ({syncs}), '
                      'expected 1 (the batch\'s copy to the host)')
        log(f'[graphs] sampler {label}: the synchronizing calls\' stacks:\n' + '\n'.join(stacks))
    if faults:
        raise AssertionError(f'graphs sampler {label}: {faults[:4]}; per-step launches '
                             f'{ref_launches}')
    _check_samples(f'graphs sampler {label}', ref, 64)
    walls = sorted(sec for _, _, sec in graphed)
    trace = _count_launches(f'graphs sampler {label} graphed request',
                            lambda: server.sample(64, y=y, seed=7))
    total = {k: v for k, v in _read(counters).items() if v}
    passes = server.warm_passes + 3 + 1 + 1 + 1  # warm, graphed, synced, per-step, traced
    want = {k: v * passes for k, v in ref_launches.items() if v}
    if total != want:
        raise AssertionError(f'graphs sampler {label}: {passes} passes counted {total}, '
                             f'{passes} times the per-step request\'s is {want}')
    out = dict(warm_sec=warm, eager_sec=eager_sec, graphed_sec=walls, graphed_median_sec=walls[1],
               syncs=len(syncs), launches={k: v for k, v in ref_launches.items() if v},
               passes=passes, launches_total=total,
               trace=trace, replays=_pass_replays(f'graphs sampler {label}', model),
               graphs=sum(len(h.graphs.graphs) for h in model._pass_graphs.values()))
    if label in SAMPLER_STREAM:
        out['sample_stream'] = _sample_stream(label, model)
    log(f'[graphs] sampler {label}: bitwise the per-step loop; per-step {eager_sec:.3f}s, '
        f'graphed {walls[1]:.3f}s (median of 3; warm {warm:.2f}s); device '
        f'{trace["device_ms"]:.1f} ms, {trace["launches"]} kernels, busy '
        f'{trace["busy_share"]:.3f}; {out["graphs"]} graphs; launches {out["launches"]} a '
        f'request, {total} counted over its {passes} passes')
    return out


SAMPLER_STREAM = ('diffusion_noisy',)  # sample() drawing each step's normals inside its graphs


def _sample_stream(label, model, calls=3):
    """The model's own sample(64) from its sampling generator (the noisy
    sampler draws each step's normals from it inside the graphs, the
    generator registered with them), calls times per-step, then as many
    times graphed from the same generator state (the first pass eager,
    the second captured, the third replayed): each batch, the generator's
    state after each call and each call's counters bitwise the per-step
    loop's."""
    gen, counters = model._sample_gen, _counters()

    def run(graphed):
        model.graph_sampling = graphed
        out = []
        for _ in range(calls):
            _reset(counters)
            batch = model.sample(64).cpu()
            out.append((batch, gen.get_state(), _read(counters)))
        return out

    start = gen.get_state()
    ref = run(False)
    gen.set_state(start)
    got = run(True)
    model.graph_sampling = True
    faults = [f'call {i}: ' + ', '.join(what for what, same in (
        ('the batch', torch.equal(b, rb)), ('the generator state', torch.equal(g, rg)),
        (f'launches {n} vs {rn}', n == rn)) if not same)
        for i, ((b, g, n), (rb, rg, rn)) in enumerate(zip(got, ref))
        if not (torch.equal(b, rb) and torch.equal(g, rg) and n == rn)]
    if faults or torch.equal(ref[0][1], ref[1][1]):
        raise AssertionError(f'graphs sampler {label} sample(): '
                             f'{faults or "the generator did not move"}')
    _check_samples(f'graphs sampler {label} sample()',
                   model._serving_unit_range(ref[0][0]).numpy(), 64)
    log(f'[graphs] sampler {label}: sample(64) x{calls} from the model\'s generator, graphed '
        f'(eager, captured, replayed) bitwise the per-step loop, the generator\'s state '
        f'after each call too')
    return dict(calls=calls, bitwise=True, generator_state_equal=True)


def phase_samplers(teacher=None):
    """Every sampler as CUDA graphs (models/base.py pass_graphs), each case
    of SAMPLER_CASES through _sampler_pair; teacher: the distilled
    student's and teacher_test's teacher model.pt (made here if None)."""
    if teacher is None:
        from generative_models_tpu_torch.utils.config import parse_args

        G, Model = parse_args(DIFF_FLAGS + ['--timesteps=256', '--bs=64'])
        Model(G).save(GRAPHS_DIR / 'teacher')
        teacher = GRAPHS_DIR / 'teacher' / 'model.pt'
    return {label: _sampler_pair(label, flags, teacher) for label, flags in SAMPLER_CASES}


def phase_graphs():
    """--jit_epoch=1 and --decode_unroll on the card: CUDA graphs
    (utils/graphs.py), bitwise the eager paths. Every registry name at its
    default width and the variants of GRAPH_CASES (_graph_pair: an epoch
    each way, then a step of each timed and traced); a resumed graphed run
    (_graph_resume); pixel_transformer's request graphed at GRAPH_UNROLLS
    against the per-step loop, fresh and after a train step, and under
    --quantize=w8a16 (_graph_requests); every traced step's kernels as
    counted (_traced_counts), each decode graph's replays as its capture's
    increments (_replays_as_counted); graph_gc's two forms, each in a
    process of its own, started first and joined last."""
    shutil.rmtree(GRAPHS_DIR, ignore_errors=True)
    if set(KERNEL_FUNCTIONS) != {fn.__name__ for fn in _counters()}:
        raise AssertionError('KERNEL_FUNCTIONS does not name every kernel counter')
    gc_runs = {form: start_only(f'graph_gc_{form}', GRAPHS_DIR / f'gc_{form}.log')
               for form in GRAPH_GC_FORMS}
    from generative_models_tpu_torch.utils.config import parse_args

    # the distilled student's teacher: a fresh 256-step model's model.pt
    G, Model = parse_args(DIFF_FLAGS + ['--timesteps=256', '--bs=64'])
    Model(G).save(GRAPHS_DIR / 'teacher')
    teacher = GRAPHS_DIR / 'teacher' / 'model.pt'
    out = {label: _graph_pair(label, flags, steps,
                              teacher if label == 'diffusion_student' else None)
           for label, flags, steps in GRAPH_CASES}
    out['resume'] = _graph_resume()
    out['request'] = _graph_requests([], train=True)
    out['request_w8a16'] = _graph_requests(['--quantize=w8a16'])
    out['samplers'] = phase_samplers(teacher)
    gc = {form: join_only(run, f'graph_gc_{form}', '[graph_gc]')[0]
          for form, run in gc_runs.items()}
    if gc['bare']['captured'] or not gc['collected']['captured']:
        raise AssertionError(f'graph_gc: {json.dumps(gc)}')
    out['graph_gc'] = gc
    return out


GRAPH_GC_FORMS = ('bare', 'collected')


def phase_graph_gc(form):
    """A capture during which the cyclic collector destroys another
    graph: made (its default width, bs=64) takes a graphed epoch of 3 steps
    and is left in a reference cycle; a second made's epoch then captures
    its step, which runs gc.collect() first (a collection that the
    capture's allocations could start). form 'bare': utils/graphs.py
    CapturedGraph without its collection before the capture (gc.collect
    stubbed there); 'collected': as it is. Returns whether the second
    epoch captured, and the error where it did not."""
    import gc
    import types
    import weakref

    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch import data as data_lib
    from generative_models_tpu_torch.utils import graphs as graphs_mod
    from generative_models_tpu_torch.utils.config import parse_args

    G, Model = parse_args(['--model=made', '--bs=64', '--data_source=synthetic'])
    mnist.TRAIN_N, mnist.TEST_N = 64 * 3, 64
    bx, by = data_lib.load_mnist(G, torch.device('cuda')).epoch_batches(
        torch.Generator().manual_seed(1))
    old = Model(G)
    old.train_epoch(bx, by)
    old.cycle = old
    old_graphs, old_ref = len(old.step_graphs().graphs), weakref.ref(old)
    gc.disable()  # the collections are the ones below, nowhere else
    del old
    if form == 'bare':
        graphs_mod.gc = types.SimpleNamespace(collect=lambda: 0, isenabled=gc.isenabled,
                                              disable=gc.disable, enable=gc.enable)
    new = Model(G)
    device_step = new.device_step

    def collecting_step(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            log(f'[graph_gc] {form}: the collector ran during the capture and freed '
                f'{gc.collect()} objects')
        return device_step(*args, **kw)

    new.device_step = collecting_step
    try:
        new.train_epoch(bx, by)
        torch.cuda.synchronize()
        res = dict(captured=True, graphs=len(new.step_graphs().graphs))
    except Exception as e:  # noqa: BLE001  (the capture's error is the result)
        res = dict(captured=False, error=f'{type(e).__name__}: {str(e).splitlines()[0]}')
    res.update(old_graphs=old_graphs, old_freed=old_ref() is None)
    log(f'[graph_gc] {form}: {json.dumps(res)}')
    return res


ONLY = {  # --only: these phases alone, in this order, after the build
    'kernels': lambda dev: phase_kernels(dev),
    'int8': lambda dev: int8_cases(np.random.RandomState(0), dev),
    'diff_train': lambda dev: phase_diff_train(),
    'diff_quant': lambda dev: phase_diff_quant(),
    'gan_sn': lambda dev: phase_small_model('gan', ['--spectral_norm=1'], 'gan_sn'),
    'resume': lambda dev: phase_resume(),
    'jax_ckpt': lambda dev: phase_jax_ckpt(),
    'stream': lambda dev: phase_stream(),
    'cli_profile': lambda dev: phase_cli_profile(),
    'parity': lambda dev: phase_parity(),
    'export': lambda dev: phase_export(),
    'moe': lambda dev: phase_moe(),
    'mesh': lambda dev: phase_mesh(),
    'chain': lambda dev: phase_chain(),
    'made_cpu': lambda dev: phase_made_cpu(),  # the whole run's process for train_flags
    'train_flags': lambda dev: phase_train_flags(),
    'graphs': lambda dev: phase_graphs(),
    'samplers': lambda dev: phase_samplers(),
    **{f'graph_gc_{form}': (lambda dev, form=form: phase_graph_gc(form))
       for form in GRAPH_GC_FORMS},
    **{name: (lambda dev, name=name: phase_raster_model(name)) for name in RASTER},
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    only = [a.split('=', 1)[1].split(',') for a in argv if a.startswith('--only=')]
    if len(only) != len(argv) or any(n not in ONLY for names in only for n in names):
        print(f'usage: chip_smoke.py [--only=<{"|".join(ONLY)},...>] (no argument: every '
              'phase)', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this needs a GPU',
              file=sys.stderr)
        return 1
    import generative_models_tpu_torch  # noqa: F401  (fails outside the repo)
    from generative_models_tpu_torch.ops.common import resolve_device

    dev = resolve_device('cuda')
    smi = nvidia_smi()
    log(f'[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    t_start = time.time()
    phase_sec = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_sec[name] = time.time() - t0
        log(f'[time] {name} {phase_sec[name]:.1f}s')
        return out

    ptxas = timed('build', phase_build)
    if only:
        # a part of the run, for working on it: no kernels line, no device
        # line, so it cannot pass for the whole
        res = {name: timed(name, ONLY[name], dev) for name in only[0]}
        log(f'[time] phases {json.dumps(phase_sec)}')
        log(json.dumps({k: v for k, v in res.items() if k not in ('kernels', 'diff_train')},
                       default=str))
        if 'kernels' in res:
            log(json.dumps({'kernel_cases': res['kernels'][0]}, default=str))
        return 0
    cases, ring = timed('kernels', phase_kernels, dev)
    sl = timed('slice', phase_slice)
    tr = timed('train', phase_train)
    model, dataset, grads = timed('grads', phase_grads)
    st = timed('seq_train', phase_train, SEQ)
    seq_model, seq_dataset, seq_grads = timed('seq_grads', phase_grads, SEQ)
    vs = timed('vq_serve', phase_vq_serve)
    vt = timed('vq_train', phase_vq_train)
    vq_model, vq_dataset, vq_grads = timed('vq_grads', phase_vq_grads)
    ms = timed('made_serve', phase_made_serve)
    md = timed('made_default', phase_made_default)
    mt = timed('made_train', phase_made_train)
    made_model, made_dataset, made_grads = timed('made_grads', phase_made_grads)
    qs = timed('quant_serve', phase_quant_serve)
    ds = timed('diff_serve', phase_diff_serve)
    dt = timed('diff_train', phase_diff_train)
    dg = timed('diff_grads', phase_diff_grads, dt['model'], dt['dataset'], dt['G'])
    ab = timed('arb_load', phase_arb_load)
    eh = timed('eval_heavy', phase_eval_heavy)
    dq = timed('diff_quant', phase_diff_quant)
    va = timed('vae', phase_small_model, 'vae')
    ga = timed('gan', phase_small_model, 'gan')
    gs = timed('gan_sn', phase_small_model, 'gan', ['--spectral_norm=1'], 'gan_sn')
    raster = {name: timed(name, phase_raster_model, name) for name in RASTER}
    prof = timed('profile', phase_profile, sl['server'], sl['x'], model, dataset,
                 vs['server'], vq_model, vq_dataset, ms['server'], made_model, made_dataset, qs,
                 seq_model, seq_dataset,
                 dict(server=ds['server'], dpm2m_server=ds['other']['dpm2m_25'].pop('server'),
                      model=dt['model'], dataset=dt['dataset']))
    ds['other']['fused_cfg'].pop('server')
    # the chain phase, then the graphs phase, in a process beside the
    # phases from resume to train_flags, joined after them
    chain = start_only('chain,graphs', CHAIN_LOG)
    rs = timed('resume', phase_resume)
    jc = timed('jax_ckpt', phase_jax_ckpt)
    sm = timed('stream', phase_stream)
    cp = timed('cli_profile', phase_cli_profile)
    pa = timed('parity', phase_parity)
    made_cpu = start_only('made_cpu', MADE_CPU_LOG)  # train_flags' CPU run, beside export
    xp = timed('export', phase_export)
    mo = timed('moe', phase_moe)
    me = timed('mesh', phase_mesh)
    tf = timed('train_flags', phase_train_flags, made_cpu)
    side, ch_wall, ch_waited = timed('chain', join_only, chain, 'chain,graphs',
                                     ('[chain]', '[graphs]'))
    ch, gr = side['chain'], side['graphs']
    ch.update(process_wall_sec=ch_wall, waited_sec=ch_waited)
    phase_sec['total'] = time.time() - t_start
    log(f'[time] phases {json.dumps(phase_sec)}')

    # (source, TPU kernel replaced) of each kernel; its launches are those
    # of pixel_transformer's serving path (sampling passes, one scoring
    # forward), training path and training path under --mesh=seq:4, and of
    # vqvae's and made's
    srcs = {
        'ln_matmul': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:46'),
        'block_tail': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:71'),
        'causal_attention_fwd': ('attention.cu', 'generative_models_tpu/ops/attention.py:148'),
        'flash_bwd_dq': ('attention_bwd.cu', 'generative_models_tpu/ops/attention.py:209'),
        'flash_bwd_dkv': ('attention_bwd.cu', 'generative_models_tpu/ops/attention.py:209'),
        'vq_one_hot': ('quantize.cu', 'generative_models_tpu/ops/quantize.py:23'),
        'masked_matmul': ('masked_dense.cu', 'generative_models_tpu/ops/masked_dense.py:24'),
        'mask_out_matmul': ('masked_dense.cu', 'generative_models_tpu/ops/masked_dense.py:35'),
        'int8_gemm': ('int8.cu', 'generative_models_tpu/ops/int8.py:49'),
        'dequant_gemm': ('int8.cu', 'generative_models_tpu/ops/int8.py:60'),
        'ring_chunk_fwd': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:565'),
        'ring_chunk_bwd_dq': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:675'),
        'ring_chunk_bwd_dkv': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:675'),
    }
    kernels = []
    for name, cs in cases.items():
        src, replaces = srcs[name]
        main_case = cs[0]
        by_path = {'serve': sl['launches'][name], 'train': tr['launches'][name],
                   'seq_train': st['launches'][name], 'vqvae_serve': vs['launches'][name], 'vqvae_train': vt['launches'][name],
                   'made_serve': ms['launches'][name], 'made_train': mt['launches'][name],
                   **{f'{key}_serve': q['launches'][name] for key, q in qs.items()},
                   **{f'diffusion_{mode}_serve': q['launches'][name]
                      for mode, q in dq['serve'].items()},
                   **{f'export_{label}': xp[label]['launches'].get(name, 0)
                      for label, *_ in EXPORT_CASES},
                   'moe_train': mo['launches'][name], 'moe_serve': mo['serve_launches'][name],
                   **{f'moe_{mode}_serve': q['launches'][name] for mode, q in mo['quant'].items()},
                   **{f'mesh_{label}' + ('' if label.startswith('serve_') else '_train'):
                      m['launches'][name] for label, m in me.items()},
                   **{f'train_flags_{label}': t['launches'][name] * 2
                      + t['remat_extra_launches'][name]
                      for label, t in tf.items() if label != 'made'},
                   'train_flags_made': tf['made']['launches'][name],
                   **{f'graphs_{label}': g['launches'].get(name, 0)
                      for label, g in gr.items() if 'launches' in g},
                   **{f'graphs_sampler_{label}': r['launches_total'].get(name, 0)
                      for label, r in gr['samplers'].items()},
                   **{f'graphs_{label}_{key}': r['launches'].get(name, 0) * r['graphed_requests']
                      for label, g in gr.items() if label.startswith('request')
                      for key, r in g.items()}}
        if sum(by_path.values()) == 0:
            raise AssertionError(f'{name} was not launched on a main path')
        kernels.append(dict(
            name=name, route='cuda',
            source=f'generative_models_tpu_torch/ops/csrc/{src}',
            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c['max_abs_err'] for c in cs),
            atol=main_case['atol'], rtol=main_case['rtol'],
            ms=main_case['ms'], kernel_ms=main_case['ms'],
            eager_ms=main_case['eager_ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'], library_ms=main_case['library_ms'],
            **{key: main_case[key] for key in ('ms_l2_cold', 'library_f32_out_ms')
               if key in main_case},
            **({'ptxas': ptxas[name]} if name in ptxas else {}), cases=cs,
        ))
    lat = sorted(sl['latencies'])
    log(json.dumps(dict(
        slice=dict(
            serve_bs=64, warm_sec=sl['warm_sec'], request_sec=lat,
            request_p50_sec=lat[len(lat) // 2], score_ms=sl['score_ms'],
            profile=prof, checks=sl['checks'], power=smi,
        ),
        train=dict(
            wall_sec=tr['wall_sec'], steps=tr['steps'], history=tr['history'],
            grads_max_rel_err=max(grads['rel_err'].values()), power=smi,
        ),
        seq_train=dict(
            mesh=f'seq:{SEQ}', wall_sec=st['wall_sec'], steps=st['steps'], history=st['history'],
            grads_max_rel_err=max(seq_grads['rel_err'].values()), ring=ring['whole'], power=smi,
        ),
        vqvae_serve=dict(
            serve_bs=64, warm_sec=vs['warm_sec'], request_sec=sorted(vs['latencies']),
            checks=vs['checks'], power=smi,
        ),
        vqvae_train=dict(
            wall_sec=vt['wall_sec'], steps=vt['steps'], history=vt['history'],
            grads_max_rel_err=max(vq_grads['rel_err'].values()),
            codes_differ=vq_grads['codes_differ'], power=smi,
        ),
        made_serve=dict(
            hidden_size=2048, serve_bs=64, warm_sec=ms['warm_sec'],
            request_sec=sorted(ms['latencies']), launches_per_pass=ms['per_pass'],
            checks=ms['checks'], default_width=md, power=smi,
        ),
        made_train=dict(
            hidden_size=2048, wall_sec=mt['wall_sec'], steps=mt['steps'], history=mt['history'],
            grads_max_rel_err=max(made_grads['rel_err'].values()), power=smi,
        ),
        quant_serve={key: dict(
            serve_bs=64, warm_sec=q['warm_sec'], request_sec=sorted(q['latencies']),
            launches_per_pass=q['per_pass'], checks=q['checks'], power=smi,
        ) for key, q in qs.items()},
        diffusion_serve=dict(
            serve_bs=64, warm_sec=ds['warm_sec'], request_sec=sorted(ds['latencies']),
            other=ds['other'], checks=ds['checks'], power=smi,
        ),
        diffusion_train=dict(
            wall_sec=dt['wall_sec'], steps=dt['steps'], history=dt['history'],
            restored_loss=dt['restored_loss'],
            grads_max_rel_err=max(dg['rel_err'].values()),
            adam_update_rel_err=dg['adam_update_rel_err'], power=smi,
        ),
        arbiters=dict(ab, power=smi),
        eval_heavy=dict(eh, power=smi),
        chain=dict(ch, power=smi),
        vae=dict(va, power=smi),
        gan=dict(ga, power=smi),
        gan_sn=dict(gs, power=smi),
        diffusion_quant=dict(dq, power=smi),
        resume=dict(rs, power=smi),
        jax_ckpt=dict(jc, power=smi),
        stream=dict(sm, power=smi),
        cli_profile=dict(cp, power=smi),
        parity=dict(pa, power=smi),
        export=dict(xp, power=smi),
        moe=dict(mo, power=smi),
        mesh=dict(me, power=smi),
        train_flags=dict(tf, power=smi),
        graphs=dict(gr, power=smi),
        **{name: dict(r, power=smi) for name, r in raster.items()},
        phase_sec=phase_sec,
    )))
    log(json.dumps({'kernels': kernels}))
    log(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
