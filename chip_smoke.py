"""Chip smoke test of the PyTorch/CUDA port (reed_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result):
  1. device: a CUDA device is required; prints its name and power limit.
  2. build: every kernel under reed_tpu_torch/csrc/, one nvcc each, together;
     ptxas registers, stack and spills of each kernel.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main paths give it (and a few more; K1 f32 also at an
     odd head dim, an unaligned base and D = 128), with stated tolerances;
     kernel, plain and library (yardstick only) times, taken in turns, and
     the least time the card could take for the same work
     (bound_ms; f32 at the 3xTF32 tensor-core rate, with bound_ms_67 at the
     CUDA-core rate beside it). K1 in bf16 also on SiT's strided q/k/v
     views of one [B, S, 3, H, D] tensor; each kernel's shared memory and
     blocks per SM; K2b's weight gradients bitwise equal over two launches.
     K1 in both dtypes also with queries of one length against keys of
     another (slice 18: (16, 128 | 256, 16, 72), (16, 64 | 256, 16, 72)
     and a ragged (2, 100 | 256, 4, 72)) against flash_attention_reference,
     and at phase 15's model-parallel layouts (tensor=2: (16, 256, 8, 72)
     on qkv views; seq=2: 128 queries on qkv views against 256 gathered
     keys and values). K2a and K2b also at H = 64 hidden units of D = 128
     (tensor=2's share of a chain: W2 [128, 64], W3 [64, 128]),
     the encoder's first chain and the decoder's, f32 and bf16, the
     partial outputs in f32 as the tensor=2 step writes them, and the bf16
     decoder case once with bf16 outputs (`message_tp_phase`).
  4. image slice: SiT-XL/2 at full width with seeded N(0, 0.02) weights
     (nonzero adaLN and final layer, so attention reaches the output): one
     model call through the kernel against the same call with plain
     attention, in f32 and bf16; times and a torch.profiler breakdown of a
     model call in bf16 and in f32 (K1 f32 on 3xTF32); then its main path,
     `generate_samples` (SDE with CFG inside a guidance window), in bf16 and
     again in f32 (`generate-image --dtype float32`), each with every
     kernel's launch count set to 0 just before it and read just after, and
     its samples against a run with plain attention.
  5. protein slice: ProteinMPNN-FMIF at full width (the default
     ProteinTrainConfig) with seeded weights (nonzero node_embeds and
     LayerNorms): one forward with the message chains through the kernel
     against the unfused layer math, in f32 and bf16; then its main path,
     `sample` (Euler unmasking, 50 steps, encoder hoisted) on a synthetic
     batch of 8 x 256 residues, with the launch counts set to 0 just before
     it and read just after, and its tokens against a run with the unfused
     chain from the same generator seed.
  6. protein training: the default ProteinTrainConfig at full width with the
     denoising loss on from step 0 and a synthetic batch of 8 x 256 with AF3-
     style embeddings. One step (dropout 0, the same corrupted tokens) with
     the message chains through K2a/K2b against the unfused layer math:
     metrics and every parameter's gradient. Then the main path,
     `ProteinTrainer.train_step` (dropout 0.1), with the launch counts set to
     0 just before its timed steps and read just after (9 K2a + 9 K2b per
     step), ms per step and residues/s, a torch.profiler breakdown of one
     step; a learning check on the convergence gate's rule data (its CE
     must fall as the JAX run's did); and `train-protein --steps 3
     --synthetic` through the CLI. Then `eval-protein` and `train-protein`
     at hidden 100 and 256, widths the kernels refuse: `--fused-messages
     auto` runs them unfused, `on` raises.
  7. image training: SiT-XL/2 at bench.py's REED configuration (bf16
     compute with f32 master weights, batch 48, projectors at depths 8
     and 16 for z_dims (768, 3584), Adam with a bf16 first moment, EMA
     every 8 steps). One full-width step through K1 against the same step
     with plain attention (same state and draws): metrics and every
     gradient, in f32 at batch 8 and in bf16 at batch 48 (the bf16 bound
     taken from the plain bf16 step's distance to the f32 step). Then the
     main path, `ImageTrainer.train_step`, with the launch counts set to 0
     just before its 20 timed steps and read just after (28 K1 a step, none
     in the backward), ms per step (wall and device), imgs/s, MFU, peak
     memory and a torch.profiler breakdown; a learning check on the
     convergence gate's data (SiT-S/4, f32: K1 at (128, 4, 6, 64)); and
     `train-image --steps 3 --synthetic` through the CLI.
  8. image eval and inputs (`eval_phases`, in a temporary directory under
     _scratch/), with seeded full-width weights written in reed_tpu's npz
     layouts: the SD-VAE decoder and encoder on the card against the CPU
     (f32, under torch's default TF32 flags, which the modules turn off
     themselves); `generate-image --vae` with SiT-XL/2 as a subprocess
     (uint8 pixels, 28 K1 launches a model call, the pixels against the CPU
     decode of the latents that the same run without --vae writes);
     `compute-fid` as a subprocess (FID(a, b) finite; FID(a, a) ~0 from
     the saved stats); Inception and DINOv2-B features card vs CPU;
     `train-image --enc-type dinov2-vit-b` at SiT-XL/2 batch 48 on a
     fabricated data directory (ms a step with and without the encoder, a
     profile of the CLI's loop split into batch reading, encoder and step,
     28 K1 launches a step); checkpoints through the CLI and resumes held
     against uninterrupted runs (SiT-B/2 bitwise; the protein default, whose
     step is not bitwise repeatable, within 10x the run-to-run difference,
     with a restore that skips the trainer's generator as the control that
     must fail), and `generate-image --ckpt-dir`.
  9. molecules (slice 9, `molecule_phases`): recipes/molecule_semla_reed.json's
     SemlaGenerator (d_model 384, 12 layers, 64 coordinate sets, REPA at
     depth 4) with seeded weights at tools/bench_domains.py's GEOM scale
     (batch 56, 36-72 atoms padded to 72), f32 with TF32 off: one forward
     on the card against the CPU on 8 rows (1e-4 of the max); the host's
     batch building timed on its own; the main path,
     `SemlaTrainer.train_step`, 20 timed steps (ms a step by wall and by
     CUDA events, molecules/s, peak memory) and a profile by kernel family
     and by range (reed::self_cond, reed::model, reed::loss,
     reed::optimizer, reed::ema); a 100-step learning check on the Semla
     gate's data and configuration (mean denoising loss of steps 80-99
     below 1.0); `train-molecule-semla --steps 3` and `eval-semla` (16
     molecules, 10 integrator steps, max_atoms 256, .xyz and .sdf files) as
     subprocesses. No TPU kernel is on these paths: K1, K2a and K2b must
     launch 0 times. The SemlaFlow resume at the gate's width (with its
     control) runs in phase 8's checkpoints.
  10. EDM molecules (slice 10, `edm_phases`): MoleculeEDMConfig's default,
     the reference QM9 recipe (EGNN hidden 256 x 9 blocks, attention, tanh,
     rep 256 with dropout 0.1, 29 atoms, batch 64), with seeded weights
     (every bias, norm, fake_latent and coordinate head moved by N(0, 0.02)),
     f32 with TF32 off: one EGNNDynamics forward with the rep and one
     forward_with_cfg on the card against the CPU on 4 rows (velocity and
     features each to 1e-4 of their max, f64 beside them; message weights
     x0.25 and coordinate heads x0.01, so that f32 itself sits ~1e-6 from
     f64); the main path,
     `MoleculeEDMTrainer.train_step`, 20 timed steps (ms a step by wall and
     by CUDA events, molecules/s, peak memory) and a profile by kernel
     family (launches, idle share); a 100-step learning check on the EDM
     gate's data and configuration (mean nll of steps 80-99 below 0.5);
     `train-molecule-edm --steps 3` for EDM and for fm and `eval-molecule`
     from each checkpoint (16 molecules, 50 EDM steps or 10 rk4 steps,
     .xyz files) as subprocesses. No TPU kernel is on these paths: K1, K2a
     and K2b must launch 0 times. The EDM resume at full width (with its
     control) runs in phase 8's checkpoints.
  11. precision and RDM (slice 11, `precision_rdm_phases`): protein
     training in bf16 over f32 master weights at the default width (8 x
     256, AF3 alignment): one step through K2a/K2b bf16 against the
     unfused bf16 chain (each gradient within 2x its own distance in the
     unfused bf16 step from the f32 step, the metrics within 2x the largest
     metric's), the main path's 20 timed
     steps with the launch counts zeroed before and read after (9 K2a + 9
     K2b a step), a profile, a 200-step learning check on the bf16 gate's
     rule data and `train-protein --set compute_dtype=bfloat16`; SemlaFlow
     mixed precision at the recipe's width (coordinates f32 and features
     bf16 in a forward, 20 timed steps beside the f32 ones, a 100-step
     learning check on the bf16 gate's templates); EDM in bf16 at the QM9
     width (finite, timed); the RDM at RDMTrainConfig's full width (~100 M
     parameters): card vs CPU (1e-4, TF32 off), 20 timed steps and a
     profile, `train-rdm --steps 3` and `eval-molecule --rdm-ref-ckpt`
     from a checkpoint written in the reference LatentDiffusion layout, as
     subprocesses. K1 launches 0 times on these paths, K2a and K2b only on
     the protein one.
  12. MultiFlow SE(3) codesign (slice 12, `multiflow_phases`):
     MultiflowTrainConfig's full width (c_s 256, c_z 128, 6 blocks, IPA 8
     heads with 8 query/key and 12 value points, 2 sequence-transformer
     layers a block) at tools/bench_domains.py's 8 x 128 residues: one
     FlowModel forward on the card against the CPU on 2 rows (f32 with TF32
     off, each output to 1e-4 of its max, f64 beside it; the init moved by
     N(0, 0.02), backbone updates N(0, 0.002)); the main path,
     `MultiflowTrainer.train_step`, 20 timed steps in f32 and in bf16 (ms a
     step by wall and by CUDA events, residues/s, peak memory) with a
     profile by kernel family; a 100-step learning check on the MultiFlow
     gate's helices in f32 and in bf16 (mean denoising loss of steps
     80-99 below 2.0); `train-multiflow --steps 3` and `eval-multiflow`
     (4 x 64 residues, 10 steps, PDB files parsed back) as subprocesses;
     the MultiFlow step's resume with its control. No TPU kernel is on
     these paths: K1, K2a and K2b must launch 0 times.
  13. property guidance and the molecule eval stack (slice 13,
     `property_phases`): PropertyTrainConfig's full-width classifier
     (hidden 128 x 7, batch 96 x 29 atoms, biases moved by N(0, 0.02)): one
     forward on the card against the CPU on 4 rows (1e-4 of the max, f32
     with TF32 off, f64 beside it); the main path,
     `PropertyTrainer.train_step`, 20 timed steps (ms a step by wall and by
     CUDA events, molecules/s, peak memory) and a profile by kernel family;
     a 200-step learning check on synthetic batches at five weight seeds
     (median rule, bound from reed_tpu's CPU run of the same steps); ChemNet's activations (2 LSTMs of 512, MAX_LEN
     350, batch 128) and the SNN product (13,083 x 1,000 fingerprints), each
     on the card against the CPU, timed; `train-property --steps 3` (the
     EGNN and --linear-probe) and `train-molecule-edm --set
     context_node_nf=1 --steps 3` as subprocesses on a fabricated QM9
     directory, then in this process `eval-conditional` with the trained
     classifier (64 molecules, 50 steps): with --out from a conditioned
     checkpoint of phase 10's well-conditioned seeded weights (.xyz files
     and property_values.log read back, finite coordinates and MAE), and
     with --sweep from the trained EDM run (whose init-scale samples are
     NaN, as reed_tpu's); and `eval-molecule` with the directory's test
     split (moses and midi present). No TPU kernel is on these paths: K1, K2a and K2b must launch
     0 times.
  14. reward-guided sampling, the alternative SemlaFlow generators and the
     rep encoders (slice 14, `slice14_phases`): the default
     ProteinMPNN-FMIF (hidden 128, 3 + 3 layers, K = 30) on seeded weights
     at 8 x 256, f32, its decoder over an encoder state computed once and a
     seeded linear reward of the expected logits: one guidance gradient
     through K2a/K2b against the unfused chain (the train step's 1e-3 of the
     max), then CG, SMC, TDS (10 steps, cut from 500) and the Gumbel sampler
     (truncate_steps 3, a backward to the weights through K2b), each with
     the launch counts set to 0 just before it and read just after, ms a
     step; VanillaEgnnGenerator and EqgatGenerator at
     recipes/molecule_semla_reed.json's widths (d_model 384, 12 layers,
     d_edge 128, d_rep 512, self-conditioning) on the 56 x 72 batch: card
     vs CPU on 8 rows (1e-4 of the max, f64 beside it), the same in bf16
     (compute_dtype bfloat16: the card within 5e-2 of the port's bf16 CPU
     forward, and at least 0.2x that forward's distance from f32 away from
     the f32 forward), 10 timed `SemlaTrainer.train_step`s (wall and device
     ms, molecules/s, peak memory, launches, idle share) and 3 bf16 ones
     beside them, a 100-step learning check at d_model 64
     on the Semla gate's chains (the loss must fall below half its start),
     `train-molecule-semla --set arch=...` and `eval-semla` as subprocesses;
     UniMolGlobal() and FradEncoder() at their defaults on 64 GEOM-sized
     molecules card vs CPU (1e-4), timed, `precompute_mol_reps` as a
     subprocess on a fabricated .rsmol and one `train-molecule-semla` step
     reading its reps.npy; `train-protein --steps 10 --profile-dir` as a
     subprocess, whose Chrome trace must name K2a's and K2b's kernels. K1,
     K2a and K2b launch 0 times on the EGNN, EQGAT and encoder paths.
  15. data parallelism and the fsdp axis over torch.distributed (slices
     16 and 17, `dp_phases`):
     (a) a one-process NCCL group against no group at full width, two
     steps each: the SiT-XL/2 REED bf16 step at batch 48 (loss, every
     gradient and every parameter bitwise equal; 28 K1 launches a step in
     the group) and the f32 protein step at 8 x 256 (within
     RESUME_NOISE_FACTOR x a repeated step's difference: K2b's atomics;
     9 K2a + 9 K2b a step); (d) each step with the group against without,
     in turns, ms by wall and by CUDA events, the gradient all-reduce
     alone and the bytes it moves a step; (b) two ranks over gloo on the
     one card (this script with --dp-rank, as subprocesses) against one
     process at the same global batch: the SiT-XL/2 bf16 step at global
     batch 16 within IMAGE_BF16_NOISE_FACTOR x the one-process bf16 step's
     distance from its f32 step, the f32 protein step at 8 x 256 within
     RESUME_NOISE_FACTOR x a repeated step's difference of its witness
     (one process running each rank's rows with the global sums and
     averaging the two gradients, as the ranks do) and within
     TRAIN_METRIC_RTOL / DP_ORDER_GRAD_RTOL of the one-process step at the
     global batch (the ranks sum in another order), sharded
     `generate_samples` (16 images, 8 SDE steps with CFG) to GEN_RTOL;
     then, on the same ranks (phase 16 (b)), fsdp=2 against their data=2
     steps, the parameters sharded at rest: the SiT-XL/2 step (metrics
     but grad_norm and gradients bitwise; grad_norm within
     FSDP_GRAD_NORM_REL; the parameters bitwise, or within FSDP_CLIP_REL
     where the clip acts), the SiT-XL/2 step at fsdp=2 under remat=True
     bitwise the fsdp=2 step without (K1 56 a rank: the recompute gathers
     each block again), each rank's memory between steps at both sizes
     beside the plan's reckoning (at fsdp=2 at most the reckoning +
     FSDP_MEMORY_SLACK and below PR 17's FSDP_PR17_BYTES), the protein
     step within RESUME_NOISE_FACTOR x a repeated data=2 step's
     difference, K1 28 and K2a/K2b 9 + 9 launches a rank; then, on the
     same ranks (slice 18, `mp_rank_part`), tensor=2 and seq=2: the
     SiT-XL/2 bf16 step at global batch 16 (whole gradients) within
     IMAGE_BF16_NOISE_FACTOR x the one-process bf16 step's distance from
     its f32 step, its seconds, 28 K1 launches a rank, each rank's memory
     between steps beside the plan's reckoning and its parameter count
     (tensor=2 holds ~452 M of 675 M), and generate_samples (16 images, 8
     SDE steps, CFG 4.0) against one process to GEN_RTOL; then
     (`mp_protein_report`) the protein step at tensor=2 at 8 x 256, each
     message chain's hidden units split (K2a/K2b at H = 64): in f32 within
     TRAIN_METRIC_RTOL / DP_ORDER_GRAD_RTOL of the one-process step (the
     split sums run in another order), in bf16 within
     PROTEIN_TP_BF16_FACTOR x the one-process bf16 step's distance from
     f32, the ranks' whole
     parameters bitwise equal (SHA-256), 9 K2a + 9 K2b launches a rank, the
     state's bytes between steps beside the plan's reckoning (~2.43 M of
     4.28 M parameters a rank), the step's seconds; then (slices 20 and
     21, `mol_tp_rank_part`, `mol_tp_report`) SemlaFlow at the recipe's
     width (56 x 72, the self-conditioning pass on) in f32 and mixed bf16,
     the EDM (MoleculeEDMConfig, 64 x 29) in f32 and bf16, the property
     classifier (PropertyTrainConfig, 96 x 29) in f32, MultiFlow
     (MultiflowTrainConfig, 8 x 128) in f32 and bf16 and the RDM
     (RDMTrainConfig, batch 128) in f32 at tensor=2, and SemlaFlow's egnn
     and eqgat archs (the recipe's width, MOL_TP_ALT_GLOO_BATCH x 72 on the
     gloo ranks of one card, 56 x 72 on NCCL) and the linear probe
     (LinearProbeConfig) whole on every tensor rank, two steps each from
     the checked weights (seeded_semla, seeded_edm, the property phase's
     moved biases, seeded_flow_model, seeded_rdm, seeded_alt): the first
     in f32 within TRAIN_METRIC_RTOL / DP_ORDER_GRAD_RTOL (of the step's
     largest gradient) of the one-process step (SemlaFlow within
     MOL_TP_GRAD_TOP and MOL_TP_F64_FACTOR x one process's distance from
     the step promoted to f64; MultiFlow's f64 distances logged), in bf16
     within MOL_TP_BF16_FACTOR x the one-process bf16 step's distance from
     f32, the ranks' whole parameters bitwise equal after both, no
     K1/K2a/K2b launch, the bytes the tensor group all-reduces a step a
     rank, the parameters and the state's bytes a rank, each step's wall
     ms; then (slice 22, `eval_rank_part`, `eval_report`) (e) the eval
     samplers at data=2 and tensor=2 against rank 0's one-process runs,
     each at full width from its checked weights with every draw made at
     the global batch: eval-protein's sample at 8 x 256, 50 steps, f32 (K2a
     at H = 128 on each batch index's 4 rows, at H = 64 under tensor, 153
     launches a rank either way; its tokens at TOKEN_AGREEMENT or above)
     and at tensor=2 in bf16 once (10 steps, logged), MultiFlow (4 x 64, 10
     steps), SemlaFlow (the recipe's width, 8 molecules at max_atoms 72, 10
     steps logged beside its jitter witness, 1 step held), the EDM (8
     molecules, T = 25) and eval-conditional's EDM with its property
     classifier (8 molecules, T = 25): every data=2 run equal to its split
     witness (one process running each rank's rows apart), continuous
     outputs within GEN_RTOL[f32] of their largest, discrete ones at
     TOKEN_AGREEMENT or above, no K1/K2a/K2b launch, each run's seconds;
     (c) the same over
     NCCL with one card a rank, and `torchrun ...
     train-protein --distributed` without and with --fsdp 2 and with --tp
     2, `torchrun ... train-image --distributed` with --fsdp 2, with --tp
     2 and with --sp 2, and `torchrun ... train-molecule-semla` (arch
     semla and egnn),
     `train-molecule-edm`, `train-property` (and `--linear-probe`),
     `train-multiflow` and `train-rdm --distributed --tp 2`, `torchrun ...
     eval-protein --distributed --dp 2` and `eval-protein`, `eval-semla`,
     `eval-molecule`, `eval-conditional` and `eval-multiflow --distributed
     --tp 2`, where the machine has two cards, else a line that says why
     it did not run.
     `python3 chip_smoke.py --mol-tp FAMILY...` runs the slice-20/21
     tensor=2 steps of the MOL_TP families named alone (over NCCL and
     with the slice-21 torchrun smokes where the machine has two cards);
     `python3 chip_smoke.py --eval` runs (e) alone (over NCCL and with the
     eval subcommands through torchrun where the machine has two cards).
  16. SiT remat (slice 17, `remat_phases`): (a) bench.py's SiT-XL/2 REED
     step at batch 48 under remat=True and 'dots' against the step
     without, from the same state and draws (bitwise where a repeated step
     is, else within RESUME_NOISE_FACTOR x its difference), ms a step
     (wall, CUDA events), peak memory over uncaptured steps and K1
     launches (28 / 56 / 56) of each setting; the recipe's batch 256 for 3
     steps under True and 'dots' (peak memory, ms a step, imgs/s beside
     the reckoning). Its (b), fsdp=2 on two ranks, runs in phase 15's
     ranks.
  17. output: a {"kernels": [...]} line (K1 four times: bf16 on the bf16
     generation path and on the image train step, f32 on the f32
     generation path and on the image gate's training; K2a and K2b in f32
     on the protein paths, in bf16 on the bf16 protein training and in f32
     on the guided samplers; each on the data-parallel and fsdp steps, K1
     on the remat step and on the fsdp=2 remat step
     (flash_attention_fsdp_remat) and, as K1_tp and K1_sp, on the tensor=2
     and seq=2
     steps; K2a and K2b at H = 64, as K2a_tp and K2b_tp, on the protein
     tensor=2 step; K2a on eval-protein's sample at data=2, as K2a_eval_dp
     (timed at its 4 rows a rank), and at tensor=2 (H = 64), as
     K2a_eval_tp), the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.

K2b (the backward kernel) is held against its plain backward in phase 3.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import math
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch import _build, cli
from reed_tpu_torch.core import configlib
from reed_tpu_torch.core.checkpoint import CheckpointManager
from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
from reed_tpu_torch.core.train_state import global_norm
from reed_tpu_torch.core.trainer import capture_gradients, combine_losses, make_train_step
from reed_tpu_torch.diffusion.continuous import FlowMatchingLossConfig
from reed_tpu_torch.diffusion.discrete import corrupt_batch
from reed_tpu_torch.encoders import registry
from reed_tpu_torch.encoders.inception import make_feature_fn, preprocess_uint8
from reed_tpu_torch.encoders.vae import to_uint8
from reed_tpu_torch.eval.fid import FIDGenConfig, generate_samples
from reed_tpu_torch.eval.frechet import compute_activation_stats, frechet_distance
from reed_tpu_torch.models.sit import create_sit
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.ops import fused_message as fm
from reed_tpu_torch.parallel.mesh import SIT_AXES, SIT_TP_RULES, local_rows, shard_state_dict
from reed_tpu_torch.diffusion import se3 as mf_se3
from reed_tpu_torch.eval import protein_metrics as eval_protein_metrics
from reed_tpu_torch.models import ipa as ipa_model
from reed_tpu_torch.tools import (convergence_edm, convergence_image, convergence_multiflow,
                                  convergence_semla, seeded_weights)
from reed_tpu_torch.tools.convergence_protein import gate_config, rule_batch
from reed_tpu_torch.tools.cuda_timing import cuda_ms, host_us, timed_in_turns
from reed_tpu_torch.train.protein import (ProteinTrainConfig, ProteinTrainer,
                                          build_model, make_loss_fn, sample,
                                          synthetic_protein_batch)
from reed_tpu_torch.train import image as image_train
from reed_tpu_torch.train import molecule_edm as edm_train
from reed_tpu_torch.train import molecule_semla as semla_train
from reed_tpu_torch.train import multiflow as mf_train
from reed_tpu_torch.train import rdm as rdm_train
from reed_tpu_torch.train import property as property_train
from reed_tpu_torch.models import semla as semla_model
from reed_tpu_torch.eval import chemnet, molsets, visualize

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input
# type. f32: the least time the card can take for f32-accurate products is
# on the tensor cores as 3xTF32, three TF32 products a piece (hi.hi + hi.lo
# + lo.hi, which keeps f32 accuracy) at 495 TFLOP/s, so 495 / 3; every f32
# kernel here (K1, K2a, K2b) runs so. The bound at the f32 rate outside the
# tensor cores (67 TFLOP/s) is reported beside it as bound_ms_67.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
F32_CUDA_CORES_FLOPS = 67e12
# K1's plain version by dtype: in bf16 the one at the kernel's rounding
# points (p rounded to bf16 before the PV product, as the TPU kernel does);
# in f32 plain attention (the same function: nothing is rounded)
ATTN_PLAIN = {torch.float32: fa.sdpa_reference, torch.bfloat16: fa.flash_attention_reference}
# kernel vs plain version, max abs error on N(0, 1) inputs. f32: both
# accumulate in f32, only the summation order differs. bf16: both round p
# to bf16 and sum p v in f32, but the kernel rounds exp(l - running max)
# and rescales it in f32 when the max moves, and sums in another order, so
# a p or an output can round the other way: about 1 bf16 ulp of outputs up
# to |2| (2^-7 on [1, 2)).
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# full SiT-XL/2 call, kernel vs plain attention, max abs error relative to
# the output's max: f32 differs by summation order only; in bf16 the
# attention outputs differ by ~1 ulp and that propagates through 28 blocks
SIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# generated latents after 8 SDE steps, kernel vs plain attention, relative
# to their max: f32 differs by summation order and 3xTF32 rounding (~1e-6
# a call); bf16 by ~1 ulp a call, carried through 8 steps
GEN_RTOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

MAIN_SHAPE = (16, 256, 16, 72)  # SiT-XL/2, batch 8 doubled by CFG
ATTN_SHAPES = [
    MAIN_SHAPE,
    (8, 256, 16, 72),   # SiT-XL/2 outside the guidance window
    (8, 64, 6, 64),     # SiT-S/4
    (4, 1024, 16, 72),  # SiT-XL/2 at 512 px
    (2, 200, 4, 72),    # ragged S
]
# K1 with queries of one length against keys of another, (B, Sq, Sk, H, D):
# a seq=2 and a seq=4 rank of SiT-XL/2 at batch 16, and a ragged query tile
ATTN_SQ_SHAPES = [(16, 128, 256, 16, 72), (16, 64, 256, 16, 72), (2, 100, 256, 4, 72)]
# K1 on the model-parallel steps of phase 15 (global batch 16, SiT-XL/2):
# tensor=2 runs 8 of the 16 heads on qkv views; seq=2 runs 128 queries (qkv
# views) against the 256 keys and values all-gathered over the seq group
# ([Sk, B, 2, H, D] gathered, read as [B, Sk, 2, H, D])
TP_ATTN_SHAPE = (16, 256, 8, 72)
SP_ATTN_SHAPE = (16, 128, 256, 16, 72)
DEPTH = 28
GEN = dict(num_samples=16, batch_size=8, mode="sde", num_steps=8,
           cfg_scale=4.0, guidance_low=0.0, guidance_high=0.5, seed=0)

# fused message kernel vs its plain version, max abs error on inputs whose
# activations are O(1). f32: both accumulate in f32; the kernel's products
# are 3xTF32 (~6e-7 relative, tests/test_torch_fused_message_tf32.py) and
# the summation order differs. bf16: both round m1, m2 and the output to
# bf16 at the same points, so they differ where an f32 summation-order
# difference flips a rounding: one bf16 ulp of an output (2^-7 on [1, 2),
# 2^-6 on [2, 4)).
MSG_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# (B, L, K, D, Ce), mask mode, outputs
MSG_CASES = [
    ((8, 256, 30, 128, 128), "post", "sum"),   # EncLayer chain 1
    ((8, 256, 30, 128, 128), "none", "msg"),   # EncLayer chain 2
    ((8, 256, 30, 128, 256), "pre", "both"),   # DecLayer, 147 of 153 launches
    ((3, 100, 30, 128, 256), "pre", "both"),   # ragged L
    ((2, 16, 4, 32, 64), "post", "both"),      # narrow
]
MSG_MAIN = MSG_CASES[2]
# eval-protein's K2a on its data=2 ranks (phase 15 (e)): the decoder's chain
# on each batch index's 4 of the 8 rows, timed beside MSG_CASES (forward)
MSG_EVAL_DP = ((4, 256, 30, 128, 256), "pre", "both")
# tensor=2's share of a chain at D = 128 (parallel/mesh.PMPNN_TP_RULES): W2's
# columns, b2 and W3's rows of H = 64 hidden units. (case, dtype, out_f32):
# the encoder's first chain and the decoder's with the partial outputs in
# f32, as the tensor=2 step writes them, and the bf16 decoder case once
# with its outputs in bf16
MSG_TP_H = 64
MSG_TP_CASES = [(case, dtype, True) for case in (MSG_CASES[0], MSG_MAIN)
                for dtype in (torch.float32, torch.bfloat16)] + [
    (MSG_MAIN, torch.bfloat16, False)]
# ProteinMPNN-FMIF log-probs, message chains through the kernel vs the
# unfused layer math, max abs error over valid positions. f32: summation
# order only, through 3 + 3 layers. bf16: the unfused math rounds each
# product's output to bf16 where the kernel keeps f32 until m1, m2 and msg
# are rounded, so messages differ by ~1 bf16 ulp, carried through 6 layers
# and 6 LayerNorms into log-probs of magnitude ~3.
PMPNN_ATOL = {torch.float32: 2e-4, torch.bfloat16: 0.25}
PROTEIN = dict(batch=8, length=256, num_steps=50)
# 50-step sampling, kernel vs unfused chain with one generator seed: at
# least this share of tokens equal (f32). A near-tie flip changes later
# draws; a broken kernel lands near chance (1/20).
TOKEN_AGREEMENT = 0.9
# one full-width train step (dropout 0, the same corrupted tokens), message
# chains through K2a/K2b vs the unfused layer math: each metric to 1e-4
# (relative above 1, absolute below: the alignment losses are near 0 at
# init), each parameter's gradient to 1e-3 of that gradient's max. Both
# are f32; the sums run in another order (K2b's fixed row ranges and
# atomic adds against cuBLAS and PyTorch's reductions) through 3 + 3 layers.
TRAIN_METRIC_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN = dict(batch=8, length=256, timed_steps=20)
# learning check on the convergence gate's data (16 x 48, rule batches of
# tools/convergence_protein.py): the JAX run on a TPU went from CE 1.50 at
# step 0 to 1.16 at step 100 and 1.17 at step 200 (CONVERGENCE_PROTEIN.json).
# The mean CE of steps 180-199 must be below LEARN_CE_MAX, which a model that
# does not learn (CE stays ~1.5) cannot reach.
LEARN_STEPS = 200
LEARN_CE_MAX = 1.30

# SiT-XL/2 REED image training at bench.py's configuration (bench.py:60-83)
IMAGE_TRAIN = dict(batch=48, warmup_steps=3, timed_steps=20, profiled_steps=8)
IMAGE_ATTN_SHAPE = (48, 256, 16, 72)  # K1 on the train step, bf16
GATE_ATTN_SHAPE = (128, 4, 6, 64)     # K1 on the image gate (SiT-S/4, 8x8 latents), f32
# one full-width step through K1 vs plain attention (same state, t, eps and
# label drops). f32 at batch 8: metrics to 1e-4 and each gradient to 1e-3
# of its max, as the protein step is held. bf16 at batch 48: the plain path
# rounds the logits to bf16 where K1 keeps them in f32, and both round the
# stream, weights and probabilities to bf16, so each is only as close to the
# other as bf16 allows. The bound is measured in the same run: the same
# plain step in f32 (same state; attention through K1 in f32, 1e-6 from
# plain) is the truth, and the K1 step may differ from the plain bf16 step
# by at most twice the plain bf16 step's own distance from it, for the
# worst gradient (max error / max |g|) and for the worst metric (relative
# above 1). A kernel that is wrong moves the step by O(1), not by bf16 noise.
IMAGE_GRAD_RTOL = 1e-3
IMAGE_METRIC_RTOL = 1e-4
IMAGE_BF16_NOISE_FACTOR = 2.0
# bench.py's flop count per trained image (bench.py:36-44): 6 N S for the
# dense products (N = 675e6, S = 256) plus 12 S^2 D per layer for attention
SIT_XL_TRAIN_FLOPS_PER_IMG = 6.0 * 675e6 * 256 + 12.0 * 256 * 256 * 1152 * 28
# learning check on the image gate's data (tools/convergence_image.py): the
# JAX run on a TPU went from a denoising loss of 2.05 at step 0 (E|v|^2 of
# the untrained, zero-output model) to 0.565 at step 200
# (CONVERGENCE_IMAGE.json). The mean of steps 180-199 must be below 1.0,
# about the geometric mean of the two: a model that does not learn stays ~2.
IMAGE_LEARN_STEPS = 200
IMAGE_LEARN_LOSS_MAX = 1.0


def log(*args):
    print(*args, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def demangle(symbol):
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return symbol
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ")  # template arguments may hold spaces


def build_phase():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():  # ptxas -v: one entry function at a time
        entry, stack = None, ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = demangle(line.split("'")[1])
            elif "spill" in line:
                stack = line.strip()
            elif "registers" in line:
                log(f"[build] {name}: {entry}: {line.split(':', 1)[-1].strip()}; {stack}")


def roofline(nbytes, flops, dtype):
    """(bound_ms, bound_by, bound_ms_67): the least time for moving nbytes
    and doing flops of dtype, what bounds it, and in f32 the same bound at
    the CUDA-core rate (None in bf16)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    ms_67 = (max(t_bytes, flops / F32_CUDA_CORES_FLOPS) * 1e3
             if dtype == torch.float32 else None)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", ms_67


def attention_bound(shape, dtype, sk=None):
    """K1's least time on q and o of `shape` [B, Sq, H, D] and k and v of
    [B, sk, H, D] (sk None: Sq)."""
    b, sq, h, d = shape
    sk = sq if sk is None else sk
    nbytes = 2 * b * (sq + sk) * h * d * torch.finfo(dtype).bits // 8  # q, o; k, v
    return roofline(nbytes, 4 * b * h * sq * sk * d, dtype)


def attention_info():
    """Dynamic shared memory per block and blocks per SM of the kernels at
    the checked head dims."""
    lib = fa._kernel()
    for dtype in (torch.bfloat16, torch.float32):
        for d in sorted({shape[-1] for shape in ATTN_SHAPES}):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = lib.reed_flash_attention_info(int(dtype == torch.bfloat16), d,
                                                ctypes.byref(smem), ctypes.byref(blocks))
            if err:
                raise RuntimeError(lib.reed_cuda_error_string(err).decode())
            log(f"[kernel] flash_attention {str(dtype)[6:]} D {d}: {smem.value} bytes "
                f"of shared memory per block, {blocks.value} blocks per SM")


def attention_case(label, q, k, v, smi, plain=None):
    dtype = q.dtype
    plain = plain or ATTN_PLAIN[dtype]
    out = fa.flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    ref = plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    times = timed_in_turns({
        "ms": lambda: fa.flash_attention_kernel(q, k, v),
        "plain_ms": lambda: plain(q, k, v),
        "library_ms": lambda: F.scaled_dot_product_attention(qt, kt, vt)})
    bound, bound_by, bound_67 = attention_bound(tuple(q.shape), dtype, k.shape[1])
    row = dict(max_abs_err=err, atol=ATTN_ATOL[dtype],
               max_abs_ref=ref.float().abs().max().item(), **times,
               faster_than_plain_and_library=times["ms"] < min(times["plain_ms"],
                                                               times["library_ms"]),
               bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67)
    log(f"[kernel] flash_attention {label} {str(dtype)[6:]} vs {plain.__name__} "
        f"({smi}): " + json.dumps(row))
    if not (torch.isfinite(out).all() and err <= ATTN_ATOL[dtype]):
        raise AssertionError(f"flash_attention {label} {dtype}: max abs err "
                             f"{err} > {ATTN_ATOL[dtype]}")
    return row


def f32_layout_phase(gen):
    """K1 f32 on layouts the checked shapes do not reach: an odd head dim and
    a base 4 bytes past 16-byte alignment (4-byte copies, scalar stores),
    and D = 128 (Q's fragments re-read from shared memory)."""
    def qkv(d, offset=0):
        return [torch.randn(2 * 100 * 3 * d + offset, generator=gen, device="cuda")[offset:]
                .view(2, 100, 3, d) for _ in range(3)]

    for label, (q, k, v) in (("D 70", qkv(70)), ("D 72, base + 4 bytes", qkv(72, 1)),
                             ("D 128", qkv(128))):
        out = fa.flash_attention_kernel(q, k, v)
        torch.cuda.synchronize()
        err = (out - fa.sdpa_reference(q, k, v)).abs().max().item()
        log(f"[kernel] flash_attention f32 (2, 100, 3, {q.shape[-1]}) {label}: max abs err "
            f"{err:.3g} (atol {ATTN_ATOL[torch.float32]})")
        if not err <= ATTN_ATOL[torch.float32]:
            raise AssertionError(f"flash_attention f32 {label}: max abs err {err}")


def kernel_phase(smi):
    attention_info()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                       for _ in range(3))
            rows[(shape, dtype)] = attention_case(str(shape), q, k, v, smi)
    # SiT's layout: q, k, v strided views of the fused projection, no copy
    b, s, h, d = MAIN_SHAPE
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    attention_case(f"{MAIN_SHAPE} qkv[:, :, i] views", q, k, v, smi)
    # the image train step's and the image gate's shapes, on qkv views as SiT
    # gives them (S stride 3 H D, H stride D, bases 0, H D and 2 H D elements)
    for shape, dtype in ((IMAGE_ATTN_SHAPE, torch.bfloat16), (GATE_ATTN_SHAPE, torch.float32)):
        b, s, h, d = shape
        views = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                            dtype=dtype).unbind(2)
        rows[(shape, dtype)] = attention_case(f"{shape} qkv[:, :, i] views", *views, smi)
    f32_layout_phase(gen)
    # queries of one length against keys of another (SiT's seq axis)
    for b, sq, sk, h, d in ATTN_SQ_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda", dtype=dtype)
            k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda", dtype=dtype)
                    for _ in range(2))
            rows[(b, sq, sk, h, d), dtype] = attention_case(
                f"(B {b}, Sq {sq} | Sk {sk}, H {h}, D {d})", q, k, v, smi,
                plain=fa.flash_attention_reference)
    # the model-parallel steps' layouts: tensor=2's heads on qkv views, seq=2's
    # queries on qkv views against keys and values of the gathered layout
    b, s, h, d = TP_ATTN_SHAPE
    views = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16).unbind(2)
    rows["tp"] = attention_case(f"tensor=2 {TP_ATTN_SHAPE} qkv[:, :, i] views", *views, smi)
    b, sq, sk, h, d = SP_ATTN_SHAPE
    q = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)[:, :, 0]
    kv = torch.randn((sk, b, 2, h, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16).movedim(0, 1)
    rows["sp"] = attention_case(f"seq=2 (B {b}, Sq {sq} | Sk {sk}, H {h}, D {d}) qkv view "
                                "against gathered k, v", q, kv[:, :, 0], kv[:, :, 1], smi)
    q, k, v = qkv.unbind(2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    log("[kernel] flash_attention host time per call (launch cost, us): " + json.dumps({
        "flash_attention_kernel": host_us(lambda: fa.flash_attention_kernel(q, k, v)),
        "flash_attention, no grad": host_us(lambda: fa.flash_attention(q, k, v)),
        "SDPA": host_us(lambda: F.scaled_dot_product_attention(qt, kt, vt))}))
    # backward: autograd.Function (kernel forward, plain recompute) vs plain
    q, k, v = (torch.randn((2, 64, 4, 72), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    g_kernel = torch.autograd.grad(fa.flash_attention(q, k, v).square().sum(), (q, k, v))
    g_plain = torch.autograd.grad(fa.sdpa_reference(q, k, v).square().sum(), (q, k, v))
    gerr = max((a - b).abs().max().item() for a, b in zip(g_kernel, g_plain))
    log(f"[kernel] flash_attention backward max abs err {gerr:.3g} (atol 1e-4)")
    if not gerr <= 1e-4:
        raise AssertionError(f"flash_attention backward err {gerr}")
    return rows


def message_bound(case, dtype, h=None, out_f32=False):
    """Least time for one fused message launch at hidden width h (default
    D): inputs read once (with int32 e_idx and f32 mask; W2 [D, h], W3 [h,
    D]) and outputs written once (in f32 with out_f32) over the memory
    rate, or the three products' 2 E (Ce D + 2 D h) flops over the peak for
    dtype."""
    (b, l, k, d, ce), mode, outputs = case
    h = d if h is None else h
    es = torch.finfo(dtype).bits // 8
    os_ = 4 if out_f32 else es
    e = b * l * k
    nbytes = (es * (2 * b * l * d + e * ce + ce * d + 2 * d * h + h + d) + 4 * e
              + (4 * e if mode != "none" else 0)
              + os_ * (b * l * d * (outputs != "msg") + e * d * (outputs != "sum")))
    return roofline(nbytes, 2 * e * (ce * d + 2 * d * h), dtype)


def message_inputs(case, dtype, gen):
    """Kernel arguments with O(1) activations (weights ~ N(0, 1/fan_in))."""
    (b, l, k, d, ce), mode, outputs = case

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    mask = (torch.rand((b, l, k), generator=gen, device="cuda") < 0.8).float()
    return dict(
        pre_self=randn(b, l, d, std=0.5), e_feat=randn(b, l, k, ce),
        nbr_src=randn(b, l, d, std=0.5),
        e_idx=torch.randint(0, l, (b, l, k), generator=gen, device="cuda",
                            dtype=torch.int32),
        w_e=randn(ce, d, std=ce ** -0.5), w2=randn(d, d, std=d ** -0.5),
        b2=randn(d, std=0.1), w3=randn(d, d, std=d ** -0.5), b3=randn(d, std=0.1),
        mask=None if mode == "none" else mask, mask_mode=mode,
        want_sum=outputs != "msg", want_msg=outputs != "sum")


def message_info():
    """Shared memory per block, blocks per SM and tile rows of the fused
    message kernels (K2a; K2b's tile kernel and weight-gradient kernel)."""
    for dtype in (torch.float32, torch.bfloat16):
        for which, name in enumerate(fm.KERNEL_NAMES):
            smem, blocks, rows = fm.kernel_info(dtype, which)
            log(f"[kernel] {name} {str(dtype)[6:]}: {smem} bytes of shared memory per "
                f"block, {blocks} blocks per SM, {rows}-row tiles")


def message_kernel_phase(smi):
    message_info()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for case in MSG_CASES + [MSG_EVAL_DP]:
        for dtype in (torch.float32, torch.bfloat16):
            kw = message_inputs(case, dtype, gen)
            out = fm.fused_message_kernel(**kw)
            torch.cuda.synchronize()
            ref = fm.fused_message_reference(**kw)
            err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(out, ref) if r is not None)
            ref_max = max(r.float().abs().max().item() for r in ref if r is not None)
            bound, bound_by, bound_67 = message_bound(case, dtype)
            times = timed_in_turns({
                "ms": lambda: fm.fused_message_kernel(**kw),
                "plain_ms": lambda: fm.fused_message_reference(**kw)})
            row = dict(max_abs_err=err, atol=MSG_ATOL[dtype], max_abs_ref=ref_max, **times,
                       bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67,
                       library_ms=None)
            rows[(case, dtype)] = row
            log(f"[kernel] fused_message {case[0]} {case[1]}/{case[2]} "
                f"{str(dtype)[6:]} ({smi}): " + json.dumps(row))
            if not err <= MSG_ATOL[dtype]:
                raise AssertionError(f"fused_message {case} {dtype}: max abs err "
                                     f"{err} > {MSG_ATOL[dtype]}")
    return rows


# backward kernel vs its plain backward, max abs error of each of the eight
# gradients relative to that gradient's max. f32: the kernel's products are
# 3xTF32 (~6e-7 relative a product, tests/test_torch_fused_message_tf32.py)
# and the summation order differs (the weight gradients sum 61,440 edge rows
# in fixed row ranges; d nbr_src takes atomic adds in no fixed order). bf16:
# both round g3, g2 and ge to bf16 at the same points, so a summation-order
# difference that flips one rounding moves that element by one bf16 ulp
# (2^-8 relative), which reaches the products it feeds.
MSG_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
GRAD_NAMES = ("d_pre_self", "d_e_feat", "d_nbr_src", "d_w_e", "d_w2", "d_b2",
              "d_w3", "d_b3")


def message_backward_bound(case, dtype, h=None, out_f32=False):
    """Least time for one backward launch at hidden width h (default D):
    inputs, cotangents and the eight gradients moved once over the memory
    rate (the partial ones, d pre_self, d e_feat, d nbr_src and dW_e, in
    f32 with out_f32), or 2 E (3 Ce D + 5 D h) flops (two recomputed
    products and five backward ones) over the peak."""
    (b, l, k, d, ce), mode, outputs = case
    h = d if h is None else h
    es = torch.finfo(dtype).bits // 8
    gs = 4 if out_f32 else es
    e = b * l * k
    n_w = ce * d + 2 * d * h + h + d
    inputs = es * (2 * b * l * d + e * ce + n_w) + 4 * e + (4 * e if mode != "none" else 0)
    cots = es * (b * l * d * (outputs != "msg") + e * d * (outputs != "sum"))
    grads = gs * (2 * b * l * d + e * ce + ce * d) + es * (n_w - ce * d)
    return roofline(inputs + cots + grads, 2 * e * (3 * ce * d + 5 * d * h), dtype)


def message_backward_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for case in MSG_CASES:
        (b, l, k, d, ce), _, _ = case
        for dtype in (torch.float32, torch.bfloat16):
            kw = message_inputs(case, dtype, gen)
            want_sum, want_msg = kw.pop("want_sum"), kw.pop("want_msg")
            kw["gdh"] = (torch.randn((b, l, d), generator=gen, device="cuda").to(dtype)
                         if want_sum else None)
            kw["gmsg"] = (torch.randn((b, l, k, d), generator=gen, device="cuda").to(dtype)
                          if want_msg else None)
            out = fm.fused_message_backward_kernel(**kw)
            again = fm.fused_message_backward_kernel(**kw)
            torch.cuda.synchronize()
            ref = fm.fused_message_backward_reference(**kw)
            rel = {n: ((a.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp_min(1e-30)).item()
                   for n, a, r in zip(GRAD_NAMES, out, ref)}
            finite = all(bool(torch.isfinite(a).all()) for a in out)
            # the weight gradients are summed in a fixed order: equal bits on every run
            same = all(torch.equal(a, b) for a, b in zip(out[3:], again[3:]))
            bound, bound_by, bound_67 = message_backward_bound(case, dtype)
            times = timed_in_turns({
                "ms": lambda: fm.fused_message_backward_kernel(**kw),
                "plain_ms": lambda: fm.fused_message_backward_reference(**kw)})
            row = dict(max_rel_err=max(rel.values()), rtol=MSG_BWD_RTOL[dtype],
                       max_abs_err=max((a.float() - r.float()).abs().max().item()
                                       for a, r in zip(out, ref)),
                       rel_err=rel, weight_grads_bitwise_equal_over_two_launches=same,
                       **times, bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67,
                       library_ms=None)
            rows[(case, dtype)] = row
            log(f"[kernel] fused_message_bwd {case[0]} {case[1]}/{case[2]} "
                f"{str(dtype)[6:]} ({smi}): " + json.dumps(row))
            if not (finite and same and row["max_rel_err"] <= MSG_BWD_RTOL[dtype]):
                raise AssertionError(f"fused_message_bwd {case} {dtype}: relative "
                                     f"errors {rel} (rtol {MSG_BWD_RTOL[dtype]}), "
                                     f"finite {finite}, weight gradients equal over "
                                     f"two launches {same}")
    # autograd: kernel forward + kernel backward against plain autograd
    case = MSG_MAIN
    kw = message_inputs(case, torch.float32, gen)
    names = ("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3", "b3")
    leaves = {n: kw[n].clone().requires_grad_() for n in names}
    cot = [torch.randn(t.shape, generator=gen, device="cuda")
           for t in fm.fused_message_reference(**kw)]
    before = (fm.launches, fm.backward_launches)
    got = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(fm.fused_message_mlp(**{**kw, **leaves}), cot)),
        [leaves[n] for n in names])
    counted = (fm.launches - before[0], fm.backward_launches - before[1])
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(fm.fused_message_reference(**{**kw, **leaves}), cot)),
        [leaves[n] for n in names])
    rel = max(((a - r).abs().max() / r.abs().max()).item() for a, r in zip(got, want))
    log(f"[kernel] fused_message_mlp autograd (K2a + K2b) vs plain autograd at "
        f"{case[0]}: max rel err {rel:.3g} (rtol {MSG_BWD_RTOL[torch.float32]}), "
        f"launches fwd/bwd {counted}")
    if not (rel <= MSG_BWD_RTOL[torch.float32] and counted == (1, 1)):
        raise AssertionError(f"fused_message_mlp autograd: rel err {rel}, launches {counted}")
    return rows


def message_tp_inputs(case, dtype, gen):
    """message_inputs with W2's first MSG_TP_H columns, b2's entries and
    W3's rows: tensor rank 0's share of the chain."""
    kw = message_inputs(case, dtype, gen)
    h = MSG_TP_H
    kw.update(w2=kw["w2"][:, :h].contiguous(), b2=kw["b2"][:h].contiguous(),
              w3=kw["w3"][:h].contiguous())
    return kw


def message_tp_phase(smi):
    """K2a and K2b at H = MSG_TP_H hidden units (tensor=2's share of a
    chain, MSG_TP_CASES) against their plain versions at the same H: the
    forward to MSG_ATOL, each backward gradient to MSG_BWD_RTOL of its
    largest, the weight gradients bitwise over two launches; device times
    in turns with the plain versions; the bounds at H."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for case, dtype, out_f32 in MSG_TP_CASES:
        (b, l, k, d, ce), _, _ = case
        label = (f"{case[0]} H {MSG_TP_H} {case[1]}/{case[2]} {str(dtype)[6:]}, "
                 f"outputs in {'f32' if out_f32 else str(dtype)[6:]}")
        kw = message_tp_inputs(case, dtype, gen)
        out = fm.fused_message_kernel(**kw, out_f32=out_f32)
        torch.cuda.synchronize()
        ref = fm.fused_message_reference(**kw, out_f32=out_f32)
        if not all(o.dtype == r.dtype for o, r in zip(out, ref) if r is not None):
            raise AssertionError(f"fused_message {label}: output dtypes differ")
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(out, ref) if r is not None)
        bound, bound_by, bound_67 = message_bound(case, dtype, MSG_TP_H, out_f32)
        times = timed_in_turns({
            "ms": lambda: fm.fused_message_kernel(**kw, out_f32=out_f32),
            "plain_ms": lambda: fm.fused_message_reference(**kw, out_f32=out_f32)})
        fwd = dict(max_abs_err=err, atol=MSG_ATOL[dtype], **times, bound_ms=bound,
                   bound_by=bound_by, bound_ms_67=bound_67, library_ms=None)
        log(f"[kernel] fused_message {label} ({smi}): " + json.dumps(fwd))
        if not err <= MSG_ATOL[dtype]:
            raise AssertionError(f"fused_message {label}: max abs err {err}")
        want_sum, want_msg = kw.pop("want_sum"), kw.pop("want_msg")
        kw["gdh"] = (torch.randn((b, l, d), generator=gen, device="cuda").to(dtype)
                     if want_sum else None)
        kw["gmsg"] = (torch.randn((b, l, k, d), generator=gen, device="cuda").to(dtype)
                      if want_msg else None)
        out = fm.fused_message_backward_kernel(**kw, out_f32=out_f32)
        again = fm.fused_message_backward_kernel(**kw, out_f32=out_f32)
        torch.cuda.synchronize()
        ref = fm.fused_message_backward_reference(**kw, out_f32=out_f32)
        rel = {n: ((a.float() - r.float()).abs().max()
                   / r.float().abs().max().clamp_min(1e-30)).item()
               for n, a, r in zip(GRAD_NAMES, out, ref)}
        shapes = all(a.shape == r.shape and a.dtype == r.dtype for a, r in zip(out, ref))
        finite = all(bool(torch.isfinite(a).all()) for a in out)
        same = all(torch.equal(a, c) for a, c in zip(out[3:], again[3:]))
        bound, bound_by, bound_67 = message_backward_bound(case, dtype, MSG_TP_H, out_f32)
        times = timed_in_turns({
            "ms": lambda: fm.fused_message_backward_kernel(**kw, out_f32=out_f32),
            "plain_ms": lambda: fm.fused_message_backward_reference(**kw, out_f32=out_f32)})
        bwd = dict(max_rel_err=max(rel.values()), rtol=MSG_BWD_RTOL[dtype],
                   max_abs_err=max((a.float() - r.float()).abs().max().item()
                                   for a, r in zip(out, ref)),
                   rel_err=rel, weight_grads_bitwise_equal_over_two_launches=same, **times,
                   bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67, library_ms=None)
        log(f"[kernel] fused_message_bwd {label} ({smi}): " + json.dumps(bwd))
        if not (shapes and finite and same and bwd["max_rel_err"] <= MSG_BWD_RTOL[dtype]):
            raise AssertionError(f"fused_message_bwd {label}: relative errors {rel}, shapes "
                                 f"and dtypes {shapes}, finite {finite}, weight gradients "
                                 f"equal over two launches {same}")
        rows[(case, dtype, out_f32)] = {"fwd": fwd, "bwd": bwd}
    return rows


# kernel families of the profile summary, matched in order on kernel names
PROFILE_GROUPS = (("K2b fused_message_bwd", ("fused_message_bwd", "fused_message_wgrad",
                                             "sum_grads", "sum_bias")),
                  ("K2a fused_message_fwd", ("fused_message_fwd",)),
                  ("K1 flash_attention", ("attention_fwd",)),
                  ("GEMM (cuBLAS/CUTLASS)", ("gemm", "Kernel2", "nvjet")),
                  ("LayerNorm fwd/bwd", ("layer_norm", "GammaBeta")),
                  ("softmax fwd/bwd", ("softmax",)),
                  ("multi-tensor (foreach)", ("multi_tensor_apply",)),
                  ("reductions", ("reduce_kernel",)),
                  ("elementwise, copies, other", ("",)))
# profiler ranges of the port (record_function): the device time of the
# kernels launched inside each
PROFILE_RANGES = ("reed::optimizer", "reed::ema", "reed::flash_attention_bwd_recompute",
                  "reed::self_cond", "reed::model", "reed::loss")


def profile(label, fn, smi, top=8):
    """Device time of one call by kernel (torch.profiler, CUPTI): the busy
    share of the call's wall time, the time of each kernel family, of the
    kernels launched inside the port's profiler ranges, and the kernels
    that take the most. Returns the call's wall ms, busy ms and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # a profiler range also appears on the device as an annotation spanning
    # its kernels: not a kernel, so not counted
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), {len(kernels)} kernel "
        f"names, {launches} launches ({smi})")
    groups = dict.fromkeys(name for name, _ in PROFILE_GROUPS)
    for e in kernels:
        name = next(n for n, keys in PROFILE_GROUPS if any(k in e.key for k in keys))
        ms, count = groups[name] or (0.0, 0)
        groups[name] = (ms + e.self_device_time_total / 1e3, count + e.count)
    log(f"[profile]   by family: " + "; ".join(
        f"{n} {v[0]:.3f} ms x{v[1]}" for n, v in groups.items() if v))
    ranges = {e.key: e for e in events
              if e.device_type == DeviceType.CPU and e.key in PROFILE_RANGES}
    if ranges:
        log(f"[profile]   by range (device time of the kernels inside): " + "; ".join(
            f"{n} {e.device_time_total / 1e3:.3f} ms x{e.count}" for n, e in ranges.items()))
    for e in kernels[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, launches=launches)


def perturb_pmpnn(model, gen):
    """Seeded nonzero node_embeds and LayerNorms on top of the initialisation
    (zero node_embeds and unit LayerNorms would hide the encoder's start)."""
    with torch.no_grad():
        model.node_embeds.normal_(0.0, 1.0, generator=gen)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(torch.randn(m.weight.shape, generator=gen,
                                          device="cuda") * 0.1)
                m.bias.normal_(0.0, 0.1, generator=gen)


@torch.no_grad()
def protein_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = ProteinTrainConfig()
    model = build_model(cfg, device="cuda", generator=gen)
    perturb_pmpnn(model, gen)
    batch = synthetic_protein_batch(gen, PROTEIN["batch"], PROTEIN["length"])
    args = (batch["X"], batch["S"], batch["mask"], batch["chain_M"],
            batch["residue_idx"], batch["chain_encoding_all"])
    for dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model).to_compute_dtype(dtype)
        m.fused = True
        out = m(*args)
        m.fused = False
        ref = m(*args)
        err = (out - ref).abs().max().item()
        log(f"[protein] ProteinMPNN-FMIF {str(dtype)[6:]} forward, kernel vs "
            f"unfused chain: log-probs max abs err {err:.3g} (atol "
            f"{PMPNN_ATOL[dtype]}), max |log p| {ref.abs().max().item():.3g}")
        if not (torch.isfinite(out).all() and err <= PMPNN_ATOL[dtype]):
            raise AssertionError(f"ProteinMPNN-FMIF {dtype}: err {err}")
        del m

    if not (model.fused and model.dtype == torch.float32):
        raise AssertionError("the default config must run the kernel in f32")
    enc = model(*args, return_enc=True)
    enc_ms = cuda_ms(lambda: model(*args, return_enc=True), iters=10, warmup=2,
                     queued=False)
    dec_ms = cuda_ms(lambda: model(*args, enc_state=enc), iters=20, warmup=2, queued=False)
    log(f"[protein] f32 encoder pass {enc_ms:.3f} ms, decoder step {dec_ms:.3f} ms "
        f"at batch {PROTEIN['batch']} x {PROTEIN['length']} ({smi})")
    profile("encoder pass", lambda: model(*args, return_enc=True), smi)
    profile("decoder step", lambda: model(*args, enc_state=enc), smi)

    interp = dataclasses.replace(cfg.interpolant, num_timesteps=PROTEIN["num_steps"])
    torch.cuda.synchronize()
    fm.launches = fa.launches = 0
    t0 = time.perf_counter()
    pred, tokens = sample(model, batch, torch.Generator(device="cuda").manual_seed(7),
                          interp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fm.launches
    expect = 2 * cfg.num_encoder_layers + cfg.num_decoder_layers * (interp.num_timesteps - 1)
    n = PROTEIN["batch"]
    log(f"[protein] sample: {n} x {PROTEIN['length']} residues, "
        f"{interp.num_timesteps} steps, {launches} fused_message launches "
        f"(expected {expect}), {fa.launches} flash_attention, {seconds:.4f} s: "
        f"{n / seconds:.3f} sequences/s, {n * PROTEIN['length'] / seconds:.1f} "
        f"residues/s, {1e3 * seconds / (interp.num_timesteps - 1):.3f} ms per "
        f"decoder step incl. the encoder pass ({smi})")
    valid = batch["mask"].bool()
    if launches != expect:
        raise AssertionError(f"expected {expect} fused_message launches, got {launches}")
    if (tokens[valid] == interp.mask_index).any() or (pred[valid] == interp.mask_index).any():
        raise AssertionError("mask tokens left at valid positions after sampling")

    model.fused = False
    pred_p, tokens_p = sample(model, batch,
                              torch.Generator(device="cuda").manual_seed(7), interp)
    model.fused = True
    agree = (tokens_p == tokens)[valid].float().mean().item()
    agree_pred = (pred_p == pred)[valid].float().mean().item()
    log(f"[protein] sampled tokens, kernel vs unfused chain: {agree:.4f} equal "
        f"(pred {agree_pred:.4f}; at least {TOKEN_AGREEMENT})")
    if not agree >= TOKEN_AGREEMENT:
        raise AssertionError(f"token agreement {agree} < {TOKEN_AGREEMENT}")
    profile(f"sample ({interp.num_timesteps} steps)", lambda: sample(
        model, batch, torch.Generator(device="cuda").manual_seed(7), interp), smi)
    return launches


def train_config(dropout=0.1):
    """The default ProteinTrainConfig with the denoising loss weighted 1 from
    step 0 (its default warm-up gives it weight 0 at step 0)."""
    cfg = ProteinTrainConfig(dropout=dropout)
    return dataclasses.replace(cfg, curriculum=dataclasses.replace(
        cfg.curriculum, diffusion_warmup_steps=0))


def train_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(3)

    # one step, message chains through the kernels vs the unfused chain
    cfg = train_config(dropout=0.0)
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    perturb_pmpnn(state.model, gen)
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    corrupted = corrupt_batch(batch, cfg.interpolant, gen)
    noisy = (corrupted["S_t"], corrupted["t"])
    loss_fn = make_loss_fn(cfg)
    names, params = zip(*state.model.named_parameters())
    results = {}
    for fused in (True, False):
        state.model.fused = fused
        before = (fm.launches, fm.backward_launches)
        metrics = loss_fn(state.model, batch, 0, noisy=noisy)
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        torch.cuda.synchronize()
        counted = (fm.launches - before[0], fm.backward_launches - before[1])
        results[fused] = ({k: v.item() for k, v in dict(metrics, loss=total).items()},
                          [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, params)], counted)
    state.model.fused = True
    (m_f, g_f, n_f), (m_u, g_u, _) = results[True], results[False]
    metric_err = max(abs(m_f[k] - m_u[k]) / max(abs(m_u[k]), 1.0) for k in m_u)
    grad_err = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for n, a, b in zip(names, g_f, g_u)}
    worst = max(grad_err, key=grad_err.get)
    per_step = 2 * trainer.cfg.num_encoder_layers + trainer.cfg.num_decoder_layers
    log(f"[train] one step at {TRAIN['batch']} x {TRAIN['length']}, kernels vs unfused "
        f"chain: metrics max rel err {metric_err:.3g} (rtol {TRAIN_METRIC_RTOL}), "
        f"gradients max err / max |g| {grad_err[worst]:.3g} at {worst} (rtol "
        f"{TRAIN_GRAD_RTOL}) over {len(names)} parameters; launches fwd/bwd {n_f}; "
        f"loss {m_f['loss']:.6g}, denoising {m_f['denoising_loss']:.6g}, proj "
        f"{m_f['proj_loss']:.6g}")
    if not (metric_err <= TRAIN_METRIC_RTOL and grad_err[worst] <= TRAIN_GRAD_RTOL
            and all(torch.isfinite(g).all() for g in g_f)):
        raise AssertionError(f"fused vs unfused train step: metrics {m_f} vs {m_u}, "
                             f"gradient errors {grad_err}")
    if n_f != (per_step, per_step):
        raise AssertionError(f"expected {per_step} K2a and K2b launches, got {n_f}")
    del trainer, state, results, g_f, g_u, grads

    # the main path: ProteinTrainer.train_step at the default dropout
    cfg = train_config()
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    steps = TRAIN["timed_steps"]
    fm.launches = fm.backward_launches = fa.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (fm.launches, fm.backward_launches)
    residues = TRAIN["batch"] * TRAIN["length"]
    log(f"[train] ProteinTrainer.train_step, default config (dropout "
        f"{cfg.dropout}): {steps} steps in {seconds:.4f} s = "
        f"{1e3 * seconds / steps:.3f} ms per step, {residues * steps / seconds:.1f} "
        f"residues/s, {TRAIN['batch'] * steps / seconds:.2f} sequences/s; launches "
        f"K2a {launches[0]}, K2b {launches[1]} (expected {per_step * steps} each), "
        f"flash_attention {fa.launches}; last loss {metrics['loss'].item():.6g}, "
        f"grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if launches != (per_step * steps, per_step * steps):
        raise AssertionError(f"expected {per_step * steps} K2a and K2b launches, "
                             f"got {launches}")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics {metrics}")
    profile("train step", lambda: trainer.train_step(state, batch), smi, top=12)
    del trainer, state, batch

    # learning: the convergence gate's configuration and data
    trainer = ProteinTrainer(gate_config(), device="cuda")
    state = trainer.init_state()
    ces = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(LEARN_STEPS):
        batch = rule_batch(step, 16, 48, "cuda")
        state, metrics = trainer.train_step(state, batch)
        ces.append(metrics["denoising_loss"])
    ces = [c.item() for c in ces]
    seconds = time.perf_counter() - t0
    late = sum(ces[-20:]) / 20
    # the kernels against the unfused chain again, at these trained weights
    cfg = trainer.cfg
    batch = rule_batch(LEARN_STEPS, 16, 48, "cuda")
    corrupted = corrupt_batch(batch, cfg.interpolant, gen)
    names, params = zip(*state.model.named_parameters())
    grads = {}
    for fused in (True, False):
        state.model.fused = fused
        metrics = make_loss_fn(cfg)(state.model, batch, 0,
                                    noisy=(corrupted["S_t"], corrupted["t"]))
        metrics.setdefault("proj_loss", torch.zeros((), device=batch["S"].device))
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads[fused] = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(total, params, allow_unused=True), params)]
    state.model.fused = True
    trained_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                      for a, b in zip(grads[True], grads[False]))
    log(f"[train] after {LEARN_STEPS} steps, kernels vs unfused chain: gradients "
        f"max err / max |g| {trained_err:.3g} (rtol {TRAIN_GRAD_RTOL})")
    if not trained_err <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"trained-state gradients differ: {trained_err}")
    log(f"[train] learning check, gate config (16 x 48, rule data): CE step 0 "
        f"{ces[0]:.4f}, step 100 {ces[100]:.4f}, mean of steps "
        f"{LEARN_STEPS - 20}-{LEARN_STEPS - 1} {late:.4f} (must be < {LEARN_CE_MAX}; "
        f"JAX on a TPU: 1.50, 1.16, 1.17); {1e3 * seconds / LEARN_STEPS:.3f} ms per "
        f"step incl. batch upload ({smi})")
    if not late < LEARN_CE_MAX:
        raise AssertionError(f"the CE did not fall: {ces[0]} -> {late}")
    del trainer, state

    # the user's entry point
    t0 = time.perf_counter()
    state = cli.main(["train-protein", "--steps", "3", "--synthetic", "--log-every", "1"])
    torch.cuda.synchronize()
    log(f"[train] cli train-protein --steps 3 --synthetic: {state.step} steps in "
        f"{time.perf_counter() - t0:.2f} s incl. set-up")
    if state.step != 3:
        raise AssertionError(f"train-protein ran {state.step} steps, not 3")
    return launches[1]


def sit_inputs(batch, gen):
    x = torch.randn((batch, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((batch,), generator=gen, device="cuda")
    y = torch.randint(0, 1001, (batch,), generator=gen, device="cuda")
    return x, t, y


@torch.no_grad()
def slice_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_sit("SiT-XL/2", device="cuda").eval()
    for p in model.parameters():
        p.normal_(0.0, 0.02, generator=gen)
    x, t, y = sit_inputs(MAIN_SHAPE[0], gen)
    for dtype in (torch.float32, torch.bfloat16):
        model.to(dtype)
        model.attn_impl = "auto"
        out = model(x, t, y)[0]
        model.attn_impl = "reference"
        ref = model(x, t, y)[0]
        model.attn_impl = "auto"
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        log(f"[slice] SiT-XL/2 {str(dtype)[6:]} call, kernel vs plain attention: "
            f"max abs err / max |out| = {rel:.3g} (rtol {SIT_RTOL[dtype]}), "
            f"max |out| {ref.abs().max().item():.3g}")
        if not (torch.isfinite(out).all() and rel <= SIT_RTOL[dtype]):
            raise AssertionError(f"SiT-XL/2 {dtype}: rel err {rel}")

    for batch in (GEN["batch_size"], 2 * GEN["batch_size"]):
        xb, tb, yb = sit_inputs(batch, gen)
        sit_call_times(model, xb, tb, yb, "bf16", smi)
    profile(f"SiT-XL/2 bf16 model call at batch {xb.shape[0]}", lambda: model(xb, tb, yb), smi)
    launches = generate_phase(model, torch.bfloat16, smi)

    # the same path in f32 (generate-image --dtype float32): K1 on 3xTF32
    model.float()
    xb, tb, yb = sit_inputs(2 * GEN["batch_size"], gen)
    sit_call_times(model, xb, tb, yb, "f32", smi)
    profile(f"SiT-XL/2 f32 model call at batch {xb.shape[0]}", lambda: model(xb, tb, yb), smi)
    return launches, generate_phase(model, torch.float32, smi)


def sit_call_times(model, x, t, y, label, smi):
    ms = cuda_ms(lambda: model(x, t, y), iters=10, warmup=2, queued=False)
    # few calls: ~450 launches each must fit in the device's launch queue
    device_ms = cuda_ms(lambda: model(x, t, y), iters=2, warmup=2)
    log(f"[slice] SiT-XL/2 {label} model call at batch {x.shape[0]}: {ms:.3f} ms back to "
        f"back, {device_ms:.3f} ms of device time (calls queued ahead) ({smi})")


def generate_phase(model, dtype, smi):
    """The image main path in `dtype`: generate_samples with the launch
    counts set to 0 just before it and read just after, its samples against
    a run with plain attention. Returns K1's launches."""
    calls = 0

    def model_fn(xx, tt, yy):
        nonlocal calls
        calls += 1
        return model(xx, tt, yy)[0]

    cfg = FIDGenConfig(**GEN)
    label = str(dtype)[6:]
    torch.cuda.synchronize()
    fa.launches = fm.launches = 0
    t0 = time.perf_counter()
    samples = generate_samples(model_fn, cfg, device="cuda")
    seconds = time.perf_counter() - t0
    launches = fa.launches
    expect_calls = cfg.num_steps * (cfg.num_samples // cfg.batch_size)
    log(f"[slice] generate_samples {label}: {samples.shape[0]} samples, {calls} model "
        f"calls, {launches} flash_attention launches, {seconds:.3f} s incl. "
        f"first batch ({samples.shape[0] / seconds:.2f} imgs/s, "
        f"{1e3 * seconds / calls:.2f} ms per model call; {smi})")
    if not (samples.shape == (cfg.num_samples, 32, 32, 4)
            and bool(torch.isfinite(torch.from_numpy(samples)).all())):
        raise AssertionError(f"generated samples: shape {samples.shape} or non-finite")
    if calls != expect_calls or launches != DEPTH * calls:
        raise AssertionError(f"expected {expect_calls} model calls and "
                             f"{DEPTH} launches per call, got {calls} and {launches}")

    model.attn_impl = "reference"
    ref = generate_samples(model_fn, cfg, device="cuda")
    model.attn_impl = "auto"
    rel = float(abs(samples - ref).max() / abs(ref).max())
    log(f"[slice] generated latents {label}, kernel vs plain attention: max abs err / "
        f"max |ref| = {rel:.3g} (rtol {GEN_RTOL[dtype]})")
    if not rel <= GEN_RTOL[dtype]:
        raise AssertionError(f"generated latents {label} rel err {rel}")
    return launches


def widths_phase():
    """eval-protein and train-protein at hidden widths the fused message
    kernels refuse (100: not a multiple of 16; 256: above 128): with
    --fused-messages auto (the default) they run the unfused chain, as
    reed_tpu's auto does; with on they raise, naming the cause."""
    for hidden in (100, 256):
        width = ["--set", f"hidden_dim={hidden}"]
        evals = ["eval-protein", "--batch-size", "2", "--length", "64", "--num-steps", "5",
                 *width]
        train = ["train-protein", "--steps", "2", "--synthetic", "--batch-size", "2",
                 "--log-every", "1", "--set", "max_len=64", *width]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(evals)
            state = cli.main(train)
        text = out.getvalue()
        refused = []
        for argv in (evals + ["--fused-messages", "on"], train + ["--set", "fused_messages=on"]):
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(argv)
            except ValueError as e:
                refused.append(str(e))
        ok = ("fused=False" in text and '"sequence_recovery"' in text and state.step == 2
              and not state.model.fused and len(refused) == 2)
        log(f"[widths] hidden {hidden}, fused_messages auto: eval-protein "
            f"{'ran unfused' if 'fused=False' in text else 'did not run unfused'}, "
            f"train-protein {state.step} steps (fused={state.model.fused}, last loss "
            f"{text.split('[step 2]')[-1].strip()[:60]}); on refused {len(refused)} of 2: "
            f"{refused[:1]}")
        if not ok:
            raise AssertionError(f"hidden {hidden}: auto/on did not resolve by width:\n{text}")


def bench_image_config(batch=IMAGE_TRAIN["batch"], dtype="bfloat16", warmup=50_000):
    """bench.py's SiT-XL/2 REED configuration on one card (bench.py:60-83):
    z_dims (768, 3584) at depths 8 (per token) and 16 (pooled), loss
    weights (1.0, 0.5), Adam lr 1e-4 with clip 1.0 and a bf16 first
    moment, proj_coeff 0.5, the denoising weight warmed up over `warmup`
    steps, EMA every 8 steps."""
    return image_train.ImageTrainConfig(
        model="SiT-XL/2", input_size=32, in_channels=4, num_classes=1000,
        encoder_depth=8, encoder_depth_text=16, z_dims=(768, 3584), z_types=("i", "t"),
        projector_dim=2048, compute_dtype=dtype, remat=False,
        batch_size=batch,
        loss=FlowMatchingLossConfig(enc_names=("dinov2", "qwen"), loss_weights=(1.0, 0.5)),
        optim=OptimConfig(lr=1e-4, grad_clip=1.0, mu_dtype="bfloat16"),
        curriculum=CurriculumConfig(proj_coeff=0.5, diffusion_warmup_steps=warmup,
                                    max_steps=1_000_000, ema_every=8))


def image_step_grads(model, cfg, batch, draws, attn_impl, dtype):
    """Metrics (floats), every parameter's gradient and the K1 launches of
    one loss and backward of `model` in `dtype` with `attn_impl`."""
    model.attn_impl, model.compute_dtype = attn_impl, dtype
    before = fa.launches
    metrics = image_train.make_loss_fn(cfg.loss)(model, batch, 0, **draws)
    total, _ = combine_losses(metrics, 0, cfg.curriculum)
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    torch.cuda.synchronize()
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    metrics = {k: v.item() for k, v in dict(metrics, loss=total).items()}
    return metrics, grads, fa.launches - before


def step_errors(a, b, names):
    """(worst metric error, relative above 1; worst gradient error as max
    |a - b| / max |b|, and its parameter) of step a against step b."""
    metric, grad = step_error_maps(a, b, names)
    worst = max(grad, key=grad.get)
    return max(metric.values()), grad[worst], worst


def step_error_maps(a, b, names):
    """({metric: error, relative above 1}, {parameter: max |a - b| / max |b|})
    of step a against step b."""
    (ma, ga), (mb, gb) = a, b
    return ({k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1.0) for k in mb},
            {n: ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
             for n, x, y in zip(names, ga, gb)})


def image_parity_phase(smi):
    """One full-width SiT-XL/2 train step through K1 against the same step
    with plain attention: f32 at batch 8, bf16 at batch 48 (with the plain
    step in f32 as the yardstick of bf16 noise)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for batch_size, dtype in ((8, torch.float32), (IMAGE_TRAIN["batch"], torch.bfloat16)):
        cfg = bench_image_config(batch_size, str(dtype)[6:], warmup=0)
        trainer = image_train.ImageTrainer(cfg, device="cuda")
        model = image_train.build_model(cfg, device="cuda")
        with torch.no_grad():  # nonzero adaLN and final layer: attention reaches the output
            for p in model.parameters():
                p.normal_(0.0, 0.02, generator=gen)
        batch = trainer.synthetic_batch(gen)
        draws = dict(t=torch.rand((batch_size,), generator=gen, device="cuda"),
                     eps=torch.randn(batch["x"].shape, generator=gen, device="cuda"),
                     drop=torch.rand((batch_size,), generator=gen, device="cuda")
                     < cfg.class_dropout_prob)
        names = [n for n, _ in model.named_parameters()]
        m_k, g_k, launches = image_step_grads(model, cfg, batch, draws, "auto", dtype)
        m_r, g_r, _ = image_step_grads(model, cfg, batch, draws, "reference", dtype)
        metric_err, grad_err, worst = step_errors((m_k, g_k), (m_r, g_r), names)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        label = (f"[image] one SiT-XL/2 train step, {str(dtype)[6:]}, batch {batch_size}, "
                 f"K1 vs plain attention: metrics max rel err {metric_err:.3g}, gradients "
                 f"max err / max |g| {grad_err:.3g} at {worst} over {len(names)} "
                 f"parameters; K1 launches {launches}; loss {m_k['loss']:.6g}, denoising "
                 f"{m_k['denoising_loss']:.6g}, proj {m_k['proj_loss']:.6g}")
        if dtype == torch.float32:
            metric_tol, grad_tol = IMAGE_METRIC_RTOL, IMAGE_GRAD_RTOL
            log(f"{label} (rtol {metric_tol}, {grad_tol})")
        else:
            m_32, g_32, _ = image_step_grads(model, cfg, batch, draws, "auto", torch.float32)
            noise_metric, noise_grad, noise_worst = step_errors((m_r, g_r), (m_32, g_32), names)
            k_metric, k_grad, _ = step_errors((m_k, g_k), (m_32, g_32), names)
            metric_tol = IMAGE_BF16_NOISE_FACTOR * noise_metric + 1e-6
            grad_tol = IMAGE_BF16_NOISE_FACTOR * noise_grad
            log(f"{label} (bound {IMAGE_BF16_NOISE_FACTOR} x the plain bf16 step's "
                f"distance from the f32 step: metrics {noise_metric:.3g}, gradients "
                f"{noise_grad:.3g} at {noise_worst}; the K1 bf16 step's distance from "
                f"it: metrics {k_metric:.3g}, gradients {k_grad:.3g})")
            del g_32
        if not (finite and metric_err <= metric_tol and grad_err <= grad_tol):
            raise AssertionError(f"image train step {dtype}: K1 vs plain attention metrics "
                                 f"{m_k} vs {m_r}, worst gradient {worst} {grad_err}")
        if launches != DEPTH:
            raise AssertionError(f"expected {DEPTH} K1 launches in a step, got {launches}")
        del trainer, model, g_k, g_r, batch
        torch.cuda.empty_cache()


def image_train_phase(smi):
    image_parity_phase(smi)

    # the main path: ImageTrainer.train_step at bench.py's configuration
    cfg = bench_image_config()
    trainer = image_train.ImageTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(42))
    n = cfg.batch_size
    torch.cuda.reset_peak_memory_stats()
    for _ in range(IMAGE_TRAIN["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    steps = IMAGE_TRAIN["timed_steps"]
    fa.launches = fm.launches = fm.backward_launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    imgs_per_s = n * steps / seconds
    mfu = imgs_per_s * SIT_XL_TRAIN_FLOPS_PER_IMG / PEAK_FLOPS[torch.bfloat16]
    log(f"[image] ImageTrainer.train_step, bench.py's SiT-XL/2 config (bf16, f32 master "
        f"weights, batch {n}, mu bf16, EMA every 8): {steps} steps in {seconds:.4f} s = "
        f"{1e3 * seconds / steps:.3f} ms per step (wall, after a sync), {imgs_per_s:.2f} "
        f"imgs/s, MFU {mfu:.4f} (bench.py's {SIT_XL_TRAIN_FLOPS_PER_IMG:.4g} flop per "
        f"image over 989 TF/s); K1 launches {launches} (expected {DEPTH * steps}), "
        f"K2a/K2b {fm.launches}/{fm.backward_launches}; peak memory {peak_gb:.2f} GB; last "
        f"loss {metrics['loss'].item():.6g}, denoising {metrics['denoising_loss'].item():.6g}"
        f", grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if launches != DEPTH * steps:
        raise AssertionError(f"expected {DEPTH * steps} K1 launches, got {launches}")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite image train metrics {metrics}")
    if not (state.opt.mu[0].dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in state.model.parameters())
            and all(e.dtype == torch.float32 for e in state.ema.values())):
        raise AssertionError("expected f32 parameters and EMA and a bf16 first moment")
    k = IMAGE_TRAIN["profiled_steps"]  # a whole EMA period

    def k_steps():
        nonlocal state
        for _ in range(k):
            state, _ = trainer.train_step(state, batch)

    prof = profile(f"{k} image train steps (one EMA)", k_steps, smi, top=14)
    busy = prof["busy_ms"] / k
    log(f"[image] per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / (1e3 * seconds / steps)):.1f} % of the unprofiled wall "
        f"({1e3 * seconds / steps:.3f} ms), "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled one "
        f"({prof['wall_ms'] / k:.3f} ms)")
    del trainer, state, batch
    torch.cuda.empty_cache()
    image_learn_launches = image_learning_phase(smi)

    # the user's entry point (reed_tpu's default image config, SiT-B/2)
    t0 = time.perf_counter()
    state = cli.main(["train-image", "--steps", "3", "--synthetic", "--log-every", "1",
                      "--batch-size", "64"])
    torch.cuda.synchronize()
    log(f"[image] cli train-image --steps 3 --synthetic --batch-size 64: {state.step} "
        f"steps in {time.perf_counter() - t0:.2f} s incl. set-up")
    if state.step != 3:
        raise AssertionError(f"train-image ran {state.step} steps, not 3")
    return launches, image_learn_launches


def image_learning_phase(smi):
    """200 steps of the image gate (tools/convergence_image.py, seed 0):
    the denoising loss must fall. Returns K1's launches (f32)."""
    gcfg = convergence_image.gate_config(seed=0)
    trainer = image_train.ImageTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    mu = convergence_image.class_means()
    losses = []
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    for step in range(IMAGE_LEARN_STEPS):
        state, metrics = trainer.train_step(
            state, convergence_image.gate_batch(step, gcfg.batch_size, mu))
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    launches = fa.launches
    depth = len(state.model.blocks)
    late = sum(losses[-20:]) / 20
    log(f"[image] learning check, image gate config (SiT-S/4 f32, batch "
        f"{gcfg.batch_size}, 8 classes): denoising loss step 0 {losses[0]:.4f}, step 100 "
        f"{losses[100]:.4f}, mean of steps {IMAGE_LEARN_STEPS - 20}-{IMAGE_LEARN_STEPS - 1} "
        f"{late:.4f} (must be < {IMAGE_LEARN_LOSS_MAX}; JAX on a TPU: 2.05 at step 0, 0.565 "
        f"at step 200); K1 launches {launches} (expected {depth * IMAGE_LEARN_STEPS}); "
        f"{1e3 * seconds / IMAGE_LEARN_STEPS:.3f} ms per step incl. batch upload ({smi})")
    if not late < IMAGE_LEARN_LOSS_MAX:
        raise AssertionError(f"the image denoising loss did not fall: {losses[0]} -> {late}")
    if launches != depth * IMAGE_LEARN_STEPS:
        raise AssertionError(f"expected {depth * IMAGE_LEARN_STEPS} K1 launches, got "
                             f"{launches}")
    return launches


# -- slice 8: the image domain's eval and inputs, checkpoints ----------------

# frozen f32 networks (SD-VAE, Inception, DINOv2) on the card against the
# port's CPU run of the same weights and inputs: max abs error over max |out|.
# Both are f32 (cuDNN and cuBLAS with TF32 off); they differ by summation
# order and algorithm (~1e-6). One TF32 product is ~5e-4 off, so a network
# on TF32 lands near 1e-3 and fails this.
F32_NET_RTOL = 1e-4
VAE_BATCH = 8
GEN_SUBPROCESS = ["--model", "SiT-XL/2", "--num-samples", "16", "--batch-size", "8",
                  "--num-steps", "8", "--cfg-scale", "4.0", "--guidance-high", "0.5"]
ENC_DATA = dict(samples=96, batch=48, steps=6, profiled_steps=3, model="SiT-XL/2",
                encoder="dinov2-vit-b")
CKPT_IMAGE = dict(model="SiT-B/2", batch=32)  # the XL state is ~9.5 GB a checkpoint
FID_SELF_MAX = 1e-3  # FID(a, a) / tr(Sigma_a): sqrtm of a singular product
# f32 decodes of one latent on two devices round to other uint8 counts only
# where a value sits on a .5 boundary (~0.015 % of values); a 1xTF32 decode
# is ~1e-3 off and moves several % of them
UINT8_SHARE_MAX = 1e-3
# a resumed run whose step is not bitwise repeatable (K2b's atomic adds)
# may differ from the uninterrupted run by at most this many times what a
# second uninterrupted run differs by (~1e-8). A restore that drops the
# moments, the EMA or a random stream moves the weights by ~lr (1e-4).
RESUME_NOISE_FACTOR = 10
# the profiler ranges of the CLI's training loop (cli._run_loop, train_image)
LOOP_RANGES = ("reed::next_batch", "reed::frozen_encoder", "reed::train_step")


@contextlib.contextmanager
def torch_default_tf32():
    """torch's own TF32 defaults (cuDNN on, cuBLAS off) instead of this
    script's (both off), so a check proves that the module turns TF32 off
    itself, as it must in a process a user starts."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def uint8_share(a, b):
    """The share of values of two uint8 images that differ."""
    return (torch.as_tensor(a).cpu() != torch.as_tensor(b).cpu()).double().mean().item()


def rel_err(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    return ((out - ref).abs().max() / ref.abs().max()).item()


# runs cli.main on each command of argv[1] (a JSON list) in turn, printing
# each command's stdout and seconds as one marked JSON line
# runs reed_tpu_torch.cli's main on each JSON list of commands it reads
CLI_WORKER = """
import contextlib, gc, io, json, sys, time, traceback
import torch
from reed_tpu_torch import cli
for line in sys.stdin:
    for args in json.loads(line):
        out, t0 = io.StringIO(), time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main(args)
        except Exception:
            sys.__stdout__.write("@@err " + json.dumps([out.getvalue(), traceback.format_exc()])
                                 + "\\n")
            break
        finally:
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        sys.__stdout__.write("@@cli " + json.dumps([out.getvalue(), time.perf_counter() - t0])
                             + "\\n")
        sys.__stdout__.flush()
    sys.__stdout__.write("@@end\\n")
    sys.__stdout__.flush()
"""
# the CLI process run_clis talks to (started at its first call)
CLI_PROCESS = {}


def stop_cli_process():
    """End the CLI process, if one was started (at exit, whatever the
    outcome)."""
    proc = CLI_PROCESS.pop("proc", None)
    if proc is None:
        return
    proc.stdin.close()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def cli_process():
    """The CLI process (started here if it is not running: main starts it
    after the build, so its imports overlap the first phases)."""
    proc = CLI_PROCESS.get("proc")
    if proc is None or proc.poll() is not None:
        stderr = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen([sys.executable, "-c", CLI_WORKER], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=stderr, text=True)
        CLI_PROCESS.update(proc=proc, stderr=stderr)
    return proc


def run_clis(commands):
    """Each (ARGS, label) of `commands` through reed_tpu_torch.cli's main, in
    order, in the one CLI process every call shares (stopped at exit): one
    interpreter, import and CUDA start-up for all of them (torch's default
    TF32 settings, which no subcommand changes for the next; the CUDA cache
    emptied after each command). Returns each command's stdout; raises on a
    failure."""
    t0 = time.perf_counter()
    labels = [label for _, label in commands]
    proc = cli_process()
    proc.stdin.write(json.dumps([list(args) for args, _ in commands]) + "\n")
    proc.stdin.flush()
    done, error = [], None
    for line in proc.stdout:
        if line.startswith("@@cli "):
            done.append(json.loads(line[6:]))
        elif line.startswith("@@err "):
            error = json.loads(line[6:])
        elif line.startswith("@@end"):
            break
    if error is not None or len(done) != len(commands):
        err = CLI_PROCESS["stderr"]
        err.seek(0)
        raise RuntimeError(f"{labels[len(done)]} (after {labels[:len(done)]}) failed (CLI "
                           f"process exit {proc.poll()}):\n{error}\n{err.read()[-3000:]}")
    log(f"[eval] the CLI process, {len(commands)} commands: "
        f"{time.perf_counter() - t0:.1f} s (" + "; ".join(
            f"{label} {seconds:.1f} s" for label, (_, seconds) in zip(labels, done)) + ")")
    return [text for text, _ in done]


def cli_quiet(args):
    """cli.main(ARGS) in this process, its output kept; returns (result,
    stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = cli.main(args)
    return result, out.getvalue()


def net_check(label, model, x, rtol=F32_NET_RTOL, cpu_rows=1, **kw):
    """`model` on the card against a CPU copy on the first `cpu_rows` rows."""
    with torch.no_grad():
        out = model(x, **kw)
        ref = copy.deepcopy(model).cpu()(x[:cpu_rows].cpu(), **kw)
    err = rel_err(out[:cpu_rows], ref)
    log(f"[eval] {label}, card vs CPU (f32): max abs err / max |out| = {err:.3g} "
        f"(rtol {rtol}), max |out| {ref.abs().max().item():.4g}")
    if not (torch.isfinite(out).all() and err <= rtol):
        raise AssertionError(f"{label}: card vs CPU rel err {err}")
    return out


def net_times(label, fn, n, smi):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fn, iters=5, warmup=1, queued=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[eval] {label}: {ms:.3f} ms a batch of {n}, {ms / n:.3f} ms an image, "
        f"{1e3 * n / ms:.1f} imgs/s; peak memory {peak:.2f} GB ({smi})")
    return ms


def vae_phase(tmp, smi):
    """SD-VAE at full width (base 128, ch_mult (1, 2, 4, 4)), seeded, f32:
    decoder [8,32,32,4] -> [8,256,256,3] and encoder [8,256,256,3] ->
    [8,32,32,8] on the card against the CPU; the decoder also with TF32
    forced on, to show what the tolerance catches. Writes the decoder in
    tools/convert_vae.py's npz layout for generate-image."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    decoder = seeded_weights.vae_decoder(0).cuda()
    encoder = seeded_weights.vae_encoder(0).cuda()
    z = torch.randn((VAE_BATCH, 32, 32, 4), generator=gen, device="cuda")
    pixels = torch.rand((VAE_BATCH, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    with torch_default_tf32():
        out = net_check("VAEDecoder [8,32,32,4] -> [8,256,256,3]", decoder, z)
        with torch.no_grad():
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = decoder.decoder(decoder.post_quant_conv(z.permute(0, 3, 1, 2)))
        tf32 = tf32.permute(0, 2, 3, 1)
        log(f"[eval] VAEDecoder with TF32 forced on (bypassing the module's full-f32 "
            f"guard): {rel_err(tf32[:1], out[:1]):.3g} off the f32 decode; as uint8, "
            f"{100 * uint8_share(to_uint8(tf32), to_uint8(out)):.3f} % of values differ "
            f"(bound {100 * UINT8_SHARE_MAX} %)")
    with torch_default_tf32():
        net_check("VAEEncoder [8,256,256,3] -> [8,32,32,8]", encoder, pixels)
    with torch.no_grad():
        net_times("SD-VAE decode, f32", lambda: decoder(z), VAE_BATCH, smi)
        net_times("SD-VAE encode, f32", lambda: encoder(pixels), VAE_BATCH, smi)
    path = seeded_weights.save(decoder.cpu(), f"{tmp}/vae_decoder.npz")
    del decoder, encoder
    torch.cuda.empty_cache()
    return path


def generate_subprocess_phase(tmp, vae_npz, smi):
    """generate-image --vae as a user runs it (a subprocess): uint8
    [16,256,256,3], K1 28 times a model call. The same run without --vae,
    in this process, warns and writes its latents; their CPU decode gives
    the subprocess's pixels to one count, and that only on .5 boundaries
    (the subprocess decoded in full f32). A second sample set (seed 1) for
    compute-fid, in this process."""
    pixels_path, latents_path, other = (f"{tmp}/gen_{n}.npz"
                                        for n in ("pixels", "latents", "seed1"))
    (text,) = run_clis([(["generate-image", *GEN_SUBPROCESS, "--vae", vae_npz, "--out",
                          pixels_path], f"generate-image {' '.join(GEN_SUBPROCESS)} --vae")])
    _, latents_text = cli_quiet(["generate-image", *GEN_SUBPROCESS, "--out", latents_path])
    cli_quiet(["generate-image", *GEN_SUBPROCESS, "--vae", vae_npz, "--seed", "1",
               "--out", other])
    pixels = np.load(pixels_path)["arr_0"]
    latents = np.load(latents_path)["arr_0"]
    launches, calls = map(int, re.search(r"flash_attention launches: (\d+) in (\d+) model",
                                         text).groups())
    without = float(re.search(r"\(([\d.]+) imgs/sec without", text).group(1))
    decode_ms = float(re.search(r"decode: ([\d.]+) ms per image", text).group(1))
    with_decode = float(re.search(r"([\d.]+) imgs/sec with the decode", text).group(1))
    decoder = vae_load_cpu(vae_npz)
    with torch.no_grad():
        cpu_pixels = to_uint8(decoder(torch.from_numpy(latents[:1]))).numpy()
    diff = np.abs(pixels[:1].astype(int) - cpu_pixels.astype(int))
    share = uint8_share(pixels[:1], cpu_pixels)
    log(f"[eval] generate-image --vae (subprocess): {pixels.shape} {pixels.dtype}; "
        f"flash_attention launches {launches} in {calls} model calls; {without:.2f} "
        f"imgs/s without the decode, decode {decode_ms:.3f} ms an image, {with_decode:.2f} "
        f"imgs/s with it (batches after the first; {smi}); image 0 against the CPU "
        f"decode of the latents run's image 0: max |diff| {diff.max()} counts, "
        f"{100 * share:.4f} % of values differ (bound {100 * UINT8_SHARE_MAX} %)")
    if pixels.shape != (16, 256, 256, 3) or pixels.dtype != np.uint8:
        raise AssertionError(f"generate-image --vae wrote {pixels.shape} {pixels.dtype}")
    if latents.shape != (16, 32, 32, 4) or "WARNING: no --vae" not in latents_text:
        raise AssertionError(f"generate-image without --vae wrote {latents.shape} "
                             "or did not warn")
    if calls != 16 or launches != DEPTH * calls:
        raise AssertionError(f"expected {DEPTH} K1 launches in each of 16 model calls, "
                             f"got {launches} in {calls}")
    if diff.max() > 1 or share > UINT8_SHARE_MAX:
        raise AssertionError(f"generate-image --vae pixels differ from the CPU decode "
                             f"by up to {diff.max()} counts in {100 * share:.4f} % of values")
    return pixels_path, other, launches


def vae_load_cpu(path):
    from reed_tpu_torch.encoders.vae import load_npz

    return load_npz(path).eval()


def fid_phase(tmp, gen_a, gen_b, smi):
    """compute-fid as a user runs it (a subprocess), on seeded Inception
    weights in save_variables_npz's layout: FID(a, b) finite, and the
    stats it saves for a equal to this process's at the f32 tolerance (the
    subprocess ran Inception in full f32). FID(a, a) of this process's
    stats, ~0 relative to tr(Sigma_a). (That the printed FID is
    frechet_distance of the saved stats is a CPU test.) In-process:
    features of two images on the card against the CPU, and ms an image."""
    model = seeded_weights.inception_v3(0)
    inc_npz = seeded_weights.save(model, f"{tmp}/inception.npz")
    model = model.cuda()
    images_a = np.load(gen_a)["arr_0"]
    images = torch.from_numpy(images_a).cuda()
    with torch_default_tf32():
        net_check("InceptionV3Pool3 features of 2 generated images", model,
                  preprocess_uint8(images[:2]), cpu_rows=2)
    x = preprocess_uint8(images)
    with torch.no_grad():
        net_times("InceptionV3 pool3 at 299, f32", lambda: model(x), len(images), smi)
    stats = compute_activation_stats(images_a, make_feature_fn(model), batch_size=16)
    del model, images, x
    torch.cuda.empty_cache()
    self_fid = {}

    def fid_self():  # on the host, beside the subprocess
        t0 = time.perf_counter()
        self_fid["fid"] = frechet_distance(stats["mu"], stats["sigma"], stats["mu"],
                                           stats["sigma"])
        self_fid["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=fid_self)
    thread.start()
    try:
        (text,) = run_clis([(["compute-fid", gen_a, gen_b, "--inception-npz", inc_npz,
                              "--batch-size", "16", "--save-stats"],
                             "compute-fid a b --save-stats")])
    finally:
        thread.join()
    self_fid, sqrtm_s = self_fid["fid"], self_fid["s"]
    fid = json.loads(text.strip().splitlines()[-1])["fid"]
    saved = np.load(gen_a.replace(".npz", "_stats.npz"))
    mu_err = rel_err(torch.from_numpy(saved["mu"]), torch.from_numpy(stats["mu"]))
    self_rel = abs(self_fid) / float(np.trace(stats["sigma"]))
    log(f"[eval] compute-fid (subprocess, seeded Inception): FID(a, b) = {fid!r}; its saved "
        f"mu of a against this process's: {mu_err:.3g} of the max (rtol {F32_NET_RTOL}); "
        f"FID(a, a) = {self_fid!r}, / tr(Sigma_a) = {self_rel:.3g} (< {FID_SELF_MAX}), "
        f"{sqrtm_s:.2f} s on the host (the sqrtm of 2048 x 2048, in a thread beside the "
        f"subprocess)")
    if not (np.isfinite(fid) and fid > 0 and mu_err <= F32_NET_RTOL
            and self_rel < FID_SELF_MAX):
        raise AssertionError(f"compute-fid: FID(a, b) {fid}, mu {mu_err}; FID(a, a) {self_fid}")


def write_image_data(root, n, seed=0):
    """A cached-latent dataset as data/image.py reads it: dataset.json,
    vae-sd/ moments [8, 32, 32] and pixels/ uint8 crops [256, 256, 3]."""
    rng = np.random.default_rng(seed)
    for sub in ("vae-sd", "pixels"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    labels = []
    for i in range(n):
        np.save(f"{root}/vae-sd/img{i:05d}.npy",
                rng.standard_normal((8, 32, 32)).astype(np.float32))
        np.save(f"{root}/pixels/img{i:05d}.npy",
                rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
        labels.append([f"img{i:05d}.png", int(i % 1000)])
    with open(f"{root}/dataset.json", "w") as f:
        json.dump({"labels": labels}, f)


def loop_split(args, smi):
    """The CLI's training loop under torch.profiler, over the steps after
    the first: a step's host ms in each of the loop's ranges (LOOP_RANGES;
    the batch reading is next_batch outside the encoder), the device ms of
    the encoder's kernels and of all kernels, and the device's idle ms
    (the trace's wall from the second fetch to the last kernel's end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli_quiet(args)
        torch.cuda.synchronize()
    events = prof.events()
    seconds = time.perf_counter() - t0
    ranges = {k: sorted((e for e in events if e.name == k and e.device_type == DeviceType.CPU),
                        key=lambda e: e.time_range.start)[1:] for k in LOOP_RANGES}
    n = len(ranges["reed::train_step"])
    start = ranges["reed::next_batch"][0].time_range.start
    # the backward's kernels are launched from autograd's own thread, outside
    # the loop's ranges: count every kernel that starts after `start`
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.time_range.start >= start]
    wall = (max(e.time_range.end for e in kernels) - start) / 1e3 / n
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    host = {k: sum(e.time_range.elapsed_us() for e in v) / 1e3 / n for k, v in ranges.items()}
    enc = sum(e.device_time_total for e in ranges["reed::frozen_encoder"]) / 1e3 / n
    log(f"[image] the same CLI run profiled, per step over its steps 2-{n + 1}: wall "
        f"{wall:.3f} ms; host: batch reading (next_batch outside the encoder) "
        f"{host['reed::next_batch'] - host['reed::frozen_encoder']:.3f} ms, encoder "
        f"{host['reed::frozen_encoder']:.3f} ms, step {host['reed::train_step']:.3f} ms "
        f"(each upload of a pageable batch waits for the device); device: encoder "
        f"{enc:.3f} ms, all kernels {busy:.3f} ms, idle {wall - busy:.3f} ms "
        f"({100 * (1 - busy / wall):.1f} %); the run and its trace took {seconds:.1f} s ({smi})")


def encoder_train_phase(tmp, smi):
    """train-image --enc-type dinov2-vit-b on a fabricated data directory:
    the frozen DINOv2-B/14 targets computed in the loop from the pixel
    crops. DINOv2 on the card against the CPU; ms a step with the encoder
    (the CLI's rate) and without it (the same step on synthetic targets),
    the encoder alone, the CLI's loop profiled (reading, encoder, step), K1
    launches (28 a step)."""
    data, enc_dir = f"{tmp}/image_data", f"{tmp}/encoders"
    os.makedirs(enc_dir, exist_ok=True)
    write_image_data(data, ENC_DATA["samples"])
    name = ENC_DATA["encoder"]
    z_dim = registry.vit_config(name).hidden_size
    seeded_weights.save(seeded_weights.vit_encoder(registry.vit_config(name), 0),
                        f"{enc_dir}/{name}.npz")
    (enc,), _, _ = registry.load_encoders(name, encoder_dir=enc_dir, device="cuda")
    raw = torch.from_numpy(np.stack([np.load(f"{data}/pixels/img{i:05d}.npy")
                                     for i in range(ENC_DATA["batch"])])).cuda()
    with torch_default_tf32():
        feats = net_check(f"{name} patch features of 2 crops", enc.model,
                          enc.preprocess(raw[:2]), cpu_rows=2)
    if feats.shape[:2] != (2, 256):
        raise AssertionError(f"{name} features {tuple(feats.shape)}")
    enc_ms = net_times(f"{name} encode (preprocess + f32 forward) at batch "
                       f"{ENC_DATA['batch']}", lambda: enc.encode(raw), ENC_DATA["batch"], smi)
    del enc
    torch.cuda.empty_cache()

    args = ["train-image", "--model", ENC_DATA["model"], "--batch-size", str(ENC_DATA["batch"]),
            "--enc-type", name, "--encoder-dir", enc_dir, "--data-dir", data,
            "--log-every", "3", "--set", f"z_dims=[{z_dim}]"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    state, text = cli_quiet(args + ["--steps", str(ENC_DATA["steps"])])
    torch.cuda.synchronize()
    launches, peak = fa.launches, torch.cuda.max_memory_allocated() / 1e9
    steps_s = float(re.search(r"([\d.]+) steps/s", text).group(1))
    imgs_s = float(re.search(r"([\d.]+) imgs/s", text).group(1))
    proj = float(re.search(r"'proj_loss': (-?[\d.e-]+)",
                           text.split(f"[step {ENC_DATA['steps']}]")[-1]).group(1))
    cfg = state.opt.cfg
    del state
    torch.cuda.empty_cache()
    loop_split(args + ["--steps", str(ENC_DATA["profiled_steps"])], smi)
    torch.cuda.empty_cache()

    # the same step without the encoder: synthetic targets of the same shape
    icfg = configlib.apply_overrides(image_train.ImageTrainConfig(
        model=ENC_DATA["model"], batch_size=ENC_DATA["batch"]), [f"z_dims=[{z_dim}]"])
    trainer = image_train.ImageTrainer(icfg, device="cuda")
    st = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(3))
    for _ in range(2):
        st, _ = trainer.train_step(st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        st, _ = trainer.train_step(st, batch)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 5
    del trainer, st, batch
    torch.cuda.empty_cache()
    mfu = imgs_s * SIT_XL_TRAIN_FLOPS_PER_IMG / PEAK_FLOPS[torch.bfloat16]
    log(f"[image] cli {' '.join(args)} --steps {ENC_DATA['steps']} (default config: one "
        f"DINOv2 target, Adam lr {cfg.lr}, EMA every step): {1e3 / steps_s:.3f} ms a step "
        f"with the in-loop encoder (the CLI's rate over steps 2-{ENC_DATA['steps']}, data "
        f"loading included), {imgs_s:.2f} imgs/s, MFU {mfu:.4f} (bench.py's flops; the "
        f"encoder's not counted); the same step on synthetic targets {plain_ms:.3f} ms "
        f"({1e3 * ENC_DATA['batch'] / plain_ms:.2f} imgs/s); the encoder alone "
        f"{enc_ms:.3f} ms a batch; K1 launches {launches} (expected "
        f"{DEPTH * ENC_DATA['steps']}); peak memory {peak:.2f} GB; last proj_loss "
        f"{proj:.5g} ({smi})")
    if launches != DEPTH * ENC_DATA["steps"]:
        raise AssertionError(f"expected {DEPTH * ENC_DATA['steps']} K1 launches, got "
                             f"{launches}")
    if not (np.isfinite(proj) and proj != 0.0):
        raise AssertionError(f"the DINOv2 targets did not reach the loss: proj {proj}")
    return launches


def state_tensors(state):
    """Every tensor of a TrainState by name: parameters, EMA, moments."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    out.update({f"ema {n}": t for n, t in state.ema.items()})
    names = [n for n, _ in state.model.named_parameters()]
    out.update({f"mu {n}": t for n, t in zip(names, state.opt.mu)})
    out.update({f"nu {n}": t for n, t in zip(names, state.opt.nu)})
    return out


def state_difference(a, b):
    """(the first tensor of two states that is not bitwise equal, the max
    |a - b| over all tensors), or None where every tensor is equal."""
    ta, tb = state_tensors(a), state_tensors(b)
    first, worst = None, 0.0
    for name in ta:
        if not torch.equal(ta[name], tb[name]):
            first = first or name
            worst = max(worst, (ta[name].float() - tb[name].float()).abs().max().item())
    return None if first is None else (first, worst)


def describe(diff):
    return ("bitwise equal" if diff is None
            else f"first difference {diff[0]}, max over all {diff[1]:.3g}")


def within_noise(diff, det):
    """A resumed run is right if it is bitwise equal to the uninterrupted
    one where a repeated run is, else within RESUME_NOISE_FACTOR times the
    repeated run's difference."""
    if det is None:
        return diff is None
    return diff is None or diff[1] <= RESUME_NOISE_FACTOR * det[1]


def resume_check(label, make_trainer, batches, tmp, control=False):
    """An uninterrupted 4-step run against 2 steps, a checkpoint, a restore
    into a fresh trainer and the same last 2 batches; and against a second
    uninterrupted run (is the step itself deterministic?). With `control`,
    also a restore that leaves the fresh trainer's generator as it was,
    which the check must catch."""
    def run(trainer, state, bs):
        for b in bs:
            state, _ = trainer.train_step(state, b)
        return state

    ta = make_trainer()
    full = run(ta, ta.init_state(), batches)
    tb = make_trainer()
    half = run(tb, tb.init_state(), batches[:2])
    mgr = CheckpointManager(f"{tmp}/{label}_resume")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(half, tb.generator)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(mgr.path(2))
    del tb, half
    tc = make_trainer()
    resumed = tc.init_state()
    t0 = time.perf_counter()
    mgr.restore(resumed, tc.generator)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed = run(tc, resumed, batches[2:])
    diff = state_difference(resumed, full)
    td = make_trainer()
    det = state_difference(run(td, td.init_state(), batches), full)
    log(f"[ckpt] {label}: checkpoint at step 2 {nbytes / 1e9:.3f} GB, save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s; resumed run after 4 steps vs "
        f"uninterrupted: {describe(diff)} over {len(state_tensors(full))} tensors "
        f"(params, EMA, mu, nu); a second uninterrupted run: {describe(det)}")
    if not within_noise(diff, det):
        raise AssertionError(f"{label}: the resumed run differs ({describe(diff)}) by more "
                             f"than {RESUME_NOISE_FACTOR}x a repeated run ({describe(det)})")
    if control:
        te = make_trainer()
        skipped = mgr.restore(te.init_state())
        skipped = state_difference(run(te, skipped, batches[2:]), full)
        log(f"[ckpt] {label}, control: a restore without the trainer's generator state: "
            f"{describe(skipped)}, {'caught' if not within_noise(skipped, det) else 'MISSED'}"
            f" (bound {RESUME_NOISE_FACTOR}x the repeated run's difference)")
        if within_noise(skipped, det):
            raise AssertionError(f"{label}: the resume check misses a dropped generator")
    return diff, det


def checkpoint_phase(tmp, smi):
    """--ckpt-every/--ckpt-dir through train-image and train-protein; then
    in-process resumes held against uninterrupted runs (SiT-B/2: the XL
    state is ~9.5 GB a checkpoint; the protein default, the SemlaFlow
    gate's width and the EDM molecule default, each with its control); and
    generate-image --ckpt-dir from the image run's EMA."""
    img_dir, prot_dir = f"{tmp}/ckpt_image", f"{tmp}/ckpt_protein"
    cli_quiet(["train-image", "--model", CKPT_IMAGE["model"], "--steps", "4",
               "--ckpt-every", "2", "--ckpt-dir", img_dir, "--synthetic",
               "--batch-size", str(CKPT_IMAGE["batch"]), "--log-every", "2"])
    cli_quiet(["train-protein", "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
               prot_dir, "--synthetic", "--log-every", "2"])
    for d in (img_dir, prot_dir):
        files = sorted(os.listdir(d))
        log(f"[ckpt] cli --ckpt-dir {os.path.basename(d)} --ckpt-every 2 --steps 4: {files}")
        if not {"2.pt", "4.pt", "config.json", "metrics.jsonl"} <= set(files):
            raise AssertionError(f"{d}: {files}")

    icfg = image_train.ImageTrainConfig(model=CKPT_IMAGE["model"],
                                        batch_size=CKPT_IMAGE["batch"])
    make = lambda: image_train.ImageTrainer(icfg, device="cuda")  # noqa: E731
    probe = make()
    batches = [probe.synthetic_batch(torch.Generator(device="cuda").manual_seed(50 + i))
               for i in range(4)]
    del probe
    image = resume_check(f"{CKPT_IMAGE['model']} image", make, batches, tmp)
    torch.cuda.empty_cache()
    pcfg = ProteinTrainConfig()
    make = lambda: ProteinTrainer(pcfg, device="cuda")  # noqa: E731
    probe = make()
    batches = [probe.synthetic_batch(torch.Generator(device="cuda").manual_seed(60 + i))
               for i in range(4)]
    del probe
    protein = resume_check("ProteinMPNN-FMIF protein", make, batches, tmp, control=True)
    torch.cuda.empty_cache()
    # SemlaFlow at the gate's width; the control's restore leaves the
    # self-conditioning coins at their start (the seed's coins are T F F T)
    gcfg = convergence_semla.gate_config()
    data = convergence_semla.GateData()
    make = lambda: semla_train.SemlaTrainer(gcfg, device="cuda")  # noqa: E731
    batches = [semla_train.batch_to_device(data.batch(70 + i), "cuda") for i in range(4)]
    semla = resume_check("SemlaFlow gate", make, batches, tmp, control=True)
    torch.cuda.empty_cache()
    # the EDM molecule model at full width; the control's restore leaves the
    # training draws (t, eps, rep dropout) at their start
    ecfg = edm_train.MoleculeEDMConfig()
    make = lambda: edm_train.MoleculeEDMTrainer(ecfg, device="cuda")  # noqa: E731
    probe = make()
    batches = [probe.synthetic_batch(torch.Generator(device="cuda").manual_seed(80 + i))
               for i in range(4)]
    del probe
    edm = resume_check("EDM molecule", make, batches, tmp, control=True)
    torch.cuda.empty_cache()

    gen = ["generate-image", "--model", CKPT_IMAGE["model"], "--num-samples", "4",
           "--batch-size", "4", "--num-steps", "4", "--mode", "ode"]
    _, text = cli_quiet(gen + ["--ckpt-dir", img_dir, "--out", f"{tmp}/ckpt_gen.npz"])
    cli_quiet(gen + ["--out", f"{tmp}/init_gen.npz"])
    a, b = (np.load(f"{tmp}/{n}.npz")["arr_0"] for n in ("ckpt_gen", "init_gen"))
    loaded = "loaded EMA weights of step 4" in text
    log(f"[ckpt] generate-image --ckpt-dir ({CKPT_IMAGE['model']}, EMA of step 4): {a.shape}, "
        f"{'loaded the EMA' if loaded else 'did not load the EMA'}; max |diff| to the "
        f"same run from the initial weights {np.abs(a - b).max():.3g}")
    if not (loaded and np.isfinite(a).all() and a.shape == (4, 32, 32, 4)):
        raise AssertionError("generate-image --ckpt-dir")
    return image, protein, semla, edm


def eval_phases(smi):
    """Slice 8's phases, in a temporary directory removed after them."""
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(tmp, *args, smi)
        log(f"[eval] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        vae_npz = timed(vae_phase)
        gen_a, gen_b, gen_launches = timed(generate_subprocess_phase, vae_npz)
        timed(fid_phase, gen_a, gen_b)
        enc_launches = timed(encoder_train_phase)
        timed(checkpoint_phase)
    return gen_launches, enc_launches


# -- slice 9: SemlaFlow molecules (train-molecule-semla, eval-semla) -------

RECIPE_SEMLA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes",
                            "molecule_semla_reed.json")
# tools/bench_domains.py's GEOM-Drugs scale: batch 56 (batch_cost 4096 / 72),
# molecules of 36-72 atoms padded to 72
SEMLA = dict(batch=56, atoms=72, warmup_steps=2, timed_steps=20, profiled_steps=4,
             cpu_rows=8)
SEMLA_FWD_RTOL = 1e-4    # card vs CPU, f32 with TF32 off
# cut from 200 (PR 23): at step 100 the f32 gate read 0.582 and the bf16
# one 0.241 against starts of 6.10 and 7.16 (H100 80GB HBM3, 700.00 W)
SEMLA_LEARN_STEPS = 100
SEMLA_LEARN_LOSS_MAX = 1.0
SEMLA_EVAL = dict(n_samples=16, num_steps=10)  # eval-semla, cut from 100 steps


def semla_full_config(**kw):
    """recipes/molecule_semla_reed.json at the GEOM scale (max_atoms 72, batch
    56), the denoising loss on from step 0."""
    cfg = configlib.merge(configlib.build(semla_train.SemlaTrainConfig),
                          configlib.load_file(RECIPE_SEMLA))
    return configlib.merge(cfg, dict(dict(max_atoms=SEMLA["atoms"], batch_size=SEMLA["batch"],
                                          diffusion_loss_max_step=0), **kw))


# the scale of the coordinate-update projections (node_ff's and coord_attn's
# attn_proj) in the checked weights: at the init's scale the coordinate sets
# grow to ~400 over 12 layers, the unnormalised gram features saturate the
# attention softmax and f32 itself lands 2-7 % from f64 (on the CPU); at 0.1
# the f32 forward is within ~1e-5 of f64, so 1e-4 between card and CPU is a
# bound on the port and not on the conditioning. Both are reported.
SEMLA_COORD_UPDATE_SCALE = 0.1


def seeded_semla(cfg, seed=5, coord_update_scale=SEMLA_COORD_UPDATE_SCALE):
    """The model of `cfg` with its initialisation moved by N(0, 0.02), so that
    no bias or norm sits at its init value, and the coordinate-update
    projections scaled by `coord_update_scale`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = semla_train.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
            if name.endswith("attn_proj.weight"):
                p.mul_(coord_update_scale)
    return model


def semla_card_vs_cpu(model, cfg, batch, rows):
    """(card outputs, {output: card vs CPU f32 rel err}, {output: CPU f32 vs
    f64 rel err}, card ms, CPU ms) of one forward with the
    self-conditioning inputs of a first pass; the CPU runs the first rows."""
    state, rep, times = batch["interpolated"], batch["rep"], batch["times"]
    with torch.no_grad():
        zero = semla_train._zero_cond(state)
        c, tl, bl, _, _ = semla_train._apply(model, cfg, state, times, zero, rep)
        cond = {"coords": c, "atomics": torch.softmax(tl, -1), "bonds": torch.softmax(bl, -1)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = semla_train._apply(model, cfg, state, times, cond, rep)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu = copy.deepcopy(model).cpu()
        sub = lambda d, dt: {k: v[:rows].cpu().to(dt) for k, v in d.items()}  # noqa: E731
        t0 = time.perf_counter()
        ref = semla_train._apply(cpu, cfg, sub(state, torch.float32), times[:rows].cpu(),
                                 sub(cond, torch.float32), rep[:rows].cpu())
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        ref64 = semla_train._apply(cpu.double(), cfg, sub(state, torch.float64),
                                   times[:rows].cpu().double(), sub(cond, torch.float64),
                                   rep[:rows].cpu().double())
    names = ["coords", "type_logits", "bond_logits", "charge_logits"]
    pairs = list(zip(out[:4], ref[:4], ref64[:4])) + list(zip(out[4], ref[4], ref64[4]))
    names += [f"zs[{i}]" for i in range(len(out[4]))]
    errs = {n: rel_err(a[:rows], b) for n, (a, b, _) in zip(names, pairs)}
    errs64 = {n: rel_err(b, c) for n, (_, b, c) in zip(names, pairs)}
    return out, errs, errs64, card_ms, cpu_ms


def semla_forward_phase(smi):
    """The recipe's full-width SemlaGenerator on the card against its CPU
    copy, on the first rows of a GEOM-scale batch; f32 on the CPU against
    f64 beside it, at the checked weights and at the init's scale."""
    cfg = semla_full_config()
    batch = semla_train.batch_to_device(
        semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=7), "cuda")
    rows = SEMLA["cpu_rows"]
    fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())  # noqa: E731
    _, errs, errs64, _, _ = semla_card_vs_cpu(seeded_semla(cfg, coord_update_scale=1.0),
                                              cfg, batch, rows)
    log(f"[semla] at the init's scale (coordinate-update projections x1; reported, not "
        f"bounded): card vs CPU {fmt(errs)}; CPU f32 vs f64 {fmt(errs64)}")
    model = seeded_semla(cfg).eval()
    out, errs, errs64, card_ms, cpu_ms = semla_card_vs_cpu(model, cfg, batch, rows)
    pad = batch["interpolated"]["mask"] == 0
    log(f"[semla] full-width forward (recipe: d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_coord_sets} sets, {cfg.n_attn_heads} heads, d_message {cfg.d_message}, d_edge "
        f"{cfg.d_edge}, d_rep {cfg.d_rep}, REPA at {tuple(cfg.align_depth)}; batch "
        f"{SEMLA['batch']} x {SEMLA['atoms']} atoms, {int(pad.sum())} padded; coordinate-"
        f"update projections x{SEMLA_COORD_UPDATE_SCALE}) card vs CPU on {rows} rows: max abs "
        f"err / max |out| {fmt(errs)} (rtol {SEMLA_FWD_RTOL}); CPU f32 vs f64 {fmt(errs64)}; "
        f"padded coords max |x| {out[0][pad].abs().max().item():.3g}; card {card_ms:.1f} ms, "
        f"CPU {cpu_ms:.0f} ms for {rows} rows ({smi})")
    if not (len(out[4]) == 1 and all(v <= SEMLA_FWD_RTOL for v in errs.values())
            and all(torch.isfinite(t).all() for t in out[:4]) and (out[0][pad] == 0).all()):
        raise AssertionError(f"SemlaGenerator card vs CPU: {errs}")


def semla_host_batch_phase(cfg):
    """The host's batch building on its own: the GEOM-scale example batch and
    the gate's batch (prior, Kabsch / Hungarian OT match per molecule,
    interpolation)."""
    data = convergence_semla.GateData()
    data.batch(0)
    semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=0)
    times = {}
    for label, fn in ((f"example_batch {SEMLA['batch']} x {SEMLA['atoms']}",
                       lambda i: semla_train.example_batch(cfg, SEMLA["batch"],
                                                           SEMLA["atoms"], seed=i)),
                      ("gate batch 128 chains", data.batch)):
        t0 = time.perf_counter()
        for i in range(10):
            fn(i)
        times[label] = 1e3 * (time.perf_counter() - t0) / 10
    log("[semla] host batch (numpy: prior, one OT match a molecule, interpolation), ms "
        "a batch: " + "; ".join(f"{k} {v:.2f}" for k, v in times.items()))
    return times


def semla_train_phase(smi):
    """The main path: SemlaTrainer.train_step at the recipe's width on the
    GEOM-scale batch; ms a step (wall and device), molecules/s, launches,
    idle share, peak memory, a profile by kernel family and range."""
    cfg = semla_full_config()
    host = semla_host_batch_phase(cfg)
    trainer = semla_train.SemlaTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = semla_train.batch_to_device(
        semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=1), "cuda")
    n, steps = SEMLA["batch"], SEMLA["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SEMLA["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernel_launches = (fa.launches, fm.launches, fm.backward_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms = 1e3 * seconds / steps
    log(f"[semla] SemlaTrainer.train_step, recipe width, f32, batch {n} x {SEMLA['atoms']}: "
        f"{steps} steps {wall_ms:.3f} ms per step (wall, after a sync), "
        f"{start.elapsed_time(end) / steps:.3f} ms (CUDA events), {n * steps / seconds:.2f} "
        f"molecules/s; peak memory {peak_gb:.2f} GB; K1/K2a/K2b launches {kernel_launches}; "
        f"last loss {metrics['loss'].item():.6g}, proj {metrics['proj_loss'].item():.4g}, "
        f"grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite Semla train metrics {metrics}")
    if any(kernel_launches):
        raise AssertionError(f"a TPU-kernel port ran on the Semla path: {kernel_launches}")
    k = SEMLA["profiled_steps"]

    def k_steps():
        nonlocal state
        for i in range(k):  # both self-conditioning branches, in turn
            state, _ = trainer.train_step(state, batch, use_sc=bool(i % 2))

    prof = profile(f"{k} Semla train steps (self-conditioning on 2 of them)", k_steps, smi,
                   top=14)
    busy = prof["busy_ms"] / k
    log(f"[semla] per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall ({wall_ms:.3f} ms), "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled one")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, mol_s=n * steps / seconds, peak_gb=peak_gb,
                busy_ms=busy, launches=prof["launches"] / k, host=host)


def semla_learning_phase(smi):
    """SEMLA_LEARN_STEPS of the Semla gate (seed 0, its data and
    configuration): the mean denoising loss of the last 20 must fall below
    1.0."""
    gcfg = convergence_semla.gate_config(seed=0)
    data = convergence_semla.GateData()
    trainer = semla_train.SemlaTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in convergence_semla.gate_batches(data, SEMLA_LEARN_STEPS,
                                                torch.device("cuda")):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    late = sum(losses[-20:]) / 20
    batch = semla_train.batch_to_device(data.batch(0), "cuda")

    def steps4():
        nonlocal state
        for i in range(4):
            state, _ = trainer.train_step(state, batch, use_sc=bool(i % 2))

    prof = profile("4 Semla gate steps (one batch, self-conditioning on 2)", steps4, smi,
                   top=6)
    log(f"[semla] gate step: device {prof['busy_ms'] / 4:.3f} ms, {prof['launches'] / 4:.0f} "
        f"launches, wall {prof['wall_ms'] / 4:.3f} ms (profiled, batch resident)")
    log(f"[semla] learning check, Semla gate config (d_model {gcfg.d_model}, "
        f"{gcfg.n_layers} layers, batch {gcfg.batch_size} chains, adaLN reps): denoising "
        f"loss step 0 {losses[0]:.4f}, step {len(losses) // 2} "
        f"{losses[len(losses) // 2]:.4f}, mean of steps "
        f"{SEMLA_LEARN_STEPS - 20}-{SEMLA_LEARN_STEPS - 1} {late:.4f} (must be < "
        f"{SEMLA_LEARN_LOSS_MAX}; JAX on a TPU: 5.74 at step 0, 0.709 at step 200); "
        f"{1e3 * seconds / SEMLA_LEARN_STEPS:.3f} ms per step, the host batches built by a "
        f"DataLoader worker, as the gate builds them ({smi})")
    if not late < SEMLA_LEARN_LOSS_MAX:
        raise AssertionError(f"the Semla denoising loss did not fall: {losses[0]} -> {late}")
    return late


def semla_cli_phase(tmp, smi):
    """train-molecule-semla and eval-semla with the recipe as subprocesses:
    3 synthetic steps with a checkpoint, then 16 molecules from its EMA at
    max_atoms 256 in 10 integrator steps, written as .xyz and .sdf."""
    run, out = f"{tmp}/semla_run", f"{tmp}/semla_mols"
    text, eval_text = run_clis([
        (["train-molecule-semla", "--config", RECIPE_SEMLA, "--synthetic", "--steps", "3",
          "--log-every", "1", "--ckpt-dir", run, "--ckpt-every", "3"],
         "train-molecule-semla --steps 3"),
        (["eval-semla", "--config", RECIPE_SEMLA, "--ckpt-dir", run, "--n-samples",
          str(SEMLA_EVAL["n_samples"]), "--n-replicates", "1", "--num-steps",
          str(SEMLA_EVAL["num_steps"]), "--out", out],
         "eval-semla --n-samples 16 --num-steps 10")])
    rate = [line for line in text.splitlines() if "steps after the first" in line]
    log(f"[semla] {rate[-1] if rate else text.splitlines()[-1]}")
    if "3.pt" not in os.listdir(run):
        raise AssertionError(f"train-molecule-semla wrote {os.listdir(run)}")
    text = eval_text
    lines = text.strip().splitlines()
    summary = json.loads(lines[-1])
    speed = next(line for line in lines if "molecules/s" in line)
    xyz = sorted(f for f in os.listdir(out) if f.endswith(".xyz"))
    log(f"[semla] eval-semla (recipe, EMA of step 3, max_atoms 256): {speed}; "
        f"{len(xyz)} .xyz files; validity {summary['validity']}, atom_stable "
        f"{summary['atom_stable']:.4f} (3 training steps: ~0 expected) ({smi})")
    if len(xyz) != SEMLA_EVAL["n_samples"] or "loaded EMA weights of step 3" not in text:
        raise AssertionError(f"eval-semla: {len(xyz)} .xyz files\n{text[-2000:]}")
    return speed


def molecule_phases(smi):
    """Slice 9's phases; returns the launches of K1, K2a and K2b on them."""
    t0 = time.perf_counter()
    fa.launches = fm.launches = fm.backward_launches = 0
    semla_forward_phase(smi)
    train = semla_train_phase(smi)
    semla_learning_phase(smi)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        semla_cli_phase(tmp, smi)
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[semla] slice 9 phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b launches "
        f"on them {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the Semla paths: {counts}")
    return train


# -- slice 10: EDM / EFM molecules (train-molecule-edm, eval-molecule) ------

# MoleculeEDMConfig's default: the reference QM9 recipe (hidden 256 x 9
# blocks, 29 atoms, rep 256 with dropout 0.1), batch 64
EDM = dict(warmup_steps=2, timed_steps=20, profiled_steps=4, cpu_rows=4, cfg_scale=2.0)
EDM_FWD_RTOL = 1e-4      # card vs CPU, f32 with TF32 off, velocity and features apart
# the scales of the message MLPs' weights (edge_mlp, node_mlp) and of the
# coordinate heads (coord_mlp.4, after their N(0, 0.02) move) in the checked
# weights: at the init's scale the coordinates move by ~100 over the nine
# blocks, most tanh coordinate gates saturate, and a gate near 0 turns f32
# rounding into 1e-5 to 3e-3 of the velocity (the CPU's f32 against f64,
# depending on the seed); at 0.25 and 0.01 the CPU's f32 is ~1e-6 from f64
# at seeds 5-7, so 1e-4 between card and CPU is a bound on the port and not
# on the conditioning. The f64 distance is logged beside it.
EDM_MESSAGE_SCALE = 0.25
EDM_COORD_HEAD_SCALE = 0.01
# cut from 200 (PR 23): nll 0.202 at step 100 against 4486 at step 0
# (H100 80GB HBM3, 700.00 W)
EDM_LEARN_STEPS = 100
EDM_LEARN_NLL_MAX = 0.5
EDM_EVAL = dict(batch=16, num_steps=50)  # eval-molecule, cut from T = 1000


def seeded_edm(cfg, seed=5):
    """The model of `cfg` with every bias, LayerNorm, fake_latent and the
    coordinate heads (coord_mlp.4) moved by N(0, 0.02), so that none sits at
    its init value and the coordinate branch and CFG reach the output; then
    the message MLPs' weights scaled by EDM_MESSAGE_SCALE and the coordinate
    heads by EDM_COORD_HEAD_SCALE, so that the bound holds the port and not
    f32's own conditioning at this depth (the CPU's f32 against f64 is
    logged beside it)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = edm_train.build_dynamics(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.endswith(("bias", "coord_mlp.4.weight")) or "norm" in name
                    or name == "fake_latent"):
                p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
            if name.endswith("coord_mlp.4.weight"):
                p.mul_(EDM_COORD_HEAD_SCALE)
            elif name.endswith("weight") and ("edge_mlp" in name or "node_mlp" in name):
                p.mul_(EDM_MESSAGE_SCALE)
    return model


def edm_forward_phase(smi):
    """One full-width EGNNDynamics forward with the rep, and forward_with_cfg,
    on the card against a CPU copy (and f64 beside it) on the first rows of
    a batch of 64 x 29 atoms; the velocity and the features each to 1e-4 of
    their max."""
    cfg = edm_train.MoleculeEDMConfig()
    trainer = edm_train.MoleculeEDMTrainer(cfg, device="cuda")
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(7))
    model = seeded_edm(cfg).eval()
    xh = torch.cat([batch["positions"], batch["one_hot"], batch["charges"]], -1)
    t = torch.rand((cfg.batch_size,), generator=torch.Generator(device="cuda").manual_seed(8),
                   device="cuda")
    rows, w = EDM["cpu_rows"], EDM["cfg_scale"]
    args = (t, xh, batch["node_mask"], batch["edge_mask"])
    errs, errs64 = {}, {}
    with torch.no_grad():
        cpu = copy.deepcopy(model).cpu()
        cpu64 = copy.deepcopy(cpu).double()
        sub = lambda a, dt: a[:rows].cpu().to(dt)  # noqa: E731
        calls = {
            "forward": (lambda m, a, r: m(*a, rep=r)),
            f"forward_with_cfg (w {w})": (lambda m, a, r: m.forward_with_cfg(*a, None, r, w)),
        }
        for label, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(model, args, batch["rep"])
            torch.cuda.synchronize()
            card_ms = 1e3 * (time.perf_counter() - t0)
            ref = call(cpu, [sub(a, torch.float32) for a in args],
                       sub(batch["rep"], torch.float32))
            ref64 = call(cpu64, [sub(a, torch.float64) for a in args],
                         sub(batch["rep"], torch.float64))
            for part, sl in (("velocity", slice(0, 3)), ("features", slice(3, None))):
                errs[f"{label} {part}"] = rel_err(out[:rows, :, sl], ref[..., sl])
                errs64[f"{label} {part}"] = rel_err(ref[..., sl], ref64[..., sl])
            log(f"[edm] {label}: card {card_ms:.1f} ms for {cfg.batch_size} x "
                f"{cfg.max_nodes} atoms (one call, after the first forward's warm-up), "
                f"max |velocity| {ref64[..., :3].abs().max().item():.4g}, max |features| "
                f"{ref64[..., 3:].abs().max().item():.4g}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"EGNNDynamics {label}: non-finite output")
    fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())  # noqa: E731
    log(f"[edm] full-width EGNNDynamics (hidden {cfg.hidden_nf} x {cfg.n_layers} blocks, "
        f"rep {cfg.rep_nf}, attention, tanh, normalization_factor "
        f"{cfg.normalization_factor}; message weights x{EDM_MESSAGE_SCALE}, coordinate heads "
        f"x{EDM_COORD_HEAD_SCALE}) card vs CPU on {rows} rows, f32: max abs err / max "
        f"|out| {fmt(errs)} (rtol {EDM_FWD_RTOL}); CPU f32 vs f64 {fmt(errs64)} ({smi})")
    if not all(v <= EDM_FWD_RTOL for v in errs.values()):
        raise AssertionError(f"EGNNDynamics card vs CPU: {errs}")


def edm_train_phase(smi):
    """The main path: MoleculeEDMTrainer.train_step at full width, batch 64 x
    29 atoms; ms a step (wall and device), molecules/s, launches, idle share,
    peak memory and a profile by kernel family."""
    cfg = edm_train.MoleculeEDMConfig()
    trainer = edm_train.MoleculeEDMTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
    n, steps = cfg.batch_size, EDM["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(EDM["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernel_launches = (fa.launches, fm.launches, fm.backward_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, event_ms = 1e3 * seconds / steps, start.elapsed_time(end) / steps
    log(f"[edm] MoleculeEDMTrainer.train_step, full width (hidden {cfg.hidden_nf} x "
        f"{cfg.n_layers}, rep {cfg.rep_nf}, EDM T {cfg.edm.timesteps}), f32, batch {n} x "
        f"{cfg.max_nodes} atoms: {steps} steps {wall_ms:.3f} ms per step (wall, after a "
        f"sync), {event_ms:.3f} ms (CUDA events), {n * steps / seconds:.2f} molecules/s; "
        f"peak memory {peak_gb:.2f} GB; K1/K2a/K2b launches {kernel_launches}; last loss "
        f"{metrics['loss'].item():.6g}, grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite EDM train metrics {metrics}")
    if any(kernel_launches):
        raise AssertionError(f"a TPU-kernel port ran on the EDM path: {kernel_launches}")
    k = EDM["profiled_steps"]

    def k_steps():
        nonlocal state
        for _ in range(k):
            state, _ = trainer.train_step(state, batch)

    prof = profile(f"{k} EDM train steps", k_steps, smi, top=12)
    busy = prof["busy_ms"] / k
    log(f"[edm] per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall ({wall_ms:.3f} ms), "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled one")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, event_ms=event_ms, mol_s=n * steps / seconds,
                peak_gb=peak_gb, busy_ms=busy, launches=prof["launches"] / k)


def edm_learning_phase(smi):
    """EDM_LEARN_STEPS of the EDM gate (seed 0, its data and configuration):
    the mean nll of the last 20 must fall below 0.5."""
    gcfg = convergence_edm.gate_config(seed=0)
    data = convergence_edm.GateData()
    trainer = edm_train.MoleculeEDMTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in convergence_edm.gate_batches(data, EDM_LEARN_STEPS, torch.device("cuda")):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    late = sum(losses[-20:]) / 20
    batch = edm_train.batch_to_device(data.batch(0), "cuda")

    def steps4():
        nonlocal state
        for _ in range(4):
            state, _ = trainer.train_step(state, batch)

    prof = profile("4 EDM gate steps (one batch)", steps4, smi, top=6)
    log(f"[edm] gate step: device {prof['busy_ms'] / 4:.3f} ms, {prof['launches'] / 4:.0f} "
        f"launches, wall {prof['wall_ms'] / 4:.3f} ms (profiled, batch resident)")
    log(f"[edm] learning check, EDM gate config (hidden {gcfg.hidden_nf}, {gcfg.n_layers} "
        f"blocks, batch {gcfg.batch_size} chains, rep {gcfg.rep_nf}): nll step 0 "
        f"{losses[0]:.4f}, step {len(losses) // 2} {losses[len(losses) // 2]:.4f}, mean of "
        f"steps {EDM_LEARN_STEPS - 20}-{EDM_LEARN_STEPS - 1} {late:.4f} (must be < "
        f"{EDM_LEARN_NLL_MAX}; JAX on a TPU: 327.3 at step 0, 0.113 at step 200); "
        f"{1e3 * seconds / EDM_LEARN_STEPS:.3f} ms per step, host batches inline ({smi})")
    if not late < EDM_LEARN_NLL_MAX:
        raise AssertionError(f"the EDM nll did not fall: {losses[0]} -> {late}")
    return late


def edm_cli_phase(tmp, smi):
    """train-molecule-edm (EDM and fm) and eval-molecule from each run's
    checkpoint, all as subprocesses at MoleculeEDMConfig's full width: 3
    synthetic steps with a checkpoint, then 16 molecules in 50 EDM steps
    (10 rk4 steps for fm), the EDM ones written as .xyz."""
    speeds, commands = {}, []
    models = (("diffusion", []),
              ("fm", ["--set", "probabilistic_model=fm", "--set", "efm.ode_steps=10"]))
    for model, extra in models:
        run = f"{tmp}/edm_{model}"
        commands += [(["train-molecule-edm", "--synthetic", "--steps", "3", "--log-every",
                       "1", "--ckpt-dir", run, "--ckpt-every", "3", *extra],
                      f"train-molecule-edm {model} --steps 3"),
                     (["eval-molecule", "--ckpt-dir", run, "--batch-size",
                       str(EDM_EVAL["batch"]), "--num-steps", str(EDM_EVAL["num_steps"]),
                       "--n-replicates", "1", "--out", f"{tmp}/edm_{model}_mols", *extra],
                      f"eval-molecule {model}")]
    texts = iter(run_clis(commands))
    for model, extra in models:
        run = f"{tmp}/edm_{model}"
        text = next(texts)
        rate = [line for line in text.splitlines() if "steps after the first" in line]
        log(f"[edm] {rate[-1] if rate else text.splitlines()[-1]}")
        if "3.pt" not in os.listdir(run):
            raise AssertionError(f"train-molecule-edm {model} wrote {os.listdir(run)}")
        out = f"{tmp}/edm_{model}_mols"
        text = next(texts)
        summary = json.loads(text[text.rindex("\n{\n") + 1:])
        speed = next(line for line in text.splitlines() if "molecules/s" in line)
        xyz = sorted(f for f in os.listdir(out) if f.endswith(".xyz"))
        log(f"[edm] eval-molecule {model} (EMA of step 3, {EDM_EVAL['batch']} molecules): "
            f"{speed}; {len(xyz)} .xyz files; validity {summary['mean']['validity']}, "
            f"atom_stable {summary['mean']['atom_stable']:.4f} (3 training steps: ~0 "
            f"expected) ({smi})")
        if len(xyz) != EDM_EVAL["batch"] or "loaded EMA weights of step 3" not in text:
            raise AssertionError(f"eval-molecule {model}: {len(xyz)} .xyz files\n"
                                 f"{text[-2000:]}")
        speeds[model] = speed
    return speeds


def edm_phases(smi):
    """Slice 10's phases; returns the train phase's numbers. K1, K2a and K2b
    must launch 0 times on them."""
    t0 = time.perf_counter()
    fa.launches = fm.launches = fm.backward_launches = 0
    edm_forward_phase(smi)
    train = edm_train_phase(smi)
    edm_learning_phase(smi)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        edm_cli_phase(tmp, smi)
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[edm] slice 10 phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b launches "
        f"on them {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the EDM paths: {counts}")
    return train


# -- slice 11: the precision options and the RDM (train-rdm, eval-molecule
# --rdm-ref-ckpt) ------------------------------------------------------------

# the protein bf16 step through K2a/K2b bf16 against the unfused bf16 chain,
# held as phase 7 holds the image bf16 step, but parameter by parameter:
# each gradient may differ from the unfused bf16 step's by at most twice
# its own distance in the unfused bf16 step from the f32 step (unfused, same
# state and draws); the metrics, by twice the largest metric's distance
PROTEIN_BF16_NOISE_FACTOR = 2.0
# the RDM at RDMTrainConfig's full width (256-d reps, 1536 x 18 blocks,
# ~100 M parameters), batch 128; card vs CPU f32 with TF32 off on 16 rows
RDM = dict(warmup_steps=3, timed_steps=20, profiled_steps=4, cpu_rows=16)
RDM_FWD_RTOL = 1e-4
EDM_BF16 = dict(warmup_steps=2, timed_steps=10)


def protein_bf16_phase(smi):
    """bf16 protein training (compute_dtype bfloat16, f32 master weights):
    one full-width step through K2a/K2b bf16 against the unfused bf16 chain
    (each gradient within 2x its own distance in the unfused bf16 step from
    the f32 step, the metrics within 2x the largest metric's); the main path, 20 timed `train_step`s with the
    launch counts zeroed before and read after (9 K2a + 9 K2b a step); a
    200-step learning check on the gate's rule data in bf16;
    `train-protein --set compute_dtype=bfloat16` through the CLI. Returns
    the (K2a, K2b) launches of the timed steps."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg = dataclasses.replace(train_config(dropout=0.0), compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    perturb_pmpnn(state.model, gen)
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    corrupted = corrupt_batch(batch, cfg.interpolant, gen)
    noisy = (corrupted["S_t"], corrupted["t"])
    names, params = zip(*state.model.named_parameters())
    steps = {}
    for label, c, fused in (("kernels", cfg, True), ("unfused", cfg, False),
                            ("f32", cfg32, False)):
        state.model.fused = fused
        before = (fm.launches, fm.backward_launches)
        metrics = make_loss_fn(c)(state.model, batch, 0, noisy=noisy)
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        torch.cuda.synchronize()
        steps[label] = ({k: v.item() for k, v in dict(metrics, loss=total).items()},
                        [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)],
                        (fm.launches - before[0], fm.backward_launches - before[1]))
    state.model.fused = True
    per_step = 2 * cfg.num_encoder_layers + cfg.num_decoder_layers
    err = step_error_maps(steps["kernels"][:2], steps["unfused"][:2], names)
    noise = step_error_maps(steps["unfused"][:2], steps["f32"][:2], names)
    k_err = step_error_maps(steps["kernels"][:2], steps["f32"][:2], names)
    # each gradient to its own noise; the metrics, scalars whose one rounding
    # sample is no yardstick, to the noisiest metric's, as phase 7 holds them
    metric_tol = PROTEIN_BF16_NOISE_FACTOR * max(noise[0].values()) + 1e-6
    tol = [{k: metric_tol for k in noise[0]},
           {k: PROTEIN_BF16_NOISE_FACTOR * v + 1e-6 for k, v in noise[1].items()}]
    # the worst entry by its share of its bound, for metrics and gradients
    worst = [max(e, key=lambda k, e=e, t=t: e[k] / t[k]) for e, t in zip(err, tol)]
    launches = steps["kernels"][2]
    fmt = lambda i: (f"{worst[i]} {err[i][worst[i]]:.3g} against {tol[i][worst[i]]:.3g} "  # noqa: E731
                     f"(its own noise {noise[i][worst[i]]:.3g})")
    log(f"[bf16] protein train step, bf16 over f32 masters, {TRAIN['batch']} x "
        f"{TRAIN['length']}, K2a/K2b bf16 vs the unfused bf16 chain, each of {len(names)} "
        f"gradients (max err / max |g|) within {PROTEIN_BF16_NOISE_FACTOR} x its own distance "
        f"in the unfused bf16 step from the f32 step, the metrics (rel err above 1) within "
        f"{PROTEIN_BF16_NOISE_FACTOR} x the largest metric's: nearest its bound, metric "
        f"{fmt(0)}, gradient {fmt(1)}; largest: "
        f"kernels vs unfused {max(err[1].values()):.3g}, unfused vs f32 "
        f"{max(noise[1].values()):.3g}, kernels vs f32 {max(k_err[1].values()):.3g}; launches "
        f"fwd/bwd {launches}; loss {steps['kernels'][0]['loss']:.6g}")
    if not (all(e[k] <= t[k] for e, t in zip(err, tol) for k in e)
            and all(torch.isfinite(g).all() for g in steps["kernels"][1])):
        raise AssertionError(f"bf16 protein step, kernels vs unfused: metrics "
                             f"{steps['kernels'][0]} vs {steps['unfused'][0]}, nearest their "
                             f"bounds: {fmt(0)}; {fmt(1)}")
    if launches != (per_step, per_step):
        raise AssertionError(f"expected {per_step} K2a and K2b bf16 launches, got {launches}")
    if any(g.dtype != torch.float32 for g in steps["kernels"][1]):
        raise AssertionError("bf16 training must leave f32 gradients on the masters")
    del trainer, state, steps

    # the main path at the default dropout
    cfg = dataclasses.replace(train_config(), compute_dtype="bfloat16")
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    n = TRAIN["timed_steps"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fm.launches = fm.backward_launches = fa.launches = 0
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (fm.launches, fm.backward_launches)
    wall_ms = 1e3 * seconds / n
    residues = TRAIN["batch"] * TRAIN["length"]
    log(f"[bf16] ProteinTrainer.train_step, compute_dtype bfloat16, default config "
        f"(dropout {cfg.dropout}): {n} steps {wall_ms:.3f} ms per step (wall), "
        f"{start.elapsed_time(end) / n:.3f} ms (CUDA events), "
        f"{residues * n / seconds:.1f} residues/s; launches K2a {launches[0]}, K2b "
        f"{launches[1]} (expected {per_step * n} each), flash_attention {fa.launches}; last "
        f"loss {metrics['loss'].item():.6g} ({smi})")
    if launches != (per_step * n, per_step * n) or fa.launches:
        raise AssertionError(f"expected {per_step * n} K2a and K2b bf16 launches, got "
                             f"{launches}, K1 {fa.launches}")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite bf16 protein metrics {metrics}")
    if state.model.W_out.weight.dtype != torch.float32 or state.opt.nu[0].dtype != torch.float32:
        raise AssertionError("bf16 protein training must keep f32 weights and optimizer")
    prof = profile("bf16 protein train step", lambda: trainer.train_step(state, batch), smi,
                   top=10)
    log(f"[bf16] protein step: device {prof['busy_ms']:.3f} ms, {prof['launches']} launches, "
        f"device idle {100 * (1 - prof['busy_ms'] / wall_ms):.1f} % of the unprofiled wall")
    del trainer, state, batch

    # learning: the bf16 gate's configuration and data
    trainer = ProteinTrainer(gate_config(compute_dtype="bfloat16"), device="cuda")
    state = trainer.init_state()
    ces = []
    t0 = time.perf_counter()
    for step in range(LEARN_STEPS):
        state, metrics = trainer.train_step(state, rule_batch(step, 16, 48, "cuda"))
        ces.append(metrics["denoising_loss"])
    ces = [c.item() for c in ces]
    late = sum(ces[-20:]) / 20
    log(f"[bf16] protein learning check, bf16 gate config (16 x 48, rule data): CE step 0 "
        f"{ces[0]:.4f}, step 100 {ces[100]:.4f}, mean of steps {LEARN_STEPS - 20}-"
        f"{LEARN_STEPS - 1} {late:.4f} (must be < {LEARN_CE_MAX}); "
        f"{1e3 * (time.perf_counter() - t0) / LEARN_STEPS:.3f} ms per step ({smi})")
    if not late < LEARN_CE_MAX:
        raise AssertionError(f"the bf16 CE did not fall: {ces[0]} -> {late}")
    del trainer, state

    state, text = cli_quiet(["train-protein", "--steps", "3", "--synthetic", "--log-every",
                             "1", "--set", "compute_dtype=bfloat16"])
    log(f"[bf16] cli train-protein --steps 3 --synthetic --set compute_dtype=bfloat16: "
        f"{text.strip().splitlines()[-1]}")
    if state.step != 3:
        raise AssertionError(f"train-protein bf16 ran {state.step} steps, not 3")
    torch.cuda.empty_cache()
    return launches


def semla_mixed_phase(smi, f32_train):
    """SemlaFlow mixed precision at the recipe's width (batch 56 x 72):
    coordinates f32 and features bf16 in one forward; 20 timed steps beside
    the f32 figures; a SEMLA_LEARN_STEPS learning check on the bf16 gate's
    data (the templates record's configuration: mean loss of the last 20
    steps below 1.0;
    the TPU's bf16 run read 5.85 at step 0 and 0.390 at step 200)."""
    cfg = semla_full_config(compute_dtype="bfloat16")
    trainer = semla_train.SemlaTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = semla_train.batch_to_device(
        semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=1), "cuda")
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, set()).update(
                t.dtype for t in (out if isinstance(out, tuple) else (out,))
                if isinstance(t, torch.Tensor))
        return hook

    handles = [m.register_forward_hook(record(type(m).__name__)) for m in state.model.modules()
               if isinstance(m, (semla_model.CoordAttention, semla_model.EdgeMessages,
                                 semla_model.NodeAttention))]
    handles.append(state.model.dynamics.coord_head.register_forward_hook(record("coord_head")))
    def ff_hook(module, args, out):
        seen.setdefault("ff", set()).add((out[0].dtype, out[1].dtype))

    handles += [m.register_forward_hook(ff_hook) for m in state.model.modules()
                if isinstance(m, semla_model.NodeFeedForward)]
    interp = batch["interpolated"]
    with torch.no_grad():
        coords, types, _, _, _ = semla_train._apply(state.model, cfg, interp, batch["times"],
                                                    semla_train._zero_cond(interp),
                                                    batch["rep"])
    for h in handles:
        h.remove()
    want = {"CoordAttention": {torch.float32}, "coord_head": {torch.float32},
            "EdgeMessages": {torch.bfloat16}, "NodeAttention": {torch.bfloat16},
            "ff": {(torch.float32, torch.bfloat16)}}
    log(f"[bf16] SemlaFlow mixed precision, dtypes seen: " + "; ".join(
        f"{k} {sorted(str(t) for t in v)}" for k, v in sorted(seen.items())))
    if seen != want or coords.dtype != torch.float32 or types.dtype != torch.float32:
        raise AssertionError(f"mixed precision dtypes {seen}, outputs {coords.dtype}, "
                             f"{types.dtype}")
    n, steps = SEMLA["batch"], SEMLA["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SEMLA["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    wall_ms, event_ms = 1e3 * seconds / steps, start.elapsed_time(end) / steps
    log(f"[bf16] SemlaTrainer.train_step, recipe width, mixed precision, batch {n} x "
        f"{SEMLA['atoms']}: {wall_ms:.3f} ms per step (wall), {event_ms:.3f} ms (CUDA "
        f"events), {n * steps / seconds:.2f} molecules/s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; f32 in this run: "
        f"{f32_train['wall_ms']:.3f} ms per step, {f32_train['busy_ms']:.3f} device ms, "
        f"{f32_train['mol_s']:.2f} molecules/s; last loss {metrics['loss'].item():.6g} "
        f"({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite mixed-precision Semla metrics {metrics}")

    def k_steps():
        nonlocal state
        for i in range(SEMLA["profiled_steps"]):
            state, _ = trainer.train_step(state, batch, use_sc=bool(i % 2))

    prof = profile("Semla mixed-precision train steps", k_steps, smi, top=8)
    busy = prof["busy_ms"] / SEMLA["profiled_steps"]
    log(f"[bf16] Semla mixed step: device {busy:.3f} ms, "
        f"{prof['launches'] / SEMLA['profiled_steps']:.0f} launches, device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall")
    del trainer, state, batch
    torch.cuda.empty_cache()

    gcfg = convergence_semla.gate_config(seed=0, templates=True, dtype="bfloat16")
    data = convergence_semla.GateData(templates=True)
    trainer = semla_train.SemlaTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    losses = []
    t0 = time.perf_counter()
    for batch in convergence_semla.gate_batches(data, SEMLA_LEARN_STEPS, torch.device("cuda")):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    late = sum(losses[-20:]) / 20
    log(f"[bf16] Semla learning check, bf16 gate config (templates, d_model "
        f"{gcfg.d_model}, batch {gcfg.batch_size}): loss step 0 {losses[0]:.4f}, step "
        f"{len(losses) // 2} {losses[len(losses) // 2]:.4f}, mean of steps "
        f"{SEMLA_LEARN_STEPS - 20}-{SEMLA_LEARN_STEPS - 1} "
        f"{late:.4f} (must be < {SEMLA_LEARN_LOSS_MAX}); "
        f"{1e3 * (time.perf_counter() - t0) / SEMLA_LEARN_STEPS:.3f} ms per step ({smi})")
    if not late < SEMLA_LEARN_LOSS_MAX:
        raise AssertionError(f"the bf16 Semla loss did not fall: {losses[0]} -> {late}")
    torch.cuda.empty_cache()


def edm_bf16_phase(smi, f32_train):
    """EDM in bf16 (compute_dtype bfloat16) at the QM9 recipe's width: a
    finite step, timed beside the f32 one."""
    cfg = edm_train.MoleculeEDMConfig(compute_dtype="bfloat16")
    trainer = edm_train.MoleculeEDMTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
    for _ in range(EDM_BF16["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    n = EDM_BF16["timed_steps"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"[bf16] MoleculeEDMTrainer.train_step, bf16, QM9 width (hidden {cfg.hidden_nf} x "
        f"{cfg.n_layers}), batch {cfg.batch_size} x {cfg.max_nodes}: {wall_ms:.3f} ms per "
        f"step (wall), {start.elapsed_time(end) / n:.3f} ms (CUDA events), "
        f"{cfg.batch_size * 1e3 / wall_ms:.2f} molecules/s; f32 in this run "
        f"{f32_train['wall_ms']:.3f} ms (wall), {f32_train['event_ms']:.3f} ms (events); loss "
        f"{metrics['loss'].item():.6g}, grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite bf16 EDM metrics {metrics}")
    del trainer, state, batch
    torch.cuda.empty_cache()


def seeded_rdm(cfg, device, seed=3):
    """The full-width SimpleMLP of `cfg` as initialised, its zero-initialised
    output layers drawn N(0, 0.02) so that every block reaches the output."""
    model = rdm_train.build_model(cfg, device=device,
                                  generator=torch.Generator(device=device).manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("out_layers.3.weight", "out.2.weight")):
                p.normal_(0.0, 0.02, generator=gen)
    return model


def rdm_phase(tmp, smi):
    """The RDM at RDMTrainConfig's full width: one forward on the card
    against the CPU (f32, TF32 off, 1e-4 of the max); the main path,
    `RDMTrainer.train_step`, 20 timed steps (ms, reps/s, peak memory) and a
    profile; `train-rdm --steps 3` and `eval-molecule --rdm-ref-ckpt` (from
    a checkpoint written here in the reference LatentDiffusion layout) as
    subprocesses."""
    cfg = rdm_train.RDMTrainConfig()
    model = seeded_rdm(cfg, "cpu").eval()
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(2)
    rows = RDM["cpu_rows"]
    x = torch.randn((rows, cfg.channels), generator=gen)
    t = torch.randint(0, cfg.rdm.timesteps, (rows,), generator=gen)
    n_nodes = torch.randint(5, cfg.max_nodes, (rows,), generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(x, t, n_nodes)
            card = copy.deepcopy(model).to("cuda")
            got = card(x.cuda(), t.cuda(), n_nodes.cuda()).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = rel_err(got, want)
    log(f"[rdm] SimpleMLP full width ({n_params / 1e6:.2f} M parameters), f32 TF32 off, "
        f"{rows} rows: card vs CPU max err / max {err:.3g} (rtol {RDM_FWD_RTOL})")
    if not err <= RDM_FWD_RTOL:
        raise AssertionError(f"RDM card vs CPU {err}")
    ref_sd = {f"model.diffusion_model.{k}": v for k, v in model.state_dict().items()
              if k != "cond_stage_model.embedding.weight"}
    # the reference's ClassEmbedder has max_nodes rows, one fewer than the port's
    ref_sd["cond_stage_model.embedding.weight"] = model.state_dict()[
        "cond_stage_model.embedding.weight"][:cfg.max_nodes]
    rdm_ckpt = os.path.join(tmp, "rdm.ckpt")
    torch.save({"state_dict": ref_sd}, rdm_ckpt)
    del model, card, ref_sd

    trainer = rdm_train.RDMTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RDM["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    n = RDM["timed_steps"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    wall_ms, event_ms = 1e3 * seconds / n, start.elapsed_time(end) / n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[rdm] RDMTrainer.train_step, full width, f32, batch {cfg.batch_size}: {wall_ms:.3f} "
        f"ms per step (wall), {event_ms:.3f} ms (CUDA events), "
        f"{cfg.batch_size * n / seconds:.1f} reps/s, peak {peak_gb:.2f} GB; loss "
        f"{metrics['loss'].item():.6g}, grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite RDM metrics {metrics}")

    def k_steps():
        nonlocal state
        for _ in range(RDM["profiled_steps"]):
            state, _ = trainer.train_step(state, batch)

    prof = profile("RDM train steps", k_steps, smi, top=8)
    busy = prof["busy_ms"] / RDM["profiled_steps"]
    log(f"[rdm] per step: device {busy:.3f} ms, {prof['launches'] / RDM['profiled_steps']:.0f} "
        f"launches, device idle {100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall")
    del trainer, state, batch
    torch.cuda.empty_cache()

    run = os.path.join(tmp, "edm_for_rdm")
    text, _, eval_text = run_clis([
        (["train-rdm", "--synthetic", "--steps", "3", "--log-every", "1"],
         "train-rdm --steps 3"),
        (["train-molecule-edm", "--synthetic", "--steps", "1", "--ckpt-dir", run,
          "--ckpt-every", "1"], "train-molecule-edm --steps 1 (for the two-stage eval)"),
        (["eval-molecule", "--ckpt-dir", run, "--rdm-ref-ckpt", rdm_ckpt, "--batch-size",
          str(EDM_EVAL["batch"]), "--num-steps", str(EDM_EVAL["num_steps"]),
          "--n-replicates", "1"], "eval-molecule --rdm-ref-ckpt")])
    rate = [line for line in text.splitlines() if "steps after the first" in line]
    log(f"[rdm] {rate[-1] if rate else text.splitlines()[-1]}")
    if f"sampled reps: (3, {cfg.channels}) finite: True" not in text:
        raise AssertionError(f"train-rdm's DDIM smoke sample:\n{text[-2000:]}")
    text = eval_text
    summary = json.loads(text[text.rindex("\n{\n") + 1:])
    speed = next(line for line in text.splitlines() if "molecules/s" in line)
    rep_time = next(line for line in text.splitlines() if "rep sampling of" in line)
    log(f"[rdm] eval-molecule --rdm-ref-ckpt (a full-width RDM in the reference layout, DDIM "
        f"250 steps, then {EDM_EVAL['num_steps']} EDM steps): {rep_time}; {speed}; validity "
        f"{summary['mean']['validity']} (1 training step: ~0 expected) ({smi})")
    if "DDIM rep sampler from the reference RDM" not in text:
        raise AssertionError(f"eval-molecule did not take the RDM:\n{text[-2000:]}")


def precision_rdm_phases(smi, semla_f32, edm_f32):
    """Slice 11's phases; returns the (K2a, K2b) bf16 launches of the
    protein bf16 main path. K1 launches 0 times on them, and K2a and K2b 0
    times outside the protein path."""
    t0 = time.perf_counter()
    launches = protein_bf16_phase(smi)
    fa.launches = fm.launches = fm.backward_launches = 0
    semla_mixed_phase(smi, semla_f32)
    edm_bf16_phase(smi, edm_f32)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        rdm_phase(tmp, smi)
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[bf16] slice 11 phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b launches on "
        f"the Semla, EDM and RDM paths {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the Semla, EDM or RDM paths: {counts}")
    return launches


# -- slice 12: MultiFlow SE(3) codesign (train-multiflow, eval-multiflow) ----

# MultiflowTrainConfig's full width (c_s 256, c_z 128, 6 blocks; IPA 8 heads
# x 16, 8 query/key and 12 value points; 2 sequence-transformer layers of 4
# heads) at tools/bench_domains.py's shape, 8 chains of 128 residues
MULTIFLOW = dict(batch=8, length=128, warmup_steps=2, timed_steps=20, profiled_steps=4,
                 cpu_rows=2)
MULTIFLOW_FWD_RTOL = 1e-4    # card vs CPU, f32 with TF32 off, each output
# the checked weights: the init with every parameter moved by N(0, 0.02), so
# that the zero-initialised layers (IPA linear_out, post_tfmr, the
# transitions' linear_3) reach the output, and the backbone updates drawn
# N(0, 0.002), so that six composed rigid updates stay well-conditioned
MULTIFLOW_MOVE = 0.02
MULTIFLOW_BB_STD = 0.002
# cut from 200 (PR 23): at step 100 f32 read 1.246 and bf16 1.279
# against 7.74 at step 0 (H100 80GB HBM3, 700.00 W)
MULTIFLOW_LEARN_STEPS = 100
MULTIFLOW_LEARN_LOSS_MAX = 2.0
MULTIFLOW_EVAL = dict(num_samples=4, length=64, num_steps=10)  # eval-multiflow, cut from 100


def seeded_flow_model(cfg, seed=9):
    """MultiflowTrainConfig's FlowModel on the card with the checked
    weights (MULTIFLOW_MOVE, MULTIFLOW_BB_STD)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = mf_train.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bb_update" in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * MULTIFLOW_BB_STD)
            else:
                p.add_(torch.randn(p.shape, generator=gen, device="cuda") * MULTIFLOW_MOVE)
    return model


def multiflow_noisy_batch(trainer, seed):
    """A corrupted synthetic batch (the trainer's schema, the batch-OT prior)
    with zero self-conditioning, as the train step feeds the model."""
    batch = trainer.synthetic_batch(np.random.default_rng(seed))
    noisy = mf_se3.corrupt_batch(trainer.cfg.interpolant, batch,
                                 generator=torch.Generator(device="cuda").manual_seed(seed))
    noisy["trans_sc"] = torch.zeros_like(noisy["trans_t"])
    noisy["aatypes_sc"] = F.one_hot(noisy["aatypes_t"], 21).float()
    return noisy


def multiflow_forward_phase(smi):
    """One full-width FlowModel forward of 8 x 128 residues on the card
    against a CPU copy (and f64 beside it) on the first 2 rows, f32 with TF32
    off: each output to 1e-4 of its max."""
    cfg = mf_train.MultiflowTrainConfig(batch_size=MULTIFLOW["batch"],
                                        max_len=MULTIFLOW["length"])
    trainer = mf_train.MultiflowTrainer(cfg, device="cuda")
    model = seeded_flow_model(cfg).eval()
    noisy = multiflow_noisy_batch(trainer, 3)
    rows = MULTIFLOW["cpu_rows"]
    with torch.no_grad():
        out = model(noisy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(noisy)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu = copy.deepcopy(model).cpu()
        sub = {k: v[:rows].cpu() for k, v in noisy.items()}
        t0 = time.perf_counter()
        ref = cpu(sub)
        cpu_s = time.perf_counter() - t0
        cpu64 = ipa_model.FlowModel(
            c_s=cfg.c_s, c_z=cfg.c_z, num_blocks=cfg.num_blocks, ipa_c_hidden=cfg.ipa_c_hidden,
            ipa_no_heads=cfg.ipa_no_heads, ipa_no_qk_points=cfg.ipa_no_qk_points,
            ipa_no_v_points=cfg.ipa_no_v_points, seq_tfmr_num_layers=cfg.seq_tfmr_num_layers,
            compute_dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        cpu64.double()
        ref64 = cpu64({k: v.double() if v.is_floating_point() else v for k, v in sub.items()})
    errs = {k: rel_err(out[k][:rows], ref[k]) for k in ref}
    errs64 = {k: rel_err(ref[k], ref64[k]) for k in ref}
    fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())  # noqa: E731
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[multiflow] full-width FlowModel (c_s {cfg.c_s}, c_z {cfg.c_z}, {cfg.num_blocks} "
        f"blocks, {n_params / 1e6:.2f} M parameters; init moved by N(0, {MULTIFLOW_MOVE}), "
        f"backbone updates N(0, {MULTIFLOW_BB_STD})), f32 TF32 off, batch "
        f"{cfg.batch_size} x {cfg.max_len}: card {card_ms:.1f} ms a forward; card vs CPU on "
        f"{rows} rows max abs err / max |out| {fmt(errs)} (rtol {MULTIFLOW_FWD_RTOL}); CPU f32 "
        f"vs f64 {fmt(errs64)}; CPU {cpu_s:.1f} s ({smi})")
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError("FlowModel: non-finite output on the card")
    if not all(v <= MULTIFLOW_FWD_RTOL for v in errs.values()):
        raise AssertionError(f"FlowModel card vs CPU: {errs}")


def multiflow_train_phase(smi, dtype):
    """The main path: MultiflowTrainer.train_step at full width, 8 x 128
    residues, in `dtype`; ms a step (wall and device), residues/s, peak
    memory, launches, idle share and a profile by kernel family. K1, K2a
    and K2b must launch 0 times in the timed steps."""
    cfg = mf_train.MultiflowTrainConfig(batch_size=MULTIFLOW["batch"],
                                        max_len=MULTIFLOW["length"], compute_dtype=dtype)
    trainer = mf_train.MultiflowTrainer(cfg, device="cuda")
    state = trainer.init_state()
    t0 = time.perf_counter()
    batch = trainer.synthetic_batch(np.random.default_rng(1))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    n, steps = cfg.batch_size * cfg.max_len, MULTIFLOW["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MULTIFLOW["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernel_launches = (fa.launches, fm.launches, fm.backward_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, event_ms = 1e3 * seconds / steps, start.elapsed_time(end) / steps
    log(f"[multiflow] MultiflowTrainer.train_step, full width, {dtype}, batch "
        f"{cfg.batch_size} x {cfg.max_len} (batch-OT prior, host {host_ms:.1f} ms a batch): "
        f"{steps} steps {wall_ms:.3f} ms per step (wall, after a sync), {event_ms:.3f} ms "
        f"(CUDA events), {n * steps / seconds:.1f} residues/s; peak memory {peak_gb:.2f} GB; "
        f"K1/K2a/K2b launches {kernel_launches}; last loss {metrics['loss'].item():.6g}, "
        f"grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite MultiFlow train metrics {metrics}")
    if any(kernel_launches):
        raise AssertionError(f"a TPU-kernel port ran on the MultiFlow path: {kernel_launches}")
    k = MULTIFLOW["profiled_steps"]

    def k_steps():
        nonlocal state
        for _ in range(k):
            state, _ = trainer.train_step(state, batch)

    prof = profile(f"{k} MultiFlow train steps ({dtype})", k_steps, smi, top=12)
    busy = prof["busy_ms"] / k
    log(f"[multiflow] {dtype} per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall ({wall_ms:.3f} ms), "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled one")
    del trainer, state, batch
    torch.cuda.empty_cache()


def multiflow_learning_phase(smi, dtype):
    """MULTIFLOW_LEARN_STEPS of the MultiFlow gate (seed 0, its helices and
    configuration) in `dtype`: the mean denoising loss of the last 20 steps
    must fall below 2.0."""
    gcfg = convergence_multiflow.gate_config(seed=0, dtype=dtype)
    trainer = mf_train.MultiflowTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(MULTIFLOW_LEARN_STEPS):
        batch = convergence_multiflow.gate_batch(step, gcfg.batch_size, gcfg.max_len, "cuda")
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    late = sum(losses[-20:]) / 20
    log(f"[multiflow] learning check, gate config ({dtype}, c_s {gcfg.c_s}, c_z {gcfg.c_z}, "
        f"{gcfg.num_blocks} blocks, batch {gcfg.batch_size} x {gcfg.max_len} helices): "
        f"denoising loss step 0 {losses[0]:.4f}, step {len(losses) // 2} "
        f"{losses[len(losses) // 2]:.4f}, mean of steps "
        f"{MULTIFLOW_LEARN_STEPS - 20}-{MULTIFLOW_LEARN_STEPS - 1} {late:.4f} (must be < "
        f"{MULTIFLOW_LEARN_LOSS_MAX}; JAX on a TPU: 8.11 at step 0, 1.11 at step 200); "
        f"{1e3 * seconds / MULTIFLOW_LEARN_STEPS:.3f} ms per step, host batches inline ({smi})")
    if not late < MULTIFLOW_LEARN_LOSS_MAX:
        raise AssertionError(f"the MultiFlow loss did not fall ({dtype}): {losses[0]} -> {late}")


def multiflow_cli_phase(tmp, smi):
    """train-multiflow --synthetic --steps 3 with a checkpoint and
    eval-multiflow from its EMA (4 samples x 64 residues, 10 steps, PDB
    files parsed back) as subprocesses at full width; then the MultiFlow
    step's resume (bitwise, or within 10x a repeated run) with its control."""
    run, out = f"{tmp}/multiflow", f"{tmp}/multiflow_pdb"
    ev = MULTIFLOW_EVAL
    text, eval_text = run_clis([
        (["train-multiflow", "--synthetic", "--steps", "3", "--log-every", "1", "--ckpt-dir",
          run, "--ckpt-every", "3"], "train-multiflow --steps 3"),
        (["eval-multiflow", "--ckpt-dir", run, "--num-samples", str(ev["num_samples"]),
          "--length", str(ev["length"]), "--num-steps", str(ev["num_steps"]), "--out", out],
         "eval-multiflow")])
    rate = [line for line in text.splitlines() if "steps after the first" in line]
    log(f"[multiflow] {rate[-1] if rate else text.splitlines()[-1]}")
    if "3.pt" not in os.listdir(run):
        raise AssertionError(f"train-multiflow wrote {os.listdir(run)}")
    text = eval_text
    summary = json.loads(text[text.rindex("\n{\n") + 1:])
    speed = next(line for line in text.splitlines() if "ms per sampler step" in line)
    backbones = [eval_protein_metrics.parse_pdb_backbone(r["pdb"]) for r in summary["samples"]]
    log(f"[multiflow] eval-multiflow (EMA of step 3, {ev['num_samples']} x {ev['length']} "
        f"residues, {ev['num_steps']} steps): {speed}; {len(backbones)} PDB files read back "
        f"{[b.shape for b in backbones]}; mean {summary['mean']} (3 training steps) ({smi})")
    if ("loaded EMA weights of step 3" not in text or len(backbones) != ev["num_samples"]
            or any(b.shape != (ev["length"], 4, 3) or not np.isfinite(b).all()
                   for b in backbones)):
        raise AssertionError(f"eval-multiflow:\n{text[-2000:]}")
    cfg = mf_train.MultiflowTrainConfig()
    make = lambda: mf_train.MultiflowTrainer(cfg, device="cuda")  # noqa: E731
    probe = make()
    batches = [probe.synthetic_batch(np.random.default_rng(90 + i)) for i in range(4)]
    del probe
    # the control's restore leaves the training draws (t, IGSO3 noise, masks)
    # at their start
    resume_check("MultiFlow", make, batches, tmp, control=True)


def multiflow_phases(smi):
    """Slice 12's phases. K1, K2a and K2b must launch 0 times on them."""
    t0 = time.perf_counter()
    fa.launches = fm.launches = fm.backward_launches = 0
    multiflow_forward_phase(smi)
    for dtype in ("float32", "bfloat16"):
        multiflow_train_phase(smi, dtype)
    for dtype in ("float32", "bfloat16"):
        multiflow_learning_phase(smi, dtype)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        multiflow_cli_phase(tmp, smi)
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[multiflow] slice 12 phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b "
        f"launches on the MultiFlow paths {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the MultiFlow paths: {counts}")


# -- slice 13: property guidance and the molecule eval stack (train-property,
# eval-conditional, eval-molecule's MOSES / MiDi block) ----------------------

# PropertyTrainConfig's default: hidden 128 x 7 layers, batch 96 x 29 atoms
PROPERTY = dict(warmup_steps=2, timed_steps=20, profiled_steps=4, cpu_rows=4)
PROPERTY_FWD_RTOL = 1e-4     # card vs CPU, f32 with TF32 off
PROPERTY_BIAS_STD = 0.02     # the biases moved off their zero init, so they take part
# the learning check: fresh synthetic batches, hidden 32 x 3 layers, batch 32,
# Adam lr 1e-3 on a cosine over the 200 steps, at the weight seeds 0-4 (one
# seed is no verdict: the sum-pooled head's first loss ranges over 3-300
# with the init). Rule: the median over the seeds of the mean L1 loss of
# steps 180-199 below 0.3, twice reed_tpu's worst seed on the CPU (0.0877,
# 0.1470, 0.0767, 0.0646, 0.0932 at seeds 0-4: tests/test_torch_property.py::
# test_learning_bound_is_twice_reed_tpus_worst_seed, marked slow)
PROPERTY_LEARN = dict(hidden_nf=32, n_layers=3, batch_size=32, steps=200, lr=1e-3,
                      seeds=(0, 1, 2, 3, 4))
PROPERTY_LEARN_LOSS_MAX = 0.3
# eval-conditional at MoleculeEDMConfig's width with context_node_nf 1: 64
# molecules a replicate, 50 steps (cut from T = 1000, as phase 10 cuts)
COND_EVAL = dict(n_samples=64, num_steps=50)
MOLECULE_EVAL = dict(batch=16, num_steps=50)   # eval-molecule with a test split
# a fabricated QM9 directory: the train split (EDM npz with an alpha column),
# reps.npy and sizes.npy beside it, and a test split in the .rsmol layout
PROPERTY_DATA = dict(train=480, test=200, rep_nf=256)
# the SNN product at QM9's test-split size (13,083 reference molecules) against
# 1,000 generated ones, 1,024-bit fingerprints at a Morgan-like 5 % density;
# ChemNet as FCD runs it: 2 stacked LSTMs of 512 over the 36-token one-hot at
# MAX_LEN 350, a 512-d penultimate dense layer, batch 128
SNN = dict(ref=13_083, gen=1_000, bits=1024, density=0.05)
SNN_ATOL = 1e-6
CHEMNET = dict(batch=128, hidden=512, layers=2, cpu_rows=4)
CHEMNET_RTOL = 1e-4


def property_learn_config(seed=0):
    """The learning check's PropertyTrainConfig at weight seed `seed`
    (PROPERTY_LEARN)."""
    c = PROPERTY_LEARN
    return property_train.PropertyTrainConfig(
        hidden_nf=c["hidden_nf"], n_layers=c["n_layers"], batch_size=c["batch_size"],
        seed=seed, optim=OptimConfig(lr=c["lr"], weight_decay=1e-16, schedule="cosine",
                                     warmup_steps=0, total_steps=c["steps"]))


def random_molecules(rng, n, n_min=9, n_max=29):
    """n QM9-like (positions, types) pairs: branched random walks of 1.45 A
    steps, types drawn from H, C, N, O, F."""
    out = []
    for _ in range(n):
        k = int(rng.integers(n_min, n_max + 1))
        pos = np.zeros((k, 3))
        for i in range(1, k):
            step = rng.standard_normal(3)
            pos[i] = pos[int(rng.integers(max(0, i - 3), i))] + 1.45 * step / np.linalg.norm(step)
        out.append((pos.astype(np.float32), rng.choice([0, 1, 1, 1, 2, 3, 4], size=k)))
    return out


def write_property_data(root, seed=0):
    """PROPERTY_DATA's fabricated QM9 directory under `root`."""
    from reed_tpu_torch.data.molecule import save_dataset

    rng = np.random.default_rng(seed)
    n = PROPERTY_DATA["train"]
    train = random_molecules(rng, n)
    positions = np.zeros((n, 29, 3), np.float32)
    charges = np.zeros((n, 29), np.int64)
    for i, (pos, types) in enumerate(train):
        positions[i, :len(pos)] = pos - pos.mean(0)
        charges[i, :len(pos)] = np.array([1, 6, 7, 8, 9])[types]
    num_atoms = np.array([len(p) for p, _ in train])
    alpha = (3.0 * num_atoms + rng.standard_normal(n)).astype(np.float32)
    np.savez(os.path.join(root, "train.npz"), positions=positions, charges=charges,
             num_atoms=num_atoms, alpha=alpha)
    np.save(os.path.join(root, "reps.npy"),
            rng.standard_normal((n, PROPERTY_DATA["rep_nf"])).astype(np.float32))
    np.save(os.path.join(root, "sizes.npy"), num_atoms)
    test = molsets.geometric_mols_from_samples(
        random_molecules(rng, PROPERTY_DATA["test"]), ["H", "C", "N", "O", "F"])
    save_dataset(os.path.join(root, "test.rsmol.npz"), test)
    return alpha


def property_forward_phase(smi):
    """One full-width PropertyClassifier forward (hidden 128 x 7, batch 96 x
    29 atoms) on the card against a CPU copy (and f64 beside it) on its
    first rows: to 1e-4 of the max."""
    cfg = property_train.PropertyTrainConfig()
    trainer = property_train.PropertyTrainer(cfg, device="cuda")
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(7))
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = property_train.build_model(cfg, device="cuda", generator=gen).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gen, device="cuda") * PROPERTY_BIAS_STD)
    args = [batch[k] for k in ("one_hot", "positions", "node_mask", "edge_mask")]
    rows = PROPERTY["cpu_rows"]
    with torch.no_grad():
        out = model(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu = copy.deepcopy(model).cpu()
        ref = cpu(*[a[:rows].cpu() for a in args])
        ref64 = copy.deepcopy(cpu).double()(*[a[:rows].cpu().double() for a in args])
    err, err64 = rel_err(out[:rows], ref), rel_err(ref, ref64)
    log(f"[property] full-width PropertyClassifier (hidden {cfg.hidden_nf} x {cfg.n_layers} "
        f"layers, attention; biases N(0, {PROPERTY_BIAS_STD})), f32 TF32 off, batch "
        f"{cfg.batch_size} x {cfg.max_nodes} atoms: card {card_ms:.2f} ms a forward; card vs "
        f"CPU on {rows} rows max abs err / max |out| {err:.3g} (rtol {PROPERTY_FWD_RTOL}), CPU "
        f"f32 vs f64 {err64:.3g}, max |out| {ref64.abs().max().item():.4g} ({smi})")
    if not (torch.isfinite(out).all() and err <= PROPERTY_FWD_RTOL):
        raise AssertionError(f"PropertyClassifier card vs CPU: {err}")


def property_train_phase(smi):
    """The main path: PropertyTrainer.train_step at full width, batch 96 x 29
    atoms; ms a step (wall and device), molecules/s, launches, idle share,
    peak memory and a profile by kernel family."""
    cfg = property_train.PropertyTrainConfig()
    trainer = property_train.PropertyTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
    n, steps = cfg.batch_size, PROPERTY["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PROPERTY["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernel_launches = (fa.launches, fm.launches, fm.backward_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, event_ms = 1e3 * seconds / steps, start.elapsed_time(end) / steps
    log(f"[property] PropertyTrainer.train_step, full width (hidden {cfg.hidden_nf} x "
        f"{cfg.n_layers}), f32, batch {n} x {cfg.max_nodes} atoms: {steps} steps "
        f"{wall_ms:.3f} ms per step (wall, after a sync), {event_ms:.3f} ms (CUDA events), "
        f"{n * steps / seconds:.1f} molecules/s; peak memory {peak_gb:.2f} GB; K1/K2a/K2b "
        f"launches {kernel_launches}; last loss {metrics['loss'].item():.6g}, grad_norm "
        f"{metrics['grad_norm'].item():.4g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite property train metrics {metrics}")
    if any(kernel_launches):
        raise AssertionError(f"a TPU-kernel port ran on the property path: {kernel_launches}")
    k = PROPERTY["profiled_steps"]

    def k_steps():
        nonlocal state
        for _ in range(k):
            state, _ = trainer.train_step(state, batch)

    prof = profile(f"{k} property train steps", k_steps, smi, top=10)
    busy = prof["busy_ms"] / k
    log(f"[property] per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall ({wall_ms:.3f} ms), "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} % of the profiled one")
    del trainer, state, batch
    torch.cuda.empty_cache()


def property_learning_phase(smi):
    """PROPERTY_LEARN's 200 steps on fresh synthetic batches (batch i from
    seed i) at each weight seed: the median over the seeds of the mean L1
    loss of steps 180-199 must fall below PROPERTY_LEARN_LOSS_MAX."""
    lates, firsts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for seed in PROPERTY_LEARN["seeds"]:
        trainer = property_train.PropertyTrainer(property_learn_config(seed), device="cuda")
        state = trainer.init_state()
        losses = []
        for i in range(PROPERTY_LEARN["steps"]):
            batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(i))
            state, metrics = trainer.train_step(state, batch)
            losses.append(metrics["loss"])
        losses = [x.item() for x in losses]
        firsts.append(losses[0])
        lates.append(sum(losses[-20:]) / 20)
    seconds = time.perf_counter() - t0
    median = float(np.median(lates))
    cfg = property_learn_config()
    log(f"[property] learning check (hidden {cfg.hidden_nf} x {cfg.n_layers}, batch "
        f"{cfg.batch_size}, cosine lr {cfg.optim.lr}, {PROPERTY_LEARN['steps']} steps) at "
        f"seeds {list(PROPERTY_LEARN['seeds'])}: L1 loss step 0 "
        f"{', '.join(f'{x:.4g}' for x in firsts)}; mean of steps 180-199 "
        f"{', '.join(f'{x:.4f}' for x in lates)}, median {median:.4f} (must be < "
        f"{PROPERTY_LEARN_LOSS_MAX}; reed_tpu on the CPU: median 0.0877, worst 0.1470); "
        f"{1e3 * seconds / (len(lates) * PROPERTY_LEARN['steps']):.3f} ms per step ({smi})")
    if not median < PROPERTY_LEARN_LOSS_MAX:
        raise AssertionError(f"the property loss did not fall: {firsts} -> {lates}")


def chemnet_params(gen):
    """CHEMNET's weights in nn.LSTM's layout and init (uniform on
    +-1/sqrt(hidden)), and the dense layer, from `gen` (CPU)."""
    h, bound = CHEMNET["hidden"], CHEMNET["hidden"] ** -0.5
    draw = lambda *shape: (torch.rand(shape, generator=gen) * 2 - 1) * bound  # noqa: E731
    sd = {}
    for k in range(CHEMNET["layers"]):
        d_in = chemnet.VOCAB_SIZE if k == 0 else h
        sd.update({f"lstm.weight_ih_l{k}": draw(4 * h, d_in),
                   f"lstm.weight_hh_l{k}": draw(4 * h, h),
                   f"lstm.bias_ih_l{k}": draw(4 * h), f"lstm.bias_hh_l{k}": draw(4 * h)})
    sd["dense.weight"], sd["dense.bias"] = draw(h, h), draw(h)
    return chemnet.convert_torch_chemnet(sd)


def chemnet_snn_phase(smi):
    """ChemNet's activations of a batch of 128 SMILES at MAX_LEN 350 and the
    SNN Tanimoto product (13,083 x 1,000 fingerprints), each on the card
    against the CPU, timed."""
    rng = np.random.default_rng(3)
    alphabet = ["C", "C", "C", "c", "N", "O", "(", ")", "=", "1", "2", "F", "Cl", "[nH]"]
    smiles = ["".join(rng.choice(alphabet, size=int(rng.integers(10, 60))))
              for _ in range(CHEMNET["batch"])]
    params = chemnet_params(torch.Generator().manual_seed(11))
    cuda_params = {"lstm": [{k: v.cuda() for k, v in layer.items()}
                            for layer in params["lstm"]],
                   "dense": {k: v.cuda() for k, v in params["dense"].items()}}
    one_hot = torch.from_numpy(chemnet.one_hot_smiles(smiles))
    oh = one_hot.cuda()
    acts = chemnet.chemnet_activations(cuda_params, oh)
    rows = CHEMNET["cpu_rows"]
    t0 = time.perf_counter()
    ref = chemnet.chemnet_activations(params, one_hot[:rows])
    cpu_s = time.perf_counter() - t0
    err = rel_err(acts[:rows], ref)
    ms = cuda_ms(lambda: chemnet.chemnet_activations(cuda_params, oh), iters=3, warmup=1,
                 queued=False)
    log(f"[property] ChemNet activations ({CHEMNET['layers']} LSTM layers of "
        f"{CHEMNET['hidden']}, one-hot {chemnet.VOCAB_SIZE} x {chemnet.MAX_LEN}, dense "
        f"{CHEMNET['hidden']}), f32 TF32 off, batch {CHEMNET['batch']}: {ms:.2f} ms a batch "
        f"on the card (CUDA events over 3 calls), CPU {1e3 * cpu_s:.0f} ms for {rows} rows; "
        f"card vs CPU max abs err / max |out| {err:.3g} (rtol {CHEMNET_RTOL}) ({smi})")
    if not (acts.shape == (CHEMNET["batch"], CHEMNET["hidden"]) and torch.isfinite(acts).all()
            and err <= CHEMNET_RTOL):
        raise AssertionError(f"ChemNet card vs CPU: {err}, {tuple(acts.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(17)
    ref_fp = (torch.rand((SNN["ref"], SNN["bits"]), generator=gen, device="cuda")
              < SNN["density"]).float()
    gen_fp = (torch.rand((SNN["gen"], SNN["bits"]), generator=gen, device="cuda")
              < SNN["density"]).float()
    card = molsets.average_agg_tanimoto(ref_fp, gen_fp, device="cuda")
    ref_cpu, gen_cpu = ref_fp.cpu(), gen_fp.cpu()
    t0 = time.perf_counter()
    cpu = molsets.average_agg_tanimoto(ref_cpu, gen_cpu, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    snn_ms = cuda_ms(lambda: molsets.average_agg_tanimoto(ref_fp, gen_fp, device="cuda"),
                     iters=10, warmup=2, queued=False)
    log(f"[property] SNN product {SNN['ref']} x {SNN['gen']} fingerprints of {SNN['bits']} "
        f"bits (density {SNN['density']}): {snn_ms:.3f} ms a call on the card (CUDA events "
        f"over 10 calls, the result read back), CPU {cpu_ms:.1f} ms; SNN card {card:.8f}, "
        f"CPU {cpu:.8f} (atol {SNN_ATOL}) ({smi})")
    if not abs(card - cpu) <= SNN_ATOL:
        raise AssertionError(f"SNN card {card} vs CPU {cpu}")
    del ref_fp, gen_fp
    torch.cuda.empty_cache()


def conditioned_edm_checkpoint(run):
    """A checkpoint (step 0) of MoleculeEDMConfig's model with
    context_node_nf 1 and phase 10's well-conditioned seeded weights
    (seeded_edm), as its EMA: at the init's scale the nine sum-aggregated
    blocks blow the sampled features up to inf within a few of the 50 steps,
    in reed_tpu's sampler as in the port's, so an untrained run's samples
    are NaN."""
    cfg = edm_train.MoleculeEDMConfig(context_node_nf=1)
    trainer = edm_train.MoleculeEDMTrainer(cfg, device="cuda")
    state = trainer.init_state()
    state.model.load_state_dict(seeded_edm(cfg).state_dict())
    state.ema = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    CheckpointManager(run).save(state, trainer.generator)


def read_xyz(path):
    """(comment, positions [N,3]) of an .xyz file."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0])
    return lines[1], np.array([[float(v) for v in line.split()[1:4]]
                               for line in lines[2:2 + n]])


def property_cli_phase(tmp, smi):
    """train-property (the EGNN regressor and --linear-probe) and
    train-molecule-edm --set context_node_nf=1, 3 steps each with a
    checkpoint, as subprocesses on a fabricated QM9 directory; then in this
    process eval-conditional with the trained classifier (64 molecules, 50
    steps): with --out from a conditioned checkpoint whose samples stay
    finite (.xyz files and property_values.log read back, a finite MAE), and
    with --sweep from the trained EDM run; then eval-molecule with the
    directory's test split (moses and midi in its result)."""
    data = os.path.join(tmp, "qm9")
    os.makedirs(data)
    alpha = write_property_data(data)
    clf, probe, gen, seeded = (os.path.join(tmp, name) for name in
                               ("clf", "probe", "edm_cond", "edm_cond_seeded"))
    runs = ((["train-property", "--data-dir", data], clf),
            (["train-property", "--linear-probe", "--data-dir", data], probe),
            (["train-molecule-edm", "--synthetic", "--set", "context_node_nf=1"], gen))
    labels = [" ".join(a for a in args if a != data) for args, _ in runs]
    texts = run_clis([([*args, "--steps", "3", "--log-every", "1", "--ckpt-dir", run,
                        "--ckpt-every", "3"], f"{label} --steps 3")
                      for (args, run), label in zip(runs, labels)])
    for (args, run), label, text in zip(runs, labels, texts):
        rate = [line for line in text.splitlines() if "steps after the first" in line]
        log(f"[property] {rate[-1] if rate else text.splitlines()[-1]}")
        if "3.pt" not in os.listdir(run):
            raise AssertionError(f"{label} wrote {os.listdir(run)}")
    conditioned_edm_checkpoint(seeded)
    ce = COND_EVAL
    common = ["eval-conditional", "--classifier-ckpt", clf, "--data-dir", data,
              "--n-samples", str(ce["n_samples"]), "--n-replicates", "1",
              "--num-steps", str(ce["num_steps"])]
    out_dir = os.path.join(tmp, "cond_mols")
    result, text = cli_quiet(common + ["--ckpt-dir", seeded, "--out", out_dir])
    speed = next(line for line in text.splitlines() if "molecules/s" in line)
    xyz = sorted(f for f in os.listdir(out_dir) if f.endswith(".xyz"))
    with open(os.path.join(out_dir, "property_values.log")) as f:
        targets = [float(v) for v in f.read().split()]
    mols = [read_xyz(os.path.join(out_dir, name)) for name in xyz]
    pngs = sum(f.endswith(".png") for f in os.listdir(out_dir))
    renders = "matplotlib present" if visualize.have_matplotlib() else "skipped: no matplotlib"
    log(f"[property] eval-conditional (the conditioned seeded EDM, classifier EMA of step 3, "
        f"{ce['n_samples']} molecules, T {ce['num_steps']}): {speed}; mae {result['mae']:.6g} "
        f"(untrained), mad_of_targets {result['mad_of_targets']:.4f}; {len(xyz)} .xyz, "
        f"{pngs} .png ({renders}), max |x| {max(np.abs(x).max() for _, x in mols):.4g} ({smi})")
    if ("loaded EMA weights of step 0" not in text
            or f"loaded EMA weights of step 3 from {clf}" not in text
            or len(xyz) != ce["n_samples"] or len(targets) != ce["n_samples"]
            or [c for c, _ in mols] != [f"alpha={t:.4f}" for t in targets]
            or not all(np.isfinite(x).all() for _, x in mols)
            or not np.isfinite(result["mae"])):
        raise AssertionError(f"eval-conditional:\n{text[-2000:]}")
    result, text = cli_quiet(common + ["--ckpt-dir", gen, "--sweep"])
    rows = result["sweep"]
    swept = [r["target"] for r in rows]
    blown = "" if np.isfinite(result["mae"]) else (
        ": the init's samples blow up at this width, in reed_tpu's sampler as in the port's")
    log(f"[property] eval-conditional --sweep (the EMA of the 3-step run): targets "
        f"{swept[0]:.3f} .. {swept[-1]:.3f} in {len(rows)} steps, mae {result['mae']:.6g}"
        f"{blown}")
    if (f"loaded EMA weights of step 3 from {gen}" not in text
            or len(rows) != ce["n_samples"] or swept != sorted(swept)
            or abs(swept[0] - float(alpha.min())) > 1e-4
            or abs(swept[-1] - float(alpha.max())) > 1e-4):
        raise AssertionError(f"eval-conditional --sweep: {swept[:3]} .. {swept[-3:]}")
    me = MOLECULE_EVAL
    result, text = cli_quiet(["eval-molecule", "--data-dir", data, "--batch-size",
                              str(me["batch"]), "--num-steps", str(me["num_steps"]),
                              "--n-replicates", "1"])
    speed = next(line for line in text.splitlines() if "molecules/s" in line)
    log(f"[property] eval-molecule with a {PROPERTY_DATA['test']}-molecule test split "
        f"(seeded init weights, {me['batch']} molecules, T {me['num_steps']}): {speed}; "
        f"moses {result.get('moses')}; midi {result.get('midi')} ({smi})")
    if not ({"moses", "midi"} <= set(result) and "SNN/Test" in result["moses"]
            and "AtomTypesTV" in result["midi"]):
        raise AssertionError(f"eval-molecule without moses/midi: {sorted(result)}")


def property_phases(smi):
    """Slice 13's phases. K1, K2a and K2b must launch 0 times on them."""
    t0 = time.perf_counter()
    fa.launches = fm.launches = fm.backward_launches = 0
    property_forward_phase(smi)
    property_train_phase(smi)
    property_learning_phase(smi)
    chemnet_snn_phase(smi)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        property_cli_phase(tmp, smi)
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[property] slice 13 phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b "
        f"launches on the property and eval paths {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the property and eval paths: {counts}")


# -- slice 14: reward-guided protein sampling, SemlaFlow's EGNN and EQGAT,
# the rep encoders with precompute_mol_reps, --profile-dir -----------------

# the default ProteinTrainConfig's model on seeded weights at 8 x 256, f32;
# 10 guided steps (num_timesteps 500 cut to 11); the Gumbel sampler's relaxed
# steps are the last truncate_steps - 1 of them (reed_tpu's rule). Sampling
# temperature 1, as reed_tpu's reward-guided tests sample: at the default
# 0.1 the draws of seeded weights are the argmax, and every sampler then
# writes the plain sampler's sequences
GUIDED = dict(batch=8, length=256, num_timesteps=11, truncate_steps=3, alpha=0.5, temp=1.0)
# the recipe's widths (d_model 384, 12 layers, d_edge 128, d_rep 512,
# self-conditioning) at the Semla phase's GEOM scale, 56 x 72; 10 timed steps
ALT = dict(warmup_steps=2, timed_steps=10, profiled_steps=2, cpu_rows=8)
ALT_FWD_RTOL = 1e-4  # card vs CPU, f32 with TF32 off
# the checked alternative generators: N(0, 0.02) on the initialisation but
# the coordinate heads (EGNN's phi_x_fc3 keeps reed_tpu's 1e-6-variance
# init, EQGAT's coord_head its lecun init) and EQGAT's vector- and
# direction-gate rows of msg_fc2 scaled by 0.1. At N(0, 0.02) everywhere
# the EGNN's coordinates overflow to NaN within 12 layers and the EQGAT's
# vector channels grow ~70-fold a layer, f32 landing 3e-4 from f64 (CPU);
# so set, f32 is within 1.6e-6 (EGNN) and 3.6e-6 (EQGAT) of f64 on the CPU
# and 1e-4 between card and CPU bounds the port, not the conditioning
ALT_EQUI_GATE_SCALE = 0.1
# compute_dtype bfloat16 card vs the port's bf16 forward on the CPU: each
# output within ALT_BF16_RTOL of its largest (the CPU test's bound against
# reed_tpu's bf16 forward, tests/test_torch_semla_alt.py), or where bf16
# itself moves an output more, within ALT_BF16_JITTER_FACTOR x the CPU
# forward's move when every weight is jittered by a relative ALT_BF16_JITTER
# (a quarter of bf16's resolution): at the recipe's width EQGAT's
# coordinates read 0.0798 card vs CPU on an H100, and on this sandbox's CPU
# the same bf16 forward moved 0.0278 with one thread instead of eight and
# 0.0378 under the jitter (f32 moves them ~1e-6); and at least
# ALT_BF16_APART x the CPU bf16 forward's distance from the f32 forward
# away from it; ALT_BF16_STEPS timed bf16 train steps after one untimed
ALT_BF16_RTOL = 5e-2
ALT_BF16_JITTER = 1e-3
ALT_BF16_JITTER_FACTOR = 2.0
ALT_BF16_APART = 0.2
ALT_BF16_STEPS = 3
# learning check: the Semla gate's chains and reps (cross-attention in every
# layer) at d_model 64, 3 layers, batch 32, 100 steps (cut from 200 in PR
# 23: at step 100 the card read EGNN 2.99 -> 0.342, EQGAT 3.35 -> 0.427;
# H100 80GB HBM3, 700.00 W): the mean denoising loss of the last 20 steps
# must be below ALT_LEARN_FALL of steps 0-4's (the port on the CPU over
# 200 steps: EGNN 1.88 -> 0.449, EQGAT 3.54 -> 0.370)
ALT_LEARN = dict(batch=32, d_model=64, layers=3, steps=100)
ALT_LEARN_FALL = 0.5
# UniMolGlobal() and FradEncoder() at their defaults on 64 GEOM-sized
# molecules (36-72 atoms padded to 72: 74 UniMol tokens); card vs CPU on 8
# rows (f32, TF32 off; f32 is within 7.3e-7 (UniMol) and 1.2e-7 (Frad) of
# f64 on the CPU); precompute_mol_reps over 256 such molecules
ENC = dict(batch=64, atoms=72, cpu_rows=8, molecules=256)
ENC_RTOL = 1e-4


def guided_phase(smi):
    """Reward-guided sampling through K2a/K2b: the decoder of the default
    ProteinMPNN-FMIF over an encoder state computed once (a closure of this
    script; the guidance gradient runs through the decoder's message
    chains), a seeded linear reward of the expected logits. One guidance
    gradient with the kernels against the unfused chain; then CG, SMC, TDS
    and the Gumbel sampler with a backward to the weights, each with the
    launch counts set to 0 just before it and read just after."""
    from reed_tpu_torch.diffusion import discrete as dd

    gen = torch.Generator(device="cuda").manual_seed(11)
    cfg = ProteinTrainConfig()
    model = build_model(cfg, device="cuda", generator=gen)
    perturb_pmpnn(model, gen)
    b, l, v = GUIDED["batch"], GUIDED["length"], cfg.interpolant.num_tokens
    mask_id, n_dec = cfg.interpolant.mask_index, cfg.num_decoder_layers
    batch = synthetic_protein_batch(gen, b, l)
    args = [batch[k] for k in ("X", "S", "mask", "chain_M", "residue_idx",
                               "chain_encoding_all")]
    with torch.no_grad():
        enc = model(*args, return_enc=True)

    def logits_fn(s, cls):
        return model(args[0], s, *args[2:], enc_state=enc)

    w = torch.randn(v, generator=gen, device="cuda")

    def reward_fn(x):
        return (x @ w).mean(dim=-1)

    def reward_of(tokens):
        return reward_fn(F.one_hot(tokens.long(), v).float()).mean().item()

    keep = torch.rand((b, l), generator=gen, device="cuda") < 0.5
    onehot = F.one_hot(torch.where(keep, batch["S"], mask_id).long(), v).float()
    grads, counts = {}, {}
    for fused in (True, False):
        model.fused = fused
        fm.launches = fm.backward_launches = 0
        grads[fused] = dd.reward_gradient(logits_fn, reward_fn, onehot)
        torch.cuda.synchronize()
        counts[fused] = (fm.launches, fm.backward_launches)
    model.fused = True
    g_err = rel_err(grads[True], grads[False])
    log(f"[guided] one guidance gradient d mean R / d onehot at {b} x {l} (half the tokens "
        f"masked), kernels vs unfused chain: max err / max |g| {g_err:.3g} (rtol "
        f"{TRAIN_GRAD_RTOL}, the train step's bound), max |g| "
        f"{grads[False].abs().max().item():.3g}; launches K2a/K2b {counts[True]} fused, "
        f"{counts[False]} unfused")
    if not (g_err <= TRAIN_GRAD_RTOL and torch.isfinite(grads[True]).all()
            and counts[True] == (n_dec, n_dec) and counts[False] == (0, 0)):
        raise AssertionError(f"guidance gradient: err {g_err}, launches {counts}")

    interp = dataclasses.replace(cfg.interpolant, num_timesteps=GUIDED["num_timesteps"],
                                 temp=GUIDED["temp"])
    steps = interp.num_timesteps - 1
    # the guidance scale that makes the largest log tilt 1 at the checked state
    scale = 1.0 / (grads[True] - grads[True][..., mask_id:mask_id + 1]).abs().max().item()
    soft = GUIDED["truncate_steps"] - 1
    names, params = zip(*model.named_parameters())
    seeded = lambda k: torch.Generator(device="cuda").manual_seed(k)  # noqa: E731

    def gumbel():
        x = dd.gumbel_softmax_sampler(logits_fn, (b, l), interp, GUIDED["truncate_steps"],
                                      generator=seeded(1), device="cuda")
        g = torch.autograd.grad(reward_fn(x).mean(), params, allow_unused=True)
        return torch.argmax(x, dim=-1).to(torch.int32), g

    samplers = {
        "CG": (lambda: dd.euler_unmask_sampler_controlled_cg(
            logits_fn, reward_fn, (b, l), interp, guidance_scale=scale, generator=seeded(1),
            device="cuda"), (2 * n_dec * steps, n_dec * steps)),
        "SMC": (lambda: dd.euler_unmask_sampler_controlled_smc(
            logits_fn, reward_fn, (b, l), interp, alpha=GUIDED["alpha"], generator=seeded(1),
            device="cuda"), (2 * n_dec * steps, 0)),
        "TDS": (lambda: dd.euler_unmask_sampler_controlled_smc(
            logits_fn, reward_fn, (b, l), interp, alpha=GUIDED["alpha"], guidance_scale=scale,
            generator=seeded(1), device="cuda"), (3 * n_dec * steps, n_dec * steps)),
        "Gumbel": (gumbel, (n_dec * steps, n_dec * soft)),
    }
    settings = {"CG": f"guidance scale {scale:.4g}", "SMC": f"alpha {GUIDED['alpha']}",
                "TDS": f"guidance scale {scale:.4g}, alpha {GUIDED['alpha']}",
                "Gumbel": f"truncate_steps {GUIDED['truncate_steps']}"}
    valid = batch["mask"].bool()
    with torch.no_grad():
        _, plain = sample(model, batch, seeded(1), interp)
    totals, ms = [0, 0], {}
    for name, (fn, expect) in samplers.items():
        fn()
        torch.cuda.synchronize()
        fm.launches = fm.backward_launches = fa.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counted = (fm.launches, fm.backward_launches)
        totals = [totals[0] + counted[0], totals[1] + counted[1]]
        ms[name] = 1e3 * seconds / steps
        tokens = out[1] if name != "Gumbel" else out[0]
        log(f"[guided] {name} ({settings[name]}): {steps} steps at {b} x {l}, "
            f"{ms[name]:.3f} ms a step "
            f"({'with the backward to the weights' if name == 'Gumbel' else 'guided'}); "
            f"launches K2a {counted[0]}, K2b {counted[1]} (expected {expect}), K1 "
            f"{fa.launches}; mean reward of the sequences {reward_of(tokens):.4f} (plain "
            f"Euler {reward_of(plain):.4f}; not bounded), "
            f"{(tokens != plain)[valid].float().mean().item():.3f} of the tokens differ from "
            f"plain Euler's from the same generator seed ({smi})")
        if counted != expect or fa.launches:
            raise AssertionError(f"{name}: launches {counted}, expected {expect}")
        if (tokens[valid] == mask_id).any():
            raise AssertionError(f"{name}: mask tokens left at valid positions")
        if name == "CG" and (tokens == plain)[valid].all():
            raise AssertionError("CG: the guidance changed no draw of plain Euler's")
        if name == "Gumbel":
            # the message chains' weights, whose gradients K2b computes
            dec = [g for n, g in zip(names, out[1])
                   if re.fullmatch(r"decoder_layers\.\d+\.W[123]\.weight", n)]
            if not (len(dec) == 3 * n_dec and all(
                    g is not None and torch.isfinite(g).all() and g.abs().max() > 0
                    for g in dec)):
                raise AssertionError("Gumbel: the decoder's message weights got no gradient")
    log(f"[guided] K2a {totals[0]} and K2b {totals[1]} launches over the four samplers")
    return dict(k2a=totals[0], k2b=totals[1], ms=ms)


def seeded_alt(cfg, seed=5):
    """The alternative generator of `cfg` on seeded weights (ALT_EQUI_GATE_SCALE)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = semla_train.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not re.search(r"phi_x_fc3|coord_head", name):
                p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
        if cfg.arch == "eqgat":
            for layer in model.layers:
                layer.msg_fc2.weight[cfg.d_model:] *= ALT_EQUI_GATE_SCALE
                layer.msg_fc2.bias[cfg.d_model:] *= ALT_EQUI_GATE_SCALE
    return model


def alt_forward_phase(arch, smi):
    """The recipe-width generator on the card against its CPU copy on the
    first rows of a GEOM-scale batch, after a first pass that gives the
    self-conditioning inputs; the CPU in f32 against f64 beside it; then the
    same weights and inputs in bf16, the card against the port's bf16 CPU
    forward (ALT_BF16_RTOL, ALT_BF16_APART). The rep goes in as the trainer
    passes it (none: the recipe's cond_type is none)."""
    cfg = semla_full_config(arch=arch)
    batch = semla_train.batch_to_device(
        semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=7), "cuda")
    state, times = batch["interpolated"], batch["times"]
    rep = batch["rep"] if cfg.cond_type != "none" else None
    rows = ALT["cpu_rows"]
    model = seeded_alt(cfg).eval()
    with torch.no_grad():
        zero = semla_train._zero_cond(state)
        c, tl, bl, _, _ = semla_train._apply(model, cfg, state, times, zero, rep)
        cond = {"coords": c, "atomics": torch.softmax(tl, -1), "bonds": torch.softmax(bl, -1)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = semla_train._apply(model, cfg, state, times, cond, rep)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        refs = {}
        for dt in (torch.float32, torch.float64):
            cpu = copy.deepcopy(model).cpu().to(dt)
            cpu.compute_dtype = dt
            sub = {k: v[:rows].cpu().to(dt) for k, v in state.items()}
            subc = {k: v[:rows].cpu().to(dt) for k, v in cond.items()}
            refs[dt] = semla_train._apply(cpu, cfg, sub, times[:rows].cpu().to(dt), subc, None)
    names = ["coords", "type_logits", "bond_logits", "charge_logits"]
    names += [f"zs[{i}]" for i in range(len(out[4]))]
    flat = lambda o: list(o[:4]) + list(o[4])  # noqa: E731
    errs = {n: rel_err(a[:rows], b) for n, a, b in zip(names, flat(out), flat(refs[torch.float32]))}
    errs64 = {n: rel_err(a, b) for n, a, b in zip(names, flat(refs[torch.float32]),
                                                   flat(refs[torch.float64]))}
    # compute_dtype bfloat16 from the same weights and inputs: the card
    # against the port's bf16 forward on the CPU, and both beside the f32
    # forward (CPU), so that a card path computing in f32 fails
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model16 = semla_train.build_model(cfg16, device="cuda").eval()
    model16.load_state_dict(model.state_dict())
    with torch.no_grad():
        out16 = semla_train._apply(model16, cfg16, state, times, cond, rep)
        sub = {k: v[:rows].cpu() for k, v in state.items()}
        subc = {k: v[:rows].cpu() for k, v in cond.items()}
        cpu16 = copy.deepcopy(model16).cpu()
        ref16 = semla_train._apply(cpu16, cfg16, sub, times[:rows].cpu(), subc, None)
        # the witness: the same CPU forward from weights moved by a relative
        # ALT_BF16_JITTER, a quarter of bf16's resolution
        gen = torch.Generator().manual_seed(11)
        for p in cpu16.parameters():
            p.mul_(1 + ALT_BF16_JITTER * torch.randn(p.shape, generator=gen))
        jit16 = semla_train._apply(cpu16, cfg16, sub, times[:rows].cpu(), subc, None)
    del model16, cpu16
    bf16 = {}
    for n, a, b, j, f in zip(names[:4], out16[:4], ref16[:4], jit16[:4],
                             refs[torch.float32][:4]):
        a, b, j, f = a[:rows].float().cpu(), b.float(), j.float(), f.float()
        top = b.abs().max()
        bf16[n] = dict(err=float((a - b).abs().max() / top),
                       jitter=float((j - b).abs().max() / top),
                       f32=float((b - f).abs().max() / top),
                       apart=float((a - f).abs().max() / (b - f).abs().max()))
        bf16[n]["bound"] = max(ALT_BF16_RTOL, ALT_BF16_JITTER_FACTOR * bf16[n]["jitter"])
    pad = state["mask"] == 0
    fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())  # noqa: E731
    pick = lambda key: fmt({k: v[key] for k, v in bf16.items()})  # noqa: E731
    log(f"[{arch}] bf16 forward (compute_dtype bfloat16, the same weights and inputs) card "
        f"vs the port's bf16 CPU forward on {rows} rows: max abs err / max |out| "
        f"{pick('err')} (bound {pick('bound')}: {ALT_BF16_RTOL}, or "
        f"{ALT_BF16_JITTER_FACTOR}x the CPU forward's move under a {ALT_BF16_JITTER} weight "
        f"jitter, {pick('jitter')}); the CPU bf16 forward's distance from f32 {pick('f32')}; "
        f"the card's distance from f32 over it {pick('apart')} (at least {ALT_BF16_APART}) "
        f"({smi})")
    if not (all(v["err"] <= v["bound"] and v["apart"] >= ALT_BF16_APART
                for v in bf16.values()) and all(torch.isfinite(t).all() for t in out16[:4])):
        raise AssertionError(f"{arch} bf16 card vs CPU: {bf16}")
    log(f"[{arch}] full-width forward (d_model {cfg.d_model}, {cfg.n_layers} layers, d_edge "
        f"{cfg.d_edge}, d_rep {cfg.d_rep}, self-conditioning; batch {SEMLA['batch']} x "
        f"{SEMLA['atoms']}, {int(pad.sum())} padded) card vs CPU on {rows} rows: max abs err "
        f"/ max |out| {fmt(errs)} (rtol {ALT_FWD_RTOL}); CPU f32 vs f64 {fmt(errs64)}; "
        f"max |coords| {out[0].abs().max().item():.3g}; card {card_ms:.1f} ms ({smi})")
    n_zs = (sum(d < cfg.n_layers for d in cfg.align_depth)
            if arch == "egnn" and cfg.rep_alignment else 0)
    if not (len(out[4]) == n_zs and all(e <= ALT_FWD_RTOL for e in errs.values())
            and all(torch.isfinite(t).all() for t in out[:4]) and (out[0][pad] == 0).all()):
        raise AssertionError(f"{arch} card vs CPU: {errs}")


def alt_train_phase(arch, smi):
    """The main path: SemlaTrainer.train_step with arch egnn / eqgat at the
    recipe's width on the GEOM-scale batch; ms a step (wall and CUDA
    events), molecules/s, peak memory, launches, idle share; then
    ALT_BF16_STEPS bf16 steps (compute_dtype bfloat16), timed beside f32."""
    cfg = semla_full_config(arch=arch)
    trainer = semla_train.SemlaTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = semla_train.batch_to_device(
        semla_train.example_batch(cfg, SEMLA["batch"], SEMLA["atoms"], seed=1), "cuda")
    n, steps = SEMLA["batch"], ALT["timed_steps"]
    torch.cuda.reset_peak_memory_stats()
    for i in range(ALT["warmup_steps"]):
        state, metrics = trainer.train_step(state, batch, use_sc=bool(i % 2))
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (fa.launches, fm.launches, fm.backward_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms = 1e3 * seconds / steps
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[{arch}] SemlaTrainer.train_step, recipe width ({n_params / 1e6:.2f} M parameters), "
        f"f32, batch {n} x {SEMLA['atoms']}: {steps} steps {wall_ms:.3f} ms per step (wall, "
        f"after a sync), {start.elapsed_time(end) / steps:.3f} ms (CUDA events), "
        f"{n * steps / seconds:.2f} molecules/s; peak memory {peak_gb:.2f} GB; K1/K2a/K2b "
        f"launches {counts}; last loss {metrics['loss'].item():.6g}, proj "
        f"{metrics['proj_loss'].item():.4g}, grad_norm {metrics['grad_norm'].item():.4g} "
        f"({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite {arch} train metrics {metrics}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the {arch} path: {counts}")
    k = ALT["profiled_steps"]

    def k_steps():
        nonlocal state
        for i in range(k):
            state, _ = trainer.train_step(state, batch, use_sc=bool(i % 2))

    prof = profile(f"{k} {arch} train steps (self-conditioning on 1)", k_steps, smi, top=8)
    busy = prof["busy_ms"] / k
    log(f"[{arch}] per step: device {busy:.3f} ms (kernel time, profiled), "
        f"{prof['launches'] / k:.0f} launches; device idle "
        f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled wall ({wall_ms:.3f} ms)")
    del trainer, state
    torch.cuda.empty_cache()
    # the bf16 train step (compute_dtype bfloat16 over f32 master weights)
    f32_ms = start.elapsed_time(end) / steps
    trainer = semla_train.SemlaTrainer(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                                       device="cuda")
    state = trainer.init_state()
    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    n16 = ALT_BF16_STEPS
    start.record()
    t0 = time.perf_counter()
    for _ in range(n16):
        state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    bf16_wall = 1e3 * (time.perf_counter() - t0) / n16
    bf16_ms = start.elapsed_time(end) / n16
    counts = (fa.launches, fm.launches, fm.backward_launches)
    log(f"[{arch}] bf16 SemlaTrainer.train_step (compute_dtype bfloat16), batch {n} x "
        f"{SEMLA['atoms']}: {n16} steps {bf16_ms:.3f} ms per step (CUDA events), "
        f"{bf16_wall:.3f} ms (wall); f32 here {f32_ms:.3f} ms (CUDA events), "
        f"{busy:.3f} ms device (profiled); K1/K2a/K2b launches {counts}; last loss "
        f"{metrics['loss'].item():.6g} ({smi})")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite {arch} bf16 train metrics {metrics}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the {arch} bf16 path: {counts}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, peak_gb=peak_gb, busy_ms=busy,
                launches=prof["launches"] / k, bf16_ms=bf16_ms)


def alt_learning_phase(arch, smi):
    """ALT_LEARN on the Semla gate's data: the loss must fall."""
    gcfg = dataclasses.replace(convergence_semla.gate_config(
        seed=0, batch_size=ALT_LEARN["batch"], d_model=ALT_LEARN["d_model"],
        layers=ALT_LEARN["layers"], steps=ALT_LEARN["steps"]), arch=arch)
    data = convergence_semla.GateData(ALT_LEARN["batch"])
    trainer = semla_train.SemlaTrainer(gcfg, device="cuda")
    state = trainer.init_state()
    losses = []
    t0 = time.perf_counter()
    for batch in convergence_semla.gate_batches(data, ALT_LEARN["steps"], torch.device("cuda")):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["denoising_loss"])
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    first, late = sum(losses[:5]) / 5, sum(losses[-20:]) / 20
    log(f"[{arch}] learning check (Semla gate chains, adaLN reps, d_model "
        f"{gcfg.d_model}, {gcfg.n_layers} layers, batch {gcfg.batch_size}): denoising loss "
        f"mean of steps 0-4 {first:.4f}, step {len(losses) // 2} "
        f"{losses[len(losses) // 2]:.4f}, mean of steps "
        f"{len(losses) - 20}-{len(losses) - 1} {late:.4f} (must be < {ALT_LEARN_FALL} x "
        f"the first); {1e3 * seconds / len(losses):.3f} ms per step ({smi})")
    if not late < ALT_LEARN_FALL * first:
        raise AssertionError(f"the {arch} loss did not fall: {first} -> {late}")


def alt_cli_phase(tmp, arch, smi):
    """train-molecule-semla and eval-semla with the recipe and --set
    arch=ARCH as subprocesses: 2 synthetic steps with a checkpoint, then 16
    molecules from its EMA at max_atoms 256 in 10 integrator steps."""
    run, out = f"{tmp}/{arch}_run", f"{tmp}/{arch}_mols"
    arch_set = ["--config", RECIPE_SEMLA, "--set", f"arch={arch}"]
    text, eval_text = run_clis([
        (["train-molecule-semla", *arch_set, "--synthetic", "--steps", "2", "--log-every",
          "1", "--ckpt-dir", run, "--ckpt-every", "2"],
         f"train-molecule-semla --set arch={arch} --steps 2"),
        (["eval-semla", *arch_set, "--ckpt-dir", run, "--n-samples",
          str(SEMLA_EVAL["n_samples"]), "--n-replicates", "1", "--num-steps",
          str(SEMLA_EVAL["num_steps"]), "--out", out],
         f"eval-semla --set arch={arch} --n-samples 16 --num-steps 10")])
    rate = [line for line in text.splitlines() if "steps after the first" in line]
    log(f"[{arch}] {rate[-1] if rate else text.splitlines()[-1]}")
    if "2.pt" not in os.listdir(run):
        raise AssertionError(f"train-molecule-semla arch={arch} wrote {os.listdir(run)}")
    text = eval_text
    lines = text.strip().splitlines()
    summary = json.loads(lines[-1])
    speed = next(line for line in lines if "molecules/s" in line)
    xyz = sorted(f for f in os.listdir(out) if f.endswith(".xyz"))
    log(f"[{arch}] eval-semla (recipe, EMA of step 2, max_atoms 256): {speed}; {len(xyz)} "
        f".xyz files; validity {summary['validity']} (2 training steps: ~0 expected) ({smi})")
    if len(xyz) != SEMLA_EVAL["n_samples"] or "loaded EMA weights of step 2" not in text:
        raise AssertionError(f"eval-semla arch={arch}: {len(xyz)} .xyz files\n{text[-2000:]}")


def geom_molecules(rng, n, n_min=36, n_max=72):
    """n GEOM-sized molecules (the first of n_max atoms): branched random
    walks of 1.45 A steps, types drawn from the vocabulary's atoms."""
    from reed_tpu_torch.data.molecule import GeometricMol

    out = []
    for i in range(n):
        k = n_max if i == 0 else int(rng.integers(n_min, n_max + 1))
        pos = np.zeros((k, 3))
        for j in range(1, k):
            step = rng.standard_normal(3)
            pos[j] = pos[int(rng.integers(max(0, j - 3), j))] + 1.45 * step / np.linalg.norm(step)
        out.append(GeometricMol(pos.astype(np.float32),
                                rng.choice([2, 3, 3, 3, 4, 5, 6, 8, 9], size=k).astype(np.int32),
                                np.zeros((0, 2), np.int32), np.zeros((0,), np.int32)))
    return out


def encoders_phase(tmp, smi):
    """UniMolGlobal() and FradEncoder() at their defaults on seeded weights:
    64 GEOM-sized molecules on the card against the CPU, timed; then
    precompute_mol_reps as a subprocess over a fabricated .rsmol (the seeded
    UniMol saved as a reference checkpoint), its reps against this
    process's, and one train-molecule-semla step that reads them."""
    from reed_tpu_torch.data.molecule import build_vocab, save_dataset
    from reed_tpu_torch.encoders.torchmd_et import FradEncoder
    from reed_tpu_torch.encoders.unimol import UniMolGlobal
    from reed_tpu_torch.tools import precompute_mol_reps as prep

    rng = np.random.default_rng(14)
    gen = torch.Generator(device="cuda").manual_seed(14)
    mols = geom_molecules(rng, ENC["molecules"])
    batch, rows, n = mols[:ENC["batch"]], ENC["cpu_rows"], ENC["batch"]
    with torch.device("cuda"):
        encoders = {"UniMolGlobal": (UniMolGlobal().initialize_weights(gen).eval(),
                                     prep.unimol_inputs(batch, ENC["atoms"])),
                    "Frad": (FradEncoder().initialize_weights(gen).eval(),
                             prep.frad_inputs(batch, ENC["atoms"], build_vocab().tokens))}
    for name, (model, arrays) in encoders.items():
        model.requires_grad_(False)
        x = [torch.from_numpy(np.asarray(a)).cuda() for a in arrays]
        with torch.no_grad():
            out = model(*x)
            ref = copy.deepcopy(model).cpu()(*(a[:rows].cpu() for a in x))
        err = rel_err(out[:rows], ref)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model(*x), iters=5, warmup=1, queued=False)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[encoders] {name} ({n_params / 1e6:.2f} M parameters) at its defaults, {n} "
            f"molecules x {x[0].shape[1]} tokens: card vs CPU on {rows} rows max abs err / "
            f"max |rep| {err:.3g} (rtol {ENC_RTOL}), rep {tuple(out.shape)}; {ms:.3f} ms a "
            f"batch, {1e3 * n / ms:.1f} molecules/s; peak memory {peak:.2f} GB ({smi})")
        if not (err <= ENC_RTOL and torch.isfinite(out).all() and out.shape[0] == n):
            raise AssertionError(f"{name} card vs CPU: {err}")

    unimol = encoders["UniMolGlobal"][0]
    data_dir = f"{tmp}/geom"
    os.makedirs(data_dir)
    save_dataset(f"{data_dir}/train.rsmol", mols)
    torch.save({"model": {k: v.cpu() for k, v in unimol.state_dict().items()}},
               f"{tmp}/unimol.pt")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "reed_tpu_torch.tools.precompute_mol_reps",
                           "--data", f"{data_dir}/train.rsmol.npz", "--weights",
                           f"{tmp}/unimol.pt", "--encoder", "unimol"],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"precompute_mol_reps exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    reps = np.load(f"{data_dir}/reps.npy")
    sizes = np.load(f"{data_dir}/sizes.npy")
    with torch.no_grad():
        mine = unimol(*(torch.from_numpy(np.asarray(a)).cuda()
                        for a in prep.unimol_inputs(batch, ENC["atoms"]))).cpu()
    err = rel_err(torch.from_numpy(reps[:n]), mine)
    speed = next(line for line in proc.stdout.splitlines() if "molecules/s" in line)
    log(f"[encoders] precompute_mol_reps (subprocess, {time.perf_counter() - t0:.1f} s): "
        f"{speed}; reps.npy {reps.shape}, its first batch against this process's max abs "
        f"err / max |rep| {err:.3g}")
    if not (reps.shape == (ENC["molecules"], 512) and np.isfinite(reps).all() and err <= 1e-5
            and list(sizes) == [m.seq_length for m in mols]):
        raise AssertionError(f"precompute_mol_reps: {reps.shape}, err {err}")
    (text,) = run_clis([(["train-molecule-semla", "--config", RECIPE_SEMLA, "--data-dir",
                          data_dir, "--dataset", "geom", "--steps", "1", "--log-every", "1"],
                         "train-molecule-semla --data-dir (reps.npy) --steps 1")])
    step = [line for line in text.splitlines() if line.startswith("[step 1]")]
    log(f"[encoders] train-molecule-semla on the fabricated GEOM split with its reps.npy: "
        f"{step[0][:160] if step else text[-300:]}")
    if not step or f"loaded {ENC['molecules']} molecules" not in text or "no reps.npy" in text:
        raise AssertionError(f"train-molecule-semla did not read reps.npy:\n{text[-2000:]}")


def profile_dir_phase(tmp, smi):
    """train-protein --steps 10 --profile-dir as a subprocess: the Chrome
    trace of steps 2-7 exists and names K2a's and K2b's kernels."""
    trace_dir = f"{tmp}/trace"
    run_clis([(["train-protein", "--steps", "10", "--synthetic", "--log-every", "5",
                "--profile-dir", trace_dir], "train-protein --steps 10 --profile-dir")])
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2a = sum("fused_message_fwd_kernel" in e["name"] for e in kernels)
    k2b = sum("fused_message_bwd_kernel" in e["name"] for e in kernels)
    traced = sum(e.get("name") == "reed::train_step" and e.get("cat") == "user_annotation"
                 for e in events)
    log(f"[profile-dir] {files} ({os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6:.1f}"
        f" MB): {len(kernels)} kernel events, K2a {k2a}, K2b {k2b}, reed::train_step ranges "
        f"{traced} ({smi})")
    if files != ["steps_2-7.pt.trace.json"] or not (k2a and k2b):
        raise AssertionError(f"--profile-dir: {files}, K2a {k2a}, K2b {k2b}")


def slice14_phases(smi):
    """Slice 14's phases. K2a and K2b run on the guided path and in the
    traced train-protein; K1, K2a and K2b launch 0 times on the others."""
    t0 = time.perf_counter()
    guided = guided_phase(smi)
    fa.launches = fm.launches = fm.backward_launches = 0
    alt = {}
    for arch in ("egnn", "eqgat"):
        alt_forward_phase(arch, smi)
        alt[arch] = alt_train_phase(arch, smi)
        alt_learning_phase(arch, smi)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for arch in ("egnn", "eqgat"):
            alt_cli_phase(tmp, arch, smi)
        encoders_phase(tmp, smi)
        counts = (fa.launches, fm.launches, fm.backward_launches)
        profile_dir_phase(tmp, smi)
    log(f"[slice14] phases in {time.perf_counter() - t0:.1f} s; K1/K2a/K2b launches on the "
        f"EGNN, EQGAT and encoder paths {counts}")
    if any(counts):
        raise AssertionError(f"a TPU-kernel port ran on the EGNN / EQGAT / encoder paths: "
                             f"{counts}")
    return guided


# -- slice 16: data parallelism over torch.distributed -------------------------

DP = dict(steps=2, timed_steps=5, world=2, image_global_batch=16, timeout=900)
# phase 15's model-parallel axes (slice 18), each at size DP['world']
MP_AXES = ("tensor", "seq")
# (c) train-image through torchrun at the model-parallel axes
TORCHRUN_IMAGE = ("--model", "SiT-XL/2", "--batch-size", "16")
DP_GEN = dict(GEN, batch_size=16)  # one batch of 16, 8 a rank
# the 2-rank protein step against the one-process step at the global batch
# differs by the order of its sums alone (two partial sums of 4 rows where
# one process sums 8): read 1.96e-5 of the largest gradient on an H100
# (the witness, the same order in one process, reads as much); the
# collectives themselves are held to the witness at RESUME_NOISE_FACTOR
DP_ORDER_GRAD_RTOL = 1e-4
DP_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# the bf16 protein step at tensor=2 against the one-process f32 step, in
# multiples of the one-process bf16 step's distance from it: the split
# chain rounds once after its f32 sum over the ranks, as one process
# rounds once in the kernel, so the two bf16 steps sit at one distance
# from f32 up to which elements round the other way
PROTEIN_TP_BF16_FACTOR = 2.0
# slice 20-21: SemlaFlow, the EGNN family, MultiFlow and the RDM at tensor=2,
# each at full width from its checked weights (seeded_semla, seeded_edm, the
# property phase's moved biases, seeded_flow_model, seeded_rdm) in the dtypes
# its trainer has, and the models that run whole on every tensor rank (SemlaFlow's
# egnn and eqgat archs from seeded_alt, the property linear probe): one step
# held against one process, a second timed; SemlaFlow and its other archs take
# their self-conditioning pass on the first. f32: metrics within
# TRAIN_METRIC_RTOL and each gradient within phase 15's order rule,
# DP_ORDER_GRAD_RTOL (1e-4) of the step's largest, the one-process step's
# distance from the same step with the model and batch promoted to f64 logged
# for the families of MOL_TP_F64. SemlaFlow alone (MOL_TP_F64_RULE) is held to
# the f64 rule instead: the whole gradient within MOL_TP_F64_FACTOR x the
# one-process f32 step's distance (L2) from the f64 step, and each gradient
# within MOL_TP_GRAD_TOP of the step's largest. The order rule assumes f32's
# own rounding sits below it; at SemlaFlow's width it does not: on an H100 the
# tensor=2 step read 2.99e-4 of the largest gradient from one process at
# dynamics.coord_proj.weight (the coordinate input projection, which every
# coordinate path feeds), and on the CPU one process's own f32 gradient sits
# 1.7e-4 from f64 where the tensor=2 one sits 2.2e-4
# (tests/test_torch_semla_tensor_parallel.py); the EDM read 1.51e-7 and the
# classifier 1.41e-5 of the largest gradient (H100 80GB HBM3, 700.00 W). The
# order-rule figure is logged beside. bf16: within MOL_TP_BF16_FACTOR x the
# one-process bf16 step's distance from the f32 step (of the largest
# gradient, as the f32 figures).
MOL_TP = {"semla": ("float32", "bfloat16"), "edm": ("float32", "bfloat16"),
          "property": ("float32",), "multiflow": ("float32", "bfloat16"),
          "rdm": ("float32",), "semla_egnn": ("float32",), "semla_eqgat": ("float32",),
          "probe": ("float32",)}
MOL_TP_BF16_FACTOR = 2.0
MOL_TP_F64_FACTOR = 2.0
MOL_TP_GRAD_TOP = 1e-3
MOL_TP_F64_RULE = ("semla",)
MOL_TP_F64 = ("semla", "multiflow")
# the families whose model runs whole on every tensor rank, as reed_tpu's
# rules, which name none of their leaves, leave them: each tensor rank holds
# every parameter
MOL_TP_WHOLE = ("semla_egnn", "semla_eqgat", "probe")
# the egnn and eqgat archs' batch on the gloo ranks, which share one card: at
# 56 x 72 the EGNN arch takes 46.75 GB a process (PERF.md §5, PR 14), and two
# do not fit in 80 GB; on the NCCL ranks, one card each, SEMLA['batch']
MOL_TP_ALT_GLOO_BATCH = 16


def dp_step_record(trainer, state, batch, steps):
    """`steps` train steps: their metrics (floats) and the gradients each
    update saw (capture_gradients)."""
    out = []
    for _ in range(steps):
        with capture_gradients() as grads:
            state, metrics = trainer.train_step(state, batch)
        out.append(({k: float(v) for k, v in metrics.items()}, grads[0]))
    return state, out


def dp_difference(a, b):
    """(first differing quantity, max |a - b| over all of them) of two lists
    of (metrics, gradients) steps, or None where all are bitwise equal."""
    first, worst = None, 0.0
    for step, ((ma, ga), (mb, gb)) in enumerate(zip(a, b)):
        for k in mb:
            if ma[k] != mb[k]:
                first = first or f"step {step} metric {k}"
                worst = max(worst, abs(ma[k] - mb[k]))
        for i, (x, y) in enumerate(zip(ga, gb)):
            if not torch.equal(x, y):
                first = first or f"step {step} gradient {i}"
                worst = max(worst, (x - y).abs().max().item())
    return None if first is None else (first, worst)


def whole_named_params(state):
    """A TrainState's parameters by name in the shapes of the model's
    parameters: gathered over the fsdp group where the plan shards them
    at rest (a collective), else as they are."""
    named = {k: p.detach() for k, p in state.model.named_parameters()}
    plan = state.opt.plan
    return named if plan is None else dict(zip(plan.names, plan.gather(
        [named[n] for n in plan.names])))


def dp_params_difference(a, b):
    first, worst = None, 0.0
    for (name, x), y in zip(whole_named_params(a).items(), whole_named_params(b).values()):
        if not torch.equal(x, y):
            first = first or f"param {name}"
            worst = max(worst, (x - y).abs().max().item())
    return None if first is None else (first, worst)


def dp_merge(*diffs):
    diffs = [d for d in diffs if d is not None]
    return None if not diffs else (diffs[0][0], max(d[1] for d in diffs))


def dp_protein_trainer():
    return ProteinTrainer(train_config(), device="cuda")


class DPWitness:
    """Rank `rank` of `world` played in one process, for (b)'s witness: it
    draws as that rank draws (parallel/draws.py), its all_sum adds what the
    other ranks summed at the same call of the previous pass (`others`),
    and it leaves the gradients and metrics local, for the caller to
    average as the ranks' all-reduces do."""

    def __init__(self, rank, world, others):
        self.rank, self.world, self.others, self.sums = rank, world, others, []

    def all_sum(self, x):
        x = x.detach().clone()
        i = len(self.sums)
        self.sums.append(x.clone())
        for other in self.others:
            x = x + other[i] if i < len(other) else x
        return x

    def all_reduce_grads(self, grads):
        return list(grads)

    def mean_metrics(self, metrics):
        return dict(metrics)


def dp_protein_witness(batch, passes=4):
    """What the ranks of (b) compute, in one process: the protein step on
    each rank's rows of the global `batch`, with the global sums and counts
    and the global batch's draws, each from a fresh state and generator;
    the gradients and tensor metrics averaged as the all-reduces average
    them ((g0 + g1) / 2 in f32), grad_norm taken of the average. The global
    sums feed on each other (repr_norm's variance uses the global mean), so
    the passes repeat until every rank's sums equal the previous pass's.
    Returns [(metrics, gradients)], dp_step_record's form."""
    world = DP["world"]
    trainer = dp_protein_trainer()
    cfg = trainer.cfg
    sums = [[] for _ in range(world)]
    for _ in range(passes):
        runs, witnesses = [], []
        for r in range(world):
            w = DPWitness(r, world, [sums[q] for q in range(world) if q != r])
            step = make_train_step(make_loss_fn(cfg, w), trainer.curriculum,
                                   accum_steps=cfg.optim.accum_steps, dp=w)
            gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
            with capture_gradients() as grads:
                _, metrics = step(trainer.init_state(), local_rows(batch, r, world),
                                  generator=gen, noisy=None, repr_noise=None)
            runs.append((metrics, grads[0]))
            witnesses.append(w.sums)
        settled = all(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
                      for a, b in zip(witnesses, sums))
        sums = witnesses
        if settled:
            break
    else:
        raise AssertionError(f"the witness's global sums did not settle in {passes} passes")
    grads = [sum(gs) / world for gs in zip(*(g for _, g in runs))]
    metrics = {k: (float(sum(m[k].float() for m, _ in runs) / world)
                   if isinstance(v, torch.Tensor) else float(v))
               for k, v in runs[0][0].items() if k != "grad_norm"}
    metrics["grad_norm"] = float(global_norm(grads))
    return [(metrics, grads)]


def dp_image_trainer(batch, dtype="bfloat16"):
    return image_train.ImageTrainer(bench_image_config(batch, dtype, warmup=0), device="cuda")


def dp_group_phase(tmp, smi):
    """(a) A one-process NCCL group against no group, at full width: the
    SiT-XL/2 REED bf16 step at batch 48 (bitwise: the step is repeatable on
    the card) and the f32 protein step at 8 x 256 (within RESUME_NOISE_FACTOR
    x a repeated step's difference: K2b's atomics), two steps each, with
    K1 and K2a/K2b counted in the group's steps. (d) The all-reduce's cost:
    the image and protein steps with the group against without, in turns,
    by wall and by CUDA events, the gradient all-reduce alone, and the bytes
    it moves a step. Returns the group runs' launches."""
    from torch import distributed as dist
    from reed_tpu_torch.parallel.mesh import init_distributed

    steps = DP["steps"]
    ia = dp_image_trainer(IMAGE_TRAIN["batch"])
    ibatch = ia.synthetic_batch(torch.Generator(device="cuda").manual_seed(11))
    pa, pa2 = dp_protein_trainer(), dp_protein_trainer()
    pbatch = pa.synthetic_batch(torch.Generator(device="cuda").manual_seed(12))
    ia_state, ia_run = dp_step_record(ia, ia.init_state(), ibatch, steps)
    pa_state, pa_run = dp_step_record(pa, pa.init_state(), pbatch, steps)
    pa2_state, pa2_run = dp_step_record(pa2, pa2.init_state(), pbatch, steps)

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        init_distributed("cuda", backend="nccl", init_method=f"file://{tmp}/store_group1")
        ib, pb = dp_image_trainer(IMAGE_TRAIN["batch"]), dp_protein_trainer()
        if ib.dp is None or pb.dp is None or ib.dp.backend != "nccl":
            raise AssertionError("the trainers did not join the one-process NCCL group")
        torch.cuda.synchronize()
        fa.launches = fm.launches = fm.backward_launches = 0
        ib_state, ib_run = dp_step_record(ib, ib.init_state(), ibatch, steps)
        torch.cuda.synchronize()
        image_launches = fa.launches
        fa.launches = fm.launches = fm.backward_launches = 0
        pb_state, pb_run = dp_step_record(pb, pb.init_state(), pbatch, steps)
        torch.cuda.synchronize()
        protein_launches = (fm.launches, fm.backward_launches, fa.launches)

        image_diff = dp_merge(dp_difference(ib_run, ia_run),
                              dp_params_difference(ib_state, ia_state))
        protein_diff = dp_merge(dp_difference(pb_run, pa_run),
                                dp_params_difference(pb_state, pa_state))
        protein_det = dp_merge(dp_difference(pa2_run, pa_run),
                               dp_params_difference(pa2_state, pa_state))
        log(f"[dp] (a) one-process NCCL group vs no group, SiT-XL/2 REED bf16 step at "
            f"batch {IMAGE_TRAIN['batch']}, {steps} steps (loss, every gradient, every "
            f"parameter): {describe(image_diff)}; loss {ib_run[-1][0]['loss']:.6g}; K1 "
            f"launches {image_launches} (expected {DEPTH * steps})")
        log(f"[dp] (a) protein f32 step at {TRAIN['batch']} x {TRAIN['length']}, {steps} "
            f"steps: group vs no group {describe(protein_diff)}; a repeated step without "
            f"a group {describe(protein_det)} (bound {RESUME_NOISE_FACTOR}x it); K2a/K2b "
            f"launches {protein_launches[:2]} (expected {9 * steps} each)")
        if image_diff is not None:
            raise AssertionError(f"the image step in a one-process group is not bitwise "
                                 f"the step without one: {describe(image_diff)}")
        if not within_noise(protein_diff, protein_det):
            raise AssertionError(f"the protein step in a one-process group differs "
                                 f"({describe(protein_diff)}) by more than "
                                 f"{RESUME_NOISE_FACTOR}x a repeated step "
                                 f"({describe(protein_det)})")
        if image_launches != DEPTH * steps or protein_launches != (9 * steps, 9 * steps, 0):
            raise AssertionError(f"launches in the group's steps: K1 {image_launches}, "
                                 f"K2a/K2b/K1 {protein_launches}")
        del ia_run, ib_run, pa_run, pa2_run, pb_run, pa2_state, pa2
        torch.cuda.empty_cache()

        # (d) the all-reduce's cost, in turns: no group, group, group, no group
        def wall_and_device(trainer, state, batch):
            n = DP["timed_steps"]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                state, _ = trainer.train_step(state, batch)
            end.record()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n, start.elapsed_time(end) / n

        for label, (ta, sa), (tb, sb), batch, model in (
                ("SiT-XL/2 bf16 batch 48", (ia, ia_state), (ib, ib_state), ibatch, ib_state.model),
                ("protein f32 8 x 256", (pa, pa_state), (pb, pb_state), pbatch, pb_state.model)):
            times = {"without": [], "with": []}
            for key, (t, st) in (("without", (ta, sa)), ("with", (tb, sb)),
                                 ("with", (tb, sb)), ("without", (ta, sa))):
                times[key].append(wall_and_device(t, st, batch))
            mean = {k: tuple(sum(x) / len(x) for x in zip(*v)) for k, v in times.items()}
            grads = [torch.zeros_like(p) for p in model.parameters()]
            reduce_ms = cuda_ms(lambda: tb.dp.all_reduce_grads(grads), iters=5, warmup=2,
                                queued=False)
            nbytes = sum(g.numel() * g.element_size() for g in grads)
            log(f"[dp] (d) {label}: ms a step without / with the group {mean['without'][0]:.3f}"
                f" / {mean['with'][0]:.3f} by wall, {mean['without'][1]:.3f} / "
                f"{mean['with'][1]:.3f} by CUDA events ({DP['timed_steps']} steps, in turns "
                f"without, with, with, without); the gradient all-reduce alone "
                f"{reduce_ms:.3f} ms ({len(grads)} gradients, {nbytes / 1e9:.4f} GB "
                f"all-reduced a step, f32) ({smi})")
            del grads
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in DP_ENV:
            os.environ.pop(key, None)
    del ia, ib, pa, pb, ia_state, ib_state, pa_state, pb_state
    torch.cuda.empty_cache()
    return image_launches, protein_launches


def dp_seeded_sit(parallel=None):
    """SiT-XL/2 with N(0, 0.02) weights from seed 0 (slice_phase's), bf16;
    split over the seq and tensor axes of `parallel` (a DataParallel)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_sit("SiT-XL/2", device="cuda").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    if parallel is not None:
        whole, model = model, create_sit("SiT-XL/2", device="cuda", parallel=parallel).eval()
        model.load_state_dict(shard_state_dict(whole.state_dict(), parallel, SIT_TP_RULES))
        del whole
    return model.to(torch.bfloat16)


def dp_generate(model, mesh=None):
    calls = 0

    def model_fn(x, t, y):
        nonlocal calls
        calls += 1
        return model(x, t, y)[0]

    fa.launches = 0
    samples = generate_samples(model_fn, FIDGenConfig(**DP_GEN), device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    return samples, calls, fa.launches


def mesh_image_step(mesh, gb, remat=False):
    """One SiT-XL/2 REED bf16 step at global batch `gb` on `mesh` (None: the
    data axis alone) under `remat`: its (metrics, gradients) and the
    parameters after it on the host, the step's seconds, K1 launches, the
    bytes allocated between steps (`allocated`; `held`: beyond what the
    process held before the trainer was built) and what the plan reckons
    for the parameters and state (f32 parameters, bf16 mu, f32 nu and EMA
    on this rank's share: under fsdp the parameters are sharded at rest
    too)."""
    from reed_tpu_torch.core.config import MeshConfig

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    trainer = image_train.ImageTrainer(
        dataclasses.replace(bench_image_config(gb, warmup=0), mesh=mesh or MeshConfig(),
                            remat=remat),
        device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(21))
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    state, run = dp_step_record(trainer, state, batch, 1)
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, fa.launches
    run = [(m, [g.cpu() for g in gs]) for m, gs in run]
    plan = state.opt.plan
    named = {k: p.detach() for k, p in state.model.named_parameters()}
    params = [p.cpu() for p in (named if plan is None else plan.join_state_dict(named)).values()]
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    n = sum(p.numel() for p in state.model.parameters())  # this rank's share
    held = n if plan is None else plan.resident_elements()
    reckoned = (4 + 2 + 4 + 4) * held  # params, bf16 mu, nu, EMA on the share
    del trainer, state, batch
    torch.cuda.empty_cache()
    return dict(run=run, params=params, s=seconds, launches=launches, allocated=allocated,
                held=allocated - before, reckoned=reckoned,
                sharded=0 if plan is None else sum(plan.sharded),
                params_rank=n, params_whole=sum(p.numel() for p in params))


def mesh_protein_step(mesh, compute_dtype="float32"):
    """One protein step at 8 x 256 on `mesh` (None: the data axis alone) in
    compute_dtype: its (metrics, gradients), state, parameter names, K2a/K2b
    launches and seconds."""
    from reed_tpu_torch.core.config import MeshConfig

    trainer = ProteinTrainer(dataclasses.replace(train_config(), mesh=mesh or MeshConfig(),
                                                 compute_dtype=compute_dtype), device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(22))
    torch.cuda.synchronize()
    fm.launches = fm.backward_launches = 0
    t0 = time.perf_counter()
    state, run = dp_step_record(trainer, state, batch, 1)
    torch.cuda.synchronize()
    return dict(run=run, state=state, launches=(fm.launches, fm.backward_launches),
                names=[n for n, _ in state.model.named_parameters()],
                s=time.perf_counter() - t0)


def fsdp_rank_part(image, protein):
    """Phase 16 (b) on a rank of phase 15's group: the SiT-XL/2 and protein
    steps at fsdp=2 against this rank's data=2 steps `image` and `protein`
    (mesh_image_step's and mesh_protein_step's, the same state, batch and
    draws), and a repeated data=2 protein step; the distances."""
    from reed_tpu_torch.core.config import MeshConfig

    fsdp = MeshConfig(fsdp=DP["world"])
    image_fsdp = mesh_image_step(fsdp, DP["image_global_batch"])
    image_remat = mesh_image_step(fsdp, DP["image_global_batch"], remat=True)
    result = {key: {k: r[k] for k in ("s", "launches", "allocated", "held", "reckoned",
                                      "sharded")}
              for key, r in (("image_data", image), ("image_fsdp", image_fsdp),
                             ("image_remat", image_remat))}
    # remat against no remat at fsdp=2: the blocks gather again in the recompute
    result["remat_bitwise"] = dp_difference(image_remat["run"], image_fsdp["run"])
    result["remat_params_bitwise"] = all(torch.equal(a, b) for a, b in
                                         zip(image_remat["params"], image_fsdp["params"]))
    del image_remat
    (md, gd), (mf, gf) = image["run"][0], image_fsdp["run"][0]
    result["clip_acted"] = md["grad_norm"] >= 1.0
    result["grad_norm_rel"] = abs(mf["grad_norm"] - md["grad_norm"]) / md["grad_norm"]
    result["image_bitwise"] = dp_difference([({k: v for k, v in mf.items() if k != "grad_norm"},
                                              gf)],
                                            [({k: v for k, v in md.items() if k != "grad_norm"},
                                              gd)])
    top = max(float(p.abs().max()) for p in image["params"])
    result["image_param_rel"] = max(float((a - b).abs().max()) for a, b in
                                    zip(image_fsdp["params"], image["params"])) / top
    result["image_params_bitwise"] = all(torch.equal(a, b) for a, b in
                                         zip(image_fsdp["params"], image["params"]))
    del image_fsdp
    p_repeat, p_fsdp = mesh_protein_step(None), mesh_protein_step(fsdp)
    result["protein_launches"] = p_fsdp["launches"]
    result["protein_diff"] = dp_merge(dp_difference(p_fsdp["run"], protein["run"]),
                                      dp_params_difference(p_fsdp["state"], protein["state"]))
    result["protein_det"] = dp_merge(dp_difference(p_repeat["run"], protein["run"]),
                                     dp_params_difference(p_repeat["state"], protein["state"]))
    return result


def dp_rank_main(out_dir, backend):
    """One rank of phase 15's (b) and (c) (`chip_smoke.py --dp-rank DIR
    BACKEND`, RANK / WORLD_SIZE / LOCAL_RANK set by the parent). Rank 0
    first takes the one-process references without a group: the SiT-XL/2
    step at batch 16 in f32 and in bf16, the protein step at 8 x 256 twice,
    16 generated images. Then every rank joins the group and runs the same
    global batches data-parallel, then phase 16 (b), the fsdp=2 steps
    against them, then the tensor=2 and seq=2 steps and generation
    (mp_rank_part), the slice-20/21 steps (mol_tp_rank_part) and the
    slice-22 eval samplers (eval_rank_part, against rank 0's one-process
    eval_refs); rank 0 writes the distances."""
    from reed_tpu_torch.parallel.mesh import init_distributed

    rank = int(os.environ["RANK"])
    gb = DP["image_global_batch"]
    result = {}
    if rank == 0:
        t32 = dp_image_trainer(gb, "float32")
        ibatch = t32.synthetic_batch(torch.Generator(device="cuda").manual_seed(21))
        state = t32.init_state()
        names = [n for n, _ in state.model.named_parameters()]
        _, ref32 = dp_step_record(t32, state, ibatch, 1)
        del t32, state
        t16 = dp_image_trainer(gb)
        _, ref16 = dp_step_record(t16, t16.init_state(), ibatch, 1)
        del t16
        result["image_bf16_vs_f32"] = step_errors(ref16[0], ref32[0], names)[:2]
        ref32 = [(m, [g.cpu() for g in gs]) for m, gs in ref32]
        del ref16
        torch.cuda.empty_cache()
        pbatch = dp_protein_trainer().synthetic_batch(
            torch.Generator(device="cuda").manual_seed(22))
        refs = []
        for _ in range(2):
            t = dp_protein_trainer()
            refs.append(dp_step_record(t, t.init_state(), pbatch, 1)[1])
        result["protein_repeat"] = dp_difference(refs[1], refs[0])
        # the tensor=2 steps' yardsticks (mp_rank_part): the one-process f32
        # step, its repeat's difference and the one-process bf16 step's
        # distance from it
        tb = ProteinTrainer(dataclasses.replace(train_config(), compute_dtype="bfloat16"),
                            device="cuda")
        ref_bf16 = dp_step_record(tb, tb.init_state(), pbatch, 1)[1]
        pnames = [n for n, _ in tb.init_state().model.named_parameters()]
        protein_refs = dict(f32=[(m, [g.cpu() for g in gs]) for m, gs in refs[0]],
                            det=result["protein_repeat"], names=pnames,
                            bf16_vs_f32=step_errors(ref_bf16[0], refs[0][0], pnames)[:2])
        del tb, ref_bf16
        witness = dp_protein_witness(pbatch)
        ref_samples, _, _ = dp_generate(dp_seeded_sit())
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mol_refs = mol_tp_refs(backend)
        result["molecule_refs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_one = eval_refs()
        result["eval_refs_s"] = time.perf_counter() - t0
    init_distributed("cuda", backend=backend, init_method=f"file://{out_dir}/store_{backend}")
    t0 = time.perf_counter()
    image = mesh_image_step(None, gb)
    result["image_step_s"], result["image_launches"] = image["s"], image["launches"]
    protein = mesh_protein_step(None)
    prun, pnames = protein["run"], protein["names"]
    result["protein_launches"] = protein["launches"]
    samples, calls, launches = dp_generate(dp_seeded_sit())
    result["generate"] = dict(calls=calls, launches=launches, shape=list(samples.shape),
                              finite=bool(np.isfinite(samples).all()))
    result["rank_s"] = time.perf_counter() - t0
    if rank == 0:
        result["image_dp_vs_f32"] = step_errors(image["run"][0], ref32[0], names)[:2]
        result["image_loss"] = (image["run"][0][0]["loss"], ref32[0][0]["loss"])
        result["protein_vs_witness"] = dp_difference(prun, witness)
        result["protein_dp_errors"] = step_errors(prun[0], refs[0][0], pnames)
        result["witness_errors"] = step_errors(witness[0], refs[0][0], pnames)
        result["protein_repeat_errors"] = step_errors(refs[1][0], refs[0][0], pnames)
        result["protein_loss"] = (prun[0][0]["loss"], refs[0][0][0]["loss"])
        result["generate"]["rel"] = float(abs(samples - ref_samples).max()
                                          / abs(ref_samples).max())
    t0 = time.perf_counter()
    result["fsdp"] = fsdp_rank_part(image, protein)
    result["fsdp_s"] = time.perf_counter() - t0
    del image, protein
    t0 = time.perf_counter()
    result["model_parallel"] = mp_rank_part(rank, ref32 if rank == 0 else None,
                                            names if rank == 0 else None,
                                            ref_samples if rank == 0 else None,
                                            protein_refs if rank == 0 else None)
    result["model_parallel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["molecule_tp"] = mol_tp_rank_part(rank, mol_refs if rank == 0 else None, backend)
    result["molecule_tp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["eval"] = eval_rank_part(rank, eval_one if rank == 0 else None)
    result["eval_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}_{backend}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def params_digest(params):
    """SHA-256 of the bytes of `params` (host tensors), in order: equal
    digests on two ranks mean bitwise equal parameters."""
    digest = hashlib.sha256()
    for p in params:
        digest.update(p.contiguous().view(-1).view(torch.uint8).numpy())
    return digest.hexdigest()


def mp_protein_step(mesh, compute_dtype):
    """mesh_protein_step on the host: its (metrics, gradients) on the CPU,
    seconds, K2a/K2b launches, the bytes its state holds between steps (the
    allocation the step leaves beside what was there before) beside what
    the plan reckons (f32 parameters of this rank's shards; mu, nu and the
    EMA in f32 on its share), the parameters a rank holds and the whole
    parameters' SHA-256, and the bytes the model's collectives all-reduce
    over the tensor group in the step (collectives.tensor_bytes) beside
    those of the replicated leaves' gradients, which the plan averages
    there."""
    from reed_tpu_torch.parallel import collectives

    base = torch.cuda.memory_allocated()
    collectives.tensor_bytes = 0
    step = mesh_protein_step(mesh, compute_dtype)
    moved = collectives.tensor_bytes
    state, plan = step["state"], step["state"].opt.plan
    run = [(m, [g.cpu() for g in gs]) for m, gs in step.pop("run")]
    named = {k: p.detach() for k, p in state.model.named_parameters()}
    params = [p.cpu() for p in (named if plan is None else plan.join_state_dict(named)).values()]
    torch.cuda.synchronize()
    n = sum(p.numel() for p in state.model.parameters())  # this rank's (tensor shards)
    held = n if plan is None else plan.resident_elements()
    replicated = sum(int(np.prod(shape)) for shape, rule in zip(plan.shapes, plan.tensor)
                     if rule is None)
    row = dict(s=step["s"], launches=list(step["launches"]), tensor_bytes=moved,
               replicated_grad_bytes=4 * replicated,
               allocated=torch.cuda.memory_allocated() - base,
               reckoned=4 * n + (4 + 4 + 4) * held, params_rank=n,
               params_whole=sum(p.numel() for p in params),
               params_sha256=params_digest(params))
    del step, state
    torch.cuda.empty_cache()
    return run, row


def mp_rank_part(rank, ref32, names, ref_samples, protein_refs):
    """Phase 15's tensor=2 and seq=2 on a rank of its group: the SiT-XL/2
    REED bf16 step at the global batch (its whole gradients against rank
    0's one-process f32 step `ref32`, parameter `names`), its seconds, K1
    launches and memory beside the plan's reckoning; and generate_samples
    of the seeded SiT-XL/2 split the same way, against rank 0's one-process
    samples `ref_samples`. Then the protein step at tensor=2 (each message
    chain's hidden units split, through K2a/K2b) in f32 and bf16 against
    rank 0's one-process steps `protein_refs`. Each rank's whole parameters
    after a step go back as their SHA-256 (params_digest)."""
    from reed_tpu_torch.core.config import MeshConfig
    from reed_tpu_torch.parallel.mesh import data_parallel

    out = {}
    for axis in MP_AXES:
        mesh = MeshConfig(**{axis: DP["world"]})
        step = mesh_image_step(mesh, DP["image_global_batch"])
        row = {k: step[k] for k in ("s", "launches", "allocated", "reckoned", "params_rank",
                                    "params_whole")}
        row["params_sha256"] = params_digest(step["params"])
        if rank == 0:
            row["vs_f32"] = step_errors(step["run"][0], ref32[0], names)[:2]
            row["loss"] = step["run"][0][0]["loss"]
        del step
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        samples, calls, launches = dp_generate(
            dp_seeded_sit(data_parallel(mesh, axes=SIT_AXES)), mesh)
        row["generate"] = dict(s=time.perf_counter() - t0, calls=calls, launches=launches,
                               shape=list(samples.shape),
                               finite=bool(np.isfinite(samples).all()))
        if rank == 0:
            row["generate"]["rel"] = float(abs(samples - ref_samples).max()
                                           / abs(ref_samples).max())
        torch.cuda.empty_cache()
        out[axis] = row
    out["protein"] = {}
    for dtype in ("float32", "bfloat16"):
        run, row = mp_protein_step(MeshConfig(tensor=DP["world"]), dtype)
        if rank == 0:
            ref = protein_refs["f32"]
            row["vs_f32"] = step_errors(run[0], ref[0], protein_refs["names"])
            if dtype == "float32":
                row["vs_one"] = dp_difference(run, ref)
                row["det"] = protein_refs["det"]
            else:
                row["bf16_vs_f32"] = protein_refs["bf16_vs_f32"]
            row["loss"] = run[0][0]["loss"]
        out["protein"][dtype] = row
    return out


def mol_tp_setup(family, mesh, dtype, backend="gloo"):
    """(trainer on `mesh` (None: one process), the whole checked weights as
    a host state_dict, this rank's device batch, the family's tensor rules,
    the step's injected draws) of `family` at full width in `dtype`:
    SemlaFlow at the GEOM scale (batch 56 x 72; its egnn and eqgat archs at
    MOL_TP_ALT_GLOO_BATCH x 72 over gloo), the EDM at MoleculeEDMConfig
    (batch 64 x 29), the property classifier at PropertyTrainConfig (batch
    96 x 29) and the linear probe at LinearProbeConfig (96 reps of 256),
    MultiFlow at MultiflowTrainConfig (batch 8 x 128), the RDM at
    RDMTrainConfig (batch 128)."""
    from reed_tpu_torch.core.config import MeshConfig
    from reed_tpu_torch.parallel.mesh import (EGNN_TP_RULES, RDM_TP_RULES, SEMLA_TP_RULES,
                                             local_batch)

    mesh = mesh or MeshConfig()
    rules, inject = (), {}
    if family in ("semla", "semla_egnn", "semla_eqgat"):
        arch = family.split("_")[1] if "_" in family else "semla"
        rows = (SEMLA["batch"] if arch == "semla" or backend == "nccl"
                else MOL_TP_ALT_GLOO_BATCH)
        cfg = semla_full_config(compute_dtype=dtype, arch=arch, batch_size=rows)
        trainer = semla_train.SemlaTrainer(dataclasses.replace(cfg, mesh=mesh), device="cuda")
        whole = seeded_semla(cfg) if arch == "semla" else seeded_alt(cfg)
        batch = semla_train.batch_to_device(local_batch(trainer.dp, semla_train.example_batch(
            cfg, rows, SEMLA["atoms"], seed=1)), "cuda")
        rules, inject = (SEMLA_TP_RULES if arch == "semla" else ()), dict(use_sc=True)
    elif family == "edm":
        cfg = edm_train.MoleculeEDMConfig(compute_dtype=dtype)
        trainer = edm_train.MoleculeEDMTrainer(dataclasses.replace(cfg, mesh=mesh),
                                               device="cuda")
        whole = seeded_edm(cfg)
        batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
        rules = EGNN_TP_RULES
    elif family == "multiflow":
        cfg = dataclasses.replace(mf_train.MultiflowTrainConfig(), batch_size=MULTIFLOW["batch"],
                                  max_len=MULTIFLOW["length"], compute_dtype=dtype)
        trainer = mf_train.MultiflowTrainer(dataclasses.replace(cfg, mesh=mesh), device="cuda")
        whole = seeded_flow_model(cfg)
        batch = trainer.synthetic_batch(np.random.default_rng(1))
        rules = mf_train.tp_rules(cfg)
    elif family == "rdm":
        cfg = rdm_train.RDMTrainConfig()
        trainer = rdm_train.RDMTrainer(dataclasses.replace(cfg, mesh=mesh), device="cuda")
        whole = seeded_rdm(cfg, "cuda")
        batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
        rules = RDM_TP_RULES
    else:
        probe = family == "probe"
        cfg = property_train.LinearProbeConfig() if probe else property_train.PropertyTrainConfig()
        trainer = (property_train.LinearProbeTrainer if probe else property_train.PropertyTrainer)(
            dataclasses.replace(cfg, mesh=mesh), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        whole = (trainer._build(gen) if probe else
                 property_train.build_model(cfg, device="cuda", generator=gen))
        with torch.no_grad():
            for name, p in whole.named_parameters():
                if name.endswith("bias"):
                    p.add_(torch.randn(p.shape, generator=gen, device="cuda")
                           * PROPERTY_BIAS_STD)
        batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(1))
        rules = () if probe else EGNN_TP_RULES
    weights = {k: v.detach().cpu() for k, v in whole.state_dict().items()}
    del whole
    torch.cuda.empty_cache()
    return trainer, weights, batch, rules, inject


def mol_tp_step(family, mesh, dtype, backend="gloo"):
    """Two train steps of `family` at full width on `mesh` (None: one
    process) in `dtype` from its checked weights (mol_tp_setup; SemlaFlow's
    first with its self-conditioning pass): the first step's (metrics, whole
    gradients) on the host and the parameter names, each step's seconds
    and the second's loss, the bytes the model's collectives all-reduced
    over the tensor group in the first step (collectives.tensor_bytes)
    beside the replicated leaves' gradients, which the plan averages there,
    the state's bytes after the steps beside the plan's reckoning (f32
    parameters of this rank's shards; mu, nu and the EMA in f32), the
    parameters a rank holds, the whole parameters' SHA-256 after the
    steps, and K1/K2a/K2b launches (none on these paths)."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.core.train_state import make_optimizer
    from reed_tpu_torch.parallel import collectives

    trainer, weights, batch, rules, inject = mol_tp_setup(family, mesh, dtype, backend)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = trainer.init_state()
    plan = state.opt.plan
    state.model.load_state_dict(shard_state_dict(weights, trainer.dp, rules))
    state.ema = ema_init(state.model, plan=plan)
    state.opt = make_optimizer(trainer.cfg.optim, list(state.model.parameters()), plan)
    names = list(weights)
    del weights
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    collectives.tensor_bytes = 0
    seconds = []
    with capture_gradients() as grads:
        t0 = time.perf_counter()
        state, first = trainer.train_step(state, batch, **inject)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    moved = collectives.tensor_bytes
    run = [({k: float(v) for k, v in first.items()}, [g.cpu() for g in grads[0]])]
    grads.clear()
    if "use_sc" in inject:
        inject = dict(inject, use_sc=False)
    t0 = time.perf_counter()
    state, second = trainer.train_step(state, batch, **inject)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    del first
    allocated = torch.cuda.memory_allocated() - base
    named = {k: p.detach() for k, p in state.model.named_parameters()}
    params = [p.cpu() for p in (named if plan is None else plan.join_state_dict(named)).values()]
    n = sum(p.numel() for p in state.model.parameters())
    held = n if plan is None else plan.resident_elements()
    replicated = (0 if plan is None else
                  sum(int(np.prod(shape)) for shape, rule in zip(plan.shapes, plan.tensor)
                      if rule is None))
    row = dict(s=seconds, loss2=float(second["loss"]), tensor_bytes=moved,
               replicated_grad_bytes=4 * replicated, allocated=allocated,
               reckoned=4 * n + (4 + 4 + 4) * held, params_rank=n,
               params_whole=sum(p.numel() for p in params), params_sha256=params_digest(params),
               launches=[fa.launches, fm.launches, fm.backward_launches],
               finite=bool(all(math.isfinite(v) for v in run[0][0].values())
                           and math.isfinite(float(second["loss"]))))
    del trainer, state, batch, named, second
    torch.cuda.empty_cache()
    return run, names, row


def multiflow_train_inputs(trainer, batch):
    """The model's input of a MultiflowTrainer step on `batch`: the batch
    corrupted with draws from the trainer's generator, as the step's loss
    draws them, with zero self-conditioning (train/multiflow.make_loss_fn)."""
    noisy = mf_se3.corrupt_batch(trainer.cfg.interpolant, batch, generator=trainer.generator)
    noisy["trans_sc"] = torch.zeros_like(noisy["trans_t"])
    noisy["aatypes_sc"] = F.one_hot(noisy["aatypes_t"], 21).float()
    return noisy


def mol_grads64(family, backend="gloo"):
    """The one-process gradient of `family`'s first mol_tp_step with the
    model and the batch promoted to f64 (the LayerNorms and MultiFlow's
    sinusoidal embeddings keep their f32 arithmetic; the same draws), on
    the host: the yardstick of f32's own rounding."""
    def promoted(x):
        if isinstance(x, dict):
            return {k: promoted(v) for k, v in x.items()}
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    trainer, weights, batch, _, inject = mol_tp_setup(family, None, "float32", backend)
    model = trainer.init_state().model
    model.load_state_dict(weights)
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    if family == "multiflow":
        # the f32 step's corrupted batch (its draws, in f32), then the model
        # and the losses in f64
        noisy = promoted(multiflow_train_inputs(trainer, batch))
        metrics = mf_train.multiflow_losses(trainer.cfg, noisy, model(noisy))
    else:
        loss_fn = {"semla": semla_train.make_loss_fn, "edm": edm_train.make_loss_fn,
                   "property": property_train.make_loss_fn}[family]
        extra = dict(generator=trainer.generator) if family != "property" else {}
        metrics = (loss_fn(trainer.cfg, "cuda") if family == "edm" else loss_fn(trainer.cfg))(
            model, promoted(batch), 0, **extra, **inject)
    total, _ = combine_losses(metrics, 0, getattr(trainer, "curriculum", trainer.cfg.curriculum))
    leaves = list(model.parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    out = [(torch.zeros_like(p) if g is None else g).cpu() for g, p in zip(grads, leaves)]
    del trainer, model, batch, metrics, total, grads, leaves
    torch.cuda.empty_cache()
    return out


def l2_distance(a, b):
    """sqrt of the sum over the tensors of a and b of |a - b|^2, in f64."""
    return math.sqrt(sum(float((x.double() - y.double()).norm()) ** 2 for x, y in zip(a, b)))


def mol_step_errors(a, b):
    """(worst metric error, relative above 1; worst gradient error as max
    |a - b| over every tensor / the largest |b| of the step, and its
    parameter index) of step a against step b."""
    (ma, ga), (mb, gb) = a, b
    top = max(float(y.abs().max()) for y in gb)
    errs = [float((x - y).abs().max()) / top for x, y in zip(ga, gb)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1.0) for k in mb), errs[worst], worst


def mol_tp_refs(backend, families=tuple(MOL_TP)):
    """Rank 0's one-process references of the slice-20 and slice-21 steps:
    each family's first step in f32 and, for MOL_TP_F64, its f64 promotion
    ({family: (run, names, grads64 or None)}), and each bf16 step's distance
    from the f32 one (mol_step_errors)."""
    refs, bf16 = {}, {}
    for family in families:
        dtypes = MOL_TP[family]
        run32, names, _ = mol_tp_step(family, None, "float32", backend)
        refs[family] = (run32, names,
                        mol_grads64(family, backend) if family in MOL_TP_F64 else None)
        if "bfloat16" in dtypes:
            run16, _, _ = mol_tp_step(family, None, "bfloat16", backend)
            bf16[family] = mol_step_errors(run16[0], run32[0])[:2]
    return refs, bf16


def mol_tp_rank_part(rank, refs, backend, families=tuple(MOL_TP)):
    """The slice-20 and slice-21 steps at tensor=2 on a rank of phase 15's
    group: each of `families` (MOL_TP keys) in each of its dtypes, against
    rank 0's one-process f32 step `refs` (mol_tp_refs)."""
    from reed_tpu_torch.core.config import MeshConfig

    out = {}
    for family in families:
        for dtype in MOL_TP[family]:
            run, names, row = mol_tp_step(family, MeshConfig(tensor=DP["world"]), dtype,
                                          backend)
            if rank == 0:
                ref_run, ref_names, grads64 = refs[0][family]
                assert names == ref_names, family
                metric, grad, worst = mol_step_errors(run[0], ref_run[0])
                row["vs_f32"] = [metric, grad, names[worst]]
                row["loss"] = run[0][0]["loss"]
                if dtype == "bfloat16":
                    row["bf16_vs_f32"] = list(refs[1][family])
                elif grads64 is not None:
                    row["l2_vs_f64"] = [l2_distance(run[0][1], grads64),
                                        l2_distance(ref_run[0][1], grads64),
                                        l2_distance(run[0][1], ref_run[0][1])]
            out[f"{family}_{dtype}"] = row
    return out


def mol_tp_report(res, where, smi):
    """The slice-20 and slice-21 lines and checks from each rank's
    mol_tp_rank_part: f32 within (TRAIN_METRIC_RTOL, DP_ORDER_GRAD_RTOL) of
    the one-process step (SemlaFlow, MOL_TP_F64_RULE: within
    (TRAIN_METRIC_RTOL, MOL_TP_GRAD_TOP) and MOL_TP_F64_FACTOR x one
    process's distance from the f64 step), bf16 within MOL_TP_BF16_FACTOR x
    the one-process bf16 step's distance from it; the ranks' whole
    parameters bitwise equal after both steps; fewer parameters a rank than
    the model's (every one for MOL_TP_WHOLE); no K1/K2a/K2b launch. Every
    family's lines come before the first failure raises."""
    gloo = "gloo" in where
    alt_rows = MOL_TP_ALT_GLOO_BATCH if gloo else SEMLA["batch"]
    log(f"[tp] {where}, at tensor=2 against one process, from the checked weights, each "
        f"rank the whole batch: split (half of each split product a rank): SemlaFlow "
        f"(recipe width, batch {SEMLA['batch']} x {SEMLA['atoms']}, the self-conditioning "
        "pass on), the EDM (MoleculeEDMConfig, batch 64 x 29), the property classifier "
        f"(PropertyTrainConfig, batch 96 x 29), MultiFlow (MultiflowTrainConfig, batch "
        f"{MULTIFLOW['batch']} x {MULTIFLOW['length']}: half the IPA and sequence heads) and "
        "the RDM (RDMTrainConfig, batch 128: half of each block's 1536 mid columns); whole on "
        f"every tensor rank: SemlaFlow's egnn and eqgat archs (recipe width, batch "
        f"{alt_rows} x {SEMLA['atoms']}"
        + (f"; two ranks at {SEMLA['batch']} do not fit one card" if gloo else "")
        + ") and the property linear probe (LinearProbeConfig, 96 reps of 256)"
        + ("; over gloo the collectives go through the host" if gloo else ""))
    record = ", a record: gloo through the host" if gloo else ""
    failures = []
    for key in res[0]:
        family = key.rsplit("_", 1)[0]
        r0 = res[0][key]
        metric, grad, worst = r0["vs_f32"]
        same = len({r[key]["params_sha256"] for r in res}) == 1
        f64 = ""
        if "l2_vs_f64" in r0:
            tp64, one64, tp_one = r0["l2_vs_f64"]
            f64 = (f"; the whole gradient's L2 distance from the f64 step {tp64:.4g}, one "
                   f"process's {one64:.4g}, from one process {tp_one:.4g}")
        if key.endswith("float32") and family in MOL_TP_F64_RULE:
            tols = (TRAIN_METRIC_RTOL, MOL_TP_GRAD_TOP)
            ok = metric <= tols[0] and grad <= tols[1] and tp64 <= MOL_TP_F64_FACTOR * one64
            bound = (f"the f64 rule ({MOL_TP_F64_FACTOR}x one process's f64 distance){f64}; "
                     f"phase 15's order rule {DP_ORDER_GRAD_RTOL} "
                     f"{'met' if grad <= DP_ORDER_GRAD_RTOL else 'not met'}")
        elif key.endswith("float32"):
            tols = (TRAIN_METRIC_RTOL, DP_ORDER_GRAD_RTOL)
            ok = metric <= tols[0] and grad <= tols[1]
            bound = f"phase 15's order rule{f64}"
        else:
            noise_metric, noise_grad = r0["bf16_vs_f32"]
            tols = (MOL_TP_BF16_FACTOR * noise_metric + 1e-6, MOL_TP_BF16_FACTOR * noise_grad)
            ok = metric <= tols[0] and grad <= tols[1]
            bound = (f"{MOL_TP_BF16_FACTOR}x the one-process bf16 step's distance "
                     f"({noise_metric:.3g}, {noise_grad:.3g})")
        log(f"[tp]   {key} step 1 against the one-process f32 step: metrics max rel err "
            f"{metric:.3g}, gradients max err / the step's largest |g| {grad:.3g} at {worst}; "
            f"bound ({tols[0]:.3g}, {tols[1]:.3g}): {bound}; loss {r0['loss']:.6g}, after "
            f"step 2 {r0['loss2']:.6g}; the steps {1e3 * r0['s'][0]:.1f} and "
            f"{1e3 * r0['s'][1]:.1f} ms (wall{record}); the tensor "
            f"group all-reduces {r0['tensor_bytes'] / 1e9:.4f} GB of f32 activations and "
            f"activation gradients a step a rank, and "
            f"{r0['replicated_grad_bytes'] / 1e6:.2f} MB of the replicated leaves' "
            f"gradients; the whole parameters after both steps bitwise equal on every "
            f"rank: {same} (SHA-256 {r0['params_sha256'][:16]}...)")
        for rank, r in enumerate(res):
            rr = r[key]
            log(f"[tp]   {key} rank {rank}: {rr['params_rank'] / 1e6:.3f} M of "
                f"{rr['params_whole'] / 1e6:.3f} M parameters; the state holds "
                f"{rr['allocated'] / 1e6:.1f} MB after the steps (the plan reckons "
                f"{rr['reckoned'] / 1e6:.1f} MB: f32 parameters with mu, nu and the EMA); "
                f"K1/K2a/K2b launches {rr['launches']} ({smi})")
        if not ok:
            failures.append(f"the {where} tensor=2 {key} step against one process: {r0}")
        if not same:
            failures.append(f"the {where} tensor=2 {key} steps: the ranks' whole parameters "
                            "differ")
        for r in res:
            rr = r[key]
            held = (rr["params_rank"] == rr["params_whole"] if family in MOL_TP_WHOLE
                    else rr["params_rank"] < rr["params_whole"])
            if any(rr["launches"]) or not rr["finite"] or not held:
                failures.append(f"the tensor=2 {key} steps on a rank: {rr}")
    if failures:
        raise AssertionError("\n".join(failures))


def mol_tp_rank_main(out_dir, backend, families):
    """One rank of the slice-20/21 tensor=2 steps alone (`chip_smoke.py
    --mol-tp-rank DIR BACKEND FAMILY...`, RANK / WORLD_SIZE / LOCAL_RANK set
    by the parent): rank 0 takes the one-process references, then every
    rank joins the group and runs the steps of `families` (MOL_TP keys)."""
    from reed_tpu_torch.parallel.mesh import init_distributed

    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    refs = mol_tp_refs(backend, families) if rank == 0 else None
    seconds = [time.perf_counter() - t0]
    init_distributed("cuda", backend=backend, init_method=f"file://{out_dir}/store_{backend}")
    t0 = time.perf_counter()
    res = mol_tp_rank_part(rank, refs, backend, families)
    seconds.append(time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{rank}_{backend}.json"), "w") as f:
        json.dump(dict(steps=res, s=seconds), f)
    torch.distributed.destroy_process_group()


def mol_tp_main(families):
    """The slice-20/21 tensor=2 steps of `families` alone (`chip_smoke.py
    --mol-tp FAMILY...`): two gloo ranks on one card, or, where the machine
    has two cards, two NCCL ranks, one card each, and then the torchrun
    --tp 2 smokes of the slice-21 subcommands; the [tp] lines and checks of
    phase 15 (mol_tp_report)."""
    smi = device_phase()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP["world"] else "gloo"
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        res = run_ranks(tmp, backend, cards, "--mol-tp-rank", tmp, backend, *families)
        where = f"{DP['world']} ranks over {backend}" + (
            " on one card" if backend == "gloo" else f" on {DP['world']} cards")
        log(f"[tp] {where}: {time.perf_counter() - t0:.1f} s; rank 0's one-process references "
            f"{res[0]['s'][0]:.1f} s, the tensor=2 steps {res[0]['s'][1]:.1f} s")
        mol_tp_report([r["steps"] for r in res], where, smi)
        if backend == "nccl":
            world = str(DP["world"])
            for cmd, *extra in (("train-multiflow",), ("train-rdm",),
                                ("train-molecule-semla", "--set", "arch=egnn"),
                                ("train-property", "--linear-probe")):
                dp_torchrun_phase(tmp, smi, cmd, "--tp", world, *extra)
    print(smi)


# --- phase 15 (e), slice 22: data- and tensor-parallel evaluation ------------

# the eval samplers on phase 15's ranks, each at its full width from its
# checked weights, at data=2 and tensor=2 against one process: eval-protein
# at PROTEIN's 8 x 256, 50 steps (K2a at H = 128 on each batch index's 4
# rows under data, at H = MSG_TP_H on the 8 rows under tensor); MultiFlow
# (MultiflowTrainConfig, 4 x 64, 10 steps), SemlaFlow (the recipe's width at
# max_atoms 72, 8 molecules of 20-40 atoms, 10 steps), the EDM
# (MoleculeEDMConfig, 8 molecules, T = 25) and eval-conditional (the EDM
# with context_node_nf 1 at T = 25 and PropertyTrainConfig's classifier on
# its 8 samples), the step counts cut from 100, 100, 1000 and 50 at most
# (the EDM's from 50 to 25 to keep the script inside its time: over gloo a
# tensor=2 EDM step takes ~0.26 s); eval-protein in bf16 at tensor=2 once,
# 10 steps (logged).
# Each run is held twice. At data=2, against the split witness (one process
# running each batch index's rows apart, its draws at the global batch):
# equal, output for output (EVAL_SPLIT_RTOL, agreement 1), since the ranks
# run the same products on the same rows. Against one process at the
# global batch, at data=2 and tensor=2: continuous outputs within
# GEN_RTOL[f32] of their largest magnitude (a batch of other rows and the
# split sums round in another order, carried through every step), discrete
# ones at TOKEN_AGREEMENT or above. SemlaFlow's 10-step run (EVAL_CHAOTIC)
# is logged beside the jitter witness instead (one process's run with every
# weight scaled by 1 + 1e-7 N(0, 1)): at the recipe's width its categorical
# draws turn one rounding into another trajectory (on an H100 80GB HBM3 at
# 700.00 W the jitter witness read 0.851 of the largest coordinate and
# 0.899 of the types and bonds equal), so no distance from one process
# bounds a split run there; its one-step run (semla_first: the first
# prediction, before any draw) is held in its place.
EVAL_MESHES = {"data": dict(data=2), "tensor": dict(tensor=2)}
EVAL_STEPS = dict(protein=PROTEIN["num_steps"], multiflow=10, semla=10, semla_first=1,
                  edm=25, conditional=25, protein_bf16=10)
EVAL_ROWS = dict(protein=PROTEIN["batch"], multiflow=4, semla=8, semla_first=8, edm=8,
                 conditional=8, protein_bf16=PROTEIN["batch"])
# the runs at each mesh (protein_bf16 at tensor=2 alone)
EVAL_RUNS = [(family, mesh) for mesh in EVAL_MESHES for family in EVAL_ROWS
             if family != "protein_bf16"] + [("protein_bf16", "tensor")]
EVAL_MULTIFLOW_LENGTH = 64
EVAL_SPLIT_RTOL = 1e-6
EVAL_CHAOTIC = ("semla",)
# (outputs held as continuous, outputs held as discrete) of each family
EVAL_OUTPUTS = {"protein": ((), ("pred", "tokens")), "protein_bf16": ((), ("pred", "tokens")),
                "multiflow": (("trans", "rotmats"), ("aatypes",)),
                "semla": (("coords",), ("atomics", "bonds", "charges")),
                "semla_first": (("coords",), ("atomics", "bonds", "charges")),
                "edm": (("x",), ("h_cat",)),
                "conditional": (("x", "preds"), ("h_cat",))}
# the eval subcommands through torchrun where two cards exist: (subcommand,
# its flags), each with --tp 2 (eval-protein with --dp 2 too)
EVAL_TORCHRUN = [
    ("eval-protein", ("--batch-size", "8", "--length", "256", "--num-steps", "10")),
    ("eval-semla", ("--config", RECIPE_SEMLA, "--n-samples", "8", "--n-replicates", "1",
                    "--num-steps", "5", "--set", "max_atoms=72")),
    ("eval-molecule", ("--batch-size", "8", "--n-replicates", "1", "--num-steps", "20")),
    ("eval-conditional", ("--n-samples", "8", "--n-replicates", "1", "--num-steps", "20")),
    ("eval-multiflow", ("--num-samples", "4", "--length", "64", "--num-steps", "5")),
]


def eval_weights():
    """The whole checked weights (host state_dicts) of each eval family at
    full width: the protein model of protein_phase (perturb_pmpnn), and
    seeded_flow_model, seeded_semla, seeded_edm (twice: without and with
    the property context) and the property classifier with its biases
    moved (mol_tp_setup's)."""
    def host(model):
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    protein = build_model(ProteinTrainConfig(), device="cuda", generator=gen)
    perturb_pmpnn(protein, gen)
    gen = torch.Generator(device="cuda").manual_seed(5)
    clf = property_train.build_model(property_train.PropertyTrainConfig(), device="cuda",
                                     generator=gen)
    with torch.no_grad():
        for name, p in clf.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gen, device="cuda") * PROPERTY_BIAS_STD)
    out = dict(protein=host(protein), classifier=host(clf),
               multiflow=host(seeded_flow_model(mf_train.MultiflowTrainConfig())),
               semla=host(seeded_semla(semla_full_config())),
               edm=host(seeded_edm(edm_train.MoleculeEDMConfig())),
               conditional=host(seeded_edm(edm_train.MoleculeEDMConfig(context_node_nf=1))))
    torch.cuda.empty_cache()
    return out


def eval_run(family, mesh, weights, split=None, jitter=False):
    """The eval sampler of `family` on `mesh` (a MeshConfig; None: one
    process) from the whole `weights`: every rank builds the global batch,
    samples its rows inside draws.global_rows and gathers them
    (parallel.mesh.run_rows). Returns its outputs on the host, its seconds,
    the K1 / K2a / K2b launches in it (counted just before, read just
    after) and, for the protein, the hidden units a rank's decoder chain
    holds. Two witnesses in one process: `split` (a count W) runs each of W
    batch indices' rows apart (parallel.mesh.rows_apart), as W data ranks
    do without their collectives; `jitter` scales
    every weight by 1 + 1e-7 N(0, 1) (about one f32 rounding), which
    measures how far the sampler's own rounding carries."""
    from reed_tpu_torch.eval.two_stage import molecule_masks
    from reed_tpu_torch.parallel.mesh import (EGNN_AXES, EGNN_TP_RULES, IPA_AXES, PMPNN_AXES,
                                             PMPNN_TP_RULES, SEMLA_AXES, SEMLA_TP_RULES,
                                             data_parallel, rows_apart, run_rows)

    def loaded(model, key, rules):
        sd = weights[key]
        if jitter:
            g = torch.Generator().manual_seed(11)
            sd = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g))
                  if v.is_floating_point() else v for k, v in sd.items()}
        model.load_state_dict(shard_state_dict(sd, dp, rules))
        return model.eval()


    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    n, steps = EVAL_ROWS[family], EVAL_STEPS[family]
    rng = np.random.default_rng(3)
    extra = {}
    if family in ("protein", "protein_bf16"):
        cfg = ProteinTrainConfig(compute_dtype="bfloat16" if family == "protein_bf16"
                                 else "float32")
        dp = None if mesh is None else data_parallel(mesh, axes=PMPNN_AXES)
        model = loaded(build_model(cfg, device="cuda", parallel=dp), "protein", PMPNN_TP_RULES)
        extra["hidden"] = int(model.state_dict()["decoder_layers.0.W2.weight"].shape[0])
        interp = dataclasses.replace(cfg.interpolant, num_timesteps=steps)
        batch = synthetic_protein_batch(gen(1), n, PROTEIN["length"])

        def fn(rows):
            return dict(zip(("pred", "tokens"), sample(model, rows, gen(7), interp)))
    elif family == "multiflow":
        cfg = mf_train.MultiflowTrainConfig()
        dp = None if mesh is None else data_parallel(mesh, axes=IPA_AXES)
        model = loaded(mf_train.build_model(cfg, device="cuda", parallel=dp), family,
                       mf_train.tp_rules(cfg))
        batch = torch.ones((n, EVAL_MULTIFLOW_LENGTH), device="cuda")

        def fn(res_mask):
            return mf_train.sample(cfg, model, res_mask, num_timesteps=steps, generator=gen(5))
    elif family in ("semla", "semla_first"):
        cfg = semla_full_config()
        cfg = dataclasses.replace(cfg, integrator=dataclasses.replace(cfg.integrator,
                                                                     steps=steps))
        dp = None if mesh is None else data_parallel(mesh, axes=SEMLA_AXES)
        model = loaded(semla_train.build_model(cfg, device="cuda", parallel=dp), "semla",
                       SEMLA_TP_RULES)
        sizes = rng.integers(20, 41, n)
        mask = (np.arange(cfg.max_atoms)[None, :] < sizes[:, None]).astype(np.float32)
        batch = {"prior": semla_train.sample_prior(cfg, rng, mask, "cuda"),
                 "rep": torch.from_numpy(rng.standard_normal((n, cfg.d_rep)).astype(
                     np.float32)).cuda()}

        def fn(rows):
            out = semla_train.generate(model, cfg, rows["prior"], rep=rows["rep"],
                                       generator=gen(6))
            return {k: out[k] for k in ("coords", "atomics", "bonds", "charges")}
    else:
        conditional = family == "conditional"
        cfg = edm_train.MoleculeEDMConfig(context_node_nf=int(conditional))
        cfg = dataclasses.replace(cfg, edm=dataclasses.replace(cfg.edm, timesteps=steps))
        dp = None if mesh is None else data_parallel(mesh, axes=EGNN_AXES)
        model = loaded(edm_train.build_dynamics(cfg, device="cuda", parallel=dp), family,
                       EGNN_TP_RULES)
        node_mask, edge_mask = molecule_masks(rng.integers(15, cfg.max_nodes + 1, n),
                                              cfg.max_nodes, device="cuda")
        rep = torch.from_numpy(rng.standard_normal((n, cfg.rep_nf)).astype(np.float32)).cuda()
        context = torch.from_numpy(rng.standard_normal((n, 1, 1)).astype(np.float32)).cuda()
        batch = (node_mask, edge_mask, rep, context.expand(n, cfg.max_nodes, 1) * node_mask)
        if conditional:
            clf_cfg = property_train.PropertyTrainConfig()
            clf = loaded(property_train.build_model(clf_cfg, device="cuda", parallel=dp),
                         "classifier", EGNN_TP_RULES)

        def fn(rows):
            nm, em, r, ctx = rows
            x, h_cat, _ = edm_train.sample(cfg, model, nm, em, rep=r,
                                           context=ctx if conditional else None,
                                           generator=gen(7))
            out = {"x": x, "h_cat": h_cat}
            if conditional:
                out["preds"] = property_train.predict(clf_cfg, clf, h_cat, x, nm, em)
            return out
    torch.cuda.synchronize()
    fa.launches = fm.launches = fm.backward_launches = 0
    t0 = time.perf_counter()
    out = rows_apart(split, n, batch, fn) if split else run_rows(dp, n, batch, fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [fa.launches, fm.launches, fm.backward_launches]
    out = {k: v.float().cpu() if v.is_floating_point() else v.cpu() for k, v in out.items()}
    del model
    torch.cuda.empty_cache()
    return dict(out=out, s=seconds, launches=launches, **extra)


def eval_compare(family, got, want):
    """(worst continuous output's max abs err / its max |ref|, the least
    share of equal discrete outputs) of `got` against `want`."""
    cont, disc = EVAL_OUTPUTS[family]
    rel = max([0.0] + [float((got[k] - want[k]).abs().max() / want[k].abs().max())
                       for k in cont])
    agree = min(float((got[k].argmax(-1) == want[k].argmax(-1)).float().mean())
                if got[k].is_floating_point() and got[k].dim() > 1
                and k not in ("pred", "tokens", "aatypes")
                else float((got[k] == want[k]).float().mean()) for k in disc)
    return rel, agree


def eval_refs():
    """Rank 0's one-process references, before the group: each family's
    eval_run (the protein in f32 and bf16) without a mesh and its witnesses
    (`split` over the data=2 indices; `jitter` for EVAL_CHAOTIC), as
    {'one', 'split', 'jitter'} a family, and the weights (under
    'weights')."""
    weights = eval_weights()
    refs = {"weights": weights}
    for family in EVAL_ROWS:
        if family == "protein_bf16":
            refs[family] = dict(one=eval_run(family, None, weights))
            continue
        split = eval_run(family, None, weights, split=2)  # first: it loads the kernels
        refs[family] = dict(one=eval_run(family, None, weights), split=split)
        if family in EVAL_CHAOTIC:
            refs[family]["jitter"] = eval_run(family, None, weights, jitter=True)
    return refs


def eval_rank_part(rank, refs):
    """Phase 15 (e) on a rank of its group: each family's eval_run at
    data=2 and at tensor=2 (the protein at tensor=2 in bf16 too), against
    rank 0's one-process `refs`: rows of (family, mesh): seconds, launches,
    and on rank 0 the errors (eval_compare)."""
    from reed_tpu_torch.core.config import MeshConfig

    weights = refs["weights"] if rank == 0 else eval_weights()
    rows = {}
    for family, mesh in EVAL_RUNS:
        run = eval_run(family, MeshConfig(**EVAL_MESHES[mesh]), weights)
        key = family
        row = dict(s=run["s"], launches=run["launches"], hidden=run.get("hidden"),
                   shapes={k: list(v.shape) for k, v in run["out"].items()},
                   finite=all(bool(torch.isfinite(v.float()).all())
                              for v in run["out"].values()))
        if rank == 0:
            ref = refs[key]
            row["rel"], row["agree"] = eval_compare(family, run["out"], ref["one"]["out"])
            row["one_s"], row["one_launches"] = ref["one"]["s"], ref["one"]["launches"]
            for witness in ("split", "jitter"):
                if witness in ref:
                    row[witness] = eval_compare(family, ref[witness]["out"], ref["one"]["out"])
            if mesh == "data" and "split" in ref:
                row["vs_split"] = eval_compare(family, run["out"], ref["split"]["out"])
        rows[f"{key}/{mesh}"] = row
    return rows


def eval_report(res, where, smi):
    """Phase 15 (e)'s lines and checks from each rank's eval_rank_part.
    Returns rank 0's K2a launches of eval-protein's sample at data=2 and
    at tensor=2."""
    r0 = res[0]
    cfg = ProteinTrainConfig()
    log(f"[eval] (e) {where}: the eval samplers at data=2 and tensor=2, each at full width "
        f"from its checked weights: data=2 equal to its split witness (within "
        f"{EVAL_SPLIT_RTOL}, every discrete output); against one process continuous outputs "
        f"within GEN_RTOL {GEN_RTOL[torch.float32]} of their largest, discrete ones at "
        f"{TOKEN_AGREEMENT} or above, but {', '.join(EVAL_CHAOTIC)} (10 steps) and the bf16 "
        "protein, logged beside the jitter witness; seconds are a record: over gloo the "
        "collectives go through the host")
    failed = []
    for key, row in r0.items():
        family, mesh = key.split("/")
        held = family not in ("protein_bf16",) + EVAL_CHAOTIC
        witnesses = "; ".join(f"{w} witness {row[w][0]:.3g}, {row[w][1]:.4f}"
                              for w in ("split", "jitter") if w in row)
        vs_split = row.get("vs_split")
        log(f"[eval]   {family} at {mesh}=2 ({EVAL_ROWS[family]} rows, {EVAL_STEPS[family]} "
            f"steps): against one process continuous max rel err {row['rel']:.3g}, discrete "
            f"agreement {row['agree']:.4f}{'' if held else ' (logged)'}"
            + (f" ({witnesses})" if witnesses else "")
            + (f"; against the split witness {vs_split[0]:.3g}, {vs_split[1]:.4f}"
               if vs_split else "")
            + f"; {row['s']:.2f} s (one process {row['one_s']:.2f} s); K1/K2a/K2b launches a "
            f"rank {[r[key]['launches'] for r in res]} (one process {row['one_launches']})"
            + (f"; K2a at H = {row['hidden']}" if row["hidden"] else "") + f" ({smi})")
        for r in res:
            rr = r[key]
            if not rr["finite"] or rr["shapes"] != row["shapes"]:
                failed.append(f"eval {key} on a rank: {rr}")
            if rr["hidden"]:
                expect = (2 * cfg.num_encoder_layers
                          + cfg.num_decoder_layers * (EVAL_STEPS[family] - 1))
                hidden = 128 if mesh == "data" else MSG_TP_H
                if rr["launches"] != [0, expect, 0] or rr["hidden"] != hidden:
                    failed.append(f"eval {key}: launches {rr['launches']} (expected "
                                  f"{[0, expect, 0]}), H {rr['hidden']} ({hidden})")
            elif rr["launches"] != [0, 0, 0]:
                failed.append(f"eval {key}: a TPU kernel's port launched: {rr}")
        if vs_split and not (vs_split[0] <= EVAL_SPLIT_RTOL and vs_split[1] == 1.0):
            failed.append(f"eval {key} against its split witness: {row}")
        if held and not (row["rel"] <= GEN_RTOL[torch.float32]
                         and row["agree"] >= TOKEN_AGREEMENT):
            failed.append(f"eval {key} against one process: {row}")
    if failed:
        raise AssertionError("\n".join(failed))
    return r0["protein/data"]["launches"][1], r0["protein/tensor"]["launches"][1]


def dp_torchrun_eval(tmp, smi, cmd, *args):
    """`cmd` --distributed through torchrun with the flags `args`, one card
    a rank: it exits 0 and rank 0 prints the JSON."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP["world"]), "-m", "reed_tpu_torch.cli",
                           cmd, "--distributed", *args], capture_output=True, text=True,
                          timeout=DP["timeout"])
    label = " ".join((f"{cmd} --distributed",) + args)
    if proc.returncode or "{" not in proc.stdout:
        raise RuntimeError(f"torchrun {label} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[eval] (c) torchrun --nproc_per_node {DP['world']} {label}: "
        f"{time.perf_counter() - t0:.1f} s, rank 0's JSON printed ({smi})")


def eval_torchrun_phase(tmp, smi):
    """(c) the eval subcommands through torchrun, one card a rank:
    eval-protein with --dp 2, then each of EVAL_TORCHRUN with --tp 2."""
    world = str(DP["world"])
    dp_torchrun_eval(tmp, smi, "eval-protein", *EVAL_TORCHRUN[0][1], "--dp", world)
    for cmd, args in EVAL_TORCHRUN:
        out = ("--out", os.path.join(tmp, "eval_multiflow")) if cmd == "eval-multiflow" else ()
        dp_torchrun_eval(tmp, smi, cmd, *args, *out, "--tp", world)


def eval_rank_main(out_dir, backend):
    """One rank of phase 15 (e) alone (`chip_smoke.py --eval-rank DIR
    BACKEND`, RANK / WORLD_SIZE / LOCAL_RANK set by the parent): rank 0
    takes the one-process references, then every rank joins the group and
    runs the eval samplers at data=2 and tensor=2."""
    from reed_tpu_torch.parallel.mesh import init_distributed

    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    refs = eval_refs() if rank == 0 else None
    seconds = [time.perf_counter() - t0]
    init_distributed("cuda", backend=backend, init_method=f"file://{out_dir}/store_{backend}")
    t0 = time.perf_counter()
    res = eval_rank_part(rank, refs)
    seconds.append(time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{rank}_{backend}.json"), "w") as f:
        json.dump(dict(eval=res, s=seconds), f)
    torch.distributed.destroy_process_group()


def eval_main():
    """Phase 15 (e) alone (`chip_smoke.py --eval`): two gloo ranks on one
    card, or, where the machine has two cards, two NCCL ranks, one card
    each, and then the eval subcommands through torchrun; the [eval] lines
    and checks (eval_report)."""
    smi = device_phase()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP["world"] else "gloo"
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        res = run_ranks(tmp, backend, cards, "--eval-rank", tmp, backend)
        where = f"{DP['world']} ranks over {backend}" + (
            " on one card" if backend == "gloo" else f" on {DP['world']} cards")
        log(f"[eval] {where}: {time.perf_counter() - t0:.1f} s; rank 0's one-process "
            f"references {res[0]['s'][0]:.1f} s, the data=2 and tensor=2 samplers "
            f"{res[0]['s'][1]:.1f} s")
        eval_report([r["eval"] for r in res], where, smi)
        if backend == "nccl":
            eval_torchrun_phase(tmp, smi)
    print(smi)


def run_ranks(tmp, backend, cards, *argv):
    """`DP['world']` ranks of this script with the arguments `argv` over
    `backend`, each on card rank % cards, their output in tmp; the JSON
    each rank wrote to tmp/rank{r}_{backend}.json. Raises with every rank's
    output where one fails (stopping the others, which would wait in a
    collective) or at DP['timeout']."""
    world = DP["world"]
    t0 = time.perf_counter()
    logs = [os.path.join(tmp, f"rank{r}_{backend}.log") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                              env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                                       LOCAL_RANK=str(r % cards)),
                              stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
             for r in range(world)]
    try:  # a rank that fails leaves the others waiting in a collective: stop them all
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            if time.perf_counter() - t0 > DP["timeout"]:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r} exit {p.returncode}\n{open(log).read()[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [json.load(open(os.path.join(tmp, f"rank{r}_{backend}.json"))) for r in range(world)]


def dp_ranks_phase(tmp, backend, cards, smi):
    """(b) / (c): `DP['world']` ranks of dp_rank_main over `backend`, each on
    card rank % cards, against one process at the same global batches, and
    at fsdp=2 against data=2 (fsdp_report), the model-parallel steps
    (mp_report, mol_tp_report) and the eval samplers (eval_report). Returns
    rank 0's launches of the fsdp steps, the model-parallel steps and the
    eval-protein samples."""
    world = DP["world"]
    t0 = time.perf_counter()
    res = run_ranks(tmp, backend, cards, "--dp-rank", tmp, backend)
    r0 = res[0]
    noise_metric, noise_grad = r0["image_bf16_vs_f32"]
    dp_metric, dp_grad = r0["image_dp_vs_f32"]
    metric_tol = IMAGE_BF16_NOISE_FACTOR * noise_metric + 1e-6
    grad_tol = IMAGE_BF16_NOISE_FACTOR * noise_grad
    det = r0["protein_repeat"]
    vs_witness = r0["protein_vs_witness"]
    p_metric, p_grad, p_worst = r0["protein_dp_errors"]
    w_metric, w_grad, w_worst = r0["witness_errors"]
    rep_metric, rep_grad, _ = r0["protein_repeat_errors"]
    gen = r0["generate"]
    where = f"{world} ranks over {backend}" + (" on one card" if cards == 1 else
                                                f" on {cards} cards")
    log(f"[dp] ({'b' if cards == 1 else 'c'}) {where}, {time.perf_counter() - t0:.1f} s "
        f"incl. start-up and the fsdp steps (rank 0's references and steps "
        f"{r0['rank_s']:.1f} s after joining, its fsdp steps {r0['fsdp_s']:.1f} s):")
    log(f"[dp]   SiT-XL/2 bf16 step at global batch {DP['image_global_batch']} "
        f"({DP['image_global_batch'] // world} a rank) against the one-process f32 step: "
        f"metrics {dp_metric:.3g}, gradients (max err / max |g|, worst parameter) "
        f"{dp_grad:.3g}; bound {IMAGE_BF16_NOISE_FACTOR}x the one-process bf16 step's "
        f"distance ({noise_metric:.3g}, {noise_grad:.3g}); loss {r0['image_loss'][0]:.6g} "
        f"(f32 {r0['image_loss'][1]:.6g}); the step {r0['image_step_s']:.2f} s; K1 "
        f"launches a rank {[r['image_launches'] for r in res]}")
    witness_rule = within_noise(vs_witness and tuple(vs_witness), det and tuple(det))
    log(f"[dp]   protein f32 step at {TRAIN['batch']} x {TRAIN['length']} "
        f"({TRAIN['batch'] // world} a rank): against the witness (one process, each "
        f"rank's rows with the global sums, the two gradients averaged) "
        f"{describe(vs_witness)}; a repeated one-process step {describe(det)} (bound "
        f"{RESUME_NOISE_FACTOR}x it). Against the one-process step at the global batch: "
        f"metrics max rel err {p_metric:.3g} (rtol {TRAIN_METRIC_RTOL}), gradients max err "
        f"/ max |g| {p_grad:.3g} at {p_worst} (rtol {DP_ORDER_GRAD_RTOL}); the witness "
        f"{w_metric:.3g}, {w_grad:.3g} at {w_worst}; a repeated step {rep_metric:.3g}, "
        f"{rep_grad:.3g}; global loss {r0['protein_loss'][0]:.6g} vs "
        f"{r0['protein_loss'][1]:.6g}; K2a/K2b launches a rank "
        f"{[r['protein_launches'] for r in res]}")
    log(f"[dp]   sharded generate_samples, {DP_GEN['num_samples']} images, "
        f"{DP_GEN['num_steps']} SDE steps with CFG, against one process: max abs err / "
        f"max |ref| {gen['rel']:.3g} (rtol {GEN_RTOL[torch.bfloat16]}); {gen['calls']} model "
        f"calls and {gen['launches']} K1 launches a rank ({smi})")
    if not (dp_metric <= metric_tol and dp_grad <= grad_tol):
        raise AssertionError(f"the {where} image step: {dp_metric}, {dp_grad} over "
                             f"{metric_tol}, {grad_tol}")
    if not witness_rule:
        raise AssertionError(f"the {where} protein step against its one-process witness: "
                             f"{describe(vs_witness)}, over {RESUME_NOISE_FACTOR}x a "
                             f"repeated step ({describe(det)})")
    if not (p_metric <= TRAIN_METRIC_RTOL and p_grad <= DP_ORDER_GRAD_RTOL):
        raise AssertionError(f"the {where} protein step against one process: metrics "
                             f"{p_metric}, gradients {p_grad} at {p_worst}")
    if not (gen["finite"] and gen["rel"] <= GEN_RTOL[torch.bfloat16]
            and gen["shape"] == [DP_GEN["num_samples"], 32, 32, 4]):
        raise AssertionError(f"the {where} sharded generation: {gen}")
    for r in res:
        if (r["image_launches"] != DEPTH or r["protein_launches"] != [9, 9]
                or r["generate"]["launches"] != DEPTH * r["generate"]["calls"]):
            raise AssertionError(f"launches on a rank: {r}")
    fsdp = fsdp_report([r["fsdp"] for r in res], where, smi)
    mp = mp_report([r["model_parallel"] for r in res], r0["model_parallel_s"], where,
                   (metric_tol, grad_tol), smi)
    log(f"[tp] slices 20-21 on {where}: rank 0's one-process references "
        f"{r0['molecule_refs_s']:.1f} s, the tensor=2 steps {r0['molecule_tp_s']:.1f} s")
    mol_tp_report([r["molecule_tp"] for r in res], where, smi)
    log(f"[eval] slice 22 on {where}: rank 0's one-process references "
        f"{r0['eval_refs_s']:.1f} s, the data=2 and tensor=2 samplers {r0['eval_s']:.1f} s")
    evals = eval_report([r["eval"] for r in res], where, smi)
    return fsdp, mp, evals


def mp_report(res, seconds, where, tols, smi):
    """Phase 15's tensor=2 and seq=2 lines and checks from each rank's
    mp_rank_part. Returns rank 0's K1 launches of each axis's step."""
    metric_tol, grad_tol = tols
    log(f"[tp/sp] {where}, tensor=2 and seq=2 against one process ({seconds:.1f} s on rank "
        f"0): SiT-XL/2 REED bf16 at global batch {DP['image_global_batch']}, each rank the "
        "whole batch (tensor: half the heads and of the MLP; seq: half the tokens; over gloo "
        "the collectives go through the host)")
    for axis in MP_AXES:
        r0 = res[0][axis]
        metric, grad = r0["vs_f32"]
        gen = r0["generate"]
        log(f"[tp/sp]   {axis}=2 step against the one-process f32 step: metrics {metric:.3g}, "
            f"gradients (max err / max |g|, worst parameter) {grad:.3g}; bound "
            f"({metric_tol:.3g}, {grad_tol:.3g}), {IMAGE_BF16_NOISE_FACTOR}x the "
            f"one-process bf16 step's distance; loss {r0['loss']:.6g}; the step "
            f"{r0['s']:.2f} s ({1e3 * r0['s']:.1f} ms); K1 launches a "
            f"rank {[r[axis]['launches'] for r in res]}; the whole parameters after it "
            f"bitwise equal on every rank: {len({r[axis]['params_sha256'] for r in res}) == 1} "
            f"(SHA-256 {r0['params_sha256'][:16]}...)")
        for rank, r in enumerate(res):
            rr = r[axis]
            log(f"[tp/sp]   {axis}=2 rank {rank}: memory allocated between steps "
                f"{rr['allocated'] / 1e9:.3f} GB (the plan reckons {rr['reckoned'] / 1e9:.3f} "
                f"GB of parameters and state: {rr['params_rank'] / 1e6:.1f} M of "
                f"{rr['params_whole'] / 1e6:.1f} M parameters on the rank) ({smi})")
        log(f"[tp/sp]   {axis}=2 generate_samples, {DP_GEN['num_samples']} images, "
            f"{DP_GEN['num_steps']} SDE steps with CFG {DP_GEN['cfg_scale']}, against one "
            f"process: max abs err / max |ref| {gen['rel']:.3g} (rtol "
            f"{GEN_RTOL[torch.bfloat16]}); {gen['calls']} model calls and {gen['launches']} K1 "
            f"launches a rank, {gen['s']:.1f} s ({smi})")
        if not (metric <= metric_tol and grad <= grad_tol):
            raise AssertionError(f"the {where} {axis}=2 image step: {metric}, {grad} over "
                                 f"{metric_tol}, {grad_tol}")
        if len({r[axis]["params_sha256"] for r in res}) != 1:
            raise AssertionError(f"the {where} {axis}=2 image step: the ranks' whole "
                                 f"parameters after it differ: "
                                 f"{[r[axis]['params_sha256'] for r in res]}")
        if not (gen["finite"] and gen["rel"] <= GEN_RTOL[torch.bfloat16]
                and gen["shape"] == [DP_GEN["num_samples"], 32, 32, 4]):
            raise AssertionError(f"the {where} {axis}=2 generation: {gen}")
        for r in res:
            rr = r[axis]
            if (rr["launches"] != DEPTH or rr["generate"]["launches"]
                    != DEPTH * rr["generate"]["calls"]):
                raise AssertionError(f"{axis}=2 launches on a rank: {rr}")
            if axis == "tensor" and not rr["params_rank"] < rr["params_whole"]:
                raise AssertionError(f"tensor=2 holds whole parameters: {rr}")
    protein = mp_protein_report([r["protein"] for r in res], where, smi)
    return dict({axis: res[0][axis]["launches"] for axis in MP_AXES}, protein=protein)


def mp_protein_report(res, where, smi):
    """Phase 15's protein tensor=2 lines and checks from each rank's
    mp_rank_part: the f32 step against the one-process f32 step within
    TRAIN_METRIC_RTOL (metrics) and DP_ORDER_GRAD_RTOL (each gradient of
    its largest), the rule phase 15 holds data=2 to against one process
    (a split product sums its partials in another order, so no one-process
    witness reproduces it bit for bit; a repeated one-process step's
    difference, K2b's atomics, is logged beside it); the bf16 step within
    PROTEIN_TP_BF16_FACTOR x the one-process bf16 step's distance from the
    f32 step; the ranks' whole parameters bitwise equal; 9 K2a + 9 K2b
    launches a rank; fewer parameters a rank than the model's. Returns
    rank 0's f32 launches."""
    log(f"[tp] {where}, the protein step at tensor=2 against one process: the default "
        f"ProteinTrainConfig at {TRAIN['batch']} x {TRAIN['length']}, each rank the whole "
        f"batch and {MSG_TP_H} of each message chain's 128 hidden units (K2a/K2b at H = "
        f"{MSG_TP_H}), half of each feed-forward, edge update and projector; over gloo the "
        "collectives go through the host")
    for dtype in ("float32", "bfloat16"):
        r0 = res[0][dtype]
        metric, grad, worst = r0["vs_f32"]
        same = len({r[dtype]["params_sha256"] for r in res}) == 1
        if dtype == "float32":
            vs_one, det = r0["vs_one"] and tuple(r0["vs_one"]), r0["det"] and tuple(r0["det"])
            rule = metric <= TRAIN_METRIC_RTOL and grad <= DP_ORDER_GRAD_RTOL
            log(f"[tp]   f32 step against the one-process f32 step: metrics max rel err "
                f"{metric:.3g} (rtol {TRAIN_METRIC_RTOL}), gradients max err / max |g| "
                f"{grad:.3g} at {worst} (rtol {DP_ORDER_GRAD_RTOL}); {describe(vs_one)}; a "
                f"repeated one-process step {describe(det)}")
        else:
            noise_metric, noise_grad = r0["bf16_vs_f32"]
            tols = (PROTEIN_TP_BF16_FACTOR * noise_metric + 1e-6,
                    PROTEIN_TP_BF16_FACTOR * noise_grad)
            rule = metric <= tols[0] and grad <= tols[1]
            log(f"[tp]   bf16 step against the one-process f32 step: metrics {metric:.3g}, "
                f"gradients {grad:.3g} at {worst}; bound ({tols[0]:.3g}, {tols[1]:.3g}), "
                f"{PROTEIN_TP_BF16_FACTOR}x the one-process bf16 step's distance "
                f"({noise_metric:.3g}, {noise_grad:.3g})")
        log(f"[tp]   {dtype}: the tensor group all-reduces {r0['tensor_bytes'] / 1e9:.4f} GB "
            f"of f32 activations and activation gradients a step a rank (the chains' "
            f"partial messages and input gradients, the feed-forwards, edge updates and "
            f"projectors), and {r0['replicated_grad_bytes'] / 1e6:.2f} MB of the replicated "
            f"leaves' gradients")
        log(f"[tp]   {dtype} loss {r0['loss']:.6g}; the step {r0['s']:.2f} s "
            f"({1e3 * r0['s']:.1f} ms, a record: gloo through the host); K2a/K2b launches a "
            f"rank {[r[dtype]['launches'] for r in res]}; the whole parameters after it "
            f"bitwise equal on every rank: {same} (SHA-256 {r0['params_sha256'][:16]}...)")
        for rank, r in enumerate(res):
            rr = r[dtype]
            log(f"[tp]   {dtype} rank {rank}: the state holds {rr['allocated'] / 1e6:.2f} MB "
                f"between steps (the plan reckons {rr['reckoned'] / 1e6:.2f} MB: "
                f"{rr['params_rank'] / 1e6:.3f} M of {rr['params_whole'] / 1e6:.3f} M "
                f"parameters on the rank, f32 with mu, nu and the EMA) ({smi})")
        if not rule:
            raise AssertionError(f"the {where} tensor=2 protein step in {dtype} against one "
                                 f"process: {r0}")
        if not same:
            raise AssertionError(f"the {where} tensor=2 protein step in {dtype}: the ranks' "
                                 f"whole parameters differ")
        for r in res:
            rr = r[dtype]
            if rr["launches"] != [9, 9] or not rr["params_rank"] < rr["params_whole"]:
                raise AssertionError(f"the tensor=2 protein step in {dtype} on a rank: {rr}")
    return tuple(res[0]["float32"]["launches"])


def fsdp_report(res, where, smi):
    """Phase 16 (b)'s lines and checks from each rank's fsdp_rank_part.
    Returns rank 0's K1 and (K2a, K2b) launches at fsdp=2."""
    r0 = res[0]
    image_ok = (r0["image_bitwise"] is None and (r0["image_params_bitwise"] or (
        r0["clip_acted"] and r0["image_param_rel"] <= FSDP_CLIP_REL))
        and r0["grad_norm_rel"] <= FSDP_GRAD_NORM_REL)
    det = r0["protein_det"] and tuple(r0["protein_det"])
    diff = r0["protein_diff"] and tuple(r0["protein_diff"])
    params = ("bitwise equal" if r0["image_params_bitwise"]
              else f"{r0['image_param_rel']:.3g} of the largest apart")
    log(f"[fsdp] (b) {where}, fsdp=2 against data=2 on the same ranks "
        f"(reduce_scatter_tensor and all_gather_into_tensor over the fsdp group)")
    log(f"[fsdp]   SiT-XL/2 bf16 step at global batch {DP['image_global_batch']}: metrics "
        f"but grad_norm and every gradient "
        f"{describe(r0['image_bitwise'] and tuple(r0['image_bitwise']))}; grad_norm "
        f"{r0['grad_norm_rel']:.3g} apart relative (bound {FSDP_GRAD_NORM_REL}); the clip "
        f"{'acts' if r0['clip_acted'] else 'does not act'} (grad_clip 1.0); parameters "
        f"after it {params} (bound {FSDP_CLIP_REL} where the clip acts); the step "
        f"{r0['image_fsdp']['s']:.2f} s at fsdp=2, {r0['image_data']['s']:.2f} s at data=2; "
        f"{r0['image_fsdp']['sharded']} sharded parameters; K1 launches a rank "
        f"{[r['image_fsdp']['launches'] for r in res]}")
    remat = r0["image_remat"]
    log(f"[fsdp]   SiT-XL/2 bf16 step at fsdp=2 under remat=True against the fsdp=2 step "
        f"without: metrics and every gradient {describe(r0['remat_bitwise'])}, parameters "
        f"after it {'bitwise equal' if r0['remat_params_bitwise'] else 'apart'}; "
        f"{remat['s']:.2f} s; K1 launches a rank {[r['image_remat']['launches'] for r in res]} "
        f"(the recompute runs each block's K1 again)")
    for r, rr in enumerate(res):
        gb = lambda key: (f"{rr[key]['held'] / 1e9:.3f} GB "  # noqa: E731
                          f"({rr[key]['allocated'] / 1e9:.3f} in all)")
        log(f"[fsdp]   rank {r}: memory the trainer holds between steps "
            f"{gb('image_data')} at data=2, {gb('image_fsdp')} at fsdp=2, "
            f"{gb('image_remat')} at fsdp=2 under remat (the plan "
            f"reckons {rr['image_data']['reckoned'] / 1e9:.3f} and "
            f"{rr['image_fsdp']['reckoned'] / 1e9:.3f} GB of parameters and state: "
            f"REMAT_RECKONING ~{REMAT_RECKONING['state']} and ~{REMAT_RECKONING['fsdp_rank']}; "
            f"bound at fsdp=2 the reckoning + {FSDP_MEMORY_SLACK / 1e9} GB and below PR 17's "
            f"{FSDP_PR17_BYTES / 1e9} GB, when only the state was sharded) ({smi})")
    log(f"[fsdp]   protein f32 step at {TRAIN['batch']} x {TRAIN['length']}: fsdp=2 against "
        f"data=2 {describe(diff)}; a repeated data=2 step {describe(det)} (bound "
        f"{RESUME_NOISE_FACTOR}x it); K2a/K2b launches a rank "
        f"{[r['protein_launches'] for r in res]}")
    if not image_ok:
        raise AssertionError(f"the {where} fsdp=2 image step against data=2: {r0}")
    if r0["remat_bitwise"] is not None or not r0["remat_params_bitwise"]:
        raise AssertionError(f"the {where} fsdp=2 remat step against fsdp=2: "
                             f"{describe(r0['remat_bitwise'])}")
    if not within_noise(diff, det):
        raise AssertionError(f"the {where} fsdp=2 protein step against data=2: "
                             f"{describe(diff)}, over {RESUME_NOISE_FACTOR}x {describe(det)}")
    for r in res:
        fsdp = r["image_fsdp"]
        if (fsdp["launches"] != DEPTH or r["image_remat"]["launches"] != 2 * DEPTH
                or r["protein_launches"] != [9, 9]):
            raise AssertionError(f"launches on a rank: {r}")
        for key in ("image_fsdp", "image_remat"):
            held = r[key]["held"]
            if not (held <= r[key]["reckoned"] + FSDP_MEMORY_SLACK and held < FSDP_PR17_BYTES
                    and held < r["image_data"]["held"]):
                raise AssertionError(f"memory on a rank at fsdp=2 ({key}): {r}")
    return (r0["image_fsdp"]["launches"], tuple(r0["protein_launches"]),
            r0["image_remat"]["launches"])


def dp_torchrun_phase(tmp, smi, cmd, *args):
    """(c) `cmd` --distributed (with the CLI flags `args`) through torchrun,
    one card a rank."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP["world"]), "-m", "reed_tpu_torch.cli",
                           cmd, "--distributed", *args, "--steps", "3",
                           "--synthetic", "--log-every", "1"], capture_output=True, text=True,
                          timeout=DP["timeout"])
    label = " ".join((f"{cmd} --distributed",) + args)
    if proc.returncode or proc.stdout.count("[step ") != 3:
        raise RuntimeError(f"torchrun {label} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[dp] (c) torchrun --nproc_per_node {DP['world']} {label} --steps 3: "
        f"{time.perf_counter() - t0:.1f} s, three [step N] lines from rank 0")


def dp_phases(smi):
    """Phase 15 (slice 16): data parallelism over torch.distributed, with
    phase 16 (b), the fsdp axis, on the same ranks. Returns the one-process
    group's launches and the gloo ranks' fsdp launches."""
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        launches = dp_group_phase(tmp, smi)
        fsdp_launches, mp_launches, eval_launches = dp_ranks_phase(tmp, "gloo", 1, smi)
        cards = torch.cuda.device_count()
        world = str(DP["world"])
        if cards >= DP["world"]:
            dp_ranks_phase(tmp, "nccl", cards, smi)
            dp_torchrun_phase(tmp, smi, "train-protein")
            dp_torchrun_phase(tmp, smi, "train-protein", "--fsdp", world)
            dp_torchrun_phase(tmp, smi, "train-image", *TORCHRUN_IMAGE, "--fsdp", world)
            dp_torchrun_phase(tmp, smi, "train-protein", "--tp", world)
            for flag in ("--tp", "--sp"):
                dp_torchrun_phase(tmp, smi, "train-image", *TORCHRUN_IMAGE, flag, world)
            for cmd in ("train-molecule-semla", "train-molecule-edm", "train-property",
                        "train-multiflow", "train-rdm"):
                dp_torchrun_phase(tmp, smi, cmd, "--tp", world)
            dp_torchrun_phase(tmp, smi, "train-molecule-semla", "--tp", world,
                              "--set", "arch=egnn")
            dp_torchrun_phase(tmp, smi, "train-property", "--tp", world, "--linear-probe")
            eval_torchrun_phase(tmp, smi)
        else:
            log(f"[dp] (c) not run: the NCCL ranks, torchrun train-protein --distributed "
                f"(without, with --fsdp {world} and with --tp {world}), torchrun "
                f"train-image --distributed --fsdp {world}, --tp {world} and --sp {world}, "
                f"and torchrun "
                f"train-molecule-semla (arch semla and egnn), train-molecule-edm, "
                f"train-property (and --linear-probe), train-multiflow and train-rdm "
                f"--distributed --tp {world}, and torchrun eval-protein --distributed "
                f"(--dp {world}, --tp {world}), eval-semla, eval-molecule, eval-conditional "
                f"and eval-multiflow --distributed --tp {world} need {world} cards (NCCL "
                f"takes one card a rank) and this machine has {cards}")
    return launches, fsdp_launches, mp_launches, eval_launches


# --- phase 16 (slice 17): SiT remat and the fsdp mesh axis -----------------

REMAT = dict(batch=48, timed_steps=3, recipe_batch=256, recipe_steps=3)
# the reckoning for SiT-XL/2 REED (697 M parameters from the 2.7874 GB of
# f32 gradients phase 15 all-reduces), GB: the state (params 2.79, bf16 mu 1.39, nu
# 2.79, EMA 2.79) and the gradients 2.79; the blocks' inputs under
# remat=True at batch 256 ([256, 256, 1152] bf16 x 28) and the products
# 'dots' keeps (qkv, proj, fc1, fc2: ~1.36 GB a block); a rank's state
# between steps at fsdp=2, every part sharded at rest (params 1.39, bf16 mu
# 0.70, nu 1.39, EMA 1.39, with the few replicated leaves whole: ~4.9;
# mesh_image_step reckons it from the plan's resident elements)
REMAT_RECKONING = dict(state=9.8, grads=2.79, block_inputs=4.2, dots_products=38.0,
                       fsdp_rank=4.9)
# phase 16 (b), fsdp=2 against data=2 on the card, where the clip acts
# (tests/test_torch_fsdp.py): grad_norm sums its squares in another order,
# the rest follows the clip's scale
FSDP_GRAD_NORM_REL = 1e-6
FSDP_CLIP_REL = 1e-5
# what a fsdp=2 rank's trainer may hold between steps beyond the plan's
# reckoning of its parameters and state (the batch and its REED targets,
# buffers, allocator rounding: 0.182 GB at data=2 and 0.233 at fsdp=2 on an
# H100 with the protein step's state beside it), and the most a rank held
# when only the state was sharded (6.444-6.525 GB, PR 17)
FSDP_MEMORY_SLACK = 0.25e9
FSDP_PR17_BYTES = 6.444e9


def remat_compare_phase(smi):
    """(a) at batch 48: one step under each remat setting (and a repeated
    step without) from the same initial state, batch and draws, its
    gradients captured; then timed steps of each without the capture, their
    peak memory, and the K1 launches of the first step. Returns the K1
    launches of the remat=True step."""
    base = bench_image_config(REMAT["batch"])
    batch, runs, rows = None, {}, {}
    for key, remat in (("off", False), ("repeat", False), ("true", True), ("dots", "dots")):
        trainer = image_train.ImageTrainer(dataclasses.replace(base, remat=remat),
                                           device="cuda")
        if batch is None:
            batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(41))
        state = trainer.init_state()
        torch.cuda.synchronize()
        fa.launches = 0
        state, runs[key] = dp_step_record(trainer, state, batch, 1)
        torch.cuda.synchronize()
        launches = fa.launches
        runs[key] = [(m, [g.cpu() for g in gs]) for m, gs in runs[key]]
        if key != "repeat":
            # the peak of the timed steps alone: the captured step holds a
            # copy of every gradient
            torch.cuda.reset_peak_memory_stats()
            n = REMAT["timed_steps"]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                state, _ = trainer.train_step(state, batch)
            end.record()
            torch.cuda.synchronize()
            rows[key] = dict(wall=1e3 * (time.perf_counter() - t0) / n,
                             device=start.elapsed_time(end) / n,
                             peak=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
        del trainer, state
        torch.cuda.empty_cache()
    det = dp_difference(runs["repeat"], runs["off"])
    for key in ("true", "dots"):
        diff = dp_difference(runs[key], runs["off"])
        log(f"[remat] (a) SiT-XL/2 REED bf16 step at batch {REMAT['batch']}, remat="
            f"{key!r} against no remat from the same state and draws (loss, metrics, every "
            f"gradient): {describe(diff)}; a repeated step without remat {describe(det)}")
        if not within_noise(diff, det):
            raise AssertionError(f"the remat={key} step differs from the step without: "
                                 f"{describe(diff)} (a repeated step: {describe(det)})")
    for key, row in rows.items():
        log(f"[remat] (a) remat={key!r} at batch {REMAT['batch']}: {row['wall']:.3f} ms a step "
            f"by wall, {row['device']:.3f} by CUDA events ({REMAT['timed_steps']} steps), "
            f"{REMAT['batch'] * 1e3 / row['wall']:.2f} imgs/s, peak {row['peak']:.2f} GB, K1 "
            f"launches in the first step {row['launches']} ({smi})")
    want = {"off": DEPTH, "true": 2 * DEPTH, "dots": 2 * DEPTH}
    if any(rows[k]["launches"] != want[k] for k in want):
        raise AssertionError(f"K1 launches a step: { {k: r['launches'] for k, r in rows.items()} }"
                             f", expected {want}")
    return rows["true"]["launches"]


def remat_recipe_phase(smi):
    """(a) the recipe's batch 256 for REMAT['recipe_steps'] steps under remat
    True and 'dots' (never without remat: it does not fit)."""
    base = bench_image_config(REMAT["recipe_batch"])
    out = {}
    for remat in (True, "dots"):
        trainer = image_train.ImageTrainer(dataclasses.replace(base, remat=remat),
                                           device="cuda")
        state = trainer.init_state()
        batch = trainer.synthetic_batch(torch.Generator(device="cuda").manual_seed(43))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0
        times = []
        for _ in range(REMAT["recipe_steps"]):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 1e9
        later = sum(times[1:]) / len(times[1:])
        out[remat] = dict(peak=peak, first=times[0], ms=later, launches=fa.launches)
        log(f"[remat] (a) recipe batch {REMAT['recipe_batch']}, remat={remat!r}: "
            f"{REMAT['recipe_steps']} steps, {times[0]:.1f} ms the first, {later:.1f} ms a "
            f"step after it by wall ({REMAT['recipe_batch'] * 1e3 / later:.1f} imgs/s), peak "
            f"{peak:.2f} GB (reckoned {REMAT_RECKONING['state']} GB of state + "
            f"{REMAT_RECKONING['grads']} of gradients + "
            + (f"{REMAT_RECKONING['block_inputs']} of block inputs and one block's recompute"
               if remat is True else f"~{REMAT_RECKONING['dots_products']} of saved products")
            + f"); K1 launches {fa.launches} (expected {2 * DEPTH * REMAT['recipe_steps']}); "
            f"loss {metrics['loss'].item():.6g} ({smi})")
        if fa.launches != 2 * DEPTH * REMAT["recipe_steps"]:
            raise AssertionError(f"K1 launches at batch 256: {fa.launches}")
        if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
            raise AssertionError(f"non-finite metrics at batch 256 remat={remat}: {metrics}")
        del trainer, state, batch
        torch.cuda.empty_cache()
    return out


def remat_phases(smi):
    """Phase 16 (slice 17): SiT remat (its (b), the fsdp axis, runs in phase
    15's ranks). Returns the K1 launches of the remat=True step."""
    remat_launches = remat_compare_phase(smi)
    remat_recipe_phase(smi)
    return remat_launches


def kernel_entry(name, replaces, row, launches, source=None):
    return dict(name=name, route="cuda",
                source=f"reed_tpu_torch/csrc/{source or name}.cu",
                replaces=replaces, launches=launches, max_abs_err=row["max_abs_err"],
                ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])


def main():
    t_start = time.perf_counter()

    def timed(fn, *args):
        """fn(*args), its seconds logged: where the script's time goes."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__} {time.perf_counter() - t0:.1f} s (script at "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out

    smi = device_phase()
    timed(build_phase)
    cli_process()
    attn_rows = timed(kernel_phase, smi)
    msg_rows = timed(message_kernel_phase, smi)
    bwd_rows = timed(message_backward_phase, smi)
    tp_rows = timed(message_tp_phase, smi)
    attn_launches, attn_f32_launches = timed(slice_phase, smi)
    msg_launches = timed(protein_phase, smi)
    bwd_launches = timed(train_phase, smi)
    timed(widths_phase)
    image_launches, gate_launches = timed(image_train_phase, smi)
    t0 = time.perf_counter()
    gen_vae_launches, enc_launches = timed(eval_phases, smi)
    log(f"[eval] slice 8 phases in {time.perf_counter() - t0:.1f} s; K1 launches on its "
        f"paths: {gen_vae_launches} in generate-image --vae (16 calls), {enc_launches} in "
        f"train-image --enc-type ({ENC_DATA['steps']} steps)")
    semla_f32 = timed(molecule_phases, smi)
    edm_f32 = timed(edm_phases, smi)
    bf16_launches = timed(precision_rdm_phases, smi, semla_f32, edm_f32)
    timed(multiflow_phases, smi)
    timed(property_phases, smi)
    guided = timed(slice14_phases, smi)
    ((dp_image, dp_protein), (fsdp_image, fsdp_protein, fsdp_remat), mp_image,
     (eval_dp, eval_tp)) = timed(dp_phases, smi)
    remat_launches = timed(remat_phases, smi)
    kernels = [
        kernel_entry("flash_attention", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(MAIN_SHAPE, torch.bfloat16)], attn_launches),
        kernel_entry("flash_attention_f32", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(MAIN_SHAPE, torch.float32)], attn_f32_launches,
                     source="flash_attention"),
        kernel_entry("fused_message", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.float32)], msg_launches),
        kernel_entry("fused_message_bwd", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.float32)], bwd_launches,
                     source="fused_message"),
        kernel_entry("flash_attention_train", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(IMAGE_ATTN_SHAPE, torch.bfloat16)], image_launches,
                     source="flash_attention"),
        kernel_entry("flash_attention_f32_gate", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(GATE_ATTN_SHAPE, torch.float32)], gate_launches,
                     source="flash_attention"),
        kernel_entry("fused_message_bf16_train", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.bfloat16)], bf16_launches[0],
                     source="fused_message"),
        kernel_entry("fused_message_bwd_bf16_train", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.bfloat16)], bf16_launches[1],
                     source="fused_message"),
        kernel_entry("fused_message_guided", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.float32)], guided["k2a"],
                     source="fused_message"),
        kernel_entry("fused_message_bwd_guided", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.float32)], guided["k2b"],
                     source="fused_message"),
        kernel_entry("flash_attention_dp", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(IMAGE_ATTN_SHAPE, torch.bfloat16)], dp_image,
                     source="flash_attention"),
        kernel_entry("fused_message_dp", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.float32)], dp_protein[0],
                     source="fused_message"),
        kernel_entry("fused_message_bwd_dp", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.float32)], dp_protein[1],
                     source="fused_message"),
        kernel_entry("flash_attention_remat", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(IMAGE_ATTN_SHAPE, torch.bfloat16)], remat_launches,
                     source="flash_attention"),
        kernel_entry("flash_attention_fsdp", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(IMAGE_ATTN_SHAPE, torch.bfloat16)], fsdp_image,
                     source="flash_attention"),
        kernel_entry("flash_attention_fsdp_remat", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(IMAGE_ATTN_SHAPE, torch.bfloat16)], fsdp_remat,
                     source="flash_attention"),
        kernel_entry("fused_message_fsdp", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.float32)], fsdp_protein[0],
                     source="fused_message"),
        kernel_entry("fused_message_bwd_fsdp", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.float32)], fsdp_protein[1],
                     source="fused_message"),
        kernel_entry("K1_tp", "reed_tpu/ops/flash_attention.py:24", attn_rows["tp"],
                     mp_image["tensor"], source="flash_attention"),
        kernel_entry("K1_sp", "reed_tpu/ops/flash_attention.py:24", attn_rows["sp"],
                     mp_image["seq"], source="flash_attention"),
        kernel_entry("K2a_tp", "reed_tpu/ops/fused_message.py:132",
                     tp_rows[(MSG_MAIN, torch.float32, True)]["fwd"], mp_image["protein"][0],
                     source="fused_message"),
        kernel_entry("K2b_tp", "reed_tpu/ops/fused_message.py:152",
                     tp_rows[(MSG_MAIN, torch.float32, True)]["bwd"], mp_image["protein"][1],
                     source="fused_message"),
        kernel_entry("K2a_eval_dp", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_EVAL_DP, torch.float32)], eval_dp, source="fused_message"),
        kernel_entry("K2a_eval_tp", "reed_tpu/ops/fused_message.py:132",
                     tp_rows[(MSG_MAIN, torch.float32, True)]["fwd"], eval_tp,
                     source="fused_message"),
    ]
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--mol-tp-rank"]:
        mol_tp_rank_main(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif sys.argv[1:2] == ["--mol-tp"]:
        mol_tp_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--eval-rank"]:
        eval_rank_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--eval"]:
        eval_main()
    else:
        try:
            main()
        finally:
            stop_cli_process()
