#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
`openasr_torch/kernels/csrc/`, holds each kernel against its plain PyTorch
version on the card (LayerNorm forward and backward, also at D 1536, the
backward's dgamma and dbeta bit-identical over two runs; flash attention
forward and backward, with and without attention dropout, also at head
dims 16 and 48, which the wrappers zero-pad, with the hash mask's dropped
pairs kept; the fused fbank from strided waves and from dithered frames,
also at 32 kHz, nfft 400, VTLN 0.9 and 40 bins, each log-mel case also
against a float64 evaluation), trains two steps of
egs/aishell1/configs/conv-ctc-transformer-test.yaml (head dim 16), then
drives the port's main paths at the full width
of the flagship conv-ctc-transformer (egs/aishell1/configs/
conv-ctc-transformer.yaml: ConvV2, d512, 6+6 post-LN layers, 8 heads, GLU
2048, vocab 4233) with random weights from a fixed seed, in float32 and in
bfloat16:

- offline decoding: 8 random-feature utterances through
  `openasr_torch.bin.infer --offline`;
- offline training: one epoch plus the dev pass through
  `openasr_torch.bin.train` on 128 random-feature utterances of 400-512
  frames, with the flagship YAML's model and training sections as they are
  (dropout 0.1, SpecAugment, batch_frames 36000, clip 50, label smoothing
  0.1, lambda_ctc 1.0, Noam);
- online decoding: 8 random-tone 16 kHz wav files of 10.0-13.6 s through
  `openasr_torch.bin.infer` without `--offline` (the fbank frontend);
- online training: one epoch plus the dev pass on 128 wav files of
  4.0-5.2 s, with egs/aishell1/configs/conv-ctc-transformer-online.yaml
  (the flagship's sections with the fbank signal, batch_time 5760000);
- conv-ctc decoding: the offline decode's 8 utterances through
  `openasr_torch.bin.infer --model_type conv-ctc --offline` with
  egs/hkust/configs/ctc.yaml's model section as it is (ConvV2, d512, 6
  post-LN layers, 8 heads, GLU 2048) at vocab 4233: greedy, the native
  host prefix beam (`--ctc_beam 10`), the device prefix beam
  (`--ctc_beam_device`, f32 and bf16) and the device beam with a hotword
  file (`--context_file`).  Then the device beam against the host beam on
  the card: on seeded peaky log-probs of the decode's shape the n-best
  lists must be equal (scores within 1e-4); on the random-weight model's
  own log-probs the 1-best scores within 1e-3 (the share of equal 1-best
  token lists is reported); and each beam's ms per batch.

Then the recipe gate and the solver's paths:

- the recipe gate's chain at a cut (egs/aishell1/run_recipe_gate_torch.sh,
  in process): `openasr_torch.bin.gen_mini_corpus --wave` (256
  utterances, the dev set cut to 8, the train rows repeated 4 times), the
  train CLI with the gate YAML's model and training sections for 2 epochs
  (online fbank kernel, SpecAugment, bf16, newbob), the infer CLI in bf16
  with the device CTC prefix beam of 4, and the scorer: one hyp line per
  test row, every kernel of the path launched, the CER printed;
- the stock optimizers (`optimtype: sgd`, `fused_adam: false`): 3 steps
  of conv-ctc-transformer-test.yaml on the card against the CPU;
- preemption: SIGTERM to a training subprocess on the card, then
  `--continue-training` to the end;
- a one-step `training.profile` window on the flagship's bf16 training
  run, with the port's kernels that its trace holds device time for;
- the attention backward in a saturated softmax (one-hot rows, as at the
  recipe gate's first layer, also with each row's max in its last key
  step): dQ and dK exactly 0, as the true gradient, and 1 / l exactly 1;
- tests/data/jax_solver_conv_ctc_transformer_test.pkg, which the JAX
  solver wrote, read here without jax and continued one step on the card.

Then the CIF path (`[cif path]`), on offline corpora with phones:
egs/aishell1/configs/cif.yaml's model and training sections as they are
(ConvV2, d512 x 6 post-LN encoder, 8 heads, GLU 2048, the assigner, the
3-layer causal CIF decoder; vocab 4233, no blank) trained through the CLI
for one epoch of 3 steps in f32 and bf16, ctc_cif on the same sections 2
steps, egs/callhome_hkust/configs/cif_fc_test.yaml and cif_mix_test.yaml
(with its acoustic loader) 2 steps each; the f32-trained package decoded
through the infer CLI (8 utterances, beam 5, `--maxlen 100`) in f32, with
a hotword file, and in bf16, and the warm ms a batch of the CIF beam; the
f32 CIF logits, fire counts (with the smallest margin |S_t - 0.95 - n|)
and one step's gradients on the card against the CPU, the CPU's at the
card's ReLU decisions, whose flips must be a handful of rounding ties.
The kernel line adds the attention forward and backward at the CIF
decoder's causal shapes beside SDPA's, their calls a step taken from the
built module and held to the run's launches.

Then the LM path (`[lm path]`): the Transformer LM at the JAX package's
create_model defaults with the flagship's d_model and its depth cut to 2
(d512 x 2 post-LN layers, 8 heads, relu FFN 2048, dropout 0.1; egs/ has
no LM config) and
the 2-layer LSTM LM at d512, both at vocabulary 4233, trained through
`openasr_torch.bin.train_lm` on 256 seeded lines of 20-60 characters (3
steps of 32 lines and a dev pass of 5 batches; the Transformer LM in f32
and bf16, its launches held to the built module's, its dev perplexity
printed);
one f32 step's gradients of each LM on the card against the CPU (1e-3,
the Transformer LM's at the card's FFN ReLU decisions, flips bounded as
in the CIF check); the Transformer LM's cached step against its batch
forward on 40 tokens (1e-4 f32, 5e-2 bf16); the fused beams through the
infer CLI (the flagship's attention beam with the Transformer LM in f32
and bf16 and with the LSTM LM, conv-ctc's device prefix beam of 10 and
the CIF beam with the Transformer LM; each run's LayerNorm launches show
the LM's step), a CTC model with `--lm_pkg` off the device beam exiting
non-zero; and each fused beam called directly: its warm ms a batch beside
the unfused beam's, --lm_weight 0 equal to the unfused beam, and on two
utterances its n-best scores on the card against the CPU's (1e-3); with
the device ms of the device CTC beam's gather of the LM cache by parent,
once a frame.  The
kernel line adds the attention forward (4l) and backward (5+6l) at the
Transformer LM's training shape (causal, no key lengths, dropout 0.1)
beside SDPA with is_causal, their calls a step taken from the built
module and held to the run's launches.

Then the streaming path (`[streaming path]`):
egs/aishell1/configs/conv-ctc-transformer-streaming.yaml's model and
training sections as they are (the flagship's widths, encoder.streaming
chunk 16, left_chunks 4) at vocabulary 4233, trained through the CLI for
one epoch of 3 steps in f32 and bf16 on 96 random-feature utterances of
1000-1200 frames (T' up to 299), the encoder's attention through the
chunk mode of the flash kernels, the launches held to the built module's,
and one f32 step's gradients on the card against the CPU (1e-3); the
trained package streamed through `openasr_torch.bin.stream_infer` (the 8
decode utterances, B 8): greedy partials, prefix-beam partials of 10 with
the [lm path]'s Transformer LM and a hotword file, and the attention
rescore, each tick 13 LayerNorm launches and no attention kernel; in
process, the streamed encoder states and CTC logits against the card's
batch forward in chunk mode (TOL_STREAM), the greedy hypotheses against
the batch forward's, the last n-best of the streaming prefix beam (with
and without the LM and hotwords) against `ctc_prefix_beam_device` over
the streamed log-probs, on the shortest utterance every mode against the
CPU, and the median ms a tick (device and wall, f32 and bf16: greedy, beam
10, beam 10 with the LM); and the same model with the online signal
streaming the 8 test waves, one fbank launch a tick, held to its batch
forward.  The kernel line adds the chunk mode's forward (4ch) and
backward (5+6ch) at the streaming training batch's encoder shape beside
SDPA with the equivalent bool mask, after holding them to their plain
versions there and on a batch whose short rows leave padded queries with
no visible key (O = 0, zero gradients), with dropout 0 and 0.1.

Then the raw-wave families (`[wave path]`), at vocabulary 4233:
egs/wav2vec/configs/wav2vec_ctc.yaml's model and training sections as
they are (WavConv 512, d512 x 6 post-LN layers, 8 heads, GELU 2048,
dropout 0.1, batch_time 1600000, accumulate_grad_batch 2) but for
freeze_finetune_updates 10000 -> 2, trained through the train CLI for one
epoch of 6 micro-batches (3 steps) in f32 and bf16 on 45 random-tone wavs
of 0.25-30 s, three of them 25-30 s (T' 2500-3000); the gate shown by the
encoder's largest move, one first Adam step at count 3; the f32 package
decoded (8 wavs of up to 30 s, greedy and the device prefix beam of 10);
its logits and one training forward's gradients on the card against the
CPU (1e-3, at the card's WavConv ReLU decisions); each run's launches
held to the built module's (13 LayerNorm and 6 attention calls a
forward).  egs/libri/configs/cpc_pretrain.yaml through `bin/train_cpc.py
--type pretrain` and gru_ctc_finetune.yaml through `--type finetune` from
its package (`load_splayer`), 3 steps each on 34 and 17 wavs of 1.25-15
s: no kernel launch (cuDNN convolutions and GRUs), the splayer unchanged,
the finetuned package decoded greedily and with the host prefix beam, and
the CPC and CTC losses on the card against the CPU (1e-4 of scale).  Then
GRU-CTC's step-1 gradient at the [parallel path]'s first batch and seeded
weights (ROADMAP queue 3 item 39), in f32 and in float64 (the CTC loss
too), on the card and on the CPU (a process of its own, run while the
kernels build): each leaf's f32 distance from its device's float64, their
largest by module, and each op's own (its f32 backward fed the float64
run's input and output cotangent), the card's float64 held to the CPU's
(1e-6 of each leaf's scale) and the card's f32 distance to at most twice
the CPU's.  The kernel line adds the attention forward (4w) and backward
(5+6w) at the wav2vec run's largest batch (T' up to 3000) beside SDPA with
the same key mask, after holding them to their plain versions there, and
the backward's three kernels alone there (5sw, 5w, 6w).

Then the text families (`[text path]`), from the repo's vocabularies
(egs/IPA2char/data/callhome.IPA, 72 phones; vocab.char, 3671 characters)
on seeded phone->char pairs of 20-120 phones and 8-50 characters (at
least 2 phones a character), in f32 as the phone2char CLIs run:
egs/IPA2char/configs/callhome_ma_IPA.yaml (Embed_Decoder_CTC: d512 x 6,
8 heads, GLU 2048, dropout 0.1, batch_phones 4000, accumulate_grad_batch
8) and IPA2char.yaml (Embed_Decoder: 4 decoder layers) as they are,
each trained through `openasr_torch.bin.train_phone2char` for one epoch
of 3 steps and its dev pass (the CTC model's with its dev WER), and
semi_callhome_ma_IPA.yaml (gan_phone2char: G at those widths, D a
2-layer ConvV2 of d512 over the character vocabulary, batch_phones 1000,
unpaired_batch_size 16) through `bin/semi_train_phone2char` from the CTC
package (`G_path`) for 24 iterations (3 steps); the CTC package decoded
greedily and the Embed_Decoder package with the attention beam (5, 80
steps) through `bin/infer_phone2char` over 16 test pairs (a hyp line a
pair, the `WER:` line); each run's launches held to those counted from
the built module (a GAN iteration runs G three times: twice with
dropout and backward, once in eval mode for the D term); on the two
shortest pairs f32 on the card against the CPU: the CTC logits and one
training forward's gradients, the beam's 1-best scores (the share of
equal n-best lists printed), the GAN's three losses and one step's
gradients, D's with the gradient penalty's second-order term, at D's
ReLU decisions on the card (1e-3 each).  The kernel line adds the
attention forward (4p) and backward (5+6p) at the CTC run's largest
batch beside SDPA with the same key-length mask, after holding them to
their plain versions there.

Then the mixture of experts (`[moe path]`):
egs/aishell1/configs/conv-ctc-transformer-moe.yaml as it is (the
flagship with layers 1, 3 and 5 of the encoder 8 GLU experts each, top-2,
capacity factor 1.25, aux weight 0.01) at vocabulary 4233, trained
through the train CLI for one epoch of the flagship run's 128 utterances
(2 steps and a dev batch) in f32 and bf16 from one seeded package, with
`moe_aux_loss` finite and positive in every logged row and each run's
launches those of the flagship's steps; the f32 package's 8 test
utterances decoded through the infer CLI with the attention beam and,
its encoder and CTC head as a conv-ctc package, greedily; on two
utterances f32 on the card against the CPU for the topk router and for
an expert_choice variant at the same weights: the logits and one step's
gradients of the solver's objective (1e-3 each), the CPU at the card's
routing (`RouteReplay`: at most 16 tokens routed otherwise, each a
rounding tie); and the device ms of one MoE layer at the training batch,
forward and backward, by stage (router and combine tensor, dispatch,
expert products, combine) beside the dense GLU FFN (`[moe layer]`).

Then data parallelism (`[parallel path]`): the train CLI with
`--distributed` under `torch.distributed.run --standalone
--nproc-per-node 1` (NCCL, world 1) on the flagship YAML for 3 steps and
its dev pass (started with the [text path]: its start-up is host work),
its package held to the plain CLI's (1e-6 of scale); then two ranks over
gloo on cuda:0 (two worker processes `chip_smoke.py --parallel-worker`,
started with the [text path], which train the phase's jobs in turn, each
set up while the one-rank run trains) against one rank in this process,
3 steps each from the same seeded weights, f32, dropout 0, each rank on
its rows of the global batch of the YAML's budget (the loaders of
`bin/train.py:build_loaders` at ndata 2), ZeRO-1 on: the flagship YAML
(the flagship's 36000-frame batches; each rank a flagship step's
launches) and the MoE YAML with its 8 experts split over the two ranks,
both at GRID_LAYERS encoder and decoder layers, and libri's GRU-CTC
config (its BatchNorm statistics after the first step within 1e-5 of
scale).  Each pair: losses within 1e-3; the gradient that the ranks
reduced in step 1 (Adam's first moment, f32) within 1e-4 of each leaf's
scale; parameters within 1e-3.  GRU-CTC's f32 step-1 gradient is itself
some 5e-3 off its f64 value (its f32 CTC loss: the [wave check]), at one
rank as at two, so its one-rank run also computes that gradient in f64:
the two ranks' may be no further from it than twice one rank's plus
1e-4, and the parameters, whose Adam updates are +-lr by each element's
gradient sign, are held to 2 lr a step.  A collective that gloo refuses
on CUDA tensors fails the phase.
`python3 chip_smoke.py --parallel-cards N`, on a machine with N cards,
runs the flagship and MoE pairs over NCCL instead, a card a rank, then
the flagship on a grid of N / 2 data rows of 2 model ranks, and nothing
else.

Then tensor and sequence parallelism (`[model path]`): two ranks over gloo
on cuda:0 on a dp1 x tp2 grid (`--parallel-worker`, started with the
[parallel path]) against one rank in this process, 3 steps each from the
same seeded weights, f32, dropout 0, both ranks on every row of the YAML's
18000-frame batches: the flagship YAML with `training.sequence_parallel`
on, then off, and the MoE YAML (on), at GRID_LAYERS encoder and decoder
layers.  Each pair as the [parallel path]'s (losses 1e-3, the step-1
gradient 1e-4 of each leaf's scale, parameters 1e-3), the one-rank run
also computing the step-1 gradient in f64 (attention and LayerNorm plain
in f64), which the two ranks may be no further from than 1.5 times one
rank's distance; and each rank's LayerNorm backward launches split between
the dx-only mode (row 2: the T-sharded sites, from the host's T' and U)
and the partials mode exactly as the steps' shapes decide; off launches no
dx-only one.  The flagship's padded T is a multiple of 8, so its T' is odd
and only the decoder's sites (U 32) run on T-shards.  Row 2 is held to its
plain version and timed at the rows those launches had, [B U / 2, 512].
It prints the collectives a step on each group, in calls and bytes, and
the warm step walls, and times the attention kernels at a rank's [B, T',
4, 64] (f32 and bf16).

Then the serving path (`[serving path]`): `openasr_torch.serving`
exports, for cuda at full width, the flagship package's attention beam
(beam 5, SERVE_MAXLEN steps) with f32 weights, with int8 weights and with
the [lm path]'s Transformer LM fused, and the [moe path]'s f32 package's
with int8 weights through `openasr_torch.bin.export_decode --int8`;
conv-ctc's device prefix beam of 10
with the LM and a hotword file (over each decode utterance's first 32
frames); the streaming tick of the streaming package and of the online
streaming model (B 8); and the streaming prefix beam of 10 with the LM
and the hotwords.  Each kind runs in a worker process of its own
(`chip_smoke.py --serving-worker KIND`), all started together after the
[moe path] at the lowest priority: each exports on the host while the
later paths run, waits until the kernel rows and the [tools path] are
done, then serves its artifact from a fresh loader and holds it to the
live decode on the card (n-best equal, scores within 1e-5; every tick within
TOL_STREAM; int8 against f32 weights within 0.05, the 1-best equal off
ties), requires the exported call's kernel launches to equal the live
call's, and prints its export and load seconds, artifact bytes, graph
nodes and warm wall ms a batch or tick, exported against live.

The tools path (`[tools path]`), before the serving workers' go onto the
card: `openasr_torch.bin.bench_flash` at (B, T) (8, 256) and (16, 2048),
bf16, forward and forward + backward, the kernel chains held to SDPA's
(2e-2) before their device us and ratios print;
`openasr_torch.bin.profile_step --model online --trace --ops` at
bench.py's shape (B 64, T 512, d512 x 6 + 6) in bf16: the matmul and
convolution inventory, then the class split of a step's device time and
the idle share from utils/trace.py (the shares and idle summing to 1, the
attention, LayerNorm and fbank classes non-zero, every port kernel of the
step named in the trace); the `[profile]` window's trace read by the old
raw count and by utils/trace.py, which must agree; `openasr_torch.bin.
plot_attention` on the flagship decode package, on the card against the
CPU (maps within 1e-3, as `.npz`); and `openasr_torch.bin.
convert_reference_pkg` on a seeded reference-layout (eastonYi/OpenASR)
checkpoint at the flagship's widths, its package's encoder output and CTC
logits on the card against the CPU (1e-3, f32).

Each path runs with the kernels' launch counters set to 0 just before it
and read just after.  The f32 decoder logits, one f32 training step's
gradients and the f32 fbank features are also checked against the same
inputs on the CPU.  The CTC loss at the flagship training batch is timed
with and without its last-blank rewrite (`[ctc loss]`; the gradients
equal bit for bit), and its gradient on rows ending in the blank id held
against its plain version; on the short rows of
tests/test_torch_cif.py's blank-id test (9 and 7 frames), where the
CPU's F.ctc_loss alone is a share of 0.25-0.78 off, the card's gradient
is held to the CPU's (1e-4), with the share the rewrite adds on each
device printed.

It prints a `[time] phases` line, each phase's seconds and the total
against the run's TIME_LIMIT_S (1200 s), the card's name and power limit,
a `{"kernels": [...]}` line with each kernel's error, launches, times and
bound (the attention backward at each of the training step's three shapes:
encoder self-attention, decoder causal self-attention and cross-attention,
and a `[time]` line with their total a step; the backward's kernels also
with a cold L2, `cold_ms`, and cold minus warm with its range over
interleaved rounds), and last `{"ok": true, "device": {...}}`.  Without a
CUDA card it exits non-zero and prints no result; every phase that fails
ends the run the same way.

Scratch files go to `build/chip_smoke/` under the checkout.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
FLAGSHIP_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer.yaml")
ONLINE_YAML = os.path.join(ROOT, "egs", "aishell1", "configs",
                           "conv-ctc-transformer-online.yaml")
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")
CTC_YAML = os.path.join(ROOT, "egs", "hkust", "configs", "ctc.yaml")
SEED = 1234
TIME_LIMIT_S = 1200        # the run's limit, the kernels' build included
CTC_BEAM = 10
# device beam against the native host beam: on peaky log-probs the same
# n-best lists, scores summed in f32 in the same order; on the random-weight
# model's flatter log-probs the 1-best scores, which near-tied prefixes may
# reach by other tokens (scores of hundreds of nats, f32 ulps of 1e-5-1e-4)
TOL_BEAM_PEAKY = 1e-4
TOL_BEAM_TOP1 = 1e-3

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit).
# Bounds take the rate of the type a function reads and writes; the fbank
# kernel computes in float64 (34 TFLOP/s), its own choice, reported apart
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float64: 34e12}
# the attention kernels, forward and backward, compute f32 products on the
# tensor cores as 3xTF32, three TF32 products each (TF32: 495 TFLOP/s dense)
MMA_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TOL_LN = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# backward: max abs error over max(1, largest plain magnitude).  f32 sums
# (dgamma over thousands of rows, dk/dv over queries) in other orders; in
# bf16 the outputs round to 8 bits and O, hence delta, differ by an ulp
TOL_LN_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_FLASH_BWD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the statistics pass (m, 1 / l, delta): kernel and plain version both
# compute in f32 from the same inputs (bf16 products are exact in f32), so
# one f32 tolerance in both dtypes; m and delta over max(1, largest plain
# magnitude), 1 / l relative to each row's own 1 / l (see `stats_errs`)
TOL_FLASH_STATS = 1e-4
# the CTC gradient's rewritten blank entry against its plain version: the
# same frame's sum over V in another order (entries of at most 1 in f32)
TOL_CTC_BLANK = 1e-5
# the short rows of tests/test_torch_cif.py::test_ctc_gradient_where_a_target
# _is_the_blank_id (9 and 7 frames, vocabulary 11, blank 10): the card
# against the CPU at that test's tolerance, on rows where the CPU's
# F.ctc_loss alone is a share of 0.25-0.78 off
TOL_CTC_SHORT = 1e-4
CTC_SHORT_ROWS = (([10, 7, 2, 2], 2), ([7, 10, 5, 2], 3), ([10, 10, 2, 2], 2),
                  ([7, 5, 10, 2], 3), ([10, 2, 2, 2], 1), ([7, 5, 3, 2], 3))
# log-mel, max abs.  The kernel computes the FFT in float64, the plain
# version the folded f32 products.  So the kernel is held against a
# float64 evaluation of the same function (`fbank_float64`), to TOL_FBANK_F64
# (a few f32 ulps at the features' magnitude of 16-32: 1.9e-6 measured on
# an H100) and no farther from it than the plain version, case by case.
# Kernel against plain is then held, case by case, to the plain version's
# own error against float64 plus TOL_FBANK_F64 (the triangle inequality's
# limit): the plain error reached 2.3e-3 on bins far below a frame's
# loudest (near silence, beside tones) on the VTLN training batch.  Card
# against CPU (the plain version on both): the CPU's GEMMs block the
# 400-term sums otherwise (8.2e-4 measured)
TOL_FBANK_F64 = 1e-5
TOL_FBANK_CPU = 2e-3
# where nfft is not a power of two the kernel sums the plain version's own
# folded f32 products, in other orders (1.9e-6 measured)
TOL_FBANK_FOLDED = 1e-4
# mel energies without the log (use_log_fbank false), max abs over the
# largest energy: 1e-4 on the log is 1e-4 relative on every energy
TOL_FBANK_REL = 1e-5
RATE = 16000
DROPOUT = 0.1
DROPOUT_SEED = 987654321
DTYPES = (torch.float32, torch.bfloat16)
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

FLAGSHIP = {
    "type": "conv-ctc-transformer",
    "add_eos": True,
    "add_blk": True,
    "signal": {"feature_type": "offline"},
    "encoder": {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 2},
                "input_dim": 80, "d_model": 512, "nhead": 8,
                "dim_feedforward": 2048, "activation": "glu", "num_layers": 6,
                "dropout_rate": 0.1},
    "decoder": {"type": "TransformerDecoder", "vocab_size": 4233,
                "d_model": 512, "nhead": 8, "num_layers": 6, "encoder_dim": 512,
                "dim_feedforward": 2048, "activation": "glu", "dropout_rate": 0.1},
}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference, with +inf entries required to match exactly."""
    a, b = a.float(), b.float()
    inf_a, inf_b = torch.isinf(a), torch.isinf(b)
    if not torch.equal(inf_a, inf_b) or not torch.equal(a[inf_a], b[inf_b]):
        return float("inf")
    if bool(torch.isnan(a).any() or torch.isnan(b).any()):
        return float("nan")
    fin = ~inf_a
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def scaled_err(got: torch.Tensor, want: torch.Tensor):
    """-> (max abs error, max(1, largest magnitude of `want`))."""
    return max_err(got, want), max(1.0, float(want.float().abs().max()))


def stats_errs(got, want) -> list:
    """-> [(name, max abs error, scaled error)] of the statistics pass's m,
    1 / l and delta against their plain version: m and delta over max(1,
    largest plain magnitude); 1 / l relative to each row's own plain 1 / l,
    and infinite where exactly one of the two is 0 (a row with no valid key
    must give 0, and only such a row)."""
    out = []
    for name, g, w in zip(("m", "1 / l", "delta"), got, want):
        e, scale = scaled_err(g, w)
        if name == "1 / l":
            if not torch.equal(g == 0, w == 0):
                out.append((name, e, float("inf")))
                continue
            pos = w > 0
            rel = (g[pos] - w[pos]).abs() / w[pos]
            out.append((name, e, float(rel.max()) if bool(pos.any()) else 0.0))
        else:
            out.append((name, e, e / scale))
    return out


def note_err(errs, key, abs_err, scaled) -> None:
    """Keep a backward kernel's largest abs error and largest scaled one."""
    a, r = errs.get(key, (0.0, 0.0))
    errs[key] = (max(a, abs_err), max(r, scaled))


SLOW_CALL_MS = 1.0


def captured(fn, calls: int):
    """A CUDA graph of `calls` calls of `fn`, warmed up and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call: `calls` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events, so no host work is timed.
    The inputs stay resident in the 50 MB L2 between calls (warm L2), as
    far as they fit.  A call that takes over SLOW_CALL_MS (the plain
    versions and library calls at wav2vec's T' 2802 take 3-80 ms) is
    captured alone and replayed 3-`reps` times, about 50 ms in all: its
    time dwarfs a launch's, and 200 calls of it took seconds a row."""
    fn()
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    fn()
    probe[1].record()
    torch.cuda.synchronize()
    one = probe[0].elapsed_time(probe[1])
    if one > SLOW_CALL_MS:
        calls, reps = 1, max(3, min(reps, math.ceil(50.0 / one)))
    graph = captured(fn, calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def cold_l2_ms(fn, calls: int = 20, rounds: int = 10) -> dict:
    """Device time of one call with a cold L2, and what the cold L2 adds to
    the warm time, from interleaved replays.  Three graphs of `calls` calls:
    `fn` alone (warm), a read of 128 MB alone (more than twice the L2, so
    that what `fn` reads next comes from device memory), and the read then
    `fn`; each round replays the three in turn, each between its own CUDA
    events.  A round gives cold = (t(read then fn) - t(read)) / calls and
    extra = cold - t(fn) / calls.  -> {"cold_ms": median cold, "cold_extra_ms":
    median extra, "cold_extra_range_ms": [least, largest] extra}, over
    `rounds` rounds after one that is not counted."""
    buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")

    def flush():
        torch.sum(buf, dim=0, out=total)

    graphs = [captured(f, calls) for f in (fn, flush, lambda: (flush(), fn()))]
    events = [[[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in graphs]
              for _ in range(rounds + 1)]
    for per_round in events:
        for graph, (start, end) in zip(graphs, per_round):
            start.record()
            graph.replay()
            end.record()
    torch.cuda.synchronize()
    cold, extra = [], []
    for per_round in events[1:]:
        warm_ms, flush_ms, both_ms = (s.elapsed_time(e) / calls for s, e in per_round)
        cold.append(both_ms - flush_ms)
        extra.append(both_ms - flush_ms - warm_ms)
    return {"cold_ms": float(np.median(cold)), "cold_extra_ms": float(np.median(extra)),
            "cold_extra_range_ms": [min(extra), max(extra)]}


class PhaseClock:
    """Each phase's seconds: `done(phase)` prints `[time] <phase> done at
    <seconds since the start>s` (or `what` in its place) and books the
    seconds since the last call to the phase; `line()` is the `[time]
    phases` line, the total against the TIME_LIMIT_S the run must keep
    within."""

    def __init__(self):
        self.start = self.last = time.time()
        self.seconds = {}

    def done(self, phase, what=None) -> None:
        now = time.time()
        self.seconds[phase] = now - self.last
        self.last = now
        print(f"[time] {what or phase + ' done'} at {now - self.start:.1f}s")

    def line(self) -> str:
        total = time.time() - self.start
        return ("[time] phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in self.seconds.items())
                + f"; total {total:.1f} of {TIME_LIMIT_S} ({100 * total / TIME_LIMIT_S:.1f}%)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip()


def reset_counters():
    from openasr_torch.kernels.fbank import fused_fbank
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_bwd_stats,
    )
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_bwd

    torch.cuda.synchronize()
    for fn, attr in ((fused_layer_norm, "launches"), (layer_norm_bwd, "launches"),
                     (layer_norm_bwd, "dx_launches"),
                     (flash_attention, "launches"), (flash_attention, "dropout_launches"),
                     (flash_bwd_stats, "launches"), (flash_attention_bwd_dkv, "launches"),
                     (flash_attention_bwd_dq, "launches"), (fused_fbank, "launches")):
        setattr(fn, attr, 0)


def read_counters() -> dict:
    from openasr_torch.kernels.fbank import fused_fbank
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_bwd_stats,
    )
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_bwd

    torch.cuda.synchronize()
    return {
        "layer_norm_fwd": fused_layer_norm.launches,
        "layer_norm_bwd": layer_norm_bwd.launches,
        "layer_norm_bwd_dx": layer_norm_bwd.dx_launches,
        "flash_attention_fwd": flash_attention.launches,
        "flash_attention_fwd_dropout": flash_attention.dropout_launches,
        "flash_bwd_stats": flash_bwd_stats.launches,
        "flash_attention_bwd_dkv": flash_attention_bwd_dkv.launches,
        "flash_attention_bwd_dq": flash_attention_bwd_dq.launches,
        "fbank": fused_fbank.launches,
    }


# --------------------------------------------------------------- phase 1

def attention_ptxas(log: str) -> list:
    """(kernel, registers, spill bytes) of each instantiation of the
    attention kernels, forward and backward, from nvcc's -Xptxas -v output
    in a build log; spill bytes count stores and loads."""
    import re

    out = []
    for source in ("flash_attention.cu", "flash_attention_bwd.cu"):
        sec = log[log.index(f"== nvcc {source}"):]
        end = sec.find("== nvcc", 1)
        name, spill = None, 0
        for line in (sec if end < 0 else sec[:end]).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                d, drop = re.search(r"Li(\d+)ELb(\d)", fn).groups()
                kind = ("fwd" if "_fwd_" in fn else "dkv" if "_dkv_" in fn
                        else "stats" if "_stats_" in fn else "dq")
                name = (f"{kind} {'bf16' if 'Bf16Ops' in fn else 'f32'} D{d}"
                        + (" dropout" if drop == "1" else ""))
            elif "spill stores" in line:
                spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
            elif "Used" in line and name:
                out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)),
                            spill))
                name = None
    return out


def ptxas_report(log: str, source: str) -> list:
    """(kernel, registers, spill bytes) of every entry function that nvcc's
    -Xptxas -v output lists for one source in a build log."""
    import re

    sec = log[log.index(f"== nvcc {source}"):]
    end = sec.find("== nvcc", 1)
    out, name, spill = [], None, 0
    for line in (sec if end < 0 else sec[:end]).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and name:
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            name = None
    return out


def phase_build():
    """The CUDA kernels (nvcc, a process per source) and, alongside them,
    the native CTC decoder (g++)."""
    from concurrent.futures import ThreadPoolExecutor

    from openasr_torch import kernels
    from openasr_torch.ops.prefix_beam import build_native

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)
        so = kernels.build_library()
        kernels.library()
        native_so = native.result()
    secs = time.time() - t0
    print(f"[build] {so.name} (sm_90a) and {native_so.name} (g++) in {secs:.1f}s")
    print(nvidia_smi())
    log = so.parent / so.name.replace("libopenasr_kernels-", "build-").replace(".so", ".log")
    report = attention_ptxas(log.read_text())
    print("[ptxas] attention registers (spill bytes): " + ", ".join(
        f"{n} {r} ({sp})" for n, r, sp in report))
    require(len(report) == 48, f"{len(report)} attention kernels in the build log, not 48")
    require(all(sp == 0 for _, _, sp in report), "an attention kernel spills registers")
    text = log.read_text()
    for source, keys in (("fbank.cu", ("fbank_fft", "fbank_folded")),
                         ("layer_norm.cu", ("layer_norm_bwd", "column_sum"))):
        rows = [(short_name(n), r, sp) for n, r, sp in ptxas_report(text, source)
                if any(k in n for k in keys)]
        print(f"[ptxas] {source} registers (spill bytes): " + ", ".join(
            f"{n} {r} ({sp})" for n, r, sp in rows))
        require(rows, f"no kernel of {source} in the build log")


def short_name(mangled: str) -> str:
    """kernel<template arguments> of a mangled kernel name: bf16 or f32,
    then its integer and bool arguments (VEC, NV, partials; R)."""
    import re

    name = re.search(r"(?<=\d)((?:layer_norm|fbank|column)_[a-z0-9_]*?kernel)(?=[IE])",
                     mangled).group(1)
    args = (["bf16"] if "nv_bfloat16" in mangled else ["f32"] if "IfL" in mangled else [])
    args += re.findall(r"L[ib](\d+)E", mangled)
    return name + (f"<{','.join(args)}>" if args else "")


# --------------------------------------------------------------- phase 2

def ln_inputs(n, d, dtype, rng):
    x = torch.from_numpy((rng.randn(n, d) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(d)).astype(np.float32))
    return x.to("cuda", dtype), g.cuda(), b.cuda()


def phase_layer_norm(errs):
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

    rng = np.random.RandomState(SEED)
    for dtype in DTYPES:
        for n, d in ((2400, 512), (40, 512), (300, 1536)):
            x, g, b = ln_inputs(n, d, dtype, rng)
            y, mu, rs = fused_layer_norm(x, g, b)
            torch.cuda.synchronize()
            y_r, mu_r, rs_r = layer_norm_reference(x, g, b)
            e = max_err(y, y_r)
            e_stats = max(max_err(mu, mu_r), max_err(rs, rs_r))
            tol = TOL_LN[dtype]
            print(f"[layer_norm] [{n}, {d}] {DTYPE_NAME[dtype]}: y err {e:.3g}, "
                  f"stats err {e_stats:.3g} (tol {tol})")
            require(e <= tol and e_stats <= 1e-5,
                    f"layer_norm [{n}, {d}] {DTYPE_NAME[dtype]} disagrees")
            errs[("layer_norm_fwd", dtype)] = max(errs.get(("layer_norm_fwd", dtype), 0.0), e)


def phase_layer_norm_bwd(errs, rows_main):
    """dx, dgamma, dbeta through torch.autograd.grad of the kernel against
    the plain backward on the same inputs, both modes of the kernel."""
    from openasr_torch.kernels.layer_norm import (
        fused_layer_norm,
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    rng = np.random.RandomState(SEED + 3)
    for dtype in DTYPES:
        tol = TOL_LN_BWD[dtype]
        for n, d in ((rows_main, 512), (40, 512), (37, 64), (1, 1000), (1, 512), (5, 512),
                     (1027, 512), (300, 1536)):
            x, g, b = ln_inputs(n, d, dtype, rng)
            dy = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to("cuda", dtype)
            xr, gr, br = (t.clone().requires_grad_() for t in (x, g, b))
            y, _, _ = fused_layer_norm(xr, gr, br)
            got = torch.autograd.grad(y, (xr, gr, br), dy)
            _, mean, rstd = layer_norm_reference(x, g, b)
            want = layer_norm_bwd_reference(x, dy, g, mean, rstd)
            dx_only, none_g, none_b = layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)
            torch.cuda.synchronize()
            require(none_g is None and none_b is None, "dx-only mode returned partials")
            worst = 0.0
            for name, t, w in zip(("dx", "dgamma", "dbeta", "dx(dx-only)"),
                                  (*got, dx_only), (*want, want[0])):
                e, scale = scaled_err(t, w)
                require(e <= tol * scale,
                        f"layer_norm_bwd [{n}, {d}] {DTYPE_NAME[dtype]} {name}: "
                        f"err {e:.3g} > {tol} x {scale:.3g}")
                worst = max(worst, e / scale)
                key = "layer_norm_bwd_dx" if name == "dx(dx-only)" else "layer_norm_bwd"
                note_err(errs, (key, dtype), e, e / scale)
            print(f"[layer_norm_bwd] [{n}, {d}] {DTYPE_NAME[dtype]}: worst err "
                  f"{worst:.3g} of max(1, |grad|) (tol {tol})")
            if n in (rows_main, 300):
                again = layer_norm_bwd(x, dy, g, mean, rstd)
                first = layer_norm_bwd(x, dy, g, mean, rstd)
                torch.cuda.synchronize()
                require(all(torch.equal(a, c) for a, c in zip(first, again)),
                        f"layer_norm_bwd [{n}, {d}] {DTYPE_NAME[dtype]}: two runs differ")
                print(f"[layer_norm_bwd] [{n}, {d}] {DTYPE_NAME[dtype]}: dx, dgamma, dbeta "
                      f"bit-identical over two runs")


# --------------------------------------------------------------- phase 3

def flash_case(b, h, d, tq, tk, dtype, rng):
    """q/k/v as strided [B, T, H, D] views of one packed projection."""
    qkv = torch.from_numpy(rng.randn(b, tq, 3, h, d).astype(np.float32)).to("cuda", dtype)
    q = qkv[:, :, 0]
    if tq == tk:
        k, v = qkv[:, :, 1], qkv[:, :, 2]
    else:
        kv = torch.from_numpy(rng.randn(b, tk, 2, h, d).astype(np.float32)).to("cuda", dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    lens = rng.randint(1, tk + 1, size=b)
    lens[0], lens[-1] = tk, 0  # a full row and a fully masked one
    return q, k, v, torch.from_numpy(lens.astype(np.int32)).cuda()


def phase_flash(errs):
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    rng = np.random.RandomState(SEED + 1)
    cases = [(8, 8, 64, t, t, c) for t in (1, 37, 304, 1024) for c in (False, True)]
    cases += [(8, 8, 64, 37, 304, False), (4, 8, 32, 304, 304, False),
              (4, 4, 128, 304, 304, True)]
    # head dims the wrappers zero-pad (16 -> 32, 48 -> 64), causal and padded
    cases += [(4, 4, d, t, t, c) for d in (16, 48) for t in (37, 139) for c in (False, True)]
    for dtype in DTYPES:
        for rate in (0.0, DROPOUT):
            seed = DROPOUT_SEED if rate else None
            for b, h, d, tq, tk, causal in cases:
                q, k, v, lens = flash_case(b, h, d, tq, tk, dtype, rng)
                out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal,
                                           dropout_rate=rate, dropout_seed=seed)
                torch.cuda.synchronize()
                out_r, lse_r = flash_attention_reference(q, k, v, lens, causal, None, rate,
                                                         seed or 0)
                e = max_err(out, out_r)
                e_lse = max_err(lse, lse_r)
                tol = TOL_FLASH[dtype]
                zero_row = float(out[-1].float().abs().max())
                print(f"[flash] B{b} H{h} D{d} Tq{tq} Tk{tk} causal={causal} "
                      f"dropout={rate} {DTYPE_NAME[dtype]}: out err {e:.3g}, lse err "
                      f"{e_lse:.3g} (tol {tol}, lse 1e-3)")
                require(e <= tol and e_lse <= 1e-3 and zero_row == 0.0,
                        f"flash {tq}x{tk} causal={causal} dropout={rate} "
                        f"{DTYPE_NAME[dtype]} disagrees")
                if d == 64:
                    key = ("flash_attention_fwd_dropout" if rate else "flash_attention_fwd",
                           dtype)
                    errs[key] = max(errs.get(key, 0.0), e)
        dropped_pairs(dtype)


def dropped_pairs(dtype):
    """At D = 16 (padded to 32) with dropout 0.1 and v[b, key, h] = e_key,
    O[b, q, h, key] is the kept weight of (q, key): its zeros must be the
    hash mask's dropped (and the causal mask's) pairs, as in the plain
    version with the same seed."""
    from openasr_torch.kernels.flash_attention import (
        attention_dropout_mask,
        flash_attention,
        flash_attention_reference,
    )

    b, h, d, tq, tk = 2, 2, 16, 37, 16
    gen = torch.Generator().manual_seed(SEED)
    for causal in (False, True):
        q = torch.randn(b, tq, h, d, generator=gen).to("cuda", dtype)
        k = torch.randn(b, tk, h, d, generator=gen).to("cuda", dtype)
        v = torch.eye(tk)[None, :, None, :].expand(b, tk, h, d).to("cuda", dtype).contiguous()
        out, _ = flash_attention(q, k, v, causal=causal, dropout_rate=DROPOUT,
                                 dropout_seed=DROPOUT_SEED)
        out_r, _ = flash_attention_reference(q, k, v, None, causal, None, DROPOUT,
                                             DROPOUT_SEED)
        torch.cuda.synchronize()
        keep = attention_dropout_mask(DROPOUT_SEED, b, h, tq, tk, DROPOUT, "cuda")
        if causal:
            keep = keep & (torch.arange(tk, device="cuda")[None, :]
                           <= torch.arange(tq, device="cuda")[:, None])
        same = [torch.equal(o.permute(0, 2, 1, 3) != 0, keep) for o in (out, out_r)]
        print(f"[flash] D16 dropout={DROPOUT} causal={causal} {DTYPE_NAME[dtype]}: "
              f"{int((~keep).sum())} dropped or masked pairs of {keep.numel()}; the kernel's "
              f"zeros are the hash mask's: {same[0]}, the plain version's: {same[1]}")
        require(all(same), "the padded kernel's dropped pairs differ from the mask")


def flash_train_case(b, h, d, tq, tk, dtype, rng, lens):
    """Leaf q/k/v (strided views of packed projections, requiring grad) and
    a dO whose layout is not contiguous (unit stride along D only)."""
    packed = torch.from_numpy(rng.randn(b, tq, 3, h, d).astype(np.float32)).to("cuda", dtype)
    packed.requires_grad_()
    q = packed[:, :, 0]
    if tq == tk:
        k, v = packed[:, :, 1], packed[:, :, 2]
    else:
        kv = torch.from_numpy(rng.randn(b, tk, 2, h, d).astype(np.float32)).to("cuda", dtype)
        kv.requires_grad_()
        k, v = kv[:, :, 0], kv[:, :, 1]
    dout = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(
        "cuda", dtype).transpose(1, 2)
    if lens is not None:
        lens = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
    return q, k, v, dout, lens


def phase_flash_bwd(errs, shapes):
    """Forward (with and without dropout) and dq / dk / dv through
    torch.autograd.grad of the kernels against the plain forward and
    backward on the same inputs and dropout seed."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_bwd_stats,
        flash_bwd_stats_reference,
    )

    rng = np.random.RandomState(SEED + 4)
    b, t, u, lens = shapes["b"], shapes["t"], shapes["u"], shapes["enc_lens"]

    def ragged(n, tk):
        x = rng.randint(1, tk + 1, size=n)
        x[0], x[-1] = tk, 0   # a full row and an empty one
        return x

    cases = [  # b, h, d, tq, tk, causal, kv lengths
        (4, 4, 32, 37, 37, False, ragged(4, 37)),
        (4, 4, 32, 37, 37, True, ragged(4, 37)),
        (4, 8, 64, 130, 130, True, None),
        (4, 8, 64, 25, 127, False, ragged(4, 127)),
        (2, 4, 128, 130, 130, False, ragged(2, 130)),
        (2, 4, 128, 64, 200, False, ragged(2, 200)),
        # head dims the wrappers zero-pad
        (4, 2, 16, 37, 37, True, None),
        (4, 2, 16, 25, 127, False, ragged(4, 127)),
        (4, 2, 48, 130, 130, True, ragged(4, 130)),
        (4, 2, 48, 25, 127, False, ragged(4, 127)),
        # the training path's own shapes: encoder self-attention, decoder
        # causal self-attention, cross-attention (Tq != Tk)
        (b, 8, 64, t, t, False, lens),
        (b, 8, 64, u, u, True, None),
        (b, 8, 64, u, t, False, lens),
    ]
    for dtype in DTYPES:
        tol = TOL_FLASH_BWD[dtype]
        worst_st = {}
        for rate in (0.0, DROPOUT):
            seed = DROPOUT_SEED if rate else None
            for cb, h, d, tq, tk, causal, kvl in cases:
                q, k, v, dout, kv = flash_train_case(cb, h, d, tq, tk, dtype, rng, kvl)
                out, lse = flash_attention(q, k, v, kv_lengths=kv, causal=causal,
                                           dropout_rate=rate, dropout_seed=seed)
                got = torch.autograd.grad(out, (q, k, v), dout)
                torch.cuda.synchronize()
                qd, kd, vd = q.detach(), k.detach(), v.detach()
                out_r, lse_r = flash_attention_reference(qd, kd, vd, kv, causal, None,
                                                         rate, seed or 0)
                want = flash_attention_bwd_reference(qd, kd, vd, out_r, lse_r, dout, kv,
                                                     causal, None, rate, seed or 0)
                # the statistics pass alone: m, 1 / l and delta, each to
                # TOL_FLASH_STATS as `stats_errs` scales it
                stat_args = (qd, kd, vd, dout, kv, causal, None, rate, seed or 0)
                got_st = flash_bwd_stats(*stat_args)
                want_st = flash_bwd_stats_reference(*stat_args)
                for stat, e_st, scaled_st in stats_errs(got_st, want_st):
                    require(scaled_st <= TOL_FLASH_STATS,
                            f"flash bwd statistics ({stat}) dropout={rate} {DTYPE_NAME[dtype]} "
                            f"B{cb} H{h} D{d} Tq{tq} Tk{tk}: scaled err {scaled_st:.3g} > "
                            f"{TOL_FLASH_STATS} (abs {e_st:.3g})")
                    worst_st[stat] = max(worst_st.get(stat, 0.0), scaled_st)
                    if d == 64:
                        note_err(errs, ("flash_bwd_stats", dtype), e_st, scaled_st)
                e_out = max_err(out, out_r)
                require(e_out <= TOL_FLASH[dtype],
                        f"flash fwd dropout={rate} {DTYPE_NAME[dtype]} B{cb} Tq{tq} "
                        f"Tk{tk}: out err {e_out:.3g}")
                worst = 0.0
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    e, scale = scaled_err(g, w)
                    require(e <= tol * scale,
                            f"flash bwd dropout={rate} {DTYPE_NAME[dtype]} B{cb} H{h} "
                            f"D{d} Tq{tq} Tk{tk} causal={causal}: {name} err {e:.3g} "
                            f"> {tol} x {scale:.3g}")
                    worst = max(worst, e / scale)
                    if d == 64:
                        kernel = "dq" if name == "dq" else "dkv"
                        note_err(errs, (f"flash_attention_bwd_{kernel}", dtype), e, e / scale)
                print(f"[flash_bwd] B{cb} H{h} D{d} Tq{tq} Tk{tk} causal={causal} "
                      f"dropout={rate} {DTYPE_NAME[dtype]}: out err {e_out:.3g}, "
                      f"worst grad err {worst:.3g} of max(1, |grad|) (tol {tol})")
                if d == 64 and rate:
                    key = ("flash_attention_fwd_dropout", dtype)
                    errs[key] = max(errs.get(key, 0.0), e_out)
        print(f"[flash_bwd] statistics {DTYPE_NAME[dtype]}, worst scaled err over every case: "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst_st.items())
              + f" (tol {TOL_FLASH_STATS}; 1 / l relative to itself)")


def fbank_batch(waves, utts, n=None):
    """Waves of `utts` padded to n samples (by default the collate's ladder
    over the longest), and their sample counts."""
    from openasr_torch.data.collate import quantize

    lens = np.array([len(waves[u]) for u in utts], np.int32)
    x = np.zeros((len(utts), n or quantize(int(lens.max()))), np.float32)
    for i, u in enumerate(utts):
        x[i, : lens[i]] = waves[u]
    return x, lens


def fbank_inputs(x, lens, cfg, dither):
    """Frames on the card: a strided view of the waves, or (dither) the
    materialized frames plus unit noise; and the frame counts."""
    from openasr_torch.ops.fbank import frame_signal, num_frames_of

    frames = frame_signal(torch.from_numpy(x).cuda(), cfg)
    if dither:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        frames = frames + torch.randn(frames.shape, generator=gen, device="cuda")
    return frames, num_frames_of(torch.from_numpy(lens).cuda(), cfg)


def phase_fbank(errs, train_batch, test_waves):
    """The fused fbank kernel against its plain version on the card, f32,
    TF32 off: the training and decode paths' batches, an odd T that is not
    a multiple of the kernels' 16- or 32-frame tiles, 80 and 40 bins, frames read from the
    strided waves or materialized with dither, utterances of 399 (0 frames)
    and 400 samples (1 frame), mel energies without the log (held by the
    error over the largest energy), and the training batch's waves at
    32 kHz (nfft 1024, 512 bins), with nfft 400 (not a power of two: the
    folded kernel), with VTLN warp 0.9 and with 40 bins; the decode batch's
    waves read at 8 kHz (nfft 256; with 16 ms frames, nfft 128), with 100
    ms frames (nfft 2048) and at 48 kHz with 50 ms frames (nfft 4096, the
    shared-memory FFT kernel).  Each log-mel case is also held, kernel and
    plain version alike, against `fbank_float64` (the same function in
    float64 on the card)."""
    from openasr_torch.kernels.fbank import (
        fbank_float64,
        fbank_reference,
        fused_fbank,
        is_power_of_two,
    )
    from openasr_torch.ops.fbank import FbankConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 7)
    short = {f"s{i}": (rng.randn(n) * 2000).astype(np.float32)
             for i, n in enumerate((6160, 5000, 399, 400))}
    train = (train_batch["waves"], train_batch["utts"], None)
    decode = (test_waves, sorted(test_waves), None)
    cases = [  # name, (waves, utterances, padded samples), config, dither
        ("training batch", train, {}, False),
        ("training batch, dithered frames", train, {}, True),
        ("decode batch", decode, {}, False),
        ("odd T, 40 bins", (short, sorted(short), 6160), {"num_mel_bins": 40}, False),
        ("odd T, dithered frames", (short, sorted(short), 6160), {}, True),
        ("one frame", (short, ["s2", "s3"], 400), {}, False),
        ("mel energies, no log", (short, sorted(short), 6160), {"use_log_fbank": False},
         False),
        ("training batch at 32 kHz, nfft 1024", train, {"sample_rate": 32000.0}, False),
        ("training batch, nfft 400 (folded kernel)", train, {"round_to_power_of_two": False},
         False),
        ("training batch, VTLN warp 0.9", train, {"vtln_warp": 0.9}, False),
        ("training batch, 40 bins", train, {"num_mel_bins": 40}, False),
        ("decode batch at 8 kHz, nfft 256", decode, {"sample_rate": 8000.0}, False),
        ("decode batch at 8 kHz, 16 ms, nfft 128, 23 bins", decode,
         {"sample_rate": 8000.0, "frame_length_ms": 16.0, "num_mel_bins": 23}, False),
        ("decode batch, 100 ms, nfft 2048", decode, {"frame_length_ms": 100.0}, False),
        ("decode batch at 48 kHz, 50 ms, nfft 4096", decode,
         {"sample_rate": 48000.0, "frame_length_ms": 50.0}, False),
    ]
    worst = worst_64 = worst_plain_64 = worst_margin = 0.0
    for name, (waves, utts, n), kw, dither in cases:
        cfg = FbankConfig(**kw)
        x, lens = fbank_batch(waves, utts, n)
        frames, feat_lens = fbank_inputs(x, lens, cfg, dither)
        before = fused_fbank.launches
        got = fused_fbank(frames, feat_lens, cfg)
        torch.cuda.synchronize()
        require(fused_fbank.launches == before + 1, f"fbank {name}: the kernel did not launch")
        want = fbank_reference(frames, feat_lens, cfg)
        e = max_err(got, want)
        b, t, _ = frames.shape
        valid = torch.arange(t, device="cuda")[None, :] < feat_lens[:, None]
        pad_max = float(got[~valid].abs().max()) if bool((~valid).any()) else 0.0
        head = (f"[fbank] {name}: B{b} T{t} M{cfg.num_mel_bins} nfft "
                f"{cfg.padded_window_size}, frame stride {frames.stride(1)}, frames "
                f"{feat_lens.tolist() if b <= 4 else int(feat_lens.sum())}: ")
        ok = pad_max == 0.0 and bool(torch.isfinite(got).all())
        if cfg.use_log_fbank:
            f64 = fbank_float64(frames, feat_lens, cfg)
            e64, e_plain64 = max_err(got.double(), f64), max_err(want.double(), f64)
            tol = (e_plain64 + TOL_FBANK_F64 if is_power_of_two(cfg.padded_window_size)
                   else TOL_FBANK_FOLDED)
            print(head + f"err {e:.3g} (tol {tol:.3g}); against float64: kernel "
                  f"{e64:.3g} (tol {TOL_FBANK_F64}, and at most the plain version's), "
                  f"plain {e_plain64:.3g}, padding max {pad_max}")
            if is_power_of_two(cfg.padded_window_size):
                ok = ok and e <= tol and e64 <= min(TOL_FBANK_F64, e_plain64)
                worst, worst_64 = max(worst, e), max(worst_64, e64)
                worst_plain_64 = max(worst_plain_64, e_plain64)
                worst_margin = max(worst_margin, e / tol)
            else:
                ok = ok and e <= TOL_FBANK_FOLDED
                errs["fbank_folded"] = e
        else:
            scale = max(1.0, float(want.abs().max()))
            print(head + f"err {e:.3g} = {e / scale:.3g} of the largest energy {scale:.4g} "
                  f"(tol {TOL_FBANK_REL}), padding max {pad_max}")
            ok = ok and e <= TOL_FBANK_REL * scale
            errs["fbank_mel_rel"] = e / scale
        require(ok, f"fbank {name} disagrees")
    errs["fbank"], errs["fbank_vs_f64"], errs["fbank_plain_vs_f64"] = (
        worst, worst_64, worst_plain_64)
    errs["fbank_of_tol"] = worst_margin


def check_features_against_cpu(test_waves):
    """The f32 features of 2 utterances through `ops.fbank.fbank` on the
    card (the kernel) and on the CPU (the plain version)."""
    from openasr_torch.ops.fbank import FbankConfig, fbank

    x, lens = fbank_batch(test_waves, sorted(test_waves)[:2])
    cfg = FbankConfig()
    got, got_lens = fbank(torch.from_numpy(x).cuda(), torch.from_numpy(lens).cuda(), cfg)
    want, want_lens = fbank(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    e = max_err(got.cpu(), want)
    print(f"[check] f32 fbank features, card vs CPU, 2 utts {tuple(want.shape)}: "
          f"err {e:.3g} (tol {TOL_FBANK_CPU})")
    require(torch.equal(got_lens.cpu(), want_lens) and e <= TOL_FBANK_CPU,
            "fbank features differ between card and CPU")


# --------------------------------------------------------------- corpora

def write_vocab():
    chars = [chr(0x4E00 + i) for i in range(4229)]
    vocab = os.path.join(WORK, "chars.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("".join(c + "\n" for c in chars))
    return vocab, chars


def write_corpus(name, rng, chars, n_utts, frames, tokens, dim=80, phones=None):
    """`n_utts` utterances of `frames` (lo, hi) random `dim`-dim frames with
    `tokens` (lo, hi) random characters each (and as many random `phones`,
    when given), as ark/scp + json."""
    from openasr_torch.data.kaldi_io import write_ark_scp

    feats = {
        f"{name}{i:03d}": rng.randn(int(rng.randint(frames[0], frames[1] + 1)), dim)
        .astype(np.float32)
        for i in range(n_utts)
    }
    write_ark_scp(os.path.join(WORK, name), feats.items())
    rows = []
    with open(os.path.join(WORK, f"{name}.scp")) as f:
        for line in f:
            utt, path = line.split()
            n_tok = int(rng.randint(tokens[0], tokens[1] + 1))
            rows.append({"uttid": utt, "feat": path, "feat_length": feats[utt].shape[0],
                         "tokens": " ".join(rng.choice(chars, size=n_tok)),
                         "token_length": n_tok})
            if phones is not None:
                rows[-1].update(phones=" ".join(rng.choice(phones, size=n_tok)),
                                phone_length=n_tok)
    manifest = os.path.join(WORK, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return manifest, feats


def write_wave_corpus(name, rng, chars, n_utts, samples, tokens, lengths=None):
    """`n_utts` 16 kHz PCM16 wav files of `samples` (lo, hi) samples (or of
    the given `lengths`) -- three random tones over noise, with a
    near-silent stretch -- and `tokens` (lo, hi) random characters each,
    as a wave manifest."""
    from openasr_torch.data.audio import write_wav

    os.makedirs(os.path.join(WORK, name))
    rows, waves = [], {}
    for i in range(n_utts):
        n = int(rng.randint(samples[0], samples[1] + 1) if lengths is None else lengths[i])
        t = np.arange(n) / RATE
        w = 100.0 * rng.randn(n)
        for f0 in rng.uniform(100.0, 4000.0, size=3):
            w += 3000.0 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        quiet = int(rng.randint(0, n // 2))
        w[quiet: quiet + n // 4] *= 0.01
        utt = f"{name}{i:03d}"
        path = os.path.join(WORK, name, f"{utt}.wav")
        write_wav(path, RATE, w)
        waves[utt] = np.clip(np.rint(w), -32768, 32767).astype(np.float32)
        n_tok = int(rng.randint(tokens[0], tokens[1] + 1))
        rows.append({"uttid": utt, "feat": path, "feat_length": n,
                     "tokens": " ".join(rng.choice(chars, size=n_tok)),
                     "token_length": n_tok})
    manifest = os.path.join(WORK, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return manifest, waves


def online_model() -> dict:
    """The model section of the online flagship YAML (the flagship with the
    fbank signal), at the flagship's vocabulary."""
    import yaml

    with open(ONLINE_YAML) as f:
        model = yaml.safe_load(f)["model"]
    model["decoder"]["vocab_size"] = FLAGSHIP["decoder"]["vocab_size"]
    return model


def save_flagship_package(path, solver_state=None, model_cfg=FLAGSHIP):
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import save_package

    model = get_model_class("conv-ctc-transformer").create_model(
        model_cfg, device="cuda", generator=torch.Generator().manual_seed(SEED)
    )
    pkg = model.package()
    if solver_state is not None:
        pkg = {"model": pkg, "solver_state": solver_state, "optim_state": None}
    save_package(pkg, path)
    return pkg


# --------------------------------------------------------------- phase 4

def phase_decode(pkg, vocab, manifest, launches, online=False):
    """Decode through the CLI in both dtypes, from features (--offline,
    36000 frames a batch) or from waves (5760000 samples a batch); counters
    reset just before each run and read just after.  The flash kernel runs
    once per encoder layer of a batch and the fbank kernel once per online
    batch."""
    from openasr_torch.bin import infer

    budget = 5760000 if online else 36000
    n_batches = decode_batches(manifest, budget, online)
    n_utts = len(json.load(open(manifest)))
    tag = "online decode" if online else "decode"
    for dtype in DTYPES:
        hyp = os.path.join(WORK, f"hyp_{tag.replace(' ', '_')}_{DTYPE_NAME[dtype]}.txt")
        argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                "--vocab_path", vocab, "--json_file", manifest, "--output", hyp,
                "--add_blk", "--nbest", "5", "--maxlen", "40",
                "--batch_frames", str(budget), "--dtype", DTYPE_NAME[dtype],
                "--device", "cuda"] + ([] if online else ["--offline"])
        reset_counters()
        t0 = time.time()
        infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        n_flash, n_ln = n["flash_attention_fwd"], n["layer_norm_fwd"]
        launches[(tag, dtype)] = n
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[{tag} path] {DTYPE_NAME[dtype]}: {len(lines)} hyps in {wall:.2f}s wall, "
              f"{n_batches} batch(es); launches: flash_attention {n_flash}, "
              f"layer_norm {n_ln}, fbank {n['fbank']}")
        require(len(lines) == n_utts, f"{len(lines)} hyp lines for {n_utts} utterances")
        require(n_flash == 6 * n_batches, f"flash launched {n_flash} times")
        require(n_ln >= 13 * n_batches, f"layer_norm launched {n_ln} times")
        require(n["fbank"] == (n_batches if online else 0), f"fbank launched {n['fbank']} times")


def decode_batches(manifest, budget=36000, online=False) -> int:
    """The infer CLI's batches of `manifest` at `budget` frames (samples
    for waves)."""
    from openasr_torch.data.manifest import ArkDataset, SpeechDataset
    from openasr_torch.data.sampler import FrameBasedSampler, TimeBasedSampler

    dataset, sampler = (SpeechDataset, TimeBasedSampler) if online else (ArkDataset,
                                                                          FrameBasedSampler)
    return len(sampler(dataset(manifest, feat_range=(1, 10**9), label_range=(0, 10**9),
                               rate_in_out=(0, 10**9)), budget))


def padded_features(feats, utts):
    """The utterances' features padded as the collate pads them, and their
    frame counts."""
    from openasr_torch.data.collate import quantize

    lengths = np.array([feats[u].shape[0] for u in utts], np.int32)
    x = np.zeros((len(utts), quantize(int(lengths.max())), 80), np.float32)
    for i, u in enumerate(utts):
        x[i, : lengths[i]] = feats[u]
    return x, lengths


def padded_batch(feats, utts, rng):
    from openasr_torch.data.collate import gen_causal_targets

    x, lengths = padded_features(feats, utts)
    toks = [list(rng.randint(3, 4232, size=n)) for n in (22, 20)[: len(utts)]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True)
    return {"feats": x, "feat_lengths": lengths, "ids": ids.astype(np.int64),
            "labels": labels, "paddings": paddings}


def check_logits_against_cpu(pkg, feats):
    """The card's f32 encoder and teacher-forced decoder (kernels) against
    the same package on the CPU (plain versions), on two utterances."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg)
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED))
    outs = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(
            Config(pkg["configs"]), device=device
        )
        model.restore(pkg)
        with torch.inference_mode():
            ctc, elens, ce = model.module(
                *(torch.from_numpy(batch[k]).to(device)
                  for k in ("feats", "feat_lengths", "ids"))
            )
        outs[device] = (ctc.cpu(), elens.cpu(), ce.cpu())
    (ctc_g, el_g, ce_g), (ctc_c, el_c, ce_c) = outs["cuda"], outs["cpu"]
    require(torch.equal(el_g, el_c), "encoder lengths differ between card and CPU")
    require(bool(torch.isfinite(ctc_g).all() and torch.isfinite(ce_g).all()),
            "non-finite logits on the card")
    e_ctc, e_ce = max_err(ctc_g, ctc_c), max_err(ce_g, ce_c)
    print(f"[check] f32 card vs CPU, 2 utts: ctc_fc logits err {e_ctc:.3g}, "
          f"decoder logits err {e_ce:.3g} (tol 1e-3)")
    require(e_ctc <= 1e-3 and e_ce <= 1e-3, "card and CPU disagree")


def ctc_model() -> dict:
    """The model section of egs/hkust/configs/ctc.yaml as it is, at the
    smoke test's vocabulary."""
    import yaml

    with open(CTC_YAML) as f:
        model = yaml.safe_load(f)["model"]
    model["decoder"]["vocab_size"] = FLAGSHIP["decoder"]["vocab_size"]
    return model


def save_ctc_package(path):
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import save_package

    model = get_model_class("conv-ctc").create_model(
        ctc_model(), device="cuda", generator=torch.Generator().manual_seed(SEED))
    save_package(model.package(), path)


def ctc_decode_launches() -> dict:
    """Kernel launches of one conv-ctc decode batch: every LayerNorm and
    every attention of the module once."""
    from openasr_torch.config import Config
    from openasr_torch.models.layers import LayerNorm, MultiHeadAttention
    from openasr_torch.models.speech import ConvCTCModule

    with torch.device("meta"):
        module = ConvCTCModule(Config(ctc_model()))
    return {"layer_norm_fwd": sum(isinstance(m, LayerNorm) for m in module.modules()),
            "flash_attention_fwd": sum(isinstance(m, MultiHeadAttention)
                                       for m in module.modules())}


def phase_ctc_decode(pkg, vocab, chars, manifest, launches):
    """conv-ctc through the CLI in its four modes (greedy, host beam, device
    beam, device beam with hotwords) in f32, and the device beam in bf16;
    counters reset just before each run and read just after."""
    from openasr_torch.bin import infer

    hot = os.path.join(WORK, "hotwords.txt")
    with open(hot, "w", encoding="utf-8") as f:
        f.write("".join(" ".join(chars[i: i + n]) + "\n" for i, n in ((5, 2), (100, 3), (7, 2))))
    n_utts = len(json.load(open(manifest)))
    per = ctc_decode_launches()
    beam = ["--ctc_beam", str(CTC_BEAM)]
    modes = [("greedy", [], torch.float32), ("host beam", beam, torch.float32),
             ("device beam", beam + ["--ctc_beam_device"], torch.float32),
             ("device beam, hotwords", beam + ["--ctc_beam_device", "--context_file", hot],
              torch.float32),
             ("device beam", beam + ["--ctc_beam_device"], torch.bfloat16)]
    for mode, extra, dtype in modes:
        hyp = os.path.join(WORK, f"hyp_ctc_{mode.replace(' ', '_').replace(',', '')}_"
                                 f"{DTYPE_NAME[dtype]}.txt")
        argv = ["--model_type", "conv-ctc", "--model_pkg", pkg, "--vocab_path", vocab,
                "--json_file", manifest, "--output", hyp, "--offline", "--add_blk",
                "--batch_frames", "36000", "--dtype", DTYPE_NAME[dtype],
                "--device", "cuda"] + extra
        reset_counters()
        t0 = time.time()
        infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        launches.setdefault(("ctc decode", dtype), {})[mode] = n
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[ctc decode path] {mode} {DTYPE_NAME[dtype]}: {len(lines)} hyps in {wall:.2f}s "
              f"wall; launches: flash_attention {n['flash_attention_fwd']}, layer_norm "
              f"{n['layer_norm_fwd']}")
        require(len(lines) == n_utts, f"{len(lines)} hyp lines for {n_utts} utterances")
        want = {k: 0 for k in n}
        want.update(per)   # the 8 utterances are one batch
        require(n == want, f"ctc decode {mode}: launches {n} != {want}")


def host_nbest(decoder, log_probs, lengths):
    """The native decoder's n-best of card log-probs, as (tokens, score)
    lists, and its wall ms."""
    lp, lens = log_probs.cpu().numpy(), lengths.cpu().numpy()
    t0 = time.perf_counter()
    nbest = decoder.decode_batch(lp, lens)
    ms = (time.perf_counter() - t0) * 1e3
    return [[(tuple(int(c) for c in h.tokens), h.score) for h in n] for n in nbest], ms


def device_nbest(log_probs, lengths):
    """The device beam's n-best (sentinel rows dropped), its device ms
    between CUDA events, and the host ms to enqueue it (the search reads
    nothing back, so the call returns once every launch is queued: where
    that is about the device ms, the host's launches bound the search)."""
    from openasr_torch.ops.ctc_beam_device import ctc_prefix_beam_device

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    toks, tlens, sc = ctc_prefix_beam_device(log_probs, lengths, blank=log_probs.shape[-1] - 1,
                                             beam=CTC_BEAM)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    toks, tlens, sc = toks.cpu().numpy(), tlens.cpu().numpy(), sc.cpu().numpy()
    return [[(tuple(int(c) for c in toks[i, n, : tlens[i, n]]), float(sc[i, n]))
             for n in range(CTC_BEAM) if sc[i, n] > -1e29]
            for i in range(len(toks))], (start.elapsed_time(end), enqueue_ms)


def check_ctc_beams(pkg, feats):
    """The device beam against the native host beam on the card's log-probs
    at the decode's shape [8, 339, 4233], beam 10, the CLI's cutoffs: on
    seeded peaky log-probs (each frame 8 nats up on blank, 60%, or a random
    character) every n-best list equal, scores within TOL_BEAM_PEAKY; on
    the random-weight conv-ctc model's own log-probs the share of equal
    1-best token lists, and the 1-best scores within TOL_BEAM_TOP1.  Each
    beam is timed on both, two runs after a warm one (their mean): device
    ms between CUDA events and the host's enqueue ms, host wall ms."""
    from openasr_torch.config import Config
    from openasr_torch.data.collate import quantize
    from openasr_torch.models import get_model_class
    from openasr_torch.ops.prefix_beam import make_decoder
    from openasr_torch.utils.checkpoint import load_package

    b, t, enc_lens = encoder_shapes(feats)
    v = FLAGSHIP["decoder"]["vocab_size"]
    decoder = make_decoder(beam_width=CTC_BEAM, blank_id=v - 1)
    rng = np.random.RandomState(SEED + 9)
    x = rng.randn(b, t, v).astype(np.float32)
    target = np.where(rng.rand(b, t) < 0.6, v - 1, rng.randint(3, v - 1, size=(b, t)))
    x[np.arange(b)[:, None], np.arange(t)[None, :], target] += 8.0
    peaky = torch.log_softmax(torch.from_numpy(x).cuda(), dim=-1)
    lengths = torch.from_numpy(enc_lens.astype(np.int32)).cuda()

    utts = sorted(feats)
    n_frames = np.array([feats[u].shape[0] for u in utts], np.int32)
    padded = np.zeros((len(utts), quantize(int(n_frames.max())), 80), np.float32)
    for i, u in enumerate(utts):
        padded[i, : n_frames[i]] = feats[u]
    pkg = load_package(pkg)
    model = get_model_class("conv-ctc").create_model(Config(pkg["configs"]), device="cuda")
    model.restore(pkg)
    logits, model_lens = model.get_logits(torch.from_numpy(padded).cuda(),
                                          torch.from_numpy(n_frames).cuda())
    own = torch.log_softmax(logits.float(), dim=-1)
    require(tuple(own.shape) == (b, t, v)
            and torch.equal(model_lens.cpu().long(), lengths.cpu().long()),
            f"conv-ctc log-probs {tuple(own.shape)}, lengths {model_lens.tolist()}")

    out = {}
    for name, lp, lens in (("peaky", peaky, lengths), ("model", own, model_lens)):
        dev, dev_times = zip(*(device_nbest(lp, lens) for _ in range(3)))
        dev_ms, enqueue_ms = zip(*dev_times)
        host, host_ms = zip(*(host_nbest(decoder, lp, lens) for _ in range(3)))
        require(all(d == dev[0] for d in dev) and all(h == host[0] for h in host),
                f"{name}: a beam's runs differ")
        dev, host = dev[0], host[0]
        same_nbest = sum([tok for tok, _ in d] == [tok for tok, _ in h]
                         for d, h in zip(dev, host))
        same_top1 = sum(d[0][0] == h[0][0] for d, h in zip(dev, host))
        top1_diff = max(abs(d[0][1] - h[0][1]) for d, h in zip(dev, host))
        score_diff = max((abs(sd - sh) for d, h in zip(dev, host)
                          if [tok for tok, _ in d] == [tok for tok, _ in h]
                          for (_, sd), (_, sh) in zip(d, h)), default=float("inf"))
        out[name] = {"device_ms": float(np.median(dev_ms[1:])),
                     "enqueue_ms": float(np.median(enqueue_ms[1:])),
                     "host_ms": float(np.median(host_ms[1:])),
                     "same_nbest": same_nbest, "same_top1": same_top1,
                     "top1_score_diff": top1_diff, "nbest_score_diff": score_diff,
                     "top1_lengths": [len(d[0][0]) for d in dev]}
        print(f"[ctc beams] {name} log-probs [{b}, {t}, {v}], beam {CTC_BEAM}: n-best equal "
              f"{same_nbest}/{b}, 1-best tokens equal {same_top1}/{b} (lengths "
              f"{out[name]['top1_lengths']}), 1-best score diff {top1_diff:.3g}, n-best score "
              f"diff where equal {score_diff:.3g}; device beam {out[name]['device_ms']:.2f} ms "
              f"a batch (CUDA events; the host enqueued it in "
              f"{out[name]['enqueue_ms']:.2f} ms), host beam {out[name]['host_ms']:.2f} ms "
              f"(wall; runs {[round(m, 2) for m in dev_ms]} / "
              f"{[round(m, 2) for m in host_ms]})")
    require(out["peaky"]["same_nbest"] == b
            and out["peaky"]["nbest_score_diff"] <= TOL_BEAM_PEAKY,
            "device and host beams disagree on peaky log-probs")
    require(out["model"]["top1_score_diff"] <= TOL_BEAM_TOP1,
            "device and host 1-best scores disagree on the model's log-probs")
    return out


# --------------------------------------------------------------- phase 5

def train_config(train_json, dev_json, vocab, exp_dir, dtype, yaml_path=FLAGSHIP_YAML,
                 profile=None):
    """A flagship YAML with its model and training sections unchanged but
    for one epoch, a log line per step, this run's paths and `dtype` (and a
    `training.profile` window when given)."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=train_json, devset=dev_json, vocab_path=vocab)
    cfg["training"].update(exp_dir=exp_dir, num_epoch=1, print_inteval=1,
                           compute_dtype=DTYPE_NAME[dtype])
    if profile is not None:
        cfg["training"]["profile"] = profile
    path = os.path.join(exp_dir, f"train_{DTYPE_NAME[dtype]}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def per_step_launches(model_cfg=FLAGSHIP) -> dict:
    """Kernel launches of one training step (and of one dev batch) of the
    flagship: every LayerNorm and every attention of the module once, and
    the fbank kernel once for an online model."""
    from openasr_torch.config import Config
    from openasr_torch.models.layers import LayerNorm, MultiHeadAttention
    from openasr_torch.models.speech import ConvCTCTransformerModule

    with torch.device("meta"):
        module = ConvCTCTransformerModule(Config(model_cfg))
    n_ln = sum(isinstance(m, LayerNorm) for m in module.modules())
    n_attn = sum(isinstance(m, MultiHeadAttention) for m in module.modules())
    n_fbank = int(module.splayer.feature_type == "fbank")
    per = {"train": {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                     "flash_attention_fwd_dropout": n_attn,
                     "flash_bwd_stats": n_attn, "flash_attention_bwd_dkv": n_attn,
                     "flash_attention_bwd_dq": n_attn},
           "dev": {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_attn}}
    if n_fbank:
        per["train"]["fbank"] = per["dev"]["fbank"] = n_fbank
    return per


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def phase_train(train_json, dev_json, vocab, launches, online=False):
    """Train one epoch + dev pass through the CLI in f32 and bf16, from one
    initial package, on offline features (the flagship YAML) or on waves
    (the online flagship YAML); counters reset just before each run and
    read just after."""
    from openasr_torch.bin import train
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    model_cfg, yaml_path = (online_model(), ONLINE_YAML) if online else (FLAGSHIP, FLAGSHIP_YAML)
    tag = "online train" if online else "train"
    per = per_step_launches(model_cfg)
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        exp = os.path.join(WORK, f"exp_{tag.replace(' ', '_')}_{name}")
        os.makedirs(exp)
        init = save_flagship_package(
            os.path.join(exp, "last.pkg"),
            {"epoch": 0, "step": 0, "tr_loss": [], "cv_loss": []}, model_cfg)
        # the offline bf16 run's step 1 (its second) under a profiler window
        profile = ({"start_step": 1, "num_steps": 1, "logdir": os.path.join(exp, "profile")}
                   if not online and dtype == torch.bfloat16 else None)
        cfg = train_config(train_json, dev_json, vocab, exp, dtype, yaml_path, profile)
        reset_counters()
        t0 = time.time()
        train.main([cfg, "--continue-training", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        tr = [r for r in rows if r["phase"] == "train"]
        cv = [r for r in rows if r["phase"] == "cv"]
        steps, dev_batches = len(tr), len(cv)
        losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
        step_s = [b["time"] - a["time"] for a, b in zip(tr, tr[1:])]
        print(f"[{tag} path] {name}: {steps} steps + {dev_batches} dev batch(es) in "
              f"{wall:.2f}s wall; per-step host s after the first {step_s}; "
              f"losses {[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
              f"{[round(r['ce_loss'], 4) for r in tr]} (ce); launches {n}")
        require(steps >= 2 and dev_batches >= 1, f"{steps} steps, {dev_batches} dev batches")
        require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
        want = {k: 0 for k in n}
        for k, c in per["train"].items():
            want[k] += c * steps
        for k, c in per["dev"].items():
            want[k] += c * dev_batches
        require(n == want, f"launches {n} != {want} "
                           f"({per['train']} a step, {per['dev']} a dev batch)")
        require(min(n[k] for k in per["train"]) > 0, "a kernel of the path never launched")
        launches[(tag, dtype)] = {"total": n, "steps": steps, "dev_batches": dev_batches}
        if profile is not None:
            found = profile_report(profile["logdir"])
            print(f"[profile] {tag} {name}, step 1: the trace holds device time for "
                  + ("; ".join(f"{k} {c} call(s) {us:.1f} us" for k, c, us in found)
                     or "none of the port's kernels"))

        last = load_package(os.path.join(exp, "last.pkg"))
        require(last["solver_state"]["step"] == steps and
                last["optim_state"]["count"] == steps, "last.pkg holds the wrong step")
        model = get_model_class("conv-ctc-transformer").create_model(model_cfg, device="cuda")
        model.restore(last["model"])
        before = dict(leaves(init["model"]["components"]))
        after = dict(leaves(last["model"]["components"]))
        matrices = [k for k, v in before.items() if v.ndim >= 2]
        changed = [k for k in matrices if not np.array_equal(before[k], after[k])]
        finite = all(np.isfinite(v).all() for v in after.values())
        print(f"[{tag} path] {name}: last.pkg reloads at step {steps}; "
              f"{len(changed)}/{len(matrices)} weight matrices changed; finite {finite}")
        require(finite and len(changed) == len(matrices),
                f"unchanged weights: {sorted(set(matrices) - set(changed))[:5]}")
    return per


def phase_train_head_dim_16(vocab, chars, rng, launches):
    """Two training steps and a dev pass of egs/aishell1/configs/
    conv-ctc-transformer-test.yaml (d_model 32, 2 heads: head dim 16, which
    the attention wrappers zero-pad to 32) through the CLI on the card, f32,
    on 4 random 20-dim utterances: finite losses, and every attention
    kernel launched."""
    import yaml

    from openasr_torch.bin import train

    manifest, _ = write_corpus("htrain", rng, chars, 4, (80, 96), (4, 8), dim=20)
    exp = os.path.join(WORK, "exp_head_dim_16")
    os.makedirs(exp)
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=manifest, devset=manifest, vocab_path=vocab)
    cfg["training"].update(exp_dir=exp, num_epoch=1, print_inteval=1)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    reset_counters()
    train.main([path, "--device", "cuda"])
    n = read_counters()
    launches[("head dim 16 train", torch.float32)] = n
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tr = [r for r in rows if r["phase"] == "train"]
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    print(f"[head dim 16 train path] {len(tr)} steps: losses "
          f"{[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
          f"{[round(r['ce_loss'], 4) for r in tr]} (ce); launches {n}")
    require(len(tr) >= 2, f"{len(tr)} training steps")
    require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
    require(min(n[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                               "flash_attention_bwd_dq", "layer_norm_bwd")) > 0,
            "an attention or LayerNorm kernel never launched at head dim 16")


def check_grads_against_cpu(pkg_path, feats, model_cfg=FLAGSHIP, tag="grad check") -> float:
    """One f32 training step (dropout and SpecAugment off) on 2 utterances
    at full width: every parameter's gradient on the card against the CPU,
    TF32 off."""
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg_path)
    pkg = pkg.get("model", pkg)
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED + 5))
    grads = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(model_cfg, device=device)
        model.restore(pkg)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        losses = model.loss(tb, None, label_smooth=0.1,
                            empty_rows=model.has_empty_rows(batch["feat_lengths"]))
        total = losses["ce_loss"] / losses["n_tokens"] + losses["ctc_loss"] / losses["n_seqs"]
        total.backward()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
        print(f"[{tag}] {device}: loss {float(total.detach()):.6f}")
    worst, worst_name = 0.0, None
    for name, want in grads["cpu"].items():
        # an attention k-projection bias has an analytically zero gradient
        # (softmax is shift-invariant), so its values are rounding noise:
        # its error is measured against its projection weight's gradient
        ref = grads["cpu"][name[: -len("bias")] + "weight"] if name.endswith(".k.bias") else want
        scale = max(float(ref.abs().max()), 1e-30)
        rel = max_err(grads["cuda"][name], want) / scale
        if not rel <= worst:
            worst, worst_name = rel, name
    print(f"[{tag}] f32 card vs CPU, 2 utts, {len(grads['cpu'])} parameters: worst "
          f"err {worst:.3g} of the gradient's max abs ({worst_name}; tol 1e-3; "
          f"k-projection biases against their weight's)")
    require(worst <= 1e-3, f"gradient of {worst_name} disagrees: {worst:.3g}")
    return worst


def ctc_losses(log_probs, logit_lengths, targets, target_lengths):
    """The summed CTC loss of log-probs [T, B, V] as `cal_ctc_loss` takes it
    without its last-blank rewrite: F.ctc_loss and the two zeroing rules."""
    import torch.nn.functional as F

    tlen = target_lengths.to(torch.int64)
    losses = F.ctc_loss(log_probs, targets.to(torch.int64),
                        logit_lengths.to(torch.int64).clamp(min=0), tlen.clamp(min=0),
                        blank=log_probs.shape[-1] - 1, reduction="none", zero_infinity=True)
    zero = torch.zeros((), dtype=losses.dtype, device=losses.device)
    losses = torch.where(tlen > 0, losses, zero)
    return torch.where(losses < 1.0e29, losses, zero).sum()


def parent_ctc_loss(logits, logit_lengths, targets, target_lengths):
    """`cal_ctc_loss` as it was before its last-blank rewrite
    (`_LastBlankFrame`): the yardstick of what the rewrite costs."""
    import torch.nn.functional as F

    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    return ctc_losses(log_probs, logit_lengths, targets, target_lengths)


def plain_last_blank_grad(logits, logit_lengths, targets, target_lengths):
    """The plain version of `cal_ctc_loss`'s gradient: F.ctc_loss's
    gradient of the log-probs with the blank entry of each row's last
    valid frame, where its last target is the blank id, set to minus the
    sum of the frame's other entries over the whole [T, B, V] tensor, then
    through log-softmax's backward."""
    import torch.nn.functional as F

    v = logits.shape[-1]
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    g = torch.autograd.grad(ctc_losses(log_probs, logit_lengths, targets, target_lengths),
                            log_probs, retain_graph=True)[0]
    tlen = target_lengths.to(torch.int64)
    last = targets.to(torch.int64).gather(1, (tlen - 1).clamp(min=0)[:, None])[:, 0]
    ends = (tlen > 0) & (last == v - 1) & (logit_lengths > 0)
    frame = torch.arange(g.shape[0], device=g.device)[:, None]
    rows = (frame == (logit_lengths - 1)[None, :]) & ends[None, :]
    g = g.clone()
    g[..., v - 1] = torch.where(rows, g[..., v - 1] - g.sum(dim=-1), g[..., v - 1])
    return torch.autograd.grad(log_probs, logits, g)[0]


def check_ctc_loss_cost(shapes, rounds: int = 5, calls: int = 20) -> dict:
    """The CTC loss's forward + backward at the flagship training batch
    ([B, T', 4233] f32 logits, 20-24 distinct targets a row, none the
    blank), with the last-blank rewrite (`cal_ctc_loss`) and without it
    (`parent_ctc_loss`): the gradients equal bit for bit, and the device
    ms of each between CUDA events, `calls` calls a round, the median of
    `rounds` interleaved rounds (F.ctc_loss reads the lengths on the host,
    so no graph).  Then, on 8 rows of which 4 end in the blank id, the
    card's gradient against its plain version on the card
    (`plain_last_blank_grad`, TOL_CTC_BLANK)."""
    from openasr_torch.ops.losses import cal_ctc_loss

    b, t, lens = shapes["b"], shapes["t"], shapes["enc_lens"]
    v = FLAGSHIP["decoder"]["vocab_size"]
    rng = np.random.RandomState(SEED + 13)
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32)).cuda().requires_grad_()
    llen = torch.from_numpy(lens.astype(np.int64)).cuda()
    tlen = torch.from_numpy(rng.randint(20, 25, b).astype(np.int64)).cuda()
    # no label twice in a row's targets: F.ctc_loss's CUDA backward adds a
    # repeated label's shares with atomics, in an order that may vary, and
    # the two gradients are compared bit for bit
    targets = torch.from_numpy(np.stack([rng.choice(v - 1, 24, replace=False)
                                         for _ in range(b)]).astype(np.int64)).cuda()

    def grad_of(fn):
        return torch.autograd.grad(fn(logits, llen, targets, tlen), logits)[0]

    require(torch.equal(grad_of(cal_ctc_loss), grad_of(parent_ctc_loss)),
            "the last-blank rewrite changed a gradient where no target is the blank id")
    ms = {"rewrite": [], "parent": []}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for key, fn in (("rewrite", cal_ctc_loss), ("parent", parent_ctc_loss)):
            grad_of(fn)
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                grad_of(fn)
            end.record()
            torch.cuda.synchronize()
            ms[key].append(start.elapsed_time(end) / calls)
    med = {k: float(np.median(r)) for k, r in ms.items()}

    blank_targets = targets[:8].clone()
    blank_targets[:4].scatter_(1, (tlen[:4] - 1)[:, None], v - 1)
    x = logits[:8].detach().requires_grad_()
    args = (x, llen[:8], blank_targets, tlen[:8])
    got = torch.autograd.grad(cal_ctc_loss(*args), x)[0]
    err = max_err(got, plain_last_blank_grad(*args))
    moved = max_err(got, torch.autograd.grad(parent_ctc_loss(*args), x)[0])
    # the card against the CPU on the same rows: F.ctc_loss's own f32
    # rounding at losses of about a thousand nats, reported, not bounded
    xc = x.detach().cpu().requires_grad_()
    cpu_loss = cal_ctc_loss(xc, *(a.cpu() for a in args[1:]))
    by_row = (got.cpu() - torch.autograd.grad(cpu_loss, xc)[0]).abs().amax(dim=(1, 2))
    print(f"[ctc loss] flagship training batch [{b}, {t}, {v}] f32, forward + backward, "
          f"device ms a call (CUDA events, {calls} calls, median of {rounds} interleaved "
          f"rounds): with the last-blank rewrite {med['rewrite']:.4f} "
          f"(rounds {[round(r, 4) for r in ms['rewrite']]}), without it (the parent's) "
          f"{med['parent']:.4f} (rounds {[round(r, 4) for r in ms['parent']]}); gradients "
          f"equal bit for bit; 8 rows, 4 ending in the blank id: the gradient against its "
          f"plain version {err:.3g} (tol {TOL_CTC_BLANK}), the rewrite moved it by {moved:.3g}; "
          f"card vs CPU (loss {float(cpu_loss.detach()):.1f} over 8 rows) {float(by_row[:4].max()):.3g} "
          f"on the rows ending in the blank id, {float(by_row[4:].max()):.3g} on the others")
    require(err <= TOL_CTC_BLANK,
            f"CTC gradient where a target is the blank id: {err:.3g} from its plain version")
    require(moved > 0.0, "the last-blank rewrite changed nothing where it must")
    return {"ms": med, "err": err, "short": check_ctc_short_rows()}


def check_ctc_short_rows() -> dict:
    """CTC_SHORT_ROWS on the card and on the CPU: the gradient of
    `cal_ctc_loss` on the card against the CPU's (TOL_CTC_SHORT; the CPU's
    is the JAX package's there, tests/test_torch_cif.py), and per row the
    largest change the last-blank rewrite makes against
    `parent_ctc_loss`'s gradient.  On the CPU, F.ctc_loss drops a share of
    the last frame's blank gradient where a row's last target is the blank
    id, and the rewrite must add it back (at least 0.1; nothing elsewhere):
    there the check tells a right gradient on the card from one short of
    that share.  On the card the change is reported: F.ctc_loss's CUDA
    backward keeps both end states' shares, and the rewrite leaves its
    gradient as it is."""
    from openasr_torch.ops.losses import cal_ctc_loss

    worst, shares = 0.0, {"cuda": [], "cpu": []}
    for labels, n in CTC_SHORT_ROWS:
        rng = np.random.RandomState(len(labels) * 10 + n)
        logits = torch.from_numpy(rng.randn(2, 9, 11).astype(np.float32))
        args = (torch.tensor([labels, labels]), torch.tensor([9, 7]), torch.tensor([n, n]))
        out = {}
        for device in ("cuda", "cpu"):
            x = logits.to(device).requires_grad_()
            targets, llen, tlen = (t.to(device) for t in args)
            got = torch.autograd.grad(cal_ctc_loss(x, llen, targets, tlen), x)[0].cpu()
            parent = torch.autograd.grad(parent_ctc_loss(x, llen, targets, tlen), x)[0].cpu()
            out[device] = (got, (got - parent).abs().amax(dim=(1, 2)))
        (g_card, m_card), (g_cpu, m_cpu) = out["cuda"], out["cpu"]
        err = max_err(g_card, g_cpu)
        worst = max(worst, err)
        ends = labels[n - 1] == 10
        if ends:
            for device, m in (("cuda", m_card), ("cpu", m_cpu)):
                shares[device] += [float(f"{float(v):.4g}") for v in m]
        require(err <= TOL_CTC_SHORT, f"CTC short rows {labels[:n]}: card vs CPU {err:.3g}")
        require(bool((m_cpu >= 0.1).all()) if ends else bool((m_cpu == 0).all()),
                f"CTC short rows {labels[:n]}: the rewrite moved the CPU's gradient by "
                f"{m_cpu.tolist()} (ends in the blank id: {ends})")
    print(f"[ctc loss] the CPU test's short rows ({len(CTC_SHORT_ROWS)} cases of 2 rows, 9 and "
          f"7 frames, vocabulary 11, blank 10): card vs CPU gradient {worst:.3g} (tol "
          f"{TOL_CTC_SHORT}); on the rows ending in the blank id the rewrite added "
          f"{shares['cpu']} to the CPU's F.ctc_loss gradient and {shares['cuda']} to the "
          f"card's, nothing elsewhere")
    return {"err": worst, "shares": shares}


# --------------------------------------------------------------- phase 6

def train_shapes(train_json):
    """The training path's largest batch: B, padded T' after ConvV2 and the
    encoder lengths, and the decoder's U (ids width)."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import ArkDataset
    from openasr_torch.data.sampler import FrameBasedSampler

    ds = ArkDataset(train_json, feat_range=(1, 1200), label_range=(1, 60))
    best = None
    for batch in FrameBasedSampler(ds, 36000).batches:
        lens = np.array([ds[i]["feat_length"] for i in batch])
        t = quantize(int(lens.max()))
        for _ in range(2):
            t, lens = (t - 1) // 2, (lens - 1) // 2
        u = quantize(max(int(ds[i]["token_length"]) for i in batch) + 2)
        if best is None or len(batch) * t > best["b"] * best["t"]:
            best = {"b": len(batch), "t": t, "enc_lens": lens, "u": u}
    return best


def online_train_batch(train_json, waves):
    """The online training path's largest batch (by padded samples): its
    utterances and the corpus's waves."""
    import yaml

    from openasr_torch.config import parse_range
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import SpeechDataset
    from openasr_torch.data.sampler import TimeBasedSampler

    with open(ONLINE_YAML) as f:
        cfg = yaml.safe_load(f)
    ds = SpeechDataset(train_json, feat_range=parse_range(cfg["data"]["feat_range"]),
                       label_range=parse_range(cfg["data"]["label_range"]))
    batches = TimeBasedSampler(ds, int(cfg["training"]["batch_time"])).batches
    best = max(batches, key=lambda b: len(b) * quantize(max(ds[i]["feat_length"] for i in b)))
    return {"utts": [ds[i]["uttid"] for i in best], "waves": waves}


def encoder_shapes(feats):
    """The decode path's encoder batch: B, padded T' after ConvV2, lengths."""
    from openasr_torch.data.collate import quantize

    lens = np.array([m.shape[0] for m in feats.values()])
    t = quantize(int(lens.max()))
    for _ in range(2):
        t, lens = (t - 1) // 2, (lens - 1) // 2
    return len(lens), t, lens


def times(kernel, plain, library) -> dict:
    """Device ms per call (CUDA-graph replay) of the kernel, its plain
    version and the library call."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library)}


def bound(nbytes, flops, dtype, peaks=PEAK_FLOPS) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peaks[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def held_to_plain(name, kernel, plain, tol, errs, key) -> None:
    """Kernel against plain version at a main-path shape; the first
    outputs (y, O) are compared and the error joins the kernel's max."""
    got, want = kernel()[0], plain()[0]
    torch.cuda.synchronize()
    e = max_err(got, want)
    print(f"[{name}] main-path shape: err {e:.3g} (tol {tol})")
    require(e <= tol, f"{name} disagrees at the main path's shape")
    errs[key] = max(errs[key], e)


def visible(tq, n, causal, chunk_mask=None) -> np.ndarray:
    """[Tq, n] bool: the (query, key) pairs the masks leave valid for n
    valid keys (causal, or a streaming encoder's chunk mask)."""
    q, k = np.arange(tq)[:, None], np.arange(int(n))[None, :]
    ok = (k <= q) if causal else np.ones((tq, int(n)), bool)
    if chunk_mask is not None:
        chunk, left, phase = chunk_mask
        qc, kc = (q + phase) // chunk, (k + phase) // chunk
        ok = ok & (kc <= qc) & ((kc >= qc - left) if left >= 0 else True)
    return ok


def attention_pairs(tq, lens, causal, chunk_mask=None) -> int:
    """(query, key) pairs the masks leave valid, summed over the batch."""
    return sum(int(visible(tq, n, causal, chunk_mask).sum()) for n in lens)


def fwd_rows(feats, errs, launches):
    """The forward kernels (LayerNorm, attention) at the decode path's encoder shape."""
    import torch.nn.functional as F

    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

    b, t, lens = encoder_shapes(feats)
    h, d, dm = 8, 64, 512
    rng = np.random.RandomState(SEED + 2)
    rows = []
    for dtype in DTYPES:
        es = torch.tensor([], dtype=dtype).element_size()
        dec, tr = launches[("decode", dtype)], launches[("train", dtype)]
        ctc = launches[("ctc decode", dtype)]
        n = b * t
        x, g, beta = ln_inputs(n, dm, dtype, rng)
        g_l, b_l = g.to(dtype), beta.to(dtype)
        held_to_plain(f"layer_norm {DTYPE_NAME[dtype]} [{n}, {dm}]",
                      lambda: fused_layer_norm(x, g, beta),
                      lambda: layer_norm_reference(x, g, beta),
                      TOL_LN[dtype], errs, ("layer_norm_fwd", dtype))
        rows.append({
            "name": f"layer_norm_fwd[{DTYPE_NAME[dtype]}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:56",
            "shape": [n, dm],
            "launches": dec["layer_norm_fwd"],
            "launches_train_path": tr["total"]["layer_norm_fwd"],
            "launches_ctc_decode_path": {m: c["layer_norm_fwd"] for m, c in ctc.items()},
            "max_abs_err": errs[("layer_norm_fwd", dtype)],
            "tol": TOL_LN[dtype],
            **times(
                lambda: fused_layer_norm(x, g, beta),
                lambda: layer_norm_reference(x, g, beta),
                lambda: F.layer_norm(x, (dm,), g_l, b_l, 1e-6),
            ),
            **bound(2 * n * dm * es + 2 * dm * 4 + 2 * n * 4, 8 * n * dm, torch.float32),
        })

        rows.append({
            "name": f"flash_attention_fwd[{DTYPE_NAME[dtype]}]",
            **attention_fwd_row(b, h, d, t, t, False, lens, dtype, rng, errs, 0.0),
            "launches": dec["flash_attention_fwd"],
            "launches_train_path": tr["total"]["flash_attention_fwd"],
            "launches_ctc_decode_path": {m: c["flash_attention_fwd"] for m, c in ctc.items()},
            "max_abs_err": errs[("flash_attention_fwd", dtype)],
            "tol": TOL_FLASH[dtype],
        })
    return rows


def fbank_ops_per_frame(cfg) -> float:
    """Operations of one frame's log-mel, what the fbank needs: DC removal,
    preemphasis and window, 5 a sample; a real FFT of nfft points, 2.5 nfft
    log2 nfft; the power, 3 a bin; the mel product over the banks'
    nonzeros, 2 each; max and log, 2 a bin."""
    from openasr_torch.ops.fbank import mel_banks

    ws, nfft, m = cfg.window_size, cfg.padded_window_size, cfg.num_mel_bins
    nnz = int(np.count_nonzero(mel_banks(cfg)))
    return 5 * ws + 2.5 * nfft * float(np.log2(nfft)) + 3 * (nfft // 2 + 1) + 2 * nnz + 2 * m


def fbank_rows(train_batch, test_waves, errs, launches):
    """The fused fbank kernel at the online paths' batches (f32 only: the
    frontend always runs in f32): the FFT kernel, which those paths run,
    and at the decode batch with nfft 400 (round_to_power_of_two false) the
    folded kernel, which no path of the smoke test runs."""
    from openasr_torch.kernels.fbank import fbank_reference, fused_fbank
    from openasr_torch.ops.fbank import FbankConfig, rfft_fbank

    rows = []
    for path, waves, utts, kw in (
        ("train", train_batch["waves"], train_batch["utts"], {}),
        ("decode", test_waves, sorted(test_waves), {}),
        ("decode, nfft 400", test_waves, sorted(test_waves), {"round_to_power_of_two": False}),
    ):
        cfg = FbankConfig(**kw)
        ws, m = cfg.window_size, cfg.num_mel_bins
        x, lens = fbank_batch(waves, utts)
        frames, feat_lens = fbank_inputs(x, lens, cfg, False)
        b, t, _ = frames.shape
        n_valid = int(feat_lens.sum())
        # the composite computes every frame it is given: give it the valid
        # ones only, gathered before the timing, as the kernel skips padding
        valid = torch.arange(t, device="cuda")[None, :] < feat_lens[:, None]
        valid_frames = frames[valid]
        # samples read once, every output written, the frame counts read
        nbytes = 4 * int(lens.sum()) + 4 * b * t * m + 4 * b
        if kw:
            name, kernel = "fbank_folded[decode, nfft 400]", "fbank_folded_kernel"
            counted = {"launches": 0,
                       "launches_are": "the online paths' configs (nfft 512) take the FFT "
                                       "kernel; this one runs where nfft is not a power of "
                                       "two (the [fbank] phase's nfft 400 case)"}
        else:
            name, kernel = f"fbank[{path}]", "fbank_fft_kernel"
            run = launches[(f"online {path}", torch.float32)]
            counted = {"launches": run.get("total", run)["fbank"],
                       "launches_are": f"the online {path} path's, in f32 (in bf16 the same)"}
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"openasr_torch/kernels/csrc/fbank.cu:{kernel}",
            "replaces": "openasr_tpu/kernels/fbank_fused.py:90",
            "shape": [b, t, ws],
            "nfft": cfg.padded_window_size,
            **counted,
            **({"max_abs_err": errs["fbank_folded"], "tol": TOL_FBANK_FOLDED} if kw else {
                "max_abs_err": errs["fbank"],
                "tol_is": "per case, the plain version's max_abs_err against float64 plus "
                          "tol_vs_float64",
                "largest_share_of_tol": errs["fbank_of_tol"],
                "max_abs_err_vs_float64": errs["fbank_vs_f64"],
                "tol_vs_float64": TOL_FBANK_F64,
                "plain_max_abs_err_vs_float64": errs["fbank_plain_vs_f64"]}),
            "max_rel_err_no_log": errs["fbank_mel_rel"],
            "tol_no_log": TOL_FBANK_REL,
            "valid_frames": n_valid,
            **times(lambda: fused_fbank(frames, feat_lens, cfg),
                    lambda: fbank_reference(frames, feat_lens, cfg),
                    lambda: rfft_fbank(valid_frames, cfg)),
            "plain_is": "the folded products over all B.T frames, then masked",
            "library_is": "several calls, the cuFFT composite (ops.fbank.rfft_fbank): DC "
                          "removal, preemphasis and window, torch.fft.rfft, power, the mel "
                          "matmul and the log, over the valid frames only (gathered "
                          "before the timing)",
            # what the log-mel needs over the valid frames (an FFT, the mel
            # banks' nonzeros), at the rate of the f32 it reads and writes
            **bound(nbytes, n_valid * fbank_ops_per_frame(cfg), torch.float32),
            **({} if kw else {"float64_ops_bound_ms": n_valid * fbank_ops_per_frame(cfg)
                              / PEAK_FLOPS[torch.float64] * 1e3,
                              "float64_ops_bound_is": "the same operations at float64's "
                                                      "rate, the type the kernel computes in"}),
        })
    return rows


def bwd_errs(err, tol) -> dict:
    """Row keys of a backward kernel's errors over every checked case."""
    return {"max_abs_err": err[0], "max_scaled_err": err[1], "tol": tol,
            "tol_of": "max_scaled_err: max abs error over max(1, largest plain "
                      "magnitude), gradients with and without dropout"}


def stats_row_errs(err) -> dict:
    """Row keys of the statistics pass's errors over every checked case."""
    return {"max_abs_err": err[0], "max_scaled_err": err[1], "tol": TOL_FLASH_STATS,
            "tol_of": "max_scaled_err: m and delta, max abs error over max(1, largest "
                      "plain magnitude); 1 / l, relative to each row's own 1 / l; with "
                      "and without dropout"}


def backward_ms(fwd, inputs, grad_out, calls: int = 20, reps: int = 10) -> float:
    """Device ms of the backward of `fwd`: forward + backward minus the
    forward alone, both by CUDA-graph replay."""
    def both():
        torch.autograd.grad(fwd(), inputs, grad_out)

    return device_ms(both, calls, reps) - device_ms(fwd, calls, reps)


def attention_shapes(shapes, model_cfg=FLAGSHIP):
    """The training step's attention shapes: (name, Tq, Tk, causal, kv
    lengths or None, calls a step), one call a layer, forward and
    backward."""
    t, u, lens = shapes["t"], shapes["u"], shapes["enc_lens"]
    n_enc, n_dec = model_cfg["encoder"]["num_layers"], model_cfg["decoder"]["num_layers"]
    return [("encoder", t, t, False, lens, n_enc), ("decoder", u, u, True, None, n_dec),
            ("cross", u, t, False, lens, n_dec)]


def sdpa_masks(tq, tk, kv, causal, chunk_mask=None) -> dict:
    """SDPA's arguments for the same masks as the kernels': is_causal, or a
    bool key-padding mask, or both in one bool mask (the CIF decoder), or
    the key-padding and chunk masks in one (a streaming encoder)."""
    if kv is None:
        return dict(is_causal=causal)
    key = torch.arange(tk, device="cuda")
    mask = (key[None, :] < kv[:, None])[:, None, None, :]
    if causal:
        mask = mask & (key[None, :] <= torch.arange(tq, device="cuda")[:, None])[None, None]
    if chunk_mask is not None:
        mask = mask & torch.from_numpy(visible(tq, tk, False, chunk_mask)).cuda()[None, None]
    return dict(attn_mask=mask)


def attention_bwd_times(b, h, d, tq, tk, causal, lens, dtype, rng, chunk_mask=None,
                        cold=True) -> dict:
    """The whole attention backward (statistics, dK/dV, dQ) at one shape, with
    dropout 0.1 as the training path runs it: device ms of the kernels
    (`cold`: also with a cold L2), the plain backward and SDPA's backward,
    the bound and the inputs."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_bwd_stats,
    )

    es = torch.tensor([], dtype=dtype).element_size()
    q, dout = (torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to("cuda", dtype)
               for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, tk, h, d).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    kv = None if lens is None else torch.from_numpy(lens.astype(np.int32)).cuda()
    qt, kt, vt, dot = (z.transpose(1, 2) for z in (q, k, v, dout))
    qg, kg, vg = (z.detach().clone().requires_grad_() for z in (qt, kt, vt))
    sdpa = sdpa_masks(tq, tk, kv, causal, chunk_mask)
    rate, seed = DROPOUT, DROPOUT_SEED
    out, lse = flash_attention(q, k, v, kv_lengths=kv, causal=causal, dropout_rate=rate,
                               dropout_seed=seed, chunk_mask=chunk_mask)
    args = (q, k, v, out, lse, dout, kv, causal, None, rate, seed, chunk_mask)
    key_lens = [tk] * b if lens is None else [min(int(n), tk) for n in lens]
    pairs = h * attention_pairs(tq, key_lens, causal, chunk_mask)
    qo_bytes = es * b * tq * h * d                 # one [B, Tq, H, D] tensor
    kv_bytes = es * sum(key_lens) * h * d          # K or V over valid keys
    stat_bytes = 4 * b * h * tq                    # one row statistic (lse, m, 1 / l, delta)
    # q, O, dO read; K, V over valid keys; lse and lengths; dQ written over
    # every query, dK and dV over every key; five Tq.Tk.D products over the
    # valid pairs (S, dP, dV, dK, dQ)
    nbytes = 4 * qo_bytes + 2 * kv_bytes + 2 * es * b * tk * h * d + stat_bytes + 4 * b
    return {
        "shape": [b, tq, tk, h, d],
        "ms": device_ms(lambda: flash_attention_bwd(*args)),
        **(cold_l2_ms(lambda: flash_attention_bwd(*args)) if cold else {}),
        "plain_ms": device_ms(lambda: flash_attention_bwd_reference(*args)),
        "library_ms": backward_ms(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate, **sdpa),
            (qg, kg, vg), dot),
        **bound(nbytes, 5 * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
        "kernel_args": args[:6] + (flash_bwd_stats(q, k, v, dout, kv, causal, None, rate,
                                                   seed, chunk_mask),) + args[6:],
        "pairs": pairs, "qo_bytes": qo_bytes, "kv_bytes": kv_bytes, "stat_bytes": stat_bytes,
    }


def dx_only_reading(n, dm, dtype, rng, errs, timed) -> dict:
    """The LayerNorm backward's dx-only mode on [n, dm] random rows held to
    its plain version (the error joins `errs`); with `timed`, device ms of
    the kernel, the plain version and F.layer_norm's backward, and the
    bound."""
    import torch.nn.functional as F

    from openasr_torch.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    name = DTYPE_NAME[dtype]
    x, g, beta = ln_inputs(n, dm, dtype, rng)
    dy = torch.from_numpy(rng.randn(n, dm).astype(np.float32)).to("cuda", dtype)
    _, mean, rstd = layer_norm_reference(x, g, beta)
    got = layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)[0]
    e, scale = scaled_err(got, layer_norm_bwd_reference(x, dy, g, mean, rstd,
                                                        dgamma_dbeta=False)[0])
    require(e <= TOL_LN_BWD[dtype] * scale,
            f"layer_norm_bwd dx-only [{n}, {dm}] {name}: err {e:.3g} > "
            f"{TOL_LN_BWD[dtype]} x {scale:.3g}")
    note_err(errs, ("layer_norm_bwd_dx", dtype), e, e / scale)
    print(f"[model path] layer_norm_bwd dx-only [{n}, {dm}] {name}: err {e / scale:.3g} "
          f"of max(1, |dx|) (tol {TOL_LN_BWD[dtype]})")
    out = {"scaled_err": e / scale}
    if not timed:
        return out
    es = torch.tensor([], dtype=dtype).element_size()
    xl, gl, bl = (z.clone().requires_grad_() for z in (x, g.to(dtype), beta.to(dtype)))
    return {**out,
            "ms": device_ms(lambda: layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)),
            "plain_ms": device_ms(lambda: layer_norm_bwd_reference(x, dy, g, mean, rstd,
                                                                   dgamma_dbeta=False)),
            "library_ms": backward_ms(lambda: F.layer_norm(xl, (dm,), gl, bl, 1e-6),
                                      (xl, gl, bl), dy),
            # x, dy read and dx written; mean, rstd, gamma read
            **bound(3 * n * dm * es + 2 * n * 4 + dm * 4, 9 * n * dm, torch.float32)}


BWD_NOTES = {
    "ms_is": "warm L2: the inputs stay resident between calls as far as they fit",
    "cold_is": "cold L2: each call after a 128 MB read that evicts the 50 MB L2, "
               "the reads' own time subtracted; cold_extra: cold minus warm, "
               "median and range over 10 interleaved rounds (cold_l2_ms)",
    "plain_is": "the whole plain backward (dq, dk, dv together), dropout 0.1",
    "library_is": "F.scaled_dot_product_attention (dropout_p 0.1; a bool key "
                  "mask, or is_causal for the decoder) forward + backward minus "
                  "forward (graph replay), dq dk dv together",
}


def split_bwd_rows(at, suffix, dtype, errs, launches_of, notes, cold=True) -> list:
    """Rows 5s, 5 and 6 at one shape of `attention_bwd_times` (`at`): the
    statistics pass, dK/dV and dQ, each alone, with its launches
    (`launches_of(kernel)`), its error over every checked case and its
    device ms (`cold`: also with a cold L2) beside its bound; dK/dV's and
    dQ's plain and library times are those of the whole backward, the
    statistics' those of its own plain version (no one-call library
    counterpart)."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_bwd_stats,
        flash_bwd_stats_reference,
    )

    name = DTYPE_NAME[dtype]
    kernel_args, pairs, d = at["kernel_args"], at["pairs"], at["shape"][4]
    qo_bytes, kv_bytes, stat_bytes = at["qo_bytes"], at["kv_bytes"], at["stat_bytes"]
    q_, k_, v_, _, _, dout_, _, kv_, causal_, sms_, rate_, seed_, _ = kernel_args

    def stats_of(*_args):
        return flash_bwd_stats(q_, k_, v_, dout_, kv_, causal_, sms_, rate_, seed_)

    rows = []
    for kernel, fn, replaces, nbytes, products in (
        ("flash_bwd_stats", stats_of,
         "openasr_tpu/kernels/flash_attention.py:468 (delta, with each row's max "
         "and 1 / l)",
         # q, dO read; K, V over valid keys; m, 1 / l, delta written
         2 * qo_bytes + 2 * kv_bytes + 3 * stat_bytes, 2),                 # S dP
        ("flash_attention_bwd_dkv", flash_attention_bwd_dkv,
         "openasr_tpu/kernels/flash_attention.py:238",
         # q, dO, the three statistics read; K, V over valid keys; dK, dV written
         2 * qo_bytes + 2 * kv_bytes + 3 * stat_bytes + 2 * qo_bytes, 4),  # S dP dV dK
        ("flash_attention_bwd_dq", flash_attention_bwd_dq,
         "openasr_tpu/kernels/flash_attention.py:327",
         # q, dO, the three statistics read; K, V over valid keys; dQ written
         3 * qo_bytes + 2 * kv_bytes + 3 * stat_bytes, 3),                 # S dP dQ
    ):
        alone = kernel == "flash_bwd_stats"
        rows.append({
            "name": f"{kernel}{suffix}[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": replaces,
            "shape": at["shape"],
            **launches_of(kernel),
            **(stats_row_errs(errs[(kernel, dtype)]) if alone
               else bwd_errs(errs[(kernel, dtype)], TOL_FLASH_BWD[dtype])),
            "ms": device_ms(lambda: fn(*kernel_args)),
            **(cold_l2_ms(lambda: fn(*kernel_args)) if cold else {}),
            **notes,
            "plain_ms": (device_ms(lambda: flash_bwd_stats_reference(
                q_, k_, v_, dout_, kv_, causal_, sms_, rate_, seed_)) if alone
                else at["plain_ms"]),
            "plain_is": "flash_bwd_stats_reference" if alone else notes["plain_is"],
            "library_ms": None if alone else at["library_ms"],
            "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
            **bound(nbytes, products * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
        })
    return rows


def train_rows(shapes, errs, launches, per, tp_ln):
    """The training path's kernels at its encoder shape (largest batch),
    and the attention forward and backward also at the decoder's and the
    cross-attention's; the LayerNorm backward's dx-only mode at the rows a
    tp2 rank launched it on in the [model path], with those launches
    (`tp_ln`: rank 0's, sequence parallelism on), and at the encoder's
    T-shards [B (T' // 2), 512]."""
    import torch.nn.functional as F

    from openasr_torch.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    b, t = shapes["b"], shapes["t"]
    h, d, dm = 8, 64, 512
    rng = np.random.RandomState(SEED + 6)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        es = torch.tensor([], dtype=dtype).element_size()
        tr = launches[("train", dtype)]

        def launch_keys(key):
            return {"launches": tr["total"][key],
                    "launches_per_step": per["train"].get(key, 0)}

        # LayerNorm backward over the encoder's rows
        n = b * t
        x, g, beta = ln_inputs(n, dm, dtype, rng)
        dy = torch.from_numpy(rng.randn(n, dm).astype(np.float32)).to("cuda", dtype)
        _, mean, rstd = layer_norm_reference(x, g, beta)
        xl, gl, bl = (z.clone().requires_grad_() for z in (x, g.to(dtype), beta.to(dtype)))
        lib_ln_ms = backward_ms(lambda: F.layer_norm(xl, (dm,), gl, bl, 1e-6), (xl, gl, bl), dy)
        rows.append({
            "name": f"layer_norm_bwd[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:85 (and :69, the dx-only mode)",
            "shape": [n, dm],
            **launch_keys("layer_norm_bwd"),
            **bwd_errs(errs[("layer_norm_bwd", dtype)], TOL_LN_BWD[dtype]),
            "ms": device_ms(lambda: layer_norm_bwd(x, dy, g, mean, rstd)),
            "plain_ms": device_ms(lambda: layer_norm_bwd_reference(x, dy, g, mean, rstd)),
            "library_ms": lib_ln_ms,
            "library_is": "F.layer_norm forward + backward minus forward (graph replay)",
            # x, dy read and dx written; mean, rstd, gamma read; dgamma, dbeta written
            **bound(3 * n * dm * es + 2 * n * 4 + 3 * dm * 4, 13 * n * dm, torch.float32),
        })
        # the same kernel's dx-only mode (the JAX package's _bwd_dx_kernel)
        # at the rows a tp2 rank launched it on in the [model path]
        # (`tp_ln["dx_rows"]`), held to its plain version at each and timed
        # at the most launched; and, labelled apart, at the T-shards of the
        # training path's largest batch's encoder, [B (T' // 2), 512]
        dx_rows = tp_ln["dx_rows"]
        main = max(dx_rows, key=lambda n: (dx_rows[n], n))
        at = {n: dx_only_reading(n, dm, dtype, rng, errs, timed=n == main)
              for n in sorted(dx_rows)}
        enc = dx_only_reading(b * (t // 2), dm, dtype, rng, errs, timed=True)
        timings = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        rows.append({
            "name": f"layer_norm_bwd_dx[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:69",
            "shape": [main, dm],
            "launched_shapes": [[n, dm, k] for n, k in sorted(dx_rows.items())],
            "launches": tp_ln["dx"],
            "launches_per_step": tp_ln["dx"] / PARALLEL_STEPS,
            "launches_are": "a tp2 rank's on the [model path] (flagship, sequence parallelism "
                            "on, f32), its T-sharded sites; launched_shapes: [rows, 512, "
                            "launches] of each",
            **bwd_errs(errs[("layer_norm_bwd_dx", dtype)], TOL_LN_BWD[dtype]),
            **{k: at[main][k] for k in timings},
            "library_is": "F.layer_norm forward + backward minus forward (graph replay); "
                          "it also computes dgamma and dbeta",
            "at_encoder_shards": {
                "shape": [b * (t // 2), dm], **{k: enc[k] for k in timings + ("scaled_err",)},
                "is": "the training path's largest batch's encoder rows over 2: no [model "
                      "path] run launches it there (the flagship's T' is odd)"},
        })

        # the attention backward at the step's three shapes, with dropout as
        # the training path runs it; the encoder's rows keep their older names
        errs_bwd = tuple(max(a, c) for a, c in zip(errs[("flash_attention_bwd_dkv", dtype)],
                                                    errs[("flash_attention_bwd_dq", dtype)]))
        bwd_shapes = attention_shapes(shapes)
        calls = [c for *_, c in bwd_shapes]
        require(sum(calls) * tr["steps"] == tr["total"]["flash_attention_bwd_dkv"],
                f"{calls} attention backward calls a step by the config, but "
                f"{tr['total']['flash_attention_bwd_dkv']} dK/dV launches in {tr['steps']} steps")
        step_ms = step_lib_ms = 0.0
        for where, tq, tk, causal, kv_lens, n_calls in bwd_shapes:
            at = attention_bwd_times(b, h, d, tq, tk, causal, kv_lens, dtype, rng)
            step_ms += n_calls * at["ms"]
            step_lib_ms += n_calls * at["library_ms"]
            rows.append({
                "name": (f"flash_attention_bwd[{name}]" if where == "encoder"
                         else f"flash_attention_bwd_{where}[{name}]"),
                "route": "cuda",
                "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
                "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                            "delta :468, dK/dV :238, dQ :327)",
                "shape": at["shape"],
                "causal": causal,
                **launch_keys("flash_attention_bwd_dkv"),
                "calls_per_step_at_this_shape": n_calls,
                "launches_are": "backward calls at the step's three shapes, each launching "
                                "the dK/dV and the dQ kernel once",
                **bwd_errs(errs_bwd, TOL_FLASH_BWD[dtype]),
                **{key: at[key] for key in ("ms", "cold_ms", "cold_extra_ms",
                                            "cold_extra_range_ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")},
                **BWD_NOTES,
                "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
            })
            if where != "encoder":
                continue
            # each kernel alone at the encoder shape
            rows += split_bwd_rows(at, "", dtype, errs, launch_keys, BWD_NOTES)
        print(f"[time] attention backward a training step {name}, computed: each shape's "
              f"device ms a call times its calls a step ({' + '.join(map(str, calls))}, the "
              f"measured dK/dV launches a step; largest batch): kernels {step_ms:.4f} ms, "
              f"SDPA {step_lib_ms:.4f} ms")

        # the forward with dropout at the step's three shapes
        fwd_shapes = attention_shapes(shapes)
        calls = [c for *_, c in fwd_shapes]
        require(sum(calls) * tr["steps"] == tr["total"]["flash_attention_fwd_dropout"],
                f"{calls} attention forward calls a step by the config, but "
                f"{tr['total']['flash_attention_fwd_dropout']} dropout forward launches in "
                f"{tr['steps']} steps")
        step_ms = step_lib_ms = 0.0
        for where, tq, tk, causal, kv_lens, n_calls in fwd_shapes:
            row = attention_fwd_row(b, h, d, tq, tk, causal, kv_lens, dtype, rng, errs,
                                    DROPOUT)
            step_ms += n_calls * row["ms"]
            step_lib_ms += n_calls * row["library_ms"]
            rows.append({
                "name": (f"flash_attention_fwd_dropout[{name}]" if where == "encoder"
                         else f"flash_attention_fwd_dropout_{where}[{name}]"),
                **row,
                **launch_keys("flash_attention_fwd_dropout"),
                "calls_per_step_at_this_shape": n_calls,
                "launches_are": "dropout forward calls at the step's three shapes",
                "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                "tol": TOL_FLASH[dtype],
            })
        print(f"[time] attention forward a training step {name}, computed: each shape's "
              f"device ms a call times its calls a step ({' + '.join(map(str, calls))}, the "
              f"measured dropout forward launches a step; largest batch): kernels "
              f"{step_ms:.4f} ms, SDPA {step_lib_ms:.4f} ms")
    return rows


def head_dim_rows(shapes, errs, launches):
    """The attention kernels at head dim 16 (zero-padded to 32 by the
    wrappers) at the training encoder's shape with dropout 0.1, forward and
    whole backward, beside the same kernels at 32 on the inputs padded
    beforehand (`at_32_ms`: what the pad and the slices cost is the
    difference)."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        pad_head_dim,
    )

    b, t, lens = shapes["b"], shapes["t"], shapes["enc_lens"]
    h, d = 8, 16
    rng = np.random.RandomState(SEED + 8)
    run = launches[("head dim 16 train", torch.float32)]
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        row = attention_fwd_row(b, h, d, t, t, False, lens, dtype, rng, errs, DROPOUT)
        q, k, v = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
                   for _ in range(3))
        kv = torch.from_numpy(lens.astype(np.int32)).cuda()
        qp, kp, vp = (pad_head_dim(z, 32) for z in (q, k, v))
        scale = 1.0 / np.sqrt(d)
        fwd_32 = device_ms(lambda: flash_attention(qp, kp, vp, kv_lengths=kv, sm_scale=scale,
                                                   dropout_rate=DROPOUT,
                                                   dropout_seed=DROPOUT_SEED))
        rows.append({"name": f"flash_attention_fwd_dropout_d16[{name}]", **row,
                     "launches": run["flash_attention_fwd"],
                     "launches_are": "the head-dim-16 test config's two steps and dev pass "
                                     "(its dropout is 0)",
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype], "at_32_ms": fwd_32})
        at = attention_bwd_times(b, h, d, t, t, False, lens, dtype, rng)
        args = at["kernel_args"]
        q, k, v, out, lse, dout = (pad_head_dim(z, 32) if z.dim() == 4 else z
                                   for z in args[:6])
        bwd_32 = device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, kv, False,
                                                       scale, DROPOUT, DROPOUT_SEED))
        err = tuple(max(a, c) for a, c in zip(errs[("flash_attention_bwd_dkv", dtype)],
                                               errs[("flash_attention_bwd_dq", dtype)]))
        rows.append({
            "name": f"flash_attention_bwd_d16[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"],
            "launches": run["flash_attention_bwd_dkv"],
            "launches_are": "dK/dV launches of the head-dim-16 test config's two steps",
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "at_32_ms": bwd_32,
        })
    return rows


def attention_fwd_row(b, h, d, tq, tk, causal, lens, dtype, rng, errs, rate,
                      chunk_mask=None) -> dict:
    """The forward kernel at one shape, with dropout `rate` (0, or 0.1 as
    the training path runs it): held to its plain version with the same
    seed, then device ms of the kernel, the plain version and SDPA's
    forward (dropout_p `rate`), and the bound."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    es = torch.tensor([], dtype=dtype).element_size()
    q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.randn(b, tk, h, d).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    kv = None if lens is None else torch.from_numpy(lens.astype(np.int32)).cuda()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    sdpa = sdpa_masks(tq, tk, kv, causal, chunk_mask)
    seed = DROPOUT_SEED if rate else None

    def kernel():
        return flash_attention(q, k, v, kv_lengths=kv, causal=causal, dropout_rate=rate,
                               dropout_seed=seed, chunk_mask=chunk_mask)

    def plain():
        return flash_attention_reference(q, k, v, kv, causal, None, rate, seed or 0,
                                         chunk_mask)

    held_to_plain(
        f"flash dropout={rate} {DTYPE_NAME[dtype]} [{b}, {tq}, {tk}, {h}, {d}] "
        f"causal={causal} chunk_mask={chunk_mask}", kernel, plain, TOL_FLASH[dtype], errs,
        ("flash_attention_fwd_dropout" if rate else "flash_attention_fwd", dtype))
    key_lens = [tk] * b if lens is None else [min(int(n), tk) for n in lens]
    pairs = h * attention_pairs(tq, key_lens, causal, chunk_mask)
    # q read and O written over every query; K and V over the valid keys,
    # where the walk stops; lse written; lengths read.  S and P.V over the
    # valid pairs; the hash's integer operations are not counted
    nbytes = (2 * es * b * tq * h * d + 2 * es * sum(key_lens) * h * d + 4 * b * h * tq
              + (0 if kv is None else 4 * b))
    return {
        "route": "cuda",
        "source": "openasr_torch/kernels/csrc/flash_attention.cu",
        "replaces": "openasr_tpu/kernels/flash_attention.py:146"
                    + (" (hash dropout :78-134)" if rate else ""),
        "shape": [b, tq, tk, h, d],
        "causal": causal,
        "dropout_rate": rate,
        **times(kernel, plain,
                lambda: F.scaled_dot_product_attention(qt, kt, vt, dropout_p=rate, **sdpa)),
        "library_is": f"F.scaled_dot_product_attention (dropout_p {rate}"
                      + (", its own Philox mask" if rate else "")
                      + "; a bool key mask, or is_causal for the decoder)",
        "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
        **bound(nbytes, 2 * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
    }


# --------------------------------------------------------------- phase 7

GATE_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-recipe-gate.yaml")
COMMITTED_JAX_PKG = os.path.join(ROOT, "tests", "data", "jax_solver_conv_ctc_transformer_test.pkg")
GATE_EPOCHS = 2
GATE_REPEAT = 4
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "openasr_tpu")


def module_launches(module) -> dict:
    """Kernel launches of one forward of `module` (every LayerNorm, every
    attention, the fbank kernel for an fbank frontend), and of its
    training step, which adds each one's backward."""
    n_ln, n_attn = count_layer_norms(module), count_attention(module)
    splayer = getattr(module, "splayer", None)
    n_fbank = int(splayer is not None and splayer.feature_type == "fbank")
    return {"forward": {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_attn, "fbank": n_fbank},
            "step": {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                     "flash_attention_fwd_dropout": n_attn, "flash_attention_bwd_dkv": n_attn,
                     "flash_attention_bwd_dq": n_attn, "flash_bwd_stats": n_attn,
                     "fbank": n_fbank}}


def test_config(exp, train_json, dev_json, vocab, **training) -> str:
    """egs/aishell1/configs/conv-ctc-transformer-test.yaml with this run's
    data, exp dir, a log line a step and `training` changes."""
    import yaml

    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=train_json, devset=dev_json, vocab_path=vocab)
    cfg["training"].update(exp_dir=exp, print_inteval=1, **training)
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def read_metrics(exp) -> list:
    path = os.path.join(exp, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def phase_recipe_gate() -> dict:
    """egs/aishell1/run_recipe_gate_torch.sh's chain at a cut, in process:
    the jax-free generator's 256 waves (dev cut to 8, the train rows
    repeated GATE_REPEAT times), the train CLI with the gate YAML's model
    and training sections but GATE_EPOCHS epochs, the infer CLI (bf16,
    device CTC prefix beam of 4), the scorer.  Counters reset just before
    the train and the decode runs and read just after."""
    import io

    import yaml

    from openasr_torch.bin import gen_mini_corpus, infer, train, wer
    from openasr_torch.config import Config
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models.speech import ConvCTCModule

    data = os.path.join(WORK, "gate")
    with contextlib.redirect_stdout(io.StringIO()):
        gen_mini_corpus.main(["--out", data, "--wave", "--num_utts", "256"])
    with open(os.path.join(data, "dev_wav.json")) as f:
        dev = json.load(f)[:8]
    with open(os.path.join(data, "dev_wav.json"), "w") as f:
        json.dump(dev, f)
    with open(os.path.join(data, "train_wav.json")) as f:
        rows = json.load(f)
    with open(os.path.join(data, "train_wav.json"), "w") as f:
        json.dump([dict(r, uttid=f"{r['uttid']}_r{rep}") for rep in range(GATE_REPEAT)
                   for r in rows], f)
    with open(GATE_YAML) as f:
        cfg = yaml.safe_load(f)
    exp = os.path.join(WORK, "exp_gate")
    cfg["data"].update(trainset=os.path.join(data, "train_wav.json"),
                       devset=os.path.join(data, "dev_wav.json"),
                       vocab_path=os.path.join(data, "train_chars.txt"))
    cfg["training"].update(exp_dir=exp, num_epoch=GATE_EPOCHS)
    os.makedirs(exp)
    path = os.path.join(exp, "gate.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    vocab = os.path.join(data, "train_chars.txt")
    model_cfg = dict(cfg["model"],
                     decoder={"vocab_size": CharTokenizer(vocab, add_blk=True).unit_num()})
    with torch.device("meta"):
        per = module_launches(ConvCTCModule(Config(model_cfg)))

    reset_counters()
    t0 = time.time()
    train.main([path, "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    n = read_counters()
    rows = read_metrics(exp)
    epochs = [r for r in rows if r["phase"] == "epoch"]
    steps = epochs[-1]["step"]
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    # the dev forwards (dev batches and the CTC solver's sample decode) are
    # what the forward-only launches leave after the steps'
    dev_fwd = n["fbank"] - per["step"]["fbank"] * steps
    want = {k: 0 for k in n}
    for k, c in per["step"].items():
        want[k] += c * steps
    for k, c in per["forward"].items():
        want[k] += c * dev_fwd
    print(f"[recipe gate] train: {steps} steps in {GATE_EPOCHS} epochs, {dev_fwd} dev forwards, "
          f"{train_s:.2f}s wall (s an epoch {[round(r['minutes'] * 60, 2) for r in epochs]}); "
          f"tr {[round(r['tr_loss'], 4) for r in epochs]}, cv "
          f"{[round(r['cv_loss'], 4) for r in epochs]}; launches {n}; a step {per['step']}")
    require(len(epochs) == GATE_EPOCHS and steps > 0 and dev_fwd > 0,
            f"{len(epochs)} epochs, {steps} steps, {dev_fwd} dev forwards")
    require(all(np.isfinite(v) for v in losses), "non-finite loss logged")
    require(n == want, f"gate launches {n} != {want}")
    require(min(n[k] for k in per["step"]) > 0, "a kernel of the gate's path never launched")

    beam_calls = [0]
    device_beam = infer.ctc_prefix_beam_device

    def counted(*args, **kwargs):
        beam_calls[0] += 1
        return device_beam(*args, **kwargs)

    hyp = os.path.join(exp, "hyp.txt")
    infer.ctc_prefix_beam_device = counted
    try:
        reset_counters()
        t0 = time.time()
        infer.main(["--model_type", "conv-ctc", "--model_pkg", os.path.join(exp, "last.pkg"),
                    "--vocab_path", vocab,
                    "--json_file", os.path.join(data, "test_wav.json"), "--output", hyp,
                    "--batch_frames", "1000000", "--ctc_beam", "4", "--ctc_beam_device",
                    "--add_blk", "--split_token", "--dtype", "bfloat16", "--device", "cuda"])
        torch.cuda.synchronize()
        decode_s = time.time() - t0
        dn = read_counters()
    finally:
        infer.ctc_prefix_beam_device = device_beam
    with open(os.path.join(data, "test_wav.json")) as f:
        n_test = len(json.load(f))
    with open(hyp) as f:
        hyps = [line for line in f if line.strip()]
    score = io.StringIO()
    with contextlib.redirect_stdout(score):
        wer.main(["--cer", "--hyp", hyp, "--ref", os.path.join(data, "test_text.txt")])
    cer = float(score.getvalue().split()[1])
    print(f"[recipe gate] decode: {len(hyps)} hyps for {n_test} test rows in {decode_s:.2f}s "
          f"wall, {beam_calls[0]} device-beam batch(es); launches {dn}; "
          f"{score.getvalue().strip()}")
    require(len(hyps) == n_test, f"{len(hyps)} hyp lines for {n_test} test rows")
    require(beam_calls[0] > 0, "the device beam never ran")
    require(min(dn[k] for k in per["forward"]) > 0, "a kernel of the gate's decode never launched")
    return {"cer": cer, "steps": steps, "per_step": per["step"], "train_s": train_s,
            "decode_s": decode_s}


def saturated_qk(b, t, h, d, lens, gen, last_step):
    """(q, k) [B, T, H, D] f32 with every softmax row one-hot: each query
    near one valid key, both scaled by 300 (scores of about 5e5, leading
    the others by about 1e5).  Query t matches key t mod length, or, with
    `last_step`, a key in its row's last 32-key step of the kernels' walk,
    so the row's max arrives after the earlier steps' running max."""
    k = torch.randn(b, t, h, d, generator=gen) * 300.0
    n = lens[:, None].long()
    pos = torch.arange(t)[None, :]
    first = (n - 1) // 32 * 32 if last_step else torch.zeros_like(n)
    match = first + pos % (n - first)
    return k[torch.arange(b)[:, None], match] + torch.randn(b, t, h, d, generator=gen), k


def check_saturated_attention():
    """The attention backward where every softmax row is one-hot (as the
    recipe gate's layer 0 reaches 4e4 at its initialization), at the gate's
    layer-0 shape and at Tk 139 with each row's max in its last key step
    (step 5 of 5, or 4 of 4): the true dQ and dK are 0.  The statistics
    pass gives 1 / l = 1 exactly on every such row (the max's exp2(0) = 1,
    the rest vanishing beside it, also after a rescale from an earlier
    step's max), and dK/dV and dQ take P and delta from the same products,
    so their dQ and dK are exactly 0.  dV against the plain version to the
    backward tolerance."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        flash_bwd_stats,
    )

    g = torch.Generator().manual_seed(SEED)
    cases = [  # b, t, h, d, lengths, the max in the last key step
        (26, 17, 4, 32, [17, 15, 13] * 8 + [17, 9], False),
        (8, 139, 8, 64, [139, 128, 100, 97, 139, 65, 120, 139], True),
    ]
    for b, t, h, d, lengths, last_step in cases:
        lens = torch.tensor(lengths, dtype=torch.int32)
        q, k = saturated_qk(b, t, h, d, lens, g, last_step)
        v, dout = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
        where = f"B{b} T{t} D{d}" + (", the max in the last key step" if last_step else "")
        for dtype in DTYPES:
            for rate in (0.0, DROPOUT):
                grads = {}
                for name, fn in (("kernel", flash_attention), ("plain", flash_attention_reference)):
                    leaves = [x.to("cuda", dtype).clone().requires_grad_() for x in (q, k, v)]
                    out, _ = fn(*leaves, kv_lengths=lens.cuda(), dropout_rate=rate,
                                dropout_seed=DROPOUT_SEED)
                    (out.float() * dout.cuda()).sum().backward()
                    grads[name] = [x.grad.float() for x in leaves]
                inv_l = flash_bwd_stats(*(x.to("cuda", dtype) for x in (q, k, v, dout)),
                                        lens.cuda(), False, None, rate, DROPOUT_SEED)[1]
                kq, kk, kv = grads["kernel"]
                pq, pk, pv = grads["plain"]
                dv_err = max_err(kv, pv) / max(1.0, float(pv.abs().max()))
                print(f"[saturated softmax] {where}, {DTYPE_NAME[dtype]}, dropout {rate}: max "
                      f"|dQ|, |dK| kernel {float(kq.abs().max()):.3e}, "
                      f"{float(kk.abs().max()):.3e} (plain {float(pq.abs().max()):.3e}, "
                      f"{float(pk.abs().max()):.3e}; true 0); 1 / l in "
                      f"[{float(inv_l.min()):.9g}, {float(inv_l.max()):.9g}]; dV kernel vs "
                      f"plain {dv_err:.3e} of max(1, |dV|) (tol {TOL_FLASH_BWD[dtype]})")
                require(float(pq.abs().max()) == 0.0 and float(pk.abs().max()) == 0.0,
                        "the plain backward left a residue in a saturated softmax")
                require(bool((inv_l == 1.0).all()),
                        f"1 / l is not exactly 1 on a one-hot row ({where}, "
                        f"{DTYPE_NAME[dtype]}, dropout {rate})")
                require(float(kq.abs().max()) == 0.0 and float(kk.abs().max()) == 0.0,
                        f"the kernels left a residue in a saturated softmax ({where}, "
                        f"{DTYPE_NAME[dtype]}, dropout {rate})")
                require(dv_err <= TOL_FLASH_BWD[dtype], f"dV off by {dv_err:.3g}")


def small_corpus(name, rng, chars, n_utts=16):
    """`n_utts` random 20-dim utterances for the test configs."""
    manifest, feats = write_corpus(name, rng, chars, n_utts, (80, 96), (4, 8), dim=20)
    return manifest, feats


def phase_stock_optimizers(vocab, chars, rng):
    """3 steps of the test config with `optimtype: sgd` and with
    `fused_adam: false` (apply_if_finite over clip + sgd / adam) from one
    package, on the card and on the CPU in lockstep (TF32 off, the config
    has no dropout): each step's gradients within 1e-3 of their largest
    magnitude, the gradient check's tolerance, the optimizer counts equal
    and every parameter finite.  The parameters' largest difference is
    reported against the largest step: Adam moves an element by about lr
    whatever its gradient, so where a gradient is near 0 (the label
    smoothing's target for an unseen token) the two devices' roundings move
    it apart."""
    import yaml

    from openasr_torch.bin.train import build_loaders
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models import get_model_class
    from openasr_torch.solvers import batch_to_device, get_solver_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest, _ = small_corpus("stock", rng, chars)
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=manifest, devset=manifest, vocab_path=vocab)
    model_cfg = cfg["model"]
    tok = CharTokenizer(vocab, add_blk=True)
    model_cfg["decoder"]["vocab_size"] = tok.unit_num()
    loader, _ = build_loaders(cfg["data"], cfg["training"], model_cfg, tok)
    batches = list(loader)[:3]
    require(len(batches) == 3, f"{len(batches)} batches")
    pkg = get_model_class(model_cfg["type"]).create_model(
        model_cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)).package()
    for name, change in (("sgd", {"optimtype": "sgd"}), ("adam", {"fused_adam": False})):
        solvers, start = {}, {}
        for device in ("cuda", "cpu"):
            model = get_model_class(model_cfg["type"]).create_model(model_cfg, device=device)
            model.restore(pkg)
            training = dict(cfg["training"], exp_dir=os.path.join(WORK, f"exp_stock_{name}"),
                            **change)
            solvers[device] = get_solver_class(model_cfg["type"])(model, training, None, None,
                                                                 device=device)
            start[device] = {k: p.detach().cpu().clone()
                             for k, p in model.module.named_parameters()}
        worst, worst_name = 0.0, None
        for batch in batches:
            grads = {}
            for device, solver in solvers.items():
                empty = solver.model.has_empty_rows(solver.model.batch_inputs(batch)[1])
                solver.grad_step(batch_to_device(batch, torch.device(device)), empty)
                grads[device] = {k: p.grad.detach().cpu() for k, p in solver.params.items()}
                solver.apply_update()
            for k, want in grads["cpu"].items():
                # a k-projection bias has an analytically zero gradient:
                # measured against its weight's
                ref = grads["cpu"][k[: -len("bias")] + "weight"] if k.endswith(".k.bias") else want
                rel = max_err(grads["cuda"][k], want) / max(float(ref.abs().max()), 1e-30)
                if not rel <= worst:
                    worst, worst_name = rel, k
        params = {d: {k: p.detach().cpu() for k, p in s.params.items()}
                  for d, s in solvers.items()}
        step = max(float((params["cpu"][k] - start["cpu"][k]).abs().max()) for k in params["cpu"])
        drift = max(max_err(params["cuda"][k], params["cpu"][k]) for k in params["cpu"])
        counts = {d: int(s.optimizer.count) for d, s in solvers.items()}
        finite = all(torch.isfinite(p).all() for p in params["cuda"].values())
        print(f"[stock optimizers] {name}: 3 steps, card vs CPU, {len(params['cpu'])} "
              f"parameters: worst gradient err {worst:.3g} of its largest magnitude "
              f"({worst_name}; tol 1e-3); parameters apart by at most {drift:.3g}, "
              f"the largest step {step:.3g}; counts {counts}")
        require(worst <= 1e-3, f"{name}: the gradient of {worst_name} disagrees, {worst:.3g}")
        require(counts == {"cuda": 3, "cpu": 3} and finite, f"{name}: counts {counts}, "
                f"finite {finite}")


def phase_preemption(vocab, chars, rng):
    """SIGTERM to a training subprocess on the card at its second step:
    it saves last.pkg and exits 0; `--continue-training` then restarts the
    interrupted epoch and ends at the last epoch, with the steps of the
    interrupted part-epoch on top of the whole epochs'."""
    import signal

    from openasr_torch.bin import train
    from openasr_torch.utils.checkpoint import load_package

    manifest, _ = small_corpus("preempt", rng, chars)
    exp = os.path.join(WORK, "exp_preempt")
    epochs = 8
    cfg = test_config(exp, manifest, manifest, vocab, num_epoch=epochs)
    proc = subprocess.Popen([sys.executable, "-m", "openasr_torch.bin.train", cfg,
                             "--device", "cuda"], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while not any(r["phase"] == "train" and r["step"] >= 2 for r in read_metrics(exp)):
            require(proc.poll() is None and time.time() < deadline,
                    "the training subprocess ended before its second step")
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    require(proc.returncode == 0 and "preemption: saved last.pkg" in out,
            f"rc {proc.returncode}: {out[-2000:]}")
    saved = load_package(os.path.join(exp, "last.pkg"))["solver_state"]
    require(saved["epoch"] < epochs - 1, f"stopped at epoch {saved['epoch']} of {epochs}")
    before = len(read_metrics(exp))
    train.main([cfg, "--continue-training", "--device", "cuda"])
    resumed = read_metrics(exp)[before:]
    first = [r for r in resumed if r["phase"] == "train"][0]
    ends = [r for r in resumed if r["phase"] == "epoch"]
    per_epoch = ends[1]["step"] - ends[0]["step"]
    part = saved["step"] - saved["epoch"] * per_epoch
    print(f"[preemption] SIGTERM at epoch {saved['epoch'] + 1}: last.pkg at epoch "
          f"{saved['epoch']}, step {saved['step']}; resumed at epoch {first['epoch']} "
          f"batch {first['batch']} step {first['step']}, ended at epoch {ends[-1]['epoch']} "
          f"step {ends[-1]['step']} ({per_epoch} steps an epoch, {part} of the interrupted "
          f"epoch's before the stop)")
    require(first["epoch"] == saved["epoch"] + 1 and first["batch"] == 1
            and first["step"] == saved["step"] + 1, f"resumed at {first}")
    require(ends[-1]["epoch"] == epochs and ends[-1]["step"] == epochs * per_epoch + part
            and 0 <= part <= per_epoch, f"ended at {ends[-1]}")


# the port's kernels by the names their device-lane spans hold
PORT_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "column_sum", "flash_attention_fwd",
                "flash_attention_bwd_stats", "flash_attention_bwd_dkv",
                "flash_attention_bwd_dq", "fbank")


def profile_trace(logdir) -> str:
    traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    require(len(traces) == 1, f"profile traces {traces}")
    return os.path.join(logdir, traces[0])


def port_kernels(names: dict) -> list:
    """(name, calls, device us) of each port kernel in utils/trace.py's
    `by_name` reading of a lane."""
    found = {}
    for name, r in names.items():
        for n in PORT_KERNELS:
            if n in name:
                calls, us = found.get(n, (0, 0.0))
                found[n] = (calls + r["calls"], us + r["us"])
    return [(n, c, us) for n, (c, us) in sorted(found.items())]


def profile_report(logdir) -> list:
    """The port's kernels with device time in a Chrome trace of the
    profiler window: (name, calls, device us), read by utils/trace.py."""
    from openasr_torch.utils import trace

    events = trace.read_trace(profile_trace(logdir))
    return port_kernels(trace.by_name(trace.device_lane(events, "cuda")))


def phase_jax_package():
    """The committed package that the JAX solver wrote (test config, fused
    clip + Adam, 1 epoch of 4 steps), read on this machine, which has no
    jax, and continued one step on the card."""
    import io
    import shutil as sh

    from openasr_torch.bin import gen_mini_corpus, train
    from openasr_torch.utils.checkpoint import load_package

    data = os.path.join(WORK, "jaxpkg")
    with contextlib.redirect_stdout(io.StringIO()):
        gen_mini_corpus.main(["--out", data])
    with open(os.path.join(data, "train.json")) as f:
        rows = json.load(f)[:2]
    one = os.path.join(data, "one_batch.json")
    with open(one, "w") as f:
        json.dump(rows, f)
    exp = os.path.join(WORK, "exp_jaxpkg")
    cfg = test_config(exp, one, one, os.path.join(data, "chars.txt"), num_epoch=2)
    sh.copy(COMMITTED_JAX_PKG, os.path.join(exp, "last.pkg"))
    before = load_package(os.path.join(exp, "last.pkg"))
    train.main([cfg, "--continue-training", "--device", "cuda"])
    after = load_package(os.path.join(exp, "last.pkg"))
    rows = [r for r in read_metrics(exp) if r["phase"] == "train"]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)
    print(f"[jax package] {os.path.relpath(COMMITTED_JAX_PKG, ROOT)}: "
          f"{type(before['optim_state']).__name__} at step {before['solver_state']['step']} -> "
          f"{len(rows)} step(s) on the card, ctc {[round(r['ctc_loss'], 4) for r in rows]}, "
          f"now step {after['solver_state']['step']}, optimizer count "
          f"{after['optim_state']['count']}; jax modules loaded: {loaded}")
    require(type(before["optim_state"]).__name__ == "FusedClipAdamState",
            "the committed package holds no FusedClipAdamState")
    require(len(rows) == 1 and after["optim_state"]["count"] == after["solver_state"]["step"]
            == before["solver_state"]["step"] + 1, "the package did not continue one step")
    require(all(np.isfinite(r["ctc_loss"]) for r in rows), "non-finite loss")
    require(loaded == [], f"jax modules were imported: {loaded}")

# --------------------------------------------------------------- CIF path

CIF_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "cif.yaml")
CIF_FC_YAML = os.path.join(ROOT, "egs", "callhome_hkust", "configs", "cif_fc_test.yaml")
CIF_MIX_YAML = os.path.join(ROOT, "egs", "callhome_hkust", "configs", "cif_mix_test.yaml")
CIF_BEAM = 5
CIF_MAXLEN = 100
# a fire that moves between the card and the CPU is a fault unless the
# running sum lies this close to n + threshold (a rounding tie)
CIF_FIRE_TIE = 1e-4
# a ReLU input on the other side of 0 on the card and the CPU is a fault
# unless it lies this close to 0 on both, relative to its call's largest
# |x|, and there are at most a handful of them
CIF_RELU_TIE = 1e-5
CIF_RELU_MAX_FLIPS = 16


def write_text(name, lines) -> str:
    path = os.path.join(WORK, name)
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(line + "\n" for line in lines))
    return path


def cif_config(yaml_path, exp, data, model_type=None, **training) -> str:
    """A CIF-family YAML with its model and training sections unchanged but
    for this run's data, one epoch, a log line a step and `training`
    changes (and the model type, for ctc_cif on cif.yaml's sections)."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(data)
    cfg["training"].update(exp_dir=exp, num_epoch=1, print_inteval=1, **training)
    if model_type is not None:
        cfg["model"]["type"] = model_type
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def cif_module_launches(module, decode_steps=0) -> dict:
    """Launches of one training step and one dev batch of a CIF-family
    module (`module_launches`; CIF_MIX's step is an acoustic batch, which
    skips the char decoder, and a paired batch), and of one decode batch:
    the encoder once and the CIF decoder's full forward `decode_steps`
    times; and the attention modules of the encoder and the CIF decoder,
    each one attention call a forward."""
    from openasr_torch.models.layers import LayerNorm, MultiHeadAttention

    def count(m):
        if m is None:
            return 0, 0
        return (sum(isinstance(x, LayerNorm) for x in m.modules()),
                sum(isinstance(x, MultiHeadAttention) for x in m.modules()))

    per = module_launches(module)
    if module.char_decoder is not None:
        n_ln, n_attn = count(module.char_decoder)
        for k, c in (("layer_norm_fwd", n_ln), ("layer_norm_bwd", n_ln),
                     ("flash_attention_fwd_dropout", n_attn), ("flash_attention_bwd_dkv", n_attn),
                     ("flash_attention_bwd_dq", n_attn), ("flash_bwd_stats", n_attn)):
            per["step"][k] = 2 * per["step"][k] - c
    (enc_ln, enc_attn), (dec_ln, dec_attn) = count(module.encoder), count(module.decoder)
    per["decode"] = {"layer_norm_fwd": enc_ln + decode_steps * dec_ln,
                     "flash_attention_fwd": enc_attn + decode_steps * dec_attn}
    per["attention_calls"] = {"encoder": enc_attn, "cif_decoder": dec_attn}
    return per


def cif_train_run(tag, cfg_path, model_cfg, launches, min_steps) -> dict:
    """One train CLI run on the card between counter reads: finite losses,
    at least `min_steps` steps and a dev batch, and exactly the launches
    of its steps and dev batches."""
    from openasr_torch.bin import train
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class

    with torch.device("meta"):
        module = get_model_class(model_cfg["type"]).build_module(Config(model_cfg))
    per = cif_module_launches(module)
    exp = os.path.dirname(cfg_path)
    reset_counters()
    t0 = time.time()
    train.main([cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    rows = read_metrics(exp)
    tr = [r for r in rows if r["phase"] == "train"]
    cv = [r for r in rows if r["phase"] == "cv"]
    losses = {k: [round(r[k], 4) for r in tr] for k in tr[-1] if k.endswith("loss")} if tr else {}
    print(f"[cif path] {tag}: {len(tr)} steps + {len(cv)} dev batch(es) in {wall:.2f}s wall; "
          f"losses {losses}; launches {n}")
    require(len(tr) >= min_steps and len(cv) >= 1, f"{tag}: {len(tr)} steps, {len(cv)} dev")
    require(all(np.isfinite(v) for r in rows for k, v in r.items() if k.endswith("loss")),
            f"{tag}: a non-finite loss")
    want = {k: 0 for k in n}
    for k, c in per["step"].items():
        want[k] += c * len(tr)
    for k, c in per["forward"].items():
        want[k] += c * len(cv)
    # the dropout forward runs where the config has attention dropout
    if not module.encoder.layers[0].self_attn.dropout_rate:
        want["flash_attention_fwd"] += want.pop("flash_attention_fwd_dropout")
        want["flash_attention_fwd_dropout"] = 0
    require(n == want, f"{tag}: launches {n} != {want}")
    for k in ("layer_norm_fwd", "layer_norm_bwd", "flash_bwd_stats",
              "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        require(n[k] > 0, f"{tag}: {k} never launched")
    require(n["flash_attention_fwd"] + n["flash_attention_fwd_dropout"] > 0,
            f"{tag}: the flash forward never launched")
    launches[("cif train", tag)] = {"total": n, "steps": len(tr), "dev_batches": len(cv),
                                     "per_step": per["step"],
                                     "attention_calls": per["attention_calls"]}
    return {"steps": len(tr), "wall": wall, "exp": exp}


class ReluMasks:
    """The ReLUs of the ConvV2 subsampler, the CIF assigner, WavConv and the
    relu FFNs of models/layers.py (their modules' `F.relu`), recording
    each call's input on one forward and replaying the recorded inputs'
    masks `x > 0`, in call order, on another.  A ReLU's gradient jumps at 0: a pre-activation within
    rounding of 0 may fall on one side on the card and on the other on
    the CPU, and with the assigner's ReLUs on top of the encoder such a
    flip reaches every encoder layer's gradient.  Replaying the card's
    masks on the CPU compares the two gradients at the same ReLU
    decisions.  The replay counts the flips (entries whose sign differs)
    and keeps, per call with flips, the largest |x| at them on either
    device over that call's largest |x|, and the call's largest
    card-vs-CPU difference over the same: a flip is a rounding tie only
    where that first ratio is small."""

    def __init__(self):
        import types

        import torch.nn.functional as F

        self.inputs, self.replay, self.flips, self.flipped = [], False, 0, []
        self.functional = types.SimpleNamespace(
            **{k: getattr(F, k) for k in dir(F) if not k.startswith("__")})
        self.functional.relu = self.relu

    def relu(self, x):
        if not self.replay:
            self.inputs.append(x.detach().clone())
            return torch.relu(x)
        card = self.inputs[self.calls].to(x.device)
        self.calls += 1
        mask = card > 0
        flip = mask != (x > 0)
        n = int(flip.sum())
        if n:
            xd = x.detach()
            scale = max(float(card.abs().max()), float(xd.abs().max()))
            at_flips = float(torch.maximum(card.abs(), xd.abs())[flip].max())
            self.flips += n
            self.flipped.append({"call": self.calls - 1, "flips": n,
                                 "flip_abs_rel": at_flips / scale,
                                 "diff_rel": float((card - xd).abs().max()) / scale})
        return torch.where(mask, x, torch.zeros_like(x))

    def installed(self, replay: bool):
        from openasr_torch.models import assigner, frontend, layers, subsample

        @contextlib.contextmanager
        def patch():
            saved = assigner.F, subsample.F, layers.F, frontend.F
            self.replay, self.calls = replay, 0
            assigner.F = subsample.F = layers.F = frontend.F = self.functional
            try:
                yield
            finally:
                assigner.F, subsample.F, layers.F, frontend.F = saved

        return patch()


def param_errs(got, want) -> dict:
    """{parameter: error of its gradient over its largest magnitude}; a
    k-projection bias, whose true gradient is 0, against its weight's."""
    out = {}
    for name, w in want.items():
        ref = want[name[: -len("bias")] + "weight"] if name.endswith(".k.bias") else w
        out[name] = max_err(got[name], w) / max(float(ref.abs().max()), 1e-30)
    return out


def grad_errs(got, want):
    """-> (worst error of a parameter's gradient over its largest
    magnitude, the parameter), as `param_errs` measures them."""
    worst, worst_name = 0.0, None
    for name, rel in param_errs(got, want).items():
        if not rel <= worst:
            worst, worst_name = rel, name
    return worst, worst_name


def check_cif_against_cpu(pkg_path, feats) -> dict:
    """The f32 CIF model (cif.yaml at full width) on the card against the
    CPU, TF32 off, on two utterances: the teacher-forced logits of the
    deterministic forward (1e-3), the fire counts (equal, unless a running
    sum lies within CIF_FIRE_TIE of n + 0.95), the fire margin, and one
    step's gradients of the solver's mixed loss (1e-3 of each parameter's
    largest gradient; the k-projection biases against their weights'), the
    CPU's taken at the card's ReLU decisions (`ReluMasks`; the error at
    the CPU's own decisions is printed beside it).  The flips must be
    rounding ties: at most CIF_RELU_MAX_FLIPS, each within CIF_RELU_TIE of
    0 relative to its call's largest |x|."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.models.speech import target_lengths_of
    from openasr_torch.ops.cif import fire_counts, fire_margin, scale_alphas
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg_path)
    pkg = pkg.get("model", pkg)
    cfg = Config(pkg["configs"])
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED + 11))
    relus = ReluMasks()
    outs, grads = {}, {}
    # the card recording its ReLU masks, the CPU as it is, the CPU replaying them
    for device, replay in (("cuda", False), ("cpu", None), ("cpu", True)):
        model = get_model_class("CIF").create_model(cfg, device=device)
        model.restore(pkg)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        m = model.module
        if replay is not True:
            with torch.no_grad():
                tlen = target_lengths_of(tb["paddings"])
                enc, elens = m.encode(tb["feats"], tb["feat_lengths"])
                alphas, _ = scale_alphas(m.assigner(enc, elens), tlen)
                logits = m(tb["feats"], tb["feat_lengths"], tlen, tb["ids"])["logits"]
            outs[device] = (logits.cpu(), fire_counts(alphas)[1].cpu(), alphas.cpu(),
                            elens.cpu())
        with relus.installed(replay) if replay is not None else contextlib.nullcontext():
            losses = model.loss(tb, None, label_smooth=0.1, empty_rows=False)
            total = losses["ce_loss"] / losses["n_tokens"] + losses["qua_loss"] / losses["n_seqs"]
        total.backward()
        grads[device if replay is not True else "cpu at the card's ReLUs"] = {
            n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        print(f"[cif check] {device}{' at the card ReLUs' if replay else ''}: loss "
              f"{float(total.detach()):.6f}")
    (lg, fg, _, _), (lc, fc, ac, ec) = outs["cuda"], outs["cpu"]
    margin = fire_margin(ac, ec)
    moved = int((fg != fc).sum())
    e_logits = max_err(lg, lc)
    print(f"[cif check] f32 card vs CPU, 2 utts: CIF decoder logits err {e_logits:.3g} "
          f"(tol 1e-3); fire counts differ at {moved} frame(s); fire margin "
          f"min |S_t - 0.95 - n| = {margin:.3g} (a difference is a fault above "
          f"{CIF_FIRE_TIE})")
    require(bool(torch.isfinite(lg).all()), "non-finite CIF logits on the card")
    require(moved == 0 or margin <= CIF_FIRE_TIE,
            f"a fire moved between card and CPU with margin {margin:.3g}")
    require(e_logits <= 1e-3, "CIF logits: card and CPU disagree")
    own, own_name = grad_errs(grads["cuda"], grads["cpu"])
    worst, worst_name = grad_errs(grads["cuda"], grads["cpu at the card's ReLUs"])
    n_relu = sum(int(x.numel()) for x in relus.inputs)
    flip_abs = max((f["flip_abs_rel"] for f in relus.flipped), default=0.0)
    print(f"[cif check] f32 card vs CPU, one step's gradients, {len(grads['cpu'])} "
          f"parameters, the CPU at the card's ReLU decisions: worst err {worst:.3g} of the "
          f"gradient's max abs ({worst_name}; tol 1e-3); at the CPU's own decisions "
          f"{own:.3g} ({own_name}), {relus.flips} of {n_relu} ReLU inputs on the other side "
          f"of 0 (at most {CIF_RELU_MAX_FLIPS}); the largest |x| at a flip {flip_abs:.3g} of "
          f"its call's largest |x| (tol {CIF_RELU_TIE}); by call of the "
          f"{len(relus.inputs)}: {relus.flipped}")
    require(relus.flips <= CIF_RELU_MAX_FLIPS,
            f"{relus.flips} ReLU inputs on the other side of 0 between card and CPU")
    require(flip_abs <= CIF_RELU_TIE,
            f"a ReLU input flipped between card and CPU at {flip_abs:.3g} of its call's "
            f"largest |x|: not a rounding tie")
    require(worst <= 1e-3, f"CIF gradient of {worst_name} disagrees: {worst:.3g}")
    return {"logits_err": e_logits, "grad_err": worst, "grad_err_own_relus": own,
            "relu_flips": relus.flips, "relu_flip_abs": flip_abs, "fire_margin": margin,
            "fires_moved": moved}


def cif_decode_ms(pkg_path, feats, dtype) -> dict:
    """Warm wall ms of one CIF beam decode of the test batch (beam
    CIF_BEAM, CIF_MAXLEN steps), after a first call; and the batch's CIF
    lengths."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(pkg_path)
    pkg = pkg.get("model", pkg)
    model = get_model_class("CIF").create_model(Config(pkg["configs"]), device="cuda",
                                                dtype=dtype)
    model.restore(pkg)
    x, lengths = padded_features(feats, sorted(feats))
    xt, lt = torch.from_numpy(x).cuda(), torch.from_numpy(lengths).cuda()
    model.batch_beam_decode(xt, lt, CIF_BEAM, CIF_MAXLEN, empty_rows=False)
    torch.cuda.synchronize()
    t0 = time.time()
    _, lens, scores = model.batch_beam_decode(xt, lt, CIF_BEAM, CIF_MAXLEN, empty_rows=False)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    require(bool(torch.isfinite(scores).all()), "non-finite CIF beam scores")
    return {"ms": ms, "cif_lens": lens[:, 0].cpu().numpy(), "b": len(lengths)}


def phase_cif(rng, launches) -> dict:
    """The CIF family through the CLIs on the card (see the module
    docstring); counters reset just before each run and read just after."""
    from openasr_torch.bin import infer
    from openasr_torch.data.tokenizer import CharTokenizer

    # cif.yaml has no blank: 4230 characters + 3 specials is the smoke
    # test's vocabulary of 4233
    chars = [chr(0x4E00 + i) for i in range(4230)]
    vocab = write_text("cif_chars.txt", chars)
    phones = [f"ph{i}" for i in range(40)]
    phone_vocab = write_text("cif_phones.txt", phones)
    n_vocab = CharTokenizer(vocab).unit_num()
    train_json, _ = write_corpus("ciftrain", rng, chars, 120, (600, 700), (20, 30), phones=phones)
    with open(train_json, encoding="utf-8") as f:
        rows = json.load(f)
    two_json = os.path.join(WORK, "ciftrain2.json")
    with open(two_json, "w", encoding="utf-8") as f:
        json.dump(rows[:80], f, ensure_ascii=False)
    dev_json, _ = write_corpus("cifdev", rng, chars, 8, (600, 700), (20, 30), phones=phones)
    test_json, test_feats = write_corpus("ciftest", rng, chars, 8, (600, 1200), (12, 12))
    small_json, _ = write_corpus("cifsmall", rng, chars, 6, (90, 110), (4, 8), dim=20,
                                 phones=phones)
    data = {"trainset": train_json, "devset": dev_json, "vocab_path": vocab}
    import yaml

    with open(CIF_YAML) as f:
        model_cfg = yaml.safe_load(f)["model"]
    model_cfg["decoder"]["vocab_size"] = n_vocab
    runs = {}
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        cfg = cif_config(CIF_YAML, os.path.join(WORK, f"exp_cif_{name}"), data,
                         compute_dtype=name)
        runs[name] = cif_train_run(f"CIF {name}", cfg, model_cfg, launches, 3)
    ctc_cfg = cif_config(CIF_YAML, os.path.join(WORK, "exp_ctc_cif"),
                         dict(data, trainset=two_json), model_type="ctc_cif")
    cif_train_run("ctc_cif float32", ctc_cfg, dict(model_cfg, type="ctc_cif"), launches, 2)
    for yaml_path, tag, extra in (
        (CIF_FC_YAML, "CIF_FC", {"vocab_path": phone_vocab}),
        (CIF_MIX_YAML, "CIF_MIX", {"vocab_path": vocab, "vocab_phone": phone_vocab,
                                   "acousticset": small_json}),
    ):
        with open(yaml_path) as f:
            small_cfg = yaml.safe_load(f)["model"]
        small_cfg["decoder"]["vocab_size"] = CharTokenizer(extra["vocab_path"]).unit_num()
        if tag == "CIF_MIX":
            small_cfg["phone_size"] = CharTokenizer(phone_vocab, add_blk=True).unit_num()
        cfg = cif_config(yaml_path, os.path.join(WORK, f"exp_{tag}"),
                         dict(extra, trainset=small_json, devset=small_json))
        cif_train_run(tag, cfg, small_cfg, launches, 2)

    pkg = os.path.join(runs["float32"]["exp"], "last.pkg")
    hot = write_text("cif_hot.txt", [" ".join(chars[i: i + 3]) for i in (10, 200, 3000)])
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class

    with torch.device("meta"):
        module = get_model_class("CIF").build_module(Config(model_cfg))
    module_per = cif_module_launches(module, CIF_MAXLEN)
    per = module_per["decode"]
    decodes = {}
    for dtype, context in ((torch.float32, False), (torch.float32, True),
                           (torch.bfloat16, False)):
        tag = f"{DTYPE_NAME[dtype]}{' hotwords' if context else ''}"
        hyp = os.path.join(WORK, f"hyp_cif_{tag.replace(' ', '_')}.txt")
        argv = ["--model_type", "CIF", "--model_pkg", pkg, "--vocab_path", vocab,
                "--json_file", test_json, "--output", hyp, "--offline",
                "--nbest", str(CIF_BEAM), "--maxlen", str(CIF_MAXLEN),
                "--batch_frames", "36000", "--dtype", DTYPE_NAME[dtype], "--device", "cuda"]
        if context:
            argv += ["--context_file", hot]
        reset_counters()
        t0 = time.time()
        infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[cif path] decode {tag}: {len(lines)} hyps in {wall:.2f}s wall (1 batch, "
              f"beam {CIF_BEAM}, {CIF_MAXLEN} steps); launches {n}")
        require(len(lines) == len(test_feats), f"{len(lines)} hyp lines for {len(test_feats)}")
        want = {k: 0 for k in n}
        want.update(per)
        require(n == want, f"CIF decode launches {n} != {want}")
        launches[("cif decode", tag)] = n
        decodes[tag] = wall
    timing = {DTYPE_NAME[dt]: cif_decode_ms(pkg, test_feats, dt) for dt in DTYPES}
    for name, r in timing.items():
        print(f"[time] CIF decode {name}: {r['ms']:.1f} ms a batch of {r['b']} utterances "
              f"(beam {CIF_BEAM}, {CIF_MAXLEN} steps, {r['ms'] / CIF_MAXLEN:.2f} ms a step), "
              f"warm; CIF lengths {r['cif_lens'].tolist()}")
    check = check_cif_against_cpu(pkg, test_feats)
    return {"train_json": train_json, "decode": timing, "check": check, "per_decode": per,
            "attention_calls": module_per["attention_calls"], "pkg": pkg, "vocab": vocab,
            "test_json": test_json, "test_feats": test_feats}


def cif_decoder_shape(train_json):
    """The CIF training path's largest batch: B, and the CIF decoder's
    Tq = Tk (the ids width) and kv lengths (the token counts)."""
    import yaml

    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import ArkDataset
    from openasr_torch.data.sampler import FrameBasedSampler

    with open(CIF_YAML) as f:
        budget = int(yaml.safe_load(f)["training"]["batch_frames"])
    ds = ArkDataset(train_json, feat_range=(1, 1000), label_range=(1, 50))
    best = None
    for batch in FrameBasedSampler(ds, budget).batches:
        toks = np.array([int(ds[i]["token_length"]) for i in batch])
        u = quantize(int(toks.max()) + 2)
        if best is None or len(batch) * u > best["b"] * best["u"]:
            best = {"b": len(batch), "u": u, "lens": toks}
    return best


def cif_rows(cif, errs, launches):
    """The attention kernels at the CIF decoder's causal shapes, each
    against SDPA on the same call: the training batch's forward with
    dropout 0.1 and whole backward (Tq = Tk = the ids width, kv lengths
    the token counts), and the decode step's forward (B x beam rows,
    Tq = Tk = CIF_MAXLEN, kv lengths the CIF lengths)."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    shape = cif_decoder_shape(cif["train_json"])
    b, u, lens = shape["b"], shape["u"], shape["lens"]
    h, d = 8, 64
    rng = np.random.RandomState(SEED + 12)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        tr = launches[("cif train", f"CIF {name}")]
        calls = tr["attention_calls"]
        for key in ("flash_attention_fwd_dropout", "flash_attention_bwd_dkv"):
            require(sum(calls.values()) * tr["steps"] == tr["total"][key],
                    f"{calls} attention calls a step by the built module, but "
                    f"{tr['total'][key]} {key} launches in {tr['steps']} steps")
        row = attention_fwd_row(b, h, d, u, u, True, lens, dtype, rng, errs, DROPOUT)
        rows.append({"name": f"flash_attention_fwd_dropout_cif_decoder[{name}]", **row,
                     "launches": tr["total"]["flash_attention_fwd_dropout"],
                     "launches_per_step": sum(calls.values()),
                     "launches_are": "dropout forward calls of the CIF training run "
                                     "(encoder and CIF decoder)",
                     "calls_per_step_at_this_shape": calls["cif_decoder"],
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype]})
        at = attention_bwd_times(b, h, d, u, u, True, lens, dtype, rng)
        args = at["kernel_args"][:6] + at["kernel_args"][7:]
        got, want = flash_attention_bwd(*args), flash_attention_bwd_reference(*args)
        err = (0.0, 0.0)
        for g, w in zip(got, want):
            e, scale = scaled_err(g, w)
            err = (max(err[0], e), max(err[1], e / scale))
        print(f"[cif rows] flash backward {name} [{b}, {u}, {u}, {h}, {d}] causal, "
              f"kv lengths: err {err[0]:.3g}, scaled {err[1]:.3g} (tol {TOL_FLASH_BWD[dtype]})")
        require(err[1] <= TOL_FLASH_BWD[dtype], "the backward disagrees at the CIF shape")
        rows.append({
            "name": f"flash_attention_bwd_cif_decoder[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"], "causal": True,
            "launches": tr["total"]["flash_attention_bwd_dkv"],
            "launches_per_step": sum(calls.values()),
            "launches_are": "backward calls of the CIF training run (encoder and CIF "
                            "decoder), each launching statistics, dK/dV and dQ once",
            "calls_per_step_at_this_shape": calls["cif_decoder"],
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, a bool causal "
                          "and key mask) forward + backward minus forward (graph replay)",
        })
        dec = launches[("cif decode", name)]
        cif_lens = np.repeat(np.maximum(cif["decode"][name]["cif_lens"], 0), CIF_BEAM)
        bb = len(cif_lens)
        row = attention_fwd_row(bb, h, d, CIF_MAXLEN, CIF_MAXLEN, True, cif_lens, dtype, rng,
                                errs, 0.0)
        rows.append({"name": f"flash_attention_fwd_cif_decode[{name}]", **row,
                     "launches": dec["flash_attention_fwd"],
                     "launches_are": "forward calls of the CIF decode batch "
                                     f"({cif['attention_calls']['encoder']} encoder, "
                                     f"{cif['attention_calls']['cif_decoder']} a step for "
                                     f"{CIF_MAXLEN} steps)",
                     "max_abs_err": errs[("flash_attention_fwd", dtype)],
                     "tol": TOL_FLASH[dtype]})
    return rows


# ----------------------------------------------------------------- LM path

# egs/ has no LM config: the Transformer LM is the JAX package's
# TransformerLMModel.create_model defaults (openasr_tpu/models/lm.py:254-274:
# 8 heads, FFN 4 x d_model, relu, dropout 0.1) at the flagship's d_model
# 512, its depth cut from the default 6 layers to LM_LAYERS (the fused
# beams' LM step, here, in the [streaming path] and in the serving
# exports, grows with it; the run keeps within its time limit), the LSTM
# LM LSTMLMModel.create_model's default depth of 2 layers at d_model 512;
# both at the smoke test's vocabulary of 4233 (4230
# characters and 3 specials: the CIF path's, and with the blank the
# flagship's and conv-ctc's size).  Training takes the flagship YAML's
# optimizer, clip, label smoothing and schedule.
LM_LAYERS = 2
LM_MODELS = {
    "transformer_lm": {"type": "transformer_lm", "d_model": 512, "nhead": 8,
                       "num_layers": LM_LAYERS, "dim_feedforward": 2048, "activation": "relu",
                       "dropout_rate": 0.1},
    "lstm_lm": {"type": "lstm_lm", "d_model": 512, "n_layers": 2},
}
LM_BATCH = 32
LM_STEPS = 3
LM_LINES = 256            # 3 steps of 32 train lines, 5 dev batches of 32
LM_WEIGHT = 0.3
LM_STEP_TOKENS = 40
TOL_LM_STEP = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_FUSED_SCORES = 1e-3


def lm_train_config(exp, data, model_type, dtype) -> str:
    import yaml

    with open(FLAGSHIP_YAML) as f:
        flagship = yaml.safe_load(f)["training"]
    training = {k: flagship[k] for k in ("init_lr", "optimtype", "grad_max_norm",
                                         "label_smooth", "lr_scheduler")}
    training.update(exp_dir=exp, batch_size=LM_BATCH, num_epoch=1, print_inteval=1,
                    compute_dtype=DTYPE_NAME[dtype])
    cfg = {"data": dict(data, fetchworker_num=2), "model": dict(LM_MODELS[model_type]),
           "training": training}
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train_lm.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def lm_train_run(tag, cfg_path, model_type, vocab_size, launches) -> dict:
    """One train_lm CLI run on the card between counter reads: finite losses,
    LM_STEPS steps and the dev pass, exactly the launches of its steps and
    dev batches; its dev perplexity."""
    from openasr_torch.bin import train_lm
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class

    with torch.device("meta"):
        module = get_model_class(model_type).build_module(
            Config(dict(LM_MODELS[model_type], vocab_size=vocab_size)))
    per = module_launches(module)
    exp = os.path.dirname(cfg_path)
    reset_counters()
    t0 = time.time()
    train_lm.main([cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    rows = read_metrics(exp)
    tr = [r for r in rows if r["phase"] == "train"]
    cv = [r for r in rows if r["phase"] == "cv"]
    epoch = [r for r in rows if r["phase"] == "epoch"]
    dev_batches = -(-(LM_LINES - LM_BATCH * LM_STEPS) // LM_BATCH)
    require(len(tr) == LM_STEPS and len(cv) == dev_batches and len(epoch) == 1,
            f"{tag}: {len(tr)} steps, {len(cv)} dev batches")
    ppl = float(np.exp(epoch[0]["cv_loss"]))
    print(f"[lm path] {tag}: {len(tr)} steps + {len(cv)} dev batches in {wall:.2f}s wall; "
          f"ce {[round(r['ce_loss'], 4) for r in tr]}; dev perplexity {ppl:.2f} (vocabulary "
          f"{vocab_size}); launches {n}")
    require(all(np.isfinite(r[k]) for r in rows for k in r if k.endswith("loss")),
            f"{tag}: a non-finite loss")
    require(np.isfinite(ppl), f"{tag}: dev perplexity {ppl}")
    want = {k: 0 for k in n}
    for k, c in per["step"].items():
        want[k] += c * len(tr)
    for k, c in per["forward"].items():
        want[k] += c * len(cv)
    require(n == want, f"{tag}: launches {n} != {want}")
    attention_calls = count_attention(module)
    if attention_calls:
        for k in ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd_dropout",
                  "flash_bwd_stats", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                  "flash_attention_fwd"):
            require(n[k] > 0, f"{tag}: {k} never launched")
    launches[("lm train", tag)] = {"total": n, "steps": len(tr), "dev_batches": len(cv),
                                    "per_step": per["step"],
                                    "attention_calls": attention_calls}
    return {"pkg": os.path.join(exp, "last.pkg"), "ppl": ppl, "wall": wall}


def load_lm(pkg_path, device, dtype=torch.float32):
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(pkg_path)["model"]
    lm = get_model_class(pkg["model_type"]).create_model(Config(pkg["configs"]), device=device,
                                                         dtype=dtype)
    lm.restore(pkg)
    return lm


def lm_text_batch(vocab, lines):
    from openasr_torch.data.collate import TextCollate
    from openasr_torch.data.tokenizer import CharTokenizer

    return TextCollate(CharTokenizer(vocab))(lines)


def check_lm_against_cpu(pkgs, vocab, lines) -> dict:
    """One f32 step's gradients of the solver's loss (CE over tokens, label
    smoothing 0.1, no dropout) on 4 dev lines, card against CPU, TF32 off:
    the Transformer LM's with the CPU at the card's ReLU decisions
    (`ReluMasks`: its FFN ReLUs sit above every attention layer), the
    flips bounded as rounding ties as in the CIF check; the LSTM LM's as
    they are.  1e-3 of each parameter's largest gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = lm_text_batch(vocab, lines[:4])
    out = {}
    for lm_type, pkg in pkgs.items():
        relus = ReluMasks()
        runs = ((("cuda", False), ("cpu", None), ("cpu", True)) if lm_type == "transformer_lm"
                else (("cuda", None), ("cpu", None)))
        grads = {}
        for device, replay in runs:
            lm = load_lm(pkg, device)
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            with relus.installed(replay) if replay is not None else contextlib.nullcontext():
                losses = lm.loss(tb, None, label_smooth=0.1)
                total = losses["ce_loss"] / losses["n_tokens"]
            total.backward()
            grads[device if replay is not True else "cpu at the card's ReLUs"] = {
                n: p.grad.detach().cpu() for n, p in lm.module.named_parameters()}
        ref = grads.get("cpu at the card's ReLUs", grads["cpu"])
        worst, worst_name = grad_errs(grads["cuda"], ref)
        own, own_name = grad_errs(grads["cuda"], grads["cpu"])
        flip_abs = max((f["flip_abs_rel"] for f in relus.flipped), default=0.0)
        print(f"[lm check] {lm_type} f32 card vs CPU, one step's gradients on 4 lines "
              f"[{batch['ids'].shape[0]}, {batch['ids'].shape[1]}], {len(ref)} parameters"
              + (f", the CPU at the card's ReLU decisions: worst err {worst:.3g} "
                 f"({worst_name}; tol 1e-3); at the CPU's own {own:.3g} ({own_name}); "
                 f"{relus.flips} of {sum(int(x.numel()) for x in relus.inputs)} ReLU inputs "
                 f"flipped (at most {CIF_RELU_MAX_FLIPS}), the largest |x| at a flip "
                 f"{flip_abs:.3g} of its call's largest |x| (tol {CIF_RELU_TIE}): "
                 f"{relus.flipped}" if relus.inputs
                 else f": worst err {worst:.3g} ({worst_name}; tol 1e-3)"))
        require(relus.flips <= CIF_RELU_MAX_FLIPS,
                f"{lm_type}: {relus.flips} ReLU inputs flipped between card and CPU")
        require(flip_abs <= CIF_RELU_TIE, f"{lm_type}: a ReLU flip at {flip_abs:.3g}")
        require(worst <= 1e-3, f"{lm_type}: the gradient of {worst_name} disagrees: {worst:.3g}")
        out[lm_type] = {"grad_err": worst, "grad_err_own_relus": own, "relu_flips": relus.flips}
    return out


def check_lm_step(pkg, vocab, lines) -> dict:
    """The Transformer LM's cached step (dense attention over its K/V cache)
    against its batch forward (the flash and LayerNorm kernels) on the
    card: the first LM_STEP_TOKENS ids of two dev lines at least that
    long fed one a step, log-probs
    within TOL_LM_STEP, in f32 and with the LM in bf16."""
    from openasr_torch.models.lm import make_lm_fusion

    long = [line for line in lines if len(line.split()) >= LM_STEP_TOKENS][:2]
    ids = torch.from_numpy(lm_text_batch(vocab, long)["ids"][:, :LM_STEP_TOKENS]).cuda()
    require(ids.shape[1] == LM_STEP_TOKENS, f"step check: {tuple(ids.shape)} ids")
    errs = {}
    for dtype in DTYPES:
        lm = load_lm(pkg, "cuda", dtype)
        with torch.inference_mode():
            want = torch.log_softmax(lm.module(ids), dim=-1)
            step, cache = make_lm_fusion(lm, ids.shape[0], LM_STEP_TOKENS)
            got = []
            for j in range(LM_STEP_TOKENS):
                lp, cache = step(ids[:, j], cache)
                got.append(lp)
            got = torch.stack(got, dim=1)
        errs[DTYPE_NAME[dtype]] = max_err(got, want)
        require(bool(torch.isfinite(got).all()), "non-finite LM step log-probs")
    print(f"[lm check] the Transformer LM's cached step against its batch forward on the "
          f"card, [2, {LM_STEP_TOKENS}] tokens: log-prob err {errs} (tol "
          f"{ {DTYPE_NAME[k]: v for k, v in TOL_LM_STEP.items()} })")
    for dtype in DTYPES:
        require(errs[DTYPE_NAME[dtype]] <= TOL_LM_STEP[dtype],
                f"the LM step disagrees with the batch forward in {DTYPE_NAME[dtype]}")
    return errs


def count_layer_norms(module) -> int:
    from openasr_torch.models.layers import LayerNorm

    return sum(isinstance(m, LayerNorm) for m in module.modules())


def count_attention(module) -> int:
    from openasr_torch.models.layers import MultiHeadAttention

    return sum(isinstance(m, MultiHeadAttention) for m in module.modules())


def fused_cli_decode(tag, argv, n_utts, check_launches, launches) -> None:
    """One fused decode through the infer CLI on the card between counter
    reads: a hyp line an utterance and the launches `check_launches`
    accepts."""
    from openasr_torch.bin import infer

    reset_counters()
    t0 = time.time()
    infer.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    out = argv[argv.index("--output") + 1]
    with open(out, encoding="utf-8") as f:
        lines = [line for line in f if line.strip()]
    print(f"[lm path] fused decode {tag}: {len(lines)} hyps in {wall:.2f}s wall (1 batch); "
          f"launches {n}")
    require(len(lines) == n_utts, f"{tag}: {len(lines)} hyp lines for {n_utts} utterances")
    check_launches(tag, n)
    launches[("lm decode", tag)] = n


def phase_lm_cli_decodes(pkgs, flagship_pkg, ctc_pkg, vocab, test_json, test_feats, cif,
                         launches) -> None:
    """The fused beams through the infer CLI (one batch each): the flagship's
    attention beam with the Transformer LM in f32 and bf16 and with the
    LSTM LM, conv-ctc's device prefix beam with the Transformer LM, and
    the CIF beam with it; each run's LayerNorm launches are the encoder's
    plus, a step, the decoder's and the LM step's 12 (none for the LSTM),
    so they show that the LM stepped on the card.  Then a CTC model with
    --lm_pkg and no --ctc_beam_device exits non-zero."""
    from openasr_torch.bin import infer
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class

    with torch.device("meta"):
        flagship = get_model_class("conv-ctc-transformer").build_module(Config(FLAGSHIP))
        ctc = get_model_class("conv-ctc").build_module(Config(ctc_model()))
        cif_module = get_model_class("CIF").build_module(Config(load_model_cfg(CIF_YAML, 4233)))
        lm_ln = {t: count_layer_norms(get_model_class(t).build_module(
            Config(dict(LM_MODELS[t], vocab_size=4233)))) for t in LM_MODELS}
    n_utts = len(test_feats)
    common = ["--vocab_path", vocab, "--json_file", test_json, "--offline",
              "--batch_frames", "36000", "--device", "cuda", "--lm_weight", str(LM_WEIGHT)]
    enc_ln, enc_attn = count_layer_norms(flagship.encoder), count_attention(flagship.encoder)
    dec_ln = count_layer_norms(flagship.decoder)
    for lm_type, dtype in (("transformer_lm", torch.float32), ("transformer_lm", torch.bfloat16),
                           ("lstm_lm", torch.float32)):
        tag = f"attention beam, {lm_type}, {DTYPE_NAME[dtype]}"
        per_step = dec_ln + lm_ln[lm_type]

        def check(tag, n, per_step=per_step):
            steps = (n["layer_norm_fwd"] - enc_ln) // per_step
            want = {k: 0 for k in n}
            want.update(layer_norm_fwd=enc_ln + steps * per_step, flash_attention_fwd=enc_attn)
            require(n == want and steps >= 1, f"{tag}: launches {n}, not the encoder's and "
                                              f"{per_step} LayerNorms a step")

        hyp = os.path.join(WORK, f"hyp_lm_attention_{lm_type}_{DTYPE_NAME[dtype]}.txt")
        fused_cli_decode(tag, ["--model_type", "conv-ctc-transformer", "--model_pkg",
                               flagship_pkg, "--output", hyp, "--add_blk", "--nbest", "5",
                               "--maxlen", "40", "--dtype", DTYPE_NAME[dtype],
                               "--lm_pkg", pkgs[lm_type]] + common, n_utts, check, launches)
    t = encoder_shapes(test_feats)[1]
    ctc_ln, ctc_attn = count_layer_norms(ctc), count_attention(ctc)

    def check_ctc(tag, n):
        want = {k: 0 for k in n}
        # the LM steps from <sos>, then once a frame
        want.update(layer_norm_fwd=ctc_ln + (1 + t) * lm_ln["transformer_lm"],
                    flash_attention_fwd=ctc_attn)
        require(n == want, f"{tag}: launches {n} != {want}")

    beam = ["--ctc_beam", str(CTC_BEAM)]
    ctc_argv = ["--model_type", "conv-ctc", "--model_pkg", ctc_pkg, "--add_blk",
                "--lm_pkg", pkgs["transformer_lm"], "--dtype", "float32"] + common + beam
    fused_cli_decode("device ctc beam, transformer_lm, float32",
                     ctc_argv + ["--ctc_beam_device", "--output",
                                 os.path.join(WORK, "hyp_lm_ctc.txt")],
                     n_utts, check_ctc, launches)
    cif_per = cif_module_launches(cif_module, CIF_MAXLEN)["decode"]

    def check_cif(tag, n):
        want = {k: 0 for k in n}
        want.update(cif_per)
        want["layer_norm_fwd"] += CIF_MAXLEN * lm_ln["transformer_lm"]
        require(n == want, f"{tag}: launches {n} != {want}")

    fused_cli_decode("CIF beam, transformer_lm, float32",
                     ["--model_type", "CIF", "--model_pkg", cif["pkg"], "--vocab_path",
                      cif["vocab"], "--json_file", cif["test_json"], "--output",
                      os.path.join(WORK, "hyp_lm_cif.txt"), "--offline", "--nbest",
                      str(CIF_BEAM), "--maxlen", str(CIF_MAXLEN), "--batch_frames", "36000",
                      "--device", "cuda", "--lm_pkg", pkgs["transformer_lm"], "--lm_weight",
                      str(LM_WEIGHT)], len(cif["test_feats"]), check_cif, launches)
    try:
        infer.main(ctc_argv + ["--output", os.path.join(WORK, "hyp_lm_host.txt")])
        code = 0
    except SystemExit as e:
        code = e.code
    print(f"[lm path] conv-ctc with --lm_pkg and the host beam: exit {code!r}")
    require(code not in (0, None), "a CTC model fused an LM off the device beam")


def load_model_cfg(yaml_path, vocab_size) -> dict:
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg["decoder"]["vocab_size"] = vocab_size
    return cfg


def timed(fn, warm=True) -> tuple:
    """fn() after a warm call (`warm`; else the caller warmed it): (its
    result, its wall ms, the card synchronised before and after)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def fused_beams(pkgs, flagship_pkg, ctc_pkg, test_feats, cif) -> dict:
    """Each fused beam called directly, f32: warm wall ms a batch (the 8
    test utterances) fused and unfused; at --lm_weight 0 (the fused beam's
    warm-up) its output equal to the unfused one's; and on the shortest
    utterance its n-best scores on the card against the CPU's with the
    same packages (within TOL_FUSED_SCORES; whether the token lists are
    equal reported)."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import ctc_prefix_beam_device
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lms = {d: load_lm(pkgs["transformer_lm"], d) for d in ("cuda", "cpu")}

    def model_of(pkg_path, model_type, device):
        pkg = load_package(pkg_path)
        pkg = pkg.get("model", pkg)
        cfg = Config(pkg["configs"])
        if cfg.signal and "spec_aug" in cfg.signal:
            del cfg.signal["spec_aug"]
        model = get_model_class(model_type).create_model(cfg, device=device)
        model.restore(pkg)
        return model

    def attention(model, lm, w, x, lens, beam, maxlen):
        return model.batch_beam_decode(x, lens, beam, maxlen, empty_rows=False, lm=lm,
                                       lm_weight=w)

    def ctc_beam(model, lm, w, x, lens, beam, _maxlen):
        with torch.inference_mode():
            logits, llen = model.get_logits(x, lens, False)
            lp = torch.log_softmax(logits.float(), dim=-1)
            kw = {}
            if lm is not None:
                spec = make_lm_step_spec(lm)
                kw = {"lm_step_fn": spec["step_fn"], "lm_weight": w,
                      "init_lm_cache": spec["init_cache_fn"](lp.shape[0] * beam,
                                                             lp.shape[1] + 1)}
            return ctc_prefix_beam_device(lp, llen, blank=lp.shape[-1] - 1, beam=beam, **kw)

    beams = {
        "attention": (flagship_pkg, "conv-ctc-transformer", attention, test_feats, 5, 40),
        "device ctc": (ctc_pkg, "conv-ctc", ctc_beam, test_feats, CTC_BEAM, None),
        "cif": (cif["pkg"], "CIF", attention, cif["test_feats"], CIF_BEAM, CIF_MAXLEN),
    }
    out = {}
    for name, (pkg_path, model_type, run, feats, beam, maxlen) in beams.items():
        model = model_of(pkg_path, model_type, "cuda")
        utts = sorted(feats)
        x, lens = (torch.from_numpy(a).cuda() for a in padded_features(feats, utts))
        plain, plain_ms = timed(lambda: run(model, None, 0.0, x, lens, beam, maxlen))
        zero = run(model, lms["cuda"], 0.0, x, lens, beam, maxlen)
        fused, fused_ms = timed(lambda: run(model, lms["cuda"], LM_WEIGHT, x, lens, beam, maxlen),
                                warm=False)
        require(all(torch.equal(a, b) for a, b in zip(zero, plain)),
                f"{name} beam: --lm_weight 0 differs from the unfused beam")
        require(bool(torch.isfinite(fused[2][fused[2] > -1e29]).all()),
                f"{name} beam: non-finite fused scores")
        short = sorted(utts, key=lambda u: feats[u].shape[0])[:1]
        scores, toks = {}, {}
        for device in ("cuda", "cpu"):
            m = model if device == "cuda" else model_of(pkg_path, model_type, "cpu")
            xs, ls = (torch.from_numpy(a).to(device) for a in padded_features(feats, short))
            p, pl, sc = (a.cpu() for a in run(m, lms[device], LM_WEIGHT, xs, ls, beam, maxlen))
            scores[device] = sc
            toks[device] = [[tuple(p[i, n, : pl[i, n]].tolist()) for n in range(sc.shape[1])
                             if sc[i, n] > -1e29] for i in range(sc.shape[0])]
        live = scores["cpu"] > -1e29
        require(torch.equal(live, scores["cuda"] > -1e29), f"{name} beam: live rows differ")
        diff = float((scores["cuda"] - scores["cpu"])[live].abs().max())
        same = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
        out[name] = {"ms": fused_ms, "plain_ms": plain_ms, "cpu_score_diff": diff,
                     "same_nbest": same, "b": len(utts), "beam": beam}
        print(f"[lm path] {name} beam, f32, beam {beam}, Transformer LM weight {LM_WEIGHT}: "
              f"{fused_ms:.1f} ms a batch of {len(utts)} fused, {plain_ms:.1f} ms unfused "
              f"(warm wall); --lm_weight 0 equal to unfused; card vs CPU on {len(short)} "
              f"utterance(s): n-best scores within {diff:.3g} (tol {TOL_FUSED_SCORES}), n-best "
              f"token lists equal {same}/{len(short)}")
        require(diff <= TOL_FUSED_SCORES, f"{name} beam: fused scores card vs CPU {diff:.3g}")
    out["device ctc"]["cache_gather"] = lm_cache_gather_ms(lms["cuda"], test_feats)
    return out


def lm_cache_gather_ms(lm, test_feats) -> dict:
    """Device ms (CUDA-graph replay) of the device CTC beam's gather of the
    Transformer LM's cache by parent, once a frame, at the decode batch's
    shape (B x CTC_BEAM rows, T' + 1 positions), and its bytes (read and
    written once)."""
    from openasr_torch.ops.ctc_beam_device import _gather_rows

    b, t, _ = encoder_shapes(test_feats)
    cache = lm.module.init_step_cache(b * CTC_BEAM, t + 1)
    rows = torch.randint(0, CTC_BEAM, (b, CTC_BEAM), device="cuda")
    rows = (torch.arange(b, device="cuda")[:, None] * CTC_BEAM + rows).reshape(-1)
    nbytes = 2 * sum(x.numel() * x.element_size()
                     for lc in cache["layers"] for x in lc.values())
    ms = device_ms(lambda: _gather_rows(cache, rows))
    print(f"[lm path] the device CTC beam's LM cache gather by parent, "
          f"[{b * CTC_BEAM}, {t + 2}, 8, 64] x {2 * LM_LAYERS} f32: {ms:.4f} ms a frame (device), "
          f"{nbytes / 1e9:.3f} GB moved, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{ms * t:.1f} ms over the batch's {t} frames")
    return {"ms": ms, "frames": t, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def phase_lm(rng, launches, flagship_pkg, ctc_pkg, vocab, test_json, test_feats, cif) -> dict:
    """The LM path (see the module docstring); counters reset just before
    each CLI run and read just after."""
    from openasr_torch.data.tokenizer import CharTokenizer

    chars = [chr(0x4E00 + i) for i in range(4230)]
    lm_vocab = write_text("lm_chars.txt", chars)
    n_vocab = CharTokenizer(lm_vocab).unit_num()
    lines = [" ".join(rng.choice(chars, size=int(rng.randint(20, 61))))
             for _ in range(LM_LINES)]
    data = {"trainset": write_text("lm_train.txt", lines[: LM_BATCH * LM_STEPS]),
            "devset": write_text("lm_dev.txt", lines[LM_BATCH * LM_STEPS:]),
            "vocab_path": lm_vocab}
    runs = {}
    for lm_type, dtype in (("transformer_lm", torch.float32), ("transformer_lm", torch.bfloat16),
                           ("lstm_lm", torch.float32)):
        tag = f"{lm_type} {DTYPE_NAME[dtype]}"
        cfg = lm_train_config(os.path.join(WORK, f"exp_{lm_type}_{DTYPE_NAME[dtype]}"), data,
                              lm_type, dtype)
        runs[tag] = lm_train_run(tag, cfg, lm_type, n_vocab, launches)
    pkgs = {"transformer_lm": runs["transformer_lm float32"]["pkg"],
            "lstm_lm": runs["lstm_lm float32"]["pkg"]}
    dev = lines[LM_BATCH * LM_STEPS:]
    check = check_lm_against_cpu(pkgs, lm_vocab, dev)
    step = check_lm_step(pkgs["transformer_lm"], lm_vocab, dev)
    phase_lm_cli_decodes(pkgs, flagship_pkg, ctc_pkg, vocab, test_json, test_feats, cif,
                         launches)
    beams = fused_beams(pkgs, flagship_pkg, ctc_pkg, test_feats, cif)
    return {"runs": runs, "check": check, "step": step, "beams": beams,
            "train_text": data["trainset"], "vocab": lm_vocab}


def lm_shape(train_text, vocab):
    """The LM training run's largest batch: B and its ids width, from the
    train CLI's first epoch of batches."""
    from openasr_torch.data.manifest import TextLineByLineDataset
    from openasr_torch.data.sampler import CountBatchSampler

    ds = TextLineByLineDataset(train_text)
    widths = [lm_text_batch(vocab, [ds[i] for i in b])["ids"].shape[1]
              for b in CountBatchSampler(len(ds), LM_BATCH, shuffle=True, drop_last=True)]
    return LM_BATCH, max(widths)


def lm_rows(lm, errs, launches):
    """The attention kernels at the Transformer LM's training shape (causal,
    no key lengths, dropout 0.1), each against SDPA with is_causal on the
    same call: the forward (4l) and the whole backward (5+6l); their calls
    a step taken from the built module and held to the run's launches."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    b, u = lm_shape(lm["train_text"], lm["vocab"])
    h, d = LM_MODELS["transformer_lm"]["nhead"], 64
    rng = np.random.RandomState(SEED + 14)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        tr = launches[("lm train", f"transformer_lm {name}")]
        calls = tr["attention_calls"]
        for key in ("flash_attention_fwd_dropout", "flash_attention_bwd_dkv"):
            require(calls * tr["steps"] == tr["total"][key],
                    f"{calls} attention calls a step by the built module, but "
                    f"{tr['total'][key]} {key} launches in {tr['steps']} steps")
        row = attention_fwd_row(b, h, d, u, u, True, None, dtype, rng, errs, DROPOUT)
        rows.append({"name": f"flash_attention_fwd_dropout_lm[{name}]", **row,
                     "launches": tr["total"]["flash_attention_fwd_dropout"],
                     "launches_per_step": calls,
                     "launches_are": "dropout forward calls of the Transformer LM training run",
                     "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, its own "
                                   "Philox mask, is_causal=True)",
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype]})
        at = attention_bwd_times(b, h, d, u, u, True, None, dtype, rng)
        args = at["kernel_args"][:6] + at["kernel_args"][7:]
        got, want = flash_attention_bwd(*args), flash_attention_bwd_reference(*args)
        err = (0.0, 0.0)
        for g, w in zip(got, want):
            e, scale = scaled_err(g, w)
            err = (max(err[0], e), max(err[1], e / scale))
        print(f"[lm rows] flash backward {name} [{b}, {u}, {u}, {h}, {d}] causal, no key "
              f"lengths: err {err[0]:.3g}, scaled {err[1]:.3g} (tol {TOL_FLASH_BWD[dtype]})")
        require(err[1] <= TOL_FLASH_BWD[dtype], "the backward disagrees at the LM shape")
        rows.append({
            "name": f"flash_attention_bwd_lm[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"], "causal": True,
            "launches": tr["total"]["flash_attention_bwd_dkv"],
            "launches_per_step": calls,
            "launches_are": "backward calls of the Transformer LM training run, each "
                            "launching statistics, dK/dV and dQ once",
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, is_causal=True) "
                          "forward + backward minus forward (graph replay)",
        })
    return rows


# ------------------------------------------------------------ streaming path

STREAM_YAML = os.path.join(ROOT, "egs", "aishell1", "configs",
                           "conv-ctc-transformer-streaming.yaml")
STREAM_BEAM = 10
STREAM_STEPS = 3
# the streamed f32 encoder states and CTC logits against the card's batch
# forward in chunk mode (and the CPU's), on valid frames: max abs error over
# max(1, the largest magnitude), the card-vs-CPU logits check's 1e-3.  The
# chunk step attends densely in IEEE f32, the batch forward through the
# kernel's 3xTF32 products, and six layers carry the difference: 2.6e-4 of
# scale on the online model's loud log-mel inputs, 1e-5 on random
# features (PERF.md, the streaming findings)
TOL_STREAM = 1e-3
# a tick's LayerNorm launches: two a layer and the final norm
STREAM_TICK_LN = 13


def stream_model_cfg(online=False) -> dict:
    """conv-ctc-transformer-streaming.yaml's model section at the smoke
    test's vocabulary; `online`: with conv-ctc-transformer-online.yaml's
    signal (the fbank frontend; the chunk mask's phase 2)."""
    import yaml

    cfg = load_model_cfg(STREAM_YAML, FLAGSHIP["decoder"]["vocab_size"])
    if online:
        with open(ONLINE_YAML) as f:
            cfg["signal"] = yaml.safe_load(f)["model"]["signal"]
    return cfg


def phase_streaming_train(vocab, chars, rng, launches) -> dict:
    """conv-ctc-transformer-streaming.yaml's model and training sections as
    they are (dropout 0.1, SpecAugment, batch_frames 36000, Noam), one
    epoch through the train CLI in f32 and bf16 on 96 random-feature
    utterances of 1000-1200 frames (3 steps, T' up to 299) and a dev batch
    of 8, counters reset just before each run and read just after: every
    attention of the step launches once a step (the encoder's 6 in chunk
    mode, the decoder's 12 causal and cross) and every LayerNorm forward
    and backward, as the built module counts them.  Then one f32 step's
    gradients on the card against the CPU (1e-3)."""
    from openasr_torch.bin import train
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.ops.masks import ChunkMask

    train_json, feats = write_corpus("strain", rng, chars, 96, (1000, 1200), (20, 24))
    dev_json, _ = write_corpus("sdev", rng, chars, 8, (1000, 1200), (20, 24))
    model_cfg = stream_model_cfg()
    with torch.device("meta"):
        module = get_model_class("conv-ctc-transformer").build_module(Config(model_cfg))
    require(module.encoder.chunk_mask == ChunkMask(16, 4, 1),
            f"the streaming encoder's mask is {module.encoder.chunk_mask}")
    per = module_launches(module)
    runs = {}
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        exp = os.path.join(WORK, f"exp_streaming_{name}")
        os.makedirs(exp)
        cfg = train_config(train_json, dev_json, vocab, exp, dtype, STREAM_YAML)
        reset_counters()
        t0 = time.time()
        train.main([cfg, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        rows = read_metrics(exp)
        tr = [r for r in rows if r["phase"] == "train"]
        cv = [r for r in rows if r["phase"] == "cv"]
        losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
        print(f"[streaming path] train {name}: {len(tr)} steps + {len(cv)} dev batch(es) in "
              f"{wall:.2f}s wall; losses {[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
              f"{[round(r['ce_loss'], 4) for r in tr]} (ce); launches {n}")
        require(len(tr) == STREAM_STEPS and len(cv) >= 1, f"{len(tr)} steps, {len(cv)} dev")
        require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
        want = {k: 0 for k in n}
        for k, c in per["step"].items():
            want[k] += c * len(tr)
        for k, c in per["forward"].items():
            want[k] += c * len(cv)
        require(n == want, f"streaming train launches {n} != {want}")
        launches[("streaming train", dtype)] = {"total": n, "steps": len(tr),
                                                "dev_batches": len(cv), "per_step": per["step"]}
        runs[name] = {"exp": exp, "wall": wall}
    pkg = os.path.join(runs["float32"]["exp"], "last.pkg")
    grad_err = check_grads_against_cpu(pkg, feats, model_cfg, "streaming grad check")
    return {"train_json": train_json, "pkg": pkg, "grad_err": grad_err,
            "calls": {"encoder": count_attention(module.encoder),
                      "all": count_attention(module)}}


def chunk_check(tag, b, t, lens, mask, dtype, rate, rng, errs) -> int:
    """The chunk mode's forward, statistics pass and backward on the card
    against the plain versions (dense under chunk_bias) on one input [b, t,
    8, 64]: O to TOL_FLASH, the statistics to TOL_FLASH_STATS, the
    gradients to TOL_FLASH_BWD over max(1, magnitude); the rows that see no
    key give O = 0, lse = +inf, statistics 0 and finite, zero gradients.
    -> the number of such (row, query) pairs."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_bwd_stats,
        flash_bwd_stats_reference,
    )

    h, d = 8, 64
    q, k, v, dout = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
                     for _ in range(4))
    kv = torch.from_numpy(np.asarray(lens, np.int32)).cuda()
    seed = DROPOUT_SEED if rate else 0
    args = (kv, False, None, rate, seed, mask)
    out, lse = flash_attention(q, k, v, kv_lengths=kv, dropout_rate=rate, dropout_seed=seed,
                               chunk_mask=mask)
    got = flash_attention_bwd(q, k, v, out, lse, dout, *args)
    got_st = flash_bwd_stats(q, k, v, dout, *args)
    out_r, lse_r = flash_attention_reference(q, k, v, *args)
    want = flash_attention_bwd_reference(q, k, v, out_r, lse_r, dout, *args)
    want_st = flash_bwd_stats_reference(q, k, v, dout, *args)
    torch.cuda.synchronize()
    e_out = max_err(out, out_r)
    e_lse = max_err(lse, lse_r)
    empty = torch.isinf(lse_r)                    # [B, H, T]
    rows = empty.any(dim=1)                       # [B, T]
    worst = 0.0
    for g, w in zip(got, want):
        e, scale = scaled_err(g, w)
        require(bool(torch.isfinite(g).all()), f"{tag}: a non-finite gradient")
        worst = max(worst, e / scale)
        note_err(errs, ("chunk_bwd", dtype), e, e / scale)
    st = stats_errs(got_st, want_st)
    print(f"[streaming kernels] {tag} {DTYPE_NAME[dtype]} dropout={rate} [{b}, {t}, {t}, {h}, "
          f"{d}] {tuple(mask)}: out err {e_out:.3g} (tol {TOL_FLASH[dtype]}), lse err "
          f"{e_lse:.3g}; statistics " + ", ".join(f"{n} {x:.3g}" for n, _, x in st)
          + f" (tol {TOL_FLASH_STATS}); worst grad err {worst:.3g} of max(1, |grad|) (tol "
          f"{TOL_FLASH_BWD[dtype]}); {int(rows.sum())} query rows see no key")
    require(e_out <= TOL_FLASH[dtype], f"{tag}: the chunk-mode forward disagrees")
    require(e_lse <= 1e-4 * max(1.0, float(lse_r[~empty].abs().max())),
            f"{tag}: the chunk-mode lse disagrees (+inf exactly on rows that see no key)")
    require(all(x <= TOL_FLASH_STATS for _, _, x in st), f"{tag}: the statistics disagree")
    require(worst <= TOL_FLASH_BWD[dtype], f"{tag}: the chunk-mode backward disagrees")
    require(not out[rows].any() and not got[0][rows].any(),
            f"{tag}: a row that sees no key has a non-zero output or dQ")
    require(not got_st[:, empty].any(), f"{tag}: a row that sees no key has statistics")
    errs[("chunk_fwd", dtype)] = max(errs.get(("chunk_fwd", dtype), 0.0), e_out)
    for _, e, x in st:
        note_err(errs, ("chunk_stats", dtype), e, x)
    return int(rows.sum())


def streaming_rows(stream, errs, launches):
    """Rows 4ch and 5+6ch: the chunk mode's forward (dropout 0.1) and whole
    backward at the streaming training run's largest encoder batch [B, T',
    8, 64] (chunk 16, left 4, phase 1), each against SDPA with the
    equivalent bool mask on the same call, after the kernels are held to
    their plain versions there and on a batch of 8 x 300 frames whose short
    rows leave padded queries with no visible key, with dropout 0 and 0.1;
    calls a step from the built module, held to the run's launches."""
    from openasr_torch.ops.masks import ChunkMask

    mask = ChunkMask(16, 4, 1)
    shape = train_shapes(stream["train_json"])
    b, t, lens = shape["b"], shape["t"], shape["enc_lens"]
    no_key_lens = np.array([300, 299, 250, 200, 100, 37, 16, 1])
    rng = np.random.RandomState(SEED + 15)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        empty = 0
        for rate in (0.0, DROPOUT):
            chunk_check("training batch", b, t, lens, mask, dtype, rate, rng, errs)
            empty += chunk_check("rows without keys", 8, 300, no_key_lens, mask, dtype, rate,
                                 rng, errs)
        require(empty > 0, "the no-key batch has no row without a visible key")
        tr = launches[("streaming train", dtype)]
        calls = stream["calls"]
        for key in ("flash_attention_fwd_dropout", "flash_attention_bwd_dkv"):
            require(calls["all"] * tr["steps"] == tr["total"][key],
                    f"{calls['all']} attention calls a step by the built module, but "
                    f"{tr['total'][key]} {key} launches in {tr['steps']} steps")
        row = attention_fwd_row(b, 8, 64, t, t, False, lens, dtype, rng, errs, DROPOUT, mask)
        common = {"chunk_mask": list(mask), "launches_per_step": calls["all"],
                  "calls_per_step_at_this_shape": calls["encoder"]}
        rows.append({"name": f"flash_attention_fwd_dropout_chunk[{name}]", **row, **common,
                     "launches": tr["total"]["flash_attention_fwd_dropout"],
                     "launches_are": "dropout forward calls of the streaming training run "
                                     "(the encoder's in chunk mode, the decoder's causal and "
                                     "cross)",
                     "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, its own "
                                   "Philox mask, a bool key-padding and chunk mask)",
                     "max_abs_err": errs[("chunk_fwd", dtype)], "tol": TOL_FLASH[dtype]})
        at = attention_bwd_times(b, 8, 64, t, t, False, lens, dtype, rng, mask, cold=False)
        rows.append({
            "name": f"flash_attention_bwd_chunk[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327); the chunk mode replaces the JAX "
                        "encoder's dense chunk_bias attention (models/encoder.py:205-227)",
            "shape": at["shape"], **common,
            "launches": tr["total"]["flash_attention_bwd_dkv"],
            "launches_are": "backward calls of the streaming training run, each launching "
                            "statistics, dK/dV and dQ once",
            **bwd_errs(errs[("chunk_bwd", dtype)], TOL_FLASH_BWD[dtype]),
            "stats_max_scaled_err": errs[("chunk_stats", dtype)][1],
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, a bool key-padding "
                          "and chunk mask) forward + backward minus forward (graph replay)",
        })
    return rows


def pack_valid(chunks, valids):
    """Per-chunk [B, ch, ...] tensors and [B, ch] validity -> the valid
    frames of each row packed from 0 [B, E, ...], and E a row."""
    x, valid = torch.cat(chunks, dim=1), torch.cat(valids, dim=1)
    lens = valid.sum(dim=1)
    out = x.new_zeros((x.shape[0], max(int(lens.max()), 1)) + tuple(x.shape[2:]))
    rows, slots = valid.nonzero(as_tuple=True)
    out[rows, valid.cumsum(dim=1)[rows, slots] - 1] = x[rows, slots]
    return out, lens


def stream_ticks(rec, x, lens, beam=0, lm_spec=None, tables=None) -> dict:
    """Drive `rec` tick by tick over features x [B, T, D] as decode_waves
    does: greedy partials (beam 0) or the streaming prefix beam (with the
    LM of `lm_spec` at LM_WEIGHT and the hotword `tables` at weight 2),
    each tick's partial brought to the host.  -> the ticks' logits and
    validity, the last n-best (beam) and, on the card, each tick's host
    wall ms and device ms (CUDA events around the tick's work)."""
    from openasr_torch.ops.ctc_beam_device import ctc_beam_stream_init, ctc_beam_stream_step

    dev = rec.device
    b, unit = x.shape[0], rec.chunk_feats
    n_chunks = -(-x.shape[1] // unit)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, n_chunks * unit - x.shape[1]))
    xp = xp.to(dev)
    beam_state, beam_kw = None, {}
    with torch.inference_mode():
        if beam:
            init_kw = {}
            if lm_spec is not None:
                init_kw = {"lm_step_fn": lm_spec["step_fn"], "init_lm_cache":
                           lm_spec["init_cache_fn"](b * beam, n_chunks * rec.chunk + 1)}
                beam_kw.update(lm_step_fn=lm_spec["step_fn"], lm_weight=LM_WEIGHT)
            if tables is not None:
                init_kw["num_phrases"] = int(np.shape(tables["plen"])[0])
                beam_kw.update(context_tables=tables, context_weight=2.0)
            beam_state = ctc_beam_stream_init(b, beam, n_chunks * rec.chunk, device=dev,
                                              **init_kw)
        state = rec.init_state(b)
        logits, valids, wall, device = [], [], [], []
        nbest = None
        for n in range(n_chunks):
            piece = xp[:, n * unit:(n + 1) * unit]
            clens = np.clip(lens - n * unit, 0, unit)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            state, out = rec.step(state, piece, clens)
            if beam:
                beam_state, nbest = ctc_beam_stream_step(
                    beam_state, torch.log_softmax(out["logits"], dim=-1), out["valid"],
                    rec.blank, beam, **beam_kw)
                nbest[0][:, 0].cpu()
            else:
                out["logits"].argmax(dim=-1).cpu()
            if dev.type == "cuda":
                ev[1].record()
                torch.cuda.synchronize()
                device.append(ev[0].elapsed_time(ev[1]))
            wall.append((time.perf_counter() - t0) * 1e3)
            logits.append(out["logits"])
            valids.append(out["valid"])
    return {"logits": logits, "valid": valids, "nbest": nbest, "wall_ms": wall,
            "device_ms": device, "ticks": n_chunks}


def streaming_model(pkg_path, device, dtype=torch.float32, model_cfg=None):
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(pkg_path)
    pkg = pkg.get("model", pkg)
    model = get_model_class("conv-ctc-transformer").create_model(
        model_cfg or pkg["configs"], device=device, dtype=dtype)
    model.restore(pkg)
    return model


def batch_logits(model, x, lens):
    """The batch forward in chunk mode: (encoder states, CTC logits f32,
    encoder lengths)."""
    from openasr_torch.models.speech import _f32_head

    dev = model.module.encoder.dtype_probe.device
    with torch.inference_mode():
        enc, elens = model.module.encode(torch.from_numpy(x).to(dev),
                                         torch.from_numpy(lens).to(dev))
        return enc.float(), _f32_head(model.module.ctc_fc, enc), elens


def logits_close(name, got, want, lens) -> float:
    """got, want [B, >= E, V] over each row's first lens frames: max abs error
    over max(1, the largest magnitude), required within TOL_STREAM."""
    e, scale = 0.0, 1.0
    for i, n in enumerate(lens.tolist()):
        g, w = got[i, :n].float().cpu(), want[i, :n].float().cpu()
        e = max(e, max_err(g, w))
        scale = max(scale, float(w.abs().max()))
    print(f"[streaming path] {name}: err {e:.3g} of max(1, |x|) = {scale:.3g} "
          f"(tol {TOL_STREAM})")
    require(e <= TOL_STREAM * scale, f"{name} disagree")
    return e / scale


def greedy_ids(logits, lens, blank):
    """CTC greedy over each row's first lens frames: collapse repeats, drop
    the blank."""
    ids = logits.argmax(dim=-1).cpu().numpy()
    out = []
    for i, n in enumerate(lens.tolist()):
        prev, hyp = -1, []
        for tid in ids[i, :n].tolist():
            if tid != blank and tid != prev:
                hyp.append(tid)
            prev = tid
        out.append(hyp)
    return out


def same_or_ties(name, got, want, logits_err) -> int:
    """Greedy hypotheses of two runs whose logits agree within logits_err:
    equal, or (printed) differing where an argmax flipped, which logits
    that close can only do at a frame whose top two lie within 2 x
    logits_err; -> the number of differing hypotheses."""
    differ = sum(g != w for g, w in zip(got, want))
    print(f"[streaming path] {name}: {len(got) - differ} of {len(got)} hypotheses equal"
          + (f" (the others at argmax ties: logits within {logits_err:.3g})" if differ else ""))
    require(differ == 0 or logits_err > 0.0, f"{name}: hypotheses differ on equal logits")
    return differ


def nbest_close(name, got, want, exact) -> None:
    """Two n-best lists (tokens, lengths, scores): equal token lists and
    scores within 1e-4 (`exact`: the same search on the same log-probs), or
    scores within TOL_FUSED_SCORES with the 1-best equal unless the
    reference's top two lie within 2 x TOL_FUSED_SCORES (a tie)."""
    g_t, g_l, g_s = (a.cpu().numpy() for a in got)
    w_t, w_l, w_s = (a.cpu().numpy() for a in want)
    live = w_s > -1e29
    require(((g_s > -1e29) == live).all(), f"{name}: live beams differ")
    e = float(np.abs(g_s - w_s)[live].max())
    same = [[g_t[i, j, : g_l[i, j]].tolist() == w_t[i, j, : w_l[i, j]].tolist()
             for j in range(live.shape[1]) if live[i, j]] for i in range(live.shape[0])]
    ties = [bool(live[i, 1] and w_s[i, 0] - w_s[i, 1] <= 2 * TOL_FUSED_SCORES)
            for i in range(live.shape[0])]
    print(f"[streaming path] {name}: scores err {e:.3g}; n-best lists equal "
          f"{sum(all(r) for r in same)} of {len(same)}, 1-best equal "
          f"{sum(r[0] for r in same)} of {len(same)}")
    if exact:
        require(e <= 1e-4 and all(all(r) for r in same), f"{name}: n-best differs")
    else:
        require(e <= TOL_FUSED_SCORES, f"{name}: scores differ by {e:.3g}")
        require(all(r[0] or tie for r, tie in zip(same, ties)),
                f"{name}: a 1-best differs where its scores are no tie")


def phase_streaming_decode(pkg, vocab, test_json, test_feats, lm_pkg, launches) -> dict:
    """The trained streaming package through `openasr_torch.bin.stream_infer`
    (B 8, offline features): greedy partials, prefix-beam partials of 10
    with the [lm path]'s Transformer LM and a hotword file, and the
    attention rescore; counters reset just before each run and read just
    after (13 LayerNorm forwards a tick, no attention kernel: the chunk
    step attends densely; the LM's 12 a frame more with fusion).  Then in
    process: the streamed encoder states and CTC logits against the card's
    batch forward in chunk mode, the greedy hypotheses against the batch
    forward's, the last n-best of the prefix beam (with and without the LM
    and hotwords) against `ctc_prefix_beam_device` over the streamed
    log-probs; on the shortest utterance every mode against the CPU; and the
    median ms a tick, device and wall, in f32 and bf16."""
    from openasr_torch.bin import stream_infer
    from openasr_torch.config import Config
    from openasr_torch.data.collate import quantize
    from openasr_torch.models import get_model_class
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import build_context_tables, ctc_prefix_beam_device
    from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
    from openasr_torch.streaming import StreamingRecognizer

    chars = [line.strip() for line in open(vocab, encoding="utf-8")]
    hot = write_text("stream_hot.txt", [" ".join(chars[i: i + 3]) for i in (10, 200, 3000)])
    utts = sorted(test_feats)
    n_ticks = -(-quantize(max(test_feats[u].shape[0] for u in utts)) // 64)
    with torch.device("meta"):
        lm_module = get_model_class("transformer_lm").build_module(
            Config(load_package_configs(lm_pkg)))
    lm_ln = count_layer_norms(lm_module)
    modes = {
        "greedy": [],
        "beam 10 lm hotwords": ["--partial_beam", str(STREAM_BEAM), "--lm_pkg", lm_pkg,
                                "--lm_weight", str(LM_WEIGHT), "--context_file", hot],
        "rescore": ["--rescore", "--nbest", "5", "--maxlen", "40"],
    }
    cli = {}
    for tag, extra in modes.items():
        hyp = os.path.join(WORK, f"hyp_stream_{tag.replace(' ', '_')}.txt")
        argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                "--vocab_path", vocab, "--json_file", test_json, "--output", hyp,
                "--offline", "--add_blk", "--batch_size", "8", "--device", "cuda"] + extra
        reset_counters()
        t0 = time.time()
        stream_infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[streaming path] stream_infer {tag}: {len(lines)} hyps in {wall:.2f}s wall, "
              f"{n_ticks} ticks; launches {n}")
        require(len(lines) == len(utts), f"{len(lines)} hyp lines for {len(utts)} utterances")
        want_ln = STREAM_TICK_LN * n_ticks
        if "lm" in tag:
            want_ln += lm_ln * (1 + n_ticks * 16)   # <sos>, then every frame
        if tag == "rescore":
            require(n["layer_norm_fwd"] > want_ln, "the rescore launched no LayerNorm")
        else:
            require(n["layer_norm_fwd"] == want_ln,
                    f"{n['layer_norm_fwd']} LayerNorm launches, want {want_ln}")
        require(all(v == 0 for k, v in n.items() if k != "layer_norm_fwd"),
                f"a kernel other than LayerNorm launched: {n}")
        launches[("stream decode", tag)] = n
        cli[tag] = wall

    tokenizer = CharTokenizer(vocab, add_blk=True)
    tables = build_context_tables(load_context_phrases(tokenizer, hot), tokenizer.unit_num())
    x, lens = padded_features(test_feats, utts)
    model = streaming_model(pkg, "cuda")
    rec = StreamingRecognizer(model)
    lm = load_lm(lm_pkg, "cuda")
    spec = make_lm_step_spec(lm)
    enc_b, logits_b, elens = batch_logits(model, x, lens)
    hyps, enc_s, enc_lens = rec.decode_waves(x, lens)
    require(enc_lens.tolist() == elens.tolist(), f"streamed lengths {enc_lens.tolist()} != "
                                                 f"{elens.tolist()}")
    checks = {"enc_err": logits_close("streamed vs batch encoder states, f32", enc_s, enc_b,
                                      enc_lens)}
    # the f32 runs below are also the f32 tick times (warm: the CLI runs
    # came first), the bf16 ones after them
    runs = {("greedy", "float32"): stream_ticks(rec, x, lens)}
    greedy = runs[("greedy", "float32")]
    packed, plens = pack_valid(greedy["logits"], greedy["valid"])
    checks["logits_err"] = logits_close("streamed vs batch CTC logits, f32", packed, logits_b,
                                        plens)
    require(greedy_ids(packed, plens, rec.blank) == hyps, "decode_waves' greedy partials "
                                                          "differ from its ticks'")
    checks["greedy_vs_batch_differ"] = same_or_ties(
        "greedy, streamed vs batch", hyps, greedy_ids(logits_b, plens, rec.blank),
        checks["logits_err"])
    for name, kw in (("beam 10", {}), ("beam 10 lm hotwords", {"lm_spec": spec,
                                                              "tables": tables})):
        run = runs[(name, "float32")] = stream_ticks(
            rec, x, lens, STREAM_BEAM, **kw)
        lp, plens = pack_valid([torch.log_softmax(lg, dim=-1) for lg in run["logits"]],
                               run["valid"])
        one_kw = {}
        if "lm_spec" in kw:
            one_kw = {"lm_step_fn": spec["step_fn"], "lm_weight": LM_WEIGHT,
                      "init_lm_cache": spec["init_cache_fn"](len(utts) * STREAM_BEAM,
                                                             lp.shape[1] + 1),
                      "context_tables": tables, "context_weight": 2.0}
        with torch.inference_mode():
            want = ctc_prefix_beam_device(lp, plens, rec.blank, STREAM_BEAM, **one_kw)
        nbest_close(f"{name}: the last partial n-best vs ctc_prefix_beam_device over the "
                    f"streamed log-probs", run["nbest"], want, exact=True)

    # the CPU on the shortest utterance, every mode
    t_cpu = time.time()
    short = sorted(utts, key=lambda u: test_feats[u].shape[0])[:1]
    xs, ls = padded_features(test_feats, short)
    cpu_model = streaming_model(pkg, "cpu")
    cpu_rec = StreamingRecognizer(cpu_model)
    cpu_spec = make_lm_step_spec(load_lm(lm_pkg, "cpu"))
    for name, kw in (("greedy", {}), ("beam 10 lm hotwords",
                                      {"beam": STREAM_BEAM, "tables": tables})):
        run = {dev: stream_ticks(r, xs, ls, lm_spec=s if kw else None, **kw)
               for dev, r, s in (("cuda", rec, spec), ("cpu", cpu_rec, cpu_spec))}
        lg = {dev: pack_valid(r["logits"], r["valid"]) for dev, r in run.items()}
        e = logits_close(f"{name}: streamed CTC logits, card vs CPU", lg["cuda"][0],
                         lg["cpu"][0], lg["cpu"][1])
        if kw:
            nbest_close(f"{name}: card vs CPU", run["cuda"]["nbest"], run["cpu"]["nbest"],
                        exact=False)
        else:
            same_or_ties("greedy, card vs CPU", *(greedy_ids(*lg[d], rec.blank)
                                                  for d in ("cuda", "cpu")), e)
    enc_cpu = cpu_rec.decode_waves(xs, ls)
    enc_gpu = rec.decode_waves(xs, ls)
    with torch.inference_mode():
        res = {dev: m.beam_decode_encoded(o[1].to(m.module.encoder.compute_dtype), o[2],
                                          beam_size=5, max_decode_len=40)
               for dev, m, o in (("cuda", model, enc_gpu), ("cpu", cpu_model, enc_cpu))}
    nbest_close("rescore: card vs CPU", res["cuda"], res["cpu"], exact=False)
    print(f"[streaming path] the CPU checks took {time.time() - t_cpu:.1f}s")

    # median ms a tick at B 8, chunk 16, the first tick of each run left out
    rec16 = StreamingRecognizer(streaming_model(pkg, "cuda", torch.bfloat16))
    for name, kw in (("greedy", {}), ("beam 10", {"beam": STREAM_BEAM}),
                     ("beam 10 lm hotwords", {"beam": STREAM_BEAM, "lm_spec": spec,
                                              "tables": tables})):
        runs[(name, "bfloat16")] = stream_ticks(rec16, x, lens, **kw)
    times_ = {key: {"device_ms": float(np.median(run["device_ms"][1:])),
                    "wall_ms": float(np.median(run["wall_ms"][1:])), "ticks": run["ticks"]}
              for key, run in runs.items()}
    reset_counters()
    with torch.inference_mode():
        state = rec.init_state(len(utts))
        rec.step(state, x[:, : rec.chunk_feats])
    per_tick = read_counters()
    require(per_tick["layer_norm_fwd"] == STREAM_TICK_LN
            and all(v == 0 for k, v in per_tick.items() if k != "layer_norm_fwd"),
            f"a tick's launches {per_tick}")
    for (name, dt), r in sorted(times_.items()):
        print(f"[time] streaming tick {name} {dt}: median {r['device_ms']:.3f} ms device, "
              f"{r['wall_ms']:.3f} ms wall (B {len(utts)}, chunk 16 = 640 ms of audio, "
              f"{r['ticks']} ticks)")
    return {"cli_wall": cli, "checks": checks, "times": times_, "per_tick": per_tick}


def phase_streaming_online(wtest_json, wtest, launches) -> dict:
    """The streaming model with the online signal (phase 2; random weights
    from SEED) streaming the 8 test waves tick by tick, in f32: each tick
    launches the fbank kernel once and 13 LayerNorms, and the streamed
    encoder states agree with the card's batch forward in chunk mode on
    valid frames (TOL_STREAM)."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.models import get_model_class
    from openasr_torch.streaming import StreamingRecognizer

    model = get_model_class("conv-ctc-transformer").create_model(
        stream_model_cfg(online=True), device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    rec = StreamingRecognizer(model)
    require(rec.phase == 2 and not rec.offline, "the online model streams waves at phase 2")
    utts = sorted(wtest)
    lens = np.array([wtest[u].shape[0] for u in utts])
    x = np.zeros((len(utts), quantize(int(lens.max()))), np.float32)
    for i, u in enumerate(utts):
        x[i, : lens[i]] = wtest[u]
    n_ticks = -(-x.shape[1] // rec.chunk_samples)
    reset_counters()
    t0 = time.time()
    _, enc_s, enc_lens = rec.decode_waves(x, lens)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    print(f"[streaming path] online: {len(utts)} waves, {n_ticks} ticks of "
          f"{rec.chunk_samples} samples in {wall:.2f}s wall; launches {n}")
    require(n["fbank"] == n_ticks and n["layer_norm_fwd"] == STREAM_TICK_LN * n_ticks
            and n["flash_attention_fwd"] == 0, f"online streaming launches {n}")
    launches[("stream decode", "online")] = n
    with torch.inference_mode():
        enc_b, elens = model.module.encode(torch.from_numpy(x).cuda(),
                                           torch.from_numpy(lens).cuda())
    require(enc_lens.tolist() == elens.tolist(), "online: streamed lengths differ")
    err = logits_close("online: streamed vs batch encoder states, f32", enc_s, enc_b.float(),
                       enc_lens)
    return {"ticks": n_ticks, "enc_err": err, "launches": n}


# --------------------------------------------------------------- wave path

WAV2VEC_YAML = os.path.join(ROOT, "egs", "wav2vec", "configs", "wav2vec_ctc.yaml")
CPC_YAML = os.path.join(ROOT, "egs", "libri", "configs", "cpc_pretrain.yaml")
GRU_CTC_YAML = os.path.join(ROOT, "egs", "libri", "configs", "gru_ctc_finetune.yaml")
WAVE_FREEZE = 2            # wav2vec's freeze_finetune_updates, cut from 10000
WAVE_STEPS = 3             # optimizer steps of each wave-path training run
# Adam's first update from zero moments at count 3 moves each weight of
# a large gradient by lr * (0.1 / (1 - 0.9^3)) / sqrt(0.001 / (1 - 0.999^3))
FIRST_STEP_AT_3 = (0.1 / (1 - 0.9 ** 3)) / (0.001 / (1 - 0.999 ** 3)) ** 0.5
TOL_WAVE_CPU = 1e-3        # wav2vec f32 logits and gradients, card vs CPU
TOL_WAVE_LOSS = 1e-4       # CPC and GRU-CTC losses, card vs CPU, of their scale
TOL_WAVE_F64 = 1e-6        # GRU-CTC's float64 gradient, card vs CPU, of each leaf's scale
# GRU-CTC's f32 gradient: the card's distance from float64 at most twice
# the CPU's (ROADMAP queue 3 item 39)
TOL_WAVE_F32_RATIO = 2.0


def conv_frames(n: int) -> int:
    """WavConv's output frames for n padded samples."""
    from openasr_torch.models.frontend import WavConv

    for k, s, p in WavConv.LAYERS:
        n = (n + 2 * p - k) // s + 1
    return n


def wave_config(yaml_path, exp, data, model=None, **training) -> str:
    """A wave-path YAML with its model and training sections as they are,
    but for this run's data, one epoch, a log line a batch and the given
    changes."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(data, fetchworker_num=2)
    cfg["training"].update(exp_dir=exp, num_epoch=1, print_inteval=1, **training)
    for section, change in (model or {}).items():
        cfg["model"][section].update(change)
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def wav2vec_launches(module) -> dict:
    """Launches of a wav2vec micro-batch (each LayerNorm forward and
    backward, each attention's dropout forward and its three backward
    kernels) and of a deterministic forward (a dev batch, a decode batch)."""
    n_ln, n_attn = count_layer_norms(module), count_attention(module)
    return {"step": {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                     "flash_attention_fwd_dropout": n_attn, "flash_bwd_stats": n_attn,
                     "flash_attention_bwd_dkv": n_attn, "flash_attention_bwd_dq": n_attn},
            "forward": {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_attn}}


def wave_train_run(tag, argv, main, launches, per=None) -> dict:
    """One training CLI run on the card between counter reads: finite
    losses, WAVE_STEPS optimizer steps, and exactly `per`'s launches a
    micro-batch and a dev forward (the dev pass and the CTC solver's
    sample decode of its first batch), or none at all."""
    from openasr_torch.utils.checkpoint import load_package

    exp = os.path.dirname(argv[0])
    reset_counters()
    t0 = time.time()
    main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    rows = read_metrics(exp)
    tr = [r for r in rows if r["phase"] == "train"]
    cv = [r for r in rows if r["phase"] == "cv"]
    pkg = load_package(os.path.join(exp, "last.pkg"))
    losses = {k: [round(r[k], 4) for r in tr] for k in tr[-1] if k.endswith(("loss", "acc"))}
    print(f"[wave path] {tag}: {len(tr)} micro-batches, {pkg['solver_state']['step']} steps, "
          f"{len(cv)} dev batch(es) in {wall:.2f}s wall; {losses}; launches {n}")
    require(pkg["solver_state"]["step"] == WAVE_STEPS and len(cv) >= 1,
            f"{tag}: {pkg['solver_state']['step']} steps, {len(cv)} dev batches")
    require(all(np.isfinite(v) for r in rows for k, v in r.items() if k.endswith("loss")),
            f"{tag}: a non-finite loss")
    want = {k: 0 for k in n}
    if per is not None:
        for k, c in per["step"].items():
            want[k] += c * len(tr)
        for k, c in per["forward"].items():
            want[k] += c * (len(cv) + 1)
    require(n == want, f"{tag}: launches {n} != {want}")
    launches[("wave train", tag)] = {"total": n, "micro_batches": len(tr), "dev_batches": len(cv),
                                     "per_step": None if per is None else per["step"],
                                     "wall": wall}
    return {"exp": exp, "pkg": os.path.join(exp, "last.pkg"), "wall": wall,
            "micro_batches": len(tr)}


def wave_decode(tag, argv, n_utts, per_batch, launches) -> dict:
    """One infer CLI run on wave manifests between counter reads: a hyp
    line an utterance and `per_batch` launches a decode batch."""
    from openasr_torch.bin import infer

    reset_counters()
    t0 = time.time()
    infer.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    with open(argv[argv.index("--output") + 1], encoding="utf-8") as f:
        lines = [line for line in f if line.strip()]
    batches = (n["layer_norm_fwd"] // per_batch["layer_norm_fwd"]
               if per_batch.get("layer_norm_fwd") else None)
    print(f"[wave path] decode {tag}: {len(lines)} hyps in {wall:.2f}s wall; launches {n}")
    require(len(lines) == n_utts, f"{tag}: {len(lines)} hyp lines for {n_utts} utterances")
    want = {k: per_batch.get(k, 0) * (batches or 0) for k in n}
    require(n == want and (batches is None or batches > 0), f"{tag}: launches {n} != {want}")
    launches[("wave decode", tag)] = n
    return {"wall": wall, "batches": batches}


def wave_batch(waves, utts, rng, n_tokens=(12, 9), vocab_size=4233):
    """The utterances' waves padded as the collate pads them, and CTC
    targets."""
    from openasr_torch.data.collate import gen_causal_targets, quantize

    lengths = np.array([waves[u].shape[0] for u in utts], np.int32)
    x = np.zeros((len(utts), quantize(int(lengths.max()))), np.float32)
    for i, u in enumerate(utts):
        x[i, : lengths[i]] = waves[u]
    toks = [list(rng.randint(3, vocab_size - 1, size=n)) for n in n_tokens[: len(utts)]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=False)
    return {"waves": x, "wave_lengths": lengths, "ids": ids.astype(np.int64),
            "labels": labels, "paddings": paddings}


def check_wav2vec_against_cpu(pkg_path, waves) -> dict:
    """The f32 wav2vec model (wav2vec_ctc.yaml at full width, dropout off)
    on the card against the CPU, TF32 off, on the two shortest utterances
    (at most 1 s of each): the logits of the deterministic forward
    (running statistics), 1e-3 of their largest magnitude; and one
    training forward's gradients (the batch's statistics), against the
    same model in float64 on the CPU: each parameter's error (of its
    largest gradient; a k-projection bias of its weight's) within
    TOL_WAVE_CPU, the card's and the CPU f32 run's (WavConv pads its
    inputs explicitly for the CPU's sake: models/frontend.py).  The CPU
    runs take the card's ReLU decisions (`ReluMasks`, WavConv's ReLUs),
    their flips bounded as rounding ties."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.models.layers import TrainRNG
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg_path)["model"]
    cfg = Config(pkg["configs"])
    cfg.encoder["dropout_rate"] = 0.0
    utts = sorted(waves, key=lambda u: waves[u].shape[0])[:2]
    batch = wave_batch({u: waves[u][:16000] for u in utts}, utts,
                       np.random.RandomState(SEED + 21))
    relus = ReluMasks()
    logits, grads = {}, {}
    for tag, device, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                               ("cpu f64", "cpu", torch.float64)):
        model = get_model_class("wav2vec_ctc").create_model(cfg, device=device)
        model.restore(pkg)
        model.module.to(dtype)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        tb["waves"] = tb["waves"].to(dtype)
        if dtype == torch.float32:
            logits[tag] = model.get_logits(tb["waves"], tb["wave_lengths"])[0].cpu()
        with relus.installed(tag != "cuda"):
            losses = model.loss(tb, TrainRNG(0, device))
        (losses["ctc_loss"] / losses["n_seqs"]).backward()
        grads[tag] = {n: p.grad.detach().cpu().double()
                      for n, p in model.module.named_parameters()}
    scale = float(logits["cpu"].abs().max())
    e_logits = max_err(logits["cuda"], logits["cpu"]) / scale
    direct, direct_name = grad_errs(grads["cuda"], grads["cpu"])
    card = param_errs(grads["cuda"], grads["cpu f64"])
    cpu = param_errs(grads["cpu"], grads["cpu f64"])
    card_name, cpu_name = max(card, key=card.get), max(cpu, key=cpu.get)
    card_err, cpu_err = card[card_name], cpu[cpu_name]
    flip_abs = max((f["flip_abs_rel"] for f in relus.flipped), default=0.0)
    print(f"[wave check] wav2vec f32 card vs CPU, {len(utts)} utts "
          f"{batch['waves'].shape}: logits err {e_logits:.3g} of their max abs (tol "
          f"{TOL_WAVE_CPU}); one training forward's gradients, {len(grads['cpu'])} parameters, "
          f"against float64 on the CPU: the card's worst {card_err:.3g} ({card_name}), the CPU "
          f"f32 run's worst {cpu_err:.3g} ({cpu_name}; tol {TOL_WAVE_CPU} each); card vs CPU "
          f"f32 directly {direct:.3g} "
          f"({direct_name}); {relus.flips} ReLU inputs flipped, the largest |x| at a flip "
          f"{flip_abs:.3g} of its call's largest")
    require(bool(torch.isfinite(logits["cuda"]).all()), "non-finite wav2vec logits on the card")
    require(e_logits <= TOL_WAVE_CPU, "wav2vec logits: card and CPU disagree")
    require(relus.flips <= CIF_RELU_MAX_FLIPS and flip_abs <= CIF_RELU_TIE,
            f"{relus.flips} WavConv ReLU flips, the largest at {flip_abs:.3g}: not rounding ties")
    require(card_err <= TOL_WAVE_CPU and cpu_err <= TOL_WAVE_CPU,
            f"wav2vec gradients against float64: the card's {card_name} {card_err:.3g}, the "
            f"CPU f32 run's {cpu_name} {cpu_err:.3g}")
    return {"logits_err": e_logits, "grad_err": card_err, "grad_err_cpu": cpu_err,
            "grad_err_direct": direct, "relu_flips": relus.flips}


def check_cpc_gru_against_cpu(cpc_pkg, gru_pkg, waves) -> dict:
    """The CPC loss (a training forward: the batch's statistics) at a fixed
    anchor and negatives, and the GRU-CTC CTC loss (deterministic), f32 on
    the card against the CPU on one batch (the three shortest utterances,
    at most 1.5 s of each), TF32 off: each within TOL_WAVE_LOSS of its
    scale."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.models.cpc import draw_anchor
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    utts = sorted(waves, key=lambda u: waves[u].shape[0])[:3]
    batch = wave_batch({u: waves[u][:24000] for u in utts}, utts,
                       np.random.RandomState(SEED + 22), (20, 15, 10))
    out = {}
    for tag, path in (("cpc", cpc_pkg), ("gru_ctc", gru_pkg)):
        pkg = load_package(path)["model"]
        got = {}
        for device in ("cuda", "cpu"):
            model = get_model_class(pkg["model_type"]).create_model(Config(pkg["configs"]),
                                                                   device=device)
            model.restore(pkg)
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            with torch.no_grad():
                if tag == "cpc":
                    t, neg = draw_anchor(tb["wave_lengths"].cpu(), model.module.n_steps,
                                         len(utts), torch.Generator().manual_seed(SEED))
                    acc, loss = model.module(tb["waves"], tb["wave_lengths"], t.to(device),
                                             neg.to(device), train=True)
                    got[device] = (float(loss), float(acc))
                else:
                    got[device] = (float(model.loss(tb)["ctc_loss"]), 0.0)
        err = abs(got["cuda"][0] - got["cpu"][0]) / max(abs(got["cpu"][0]), 1.0)
        print(f"[wave check] {tag} loss f32 card {got['cuda'][0]:.6f} vs CPU "
              f"{got['cpu'][0]:.6f}: err {err:.3g} of its scale (tol {TOL_WAVE_LOSS})"
              + (f"; acc {got['cuda'][1]:.4f} vs {got['cpu'][1]:.4f}" if tag == "cpc" else ""))
        require(np.isfinite(got["cuda"][0]) and err <= TOL_WAVE_LOSS,
                f"{tag} loss: card and CPU disagree")
        out[tag] = err
    return out


def gru_ctc_job(vocab, wave_json) -> dict:
    """The [parallel path]'s GRU-CTC job: libri's gru_ctc_finetune.yaml at
    full width on its wave corpus, two ranks' budget, the f64 "sign"
    rule."""
    return {"tag": "gru_ctc", "yaml": GRU_CTC_YAML, "vocab": vocab,
            "data": {"trainset": wave_json, "devset": wave_json, "vocab_path": vocab},
            "signal": {"feature_type": "wave"}, "ndata": 2, "training": {"batch_time": 400000},
            "f64": "sign"}


GRU_CTC_MODULES = (("splayer convolutions", "splayer.conv"), ("BatchNorms", "splayer.bn"),
                   ("GRU", "encoder.gru"), ("fc", "fc."))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def gru_ctc_precision(job, device) -> dict:
    """GRU-CTC's step-1 gradient on `device` in f32 against float64 (the
    CTC loss in float64 too), TF32 off: the [parallel path]'s one-rank
    first batch and seeded weights, dropout 0, a training forward (the
    batch's statistics).  -> each leaf's distance of the f32 gradient from
    the float64 one (`floor_grad_errs`), their largest by module, and each
    op's own: the op in f32 fed the float64 run's input and output
    cotangent, its input and weight gradients against the float64 run's
    (`rel_err`).  The ops: the splayer's five convolutions and BatchNorms,
    the two GRU layers, the fc head and the CTC loss (its logits'
    gradient)."""
    import copy

    from openasr_torch.models import get_model_class
    from openasr_torch.models.layers import TrainRNG
    from openasr_torch.models.speech import target_lengths_of
    from openasr_torch.ops.losses import cal_ctc_loss
    from openasr_torch.solvers import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model_cfg, training = job_config(job)
    batch = job_batches(job, data, model_cfg, training)[0]
    grads, losses, seen = {}, {}, {}

    def recorder(name):
        def hook(mod, args, out):
            if args[0].requires_grad:
                args[0].retain_grad()
            out.retain_grad()
            seen[name] = (mod, args[0], out, args[1:])
        return hook

    for dtype in (torch.float32, torch.float64):
        model = get_model_class(model_cfg["type"]).create_model(
            model_cfg, device=device, generator=torch.Generator().manual_seed(SEED))
        model.module.to(dtype)
        tb = batch_to_device(batch, torch.device(device))
        tb["waves"] = tb["waves"].to(dtype)
        hooks = ([m.register_forward_hook(recorder(n)) for n, m in model.module.named_modules()
                  if n.startswith(("splayer.conv", "splayer.bn", "encoder.gru", "fc"))]
                 if dtype == torch.float64 else [])
        out = model.loss(tb, TrainRNG(0, device))
        (out["ctc_loss"] / out["n_seqs"]).backward()
        for h in hooks:
            h.remove()
        losses[dtype] = float(out["ctc_loss"])
        grads[dtype] = {n: p.grad.double().cpu().numpy()
                        for n, p in model.module.named_parameters()}
    leaf = floor_grad_errs(grads[torch.float32], grads[torch.float64])
    modules = {name: max(v for k, v in leaf.items() if k.startswith(prefix))
               for name, prefix in GRU_CTC_MODULES}
    ops = {}
    for name, (mod, x, y, rest) in seen.items():
        m32 = copy.deepcopy(mod).float()
        for p in m32.parameters():
            p.grad = None
        x32 = x.detach().float().requires_grad_(x.requires_grad)
        m32(x32, *rest).backward(y.grad.float())
        ops[name] = {**({"input": rel_err(x32.grad, x.grad)} if x.requires_grad else {}),
                     **{k: rel_err(p.grad, mod.get_parameter(k).grad)
                        for k, p in m32.named_parameters()}}
    logits = seen["fc"][2]
    lg = logits.detach().float().requires_grad_()
    n_seqs = float(tb["ids"].shape[0])
    (cal_ctc_loss(lg, tb["wave_lengths"] // 160, tb["labels"], target_lengths_of(tb["paddings"]))
     / n_seqs).backward()
    ops["ctc loss"] = {"logits": rel_err(lg.grad, logits.grad)}
    modules["CTC loss (op)"] = ops["ctc loss"]["logits"]
    worst_op = max(((o, k) for o, e in ops.items() for k in e), key=lambda ok: ops[ok[0]][ok[1]])
    return {"leaf": leaf, "worst_leaf": max(leaf, key=leaf.get), "modules": modules, "ops": ops,
            "worst_op": worst_op, "losses": losses, "grads64": grads[torch.float64],
            "shape": list(batch["waves"].shape)}


def check_gru_ctc_precision(cpu) -> dict:
    """Queue 3 item 39 on the card: `gru_ctc_precision` on the card beside
    the CPU's (`cpu`, computed while the kernels built), printed leaf by
    leaf, by module and op by op; the card's float64 gradient held to the
    CPU's (TOL_WAVE_F64 of each leaf's scale), and the card's f32 no
    farther from float64 than the CPU's f32, within TOL_WAVE_F32_RATIO."""
    card = gru_ctc_precision(cpu["job"], "cuda")
    f64 = floor_grad_errs(card["grads64"], cpu["grads64"])
    f64_leaf = max(f64, key=f64.get)
    print(f"[wave check] gru_ctc step-1 gradient (the [parallel path]'s first batch "
          f"{card['shape']}, loss f32 {card['losses'][torch.float32]:.4f} vs float64 "
          f"{card['losses'][torch.float64]:.4f} on the card): float64 card vs CPU "
          f"{f64[f64_leaf]:.3g} ({f64_leaf}; tol {TOL_WAVE_F64})")
    for where, r in (("card", card), ("CPU", cpu)):
        print(f"[wave check] gru_ctc f32 vs float64 on the {where}: worst leaf "
              f"{r['leaf'][r['worst_leaf']]:.3g} ({r['worst_leaf']}); by module " + ", ".join(
                  f"{k} {v:.3g}" for k, v in r["modules"].items())
              + f"; worst op {r['worst_op'][0]} ({r['worst_op'][1]} "
                f"{r['ops'][r['worst_op'][0]][r['worst_op'][1]]:.3g})")
        print(f"[wave check] gru_ctc leaves on the {where}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in r["leaf"].items()))
        print(f"[wave check] gru_ctc ops on the {where} (each op's f32 backward fed the float64 "
              f"run's input and output cotangent): " + "; ".join(
                  f"{o} " + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                  for o, e in r["ops"].items()))
    ratio = card["leaf"][card["worst_leaf"]] / cpu["leaf"][cpu["worst_leaf"]]
    print(f"[wave check] gru_ctc: the card's f32 sits {ratio:.3g} x the CPU's f32 distance from "
          f"float64 (tol {TOL_WAVE_F32_RATIO})")
    require(f64[f64_leaf] <= TOL_WAVE_F64, "gru_ctc float64 gradients: card and CPU disagree")
    require(ratio <= TOL_WAVE_F32_RATIO, "gru_ctc f32 gradient: the card rounds worse than the CPU")
    return {"card": {k: card[k] for k in ("worst_leaf", "modules", "worst_op")},
            "card_err": card["leaf"][card["worst_leaf"]],
            "cpu_err": cpu["leaf"][cpu["worst_leaf"]], "f64_err": f64[f64_leaf], "ratio": ratio}


def wave_train_shape(train_json) -> dict:
    """The wav2vec training path's largest batch by attention work (B T'^2):
    B, T' (WavConv frames of the padded samples) and the frame counts."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import SpeechDataset
    from openasr_torch.data.sampler import TimeBasedSampler

    ds = SpeechDataset(train_json, feat_range=(4000, 480000), label_range=(1, 100))
    best = None
    for batch in TimeBasedSampler(ds, 1600000).batches:
        lens = np.array([ds[i]["feat_length"] for i in batch])
        t = conv_frames(quantize(int(lens.max())))
        if best is None or len(batch) * t * t > best["b"] * best["t"] ** 2:
            best = {"b": len(batch), "t": t, "enc_lens": lens // 160}
    return best


def phase_wave(vocab, chars, launches, gru_cpu) -> dict:
    """The raw-wave families on the card (`[wave path]`, see the module
    docstring); counters reset just before each run and read just after."""
    import yaml

    from openasr_torch.bin import train, train_cpc
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.ops.schedules import get_schedule
    from openasr_torch.utils.checkpoint import load_package

    rng = np.random.RandomState(SEED + 20)
    # 6 micro-batches of batch_time 1600000 (3 steps at accumulate_grad_batch
    # 2), the last two holding the three utterances of 25-30 s (T' >= 2500)
    lengths = np.concatenate([rng.randint(400000, 480001, 3), rng.randint(120000, 300001, 34),
                              rng.randint(4000, 60001, 8)])
    train_json, train_waves = write_wave_corpus("w2vtrain", rng, chars, len(lengths), None,
                                                (5, 20), lengths=lengths)
    dev_json, _ = write_wave_corpus("w2vdev", rng, chars, 4, (4000, 160000), (5, 20))
    test_json, test_waves = write_wave_corpus("w2vtest", rng, chars, 8, (4000, 480000),
                                              (5, 20))
    require(sum(int(n) >= 400000 for n in lengths) >= 3, "fewer than 3 utterances of T' >= 2500")
    with open(WAV2VEC_YAML) as f:
        w2v_cfg = yaml.safe_load(f)["model"]
    w2v_cfg["decoder"]["vocab_size"] = 4233
    w2v_cfg["encoder"]["freeze_finetune_updates"] = WAVE_FREEZE
    with torch.device("meta"):
        per = wav2vec_launches(get_model_class("wav2vec_ctc").build_module(Config(w2v_cfg)))
    print(f"[wave path] wav2vec_ctc.yaml at full width; cuts: {WAVE_STEPS} optimizer steps "
          f"(one epoch of 6 micro-batches, accumulate_grad_batch 2), freeze_finetune_updates "
          f"10000 -> {WAVE_FREEZE}; {len(lengths)} train utterances of "
          f"{int(lengths.min())}-{int(lengths.max())} samples; launches a micro-batch "
          f"{per['step']}, a forward {per['forward']}")
    data = {"trainset": train_json, "devset": dev_json, "vocab_path": vocab}
    runs = {}
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        cfg = wave_config(WAV2VEC_YAML, os.path.join(WORK, f"exp_w2v_{name}"), data,
                          {"encoder": {"freeze_finetune_updates": WAVE_FREEZE}},
                          compute_dtype=name)
        runs[name] = wave_train_run(f"wav2vec {name}", [cfg], train.main, launches, per)

    # the gate: the encoder moved in step 3 alone, fc in every step
    pkg = load_package(runs["float32"]["pkg"])
    state = pkg["optim_state"]
    require(state["gate_count"] == state["count"] == WAVE_STEPS,
            f"gate count {state['gate_count']}, Adam count {state['count']}")
    init = get_model_class("wav2vec_ctc").create_model(
        pkg["model"]["configs"], device="cpu",
        generator=torch.Generator().manual_seed(0)).package()["components"]
    # the lr of the update that takes Adam's count from 2 to 3
    solver_cfg = pkg["solver_config"]
    lr = float(solver_cfg["init_lr"]) * float(get_schedule(solver_cfg["lr_scheduler"])(WAVE_STEPS))
    # weights below 1/16 in magnitude: their f32 spacing (<= 3.8e-9) is
    # fine against the step (about 1.2e-7)
    moved = {k: largest_move(pkg["model"]["components"][k], init[k], 1 / 16)
             for k in ("encoder", "fc")}
    ratio = moved["encoder"] / (lr * FIRST_STEP_AT_3)
    print(f"[wave path] freeze gate: gate count {state['gate_count']}; the encoder's largest "
          f"move {moved['encoder']:.4g} = {ratio:.3f} x one first Adam step at count 3 "
          f"(lr {lr:.4g}; a move in steps 1-3 would be about 1.6 x), fc's {moved['fc']:.4g}")
    require(0.9 <= ratio <= 1.1, "the encoder did not move by exactly one first Adam step: "
            "it moved before the gate opened, or not at step 3")

    n_test = len(test_waves)
    decodes = {}
    base = ["--model_type", "wav2vec_ctc", "--model_pkg", runs["float32"]["pkg"],
            "--vocab_path", vocab, "--json_file", test_json, "--add_blk",
            "--batch_frames", "1600000"]
    for tag, extra in (("greedy", []), (f"device beam {CTC_BEAM}",
                                        ["--ctc_beam", str(CTC_BEAM), "--ctc_beam_device"])):
        hyp = os.path.join(WORK, f"hyp_w2v_{tag.replace(' ', '_')}.txt")
        decodes[tag] = wave_decode(f"wav2vec {tag}", base + extra + ["--output", hyp],
                                   n_test, per["forward"], launches)
    check = check_wav2vec_against_cpu(runs["float32"]["pkg"], train_waves)

    # CPC -> GRU-CTC: 3 batches of 1600000 for CPC, 3 of 800000 for GRU-CTC
    rng = np.random.RandomState(SEED + 21)
    cpc_lengths = rng.randint(20000, 240001, 34)
    cpc_json, _ = write_wave_corpus("cpctrain", rng, chars, len(cpc_lengths), None, (5, 30),
                                    lengths=cpc_lengths)
    with open(cpc_json, encoding="utf-8") as f:
        rows = json.load(f)
    gru_json = os.path.join(WORK, "grutrain.json")
    with open(gru_json, "w", encoding="utf-8") as f:
        json.dump(rows[:17], f, ensure_ascii=False)
    cpc_dev, _ = write_wave_corpus("cpcdev", rng, chars, 4, (20000, 240000), (5, 30))
    cpc_test, cpc_waves = write_wave_corpus("cpctest", rng, chars, 8, (20000, 240000), (5, 30))
    cpc_cfg = wave_config(CPC_YAML, os.path.join(WORK, "exp_cpc"),
                          {"trainset": cpc_json, "devset": cpc_dev})
    cpc = wave_train_run("cpc pretrain", [cpc_cfg, "--type", "pretrain"], train_cpc.main,
                         launches)
    gru_cfg = wave_config(GRU_CTC_YAML, os.path.join(WORK, "exp_gru"),
                          {"trainset": gru_json, "devset": cpc_dev, "vocab_path": vocab},
                          load_splayer=cpc["pkg"])
    gru = wave_train_run("gru_ctc finetune", [gru_cfg, "--type", "finetune"], train_cpc.main,
                         launches)
    before = load_package(cpc["pkg"])["model"]["components"]["splayer"]
    after = load_package(gru["pkg"])["model"]["components"]["splayer"]
    same = largest_move(after, before) == 0.0
    print(f"[wave path] gru_ctc's splayer after {WAVE_STEPS} finetune steps equals the CPC "
          f"package's: {same}")
    require(same, "the frozen splayer changed in the finetune")
    for tag, extra in (("greedy", []), (f"host beam {CTC_BEAM}", ["--ctc_beam", str(CTC_BEAM)])):
        hyp = os.path.join(WORK, f"hyp_gru_{tag.replace(' ', '_')}.txt")
        decodes[f"gru_ctc {tag}"] = wave_decode(
            f"gru_ctc {tag}", ["--model_type", "gru_ctc", "--model_pkg", gru["pkg"],
                               "--vocab_path", vocab, "--json_file", cpc_test, "--add_blk",
                               "--batch_frames", "800000", "--output", hyp] + extra,
            len(cpc_waves), {}, launches)
    losses = check_cpc_gru_against_cpu(cpc["pkg"], gru["pkg"], cpc_waves)
    precision = check_gru_ctc_precision(gru_ctc_cpu_result(gru_cpu))
    return {"runs": runs, "cpc": cpc, "gru": gru, "decodes": decodes, "check": check,
            "losses": losses, "precision": precision, "train_json": train_json, "per": per,
            "gate_ratio": ratio}


def largest_move(after, before, below=None) -> float:
    """The largest |after - before| over two trees' leaves (only where
    |before| < `below`, when given)."""
    old = dict(leaves(before))
    out = 0.0
    for name, a in leaves(after):
        d = np.abs(a.astype(np.float64) - old[name])
        if below is not None:
            d = d[np.abs(old[name]) < below]
        if d.size:
            out = max(out, float(d.max()))
    return out


def wave_rows(wave, errs, launches):
    """Rows 4w and 5+6w: the attention forward (dropout 0.1) and the whole
    backward at the wav2vec training run's largest batch [B, T' up to
    3000, 8, 64] with its key lengths, each held to its plain version
    there and timed beside SDPA with the same key-length mask; rows 5sw,
    5w and 6w, the backward's three kernels alone there (`split_bwd_rows`,
    warm L2); their launches from the run."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    shape = wave_train_shape(wave["train_json"])
    b, t, lens = shape["b"], shape["t"], shape["enc_lens"]
    print(f"[wave rows] the wav2vec training path's largest batch: B {b}, T' {t}, frames "
          f"{lens.tolist()}")
    require(t >= 2500, f"the largest wav2vec batch has T' {t} < 2500")
    rng = np.random.RandomState(SEED + 23)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        tr = launches[("wave train", f"wav2vec {name}")]
        common = {"launches_per_micro_batch": tr["per_step"]["flash_attention_fwd_dropout"]}
        row = attention_fwd_row(b, 8, 64, t, t, False, lens, dtype, rng, errs, DROPOUT)
        rows.append({"name": f"flash_attention_fwd_dropout_wav2vec[{name}]", **row, **common,
                     "launches": tr["total"]["flash_attention_fwd_dropout"],
                     "launches_are": "dropout forward calls of the wav2vec training run",
                     "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, its own "
                                   "Philox mask, a bool key-padding mask)",
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype]})
        at = attention_bwd_times(b, 8, 64, t, t, False, lens, dtype, rng, cold=False)
        args = at["kernel_args"][:6] + at["kernel_args"][7:]
        got, want = flash_attention_bwd(*args), flash_attention_bwd_reference(*args)
        err = (0.0, 0.0)
        for g, w in zip(got, want):
            e, scale = scaled_err(g, w)
            err = (max(err[0], e), max(err[1], e / scale))
        del got, want
        torch.cuda.empty_cache()
        print(f"[wave rows] flash backward {name} [{b}, {t}, {t}, 8, 64] with key lengths, "
              f"dropout 0.1: err {err[0]:.3g}, scaled {err[1]:.3g} (tol {TOL_FLASH_BWD[dtype]})")
        require(err[1] <= TOL_FLASH_BWD[dtype], "the backward disagrees at the wav2vec shape")
        rows.append({
            "name": f"flash_attention_bwd_wav2vec[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"], **common,
            "launches": tr["total"]["flash_attention_bwd_dkv"],
            "launches_are": "backward calls of the wav2vec training run, each launching "
                            "statistics, dK/dV and dQ once",
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, a bool key-padding "
                          "mask) forward + backward minus forward (graph replay)",
        })
        rows += split_bwd_rows(
            at, "_wav2vec", dtype, errs,
            lambda k: {"launches": tr["total"][k], "launches_per_micro_batch": tr["per_step"][k]},
            {k: v for k, v in BWD_NOTES.items() if k != "cold_is"}, cold=False)
        del at
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- text path

IPA2CHAR = os.path.join(ROOT, "egs", "IPA2char")
TEXT_YAMLS = {name: os.path.join(IPA2CHAR, "configs", f"{stem}.yaml") for name, stem in (
    ("Embed_Decoder_CTC", "callhome_ma_IPA"), ("Embed_Decoder", "IPA2char"),
    ("gan_phone2char", "semi_callhome_ma_IPA"))}
TEXT_VOCABS = {"vocab_phone": os.path.join(IPA2CHAR, "data", "callhome.IPA"),
               "vocab_char": os.path.join(IPA2CHAR, "data", "vocab.char")}
TEXT_STEPS = 3             # optimizer steps of each text-path training run
TEXT_BEAM, TEXT_MAXLEN = 5, 80
TOL_TEXT_CPU = 1e-3        # f32 logits, losses and gradients, card vs CPU, of their scale


def text_units(path) -> list:
    with open(path, encoding="utf-8") as f:
        return [line.split()[0] for line in f if line.strip()]


def write_text_pairs(name, rng, phones, chars, n=None, total_phones=None) -> str:
    """Phone->char pairs of 20-120 phones and 8-50 characters, at least 2
    phones a character (the rate_in_out filter): n of them, or as many as
    reach `total_phones`."""
    rows, total = [], 0
    while (n is not None and len(rows) < n) or (n is None and total < total_phones):
        n_c = rng.randint(8, 51)
        n_p = rng.randint(max(20, 2 * n_c), 121)
        rows.append({"uttid": f"{name}{len(rows):05d}",
                     "phones": " ".join(rng.choice(phones, n_p)), "phone_length": int(n_p),
                     "tokens": " ".join(rng.choice(chars, n_c)), "token_length": int(n_c)})
        total += n_p
    path = os.path.join(WORK, f"{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return path


def text_training(model_type) -> dict:
    import yaml

    with open(TEXT_YAMLS[model_type]) as f:
        return yaml.safe_load(f)["training"]


def text_config(model_type, exp, data, **training) -> str:
    """The text YAML of `model_type` with its model and training sections as
    they are, but for this run's data, one epoch and a log line a batch."""
    import yaml

    with open(TEXT_YAMLS[model_type]) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(data, **TEXT_VOCABS)
    cfg["training"].update(exp_dir=exp, num_epoch=1, print_inteval=1, **training)
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return path


def text_model_cfg(model_type) -> dict:
    """The YAML's model section with the vocabularies' sizes, as the CLIs
    set them."""
    import yaml

    from openasr_torch.data.tokenizer import CharTokenizer

    with open(TEXT_YAMLS[model_type]) as f:
        cfg = yaml.safe_load(f)["model"]
    n_phone = CharTokenizer(TEXT_VOCABS["vocab_phone"]).unit_num()
    n_char = CharTokenizer(TEXT_VOCABS["vocab_char"], add_blk=cfg.get("add_blk", False)).unit_num()
    g = cfg["G"] if "G" in cfg else cfg
    g["encoder"]["vocab_size"], g["decoder"]["vocab_size"] = n_phone, n_char
    if "D" in cfg:
        cfg["D"]["encoder"]["d_input"] = n_char
    return cfg


def text_launches(model_type) -> dict:
    """Launches of a training micro-batch (or GAN iteration) and of a
    deterministic forward, counted from the built module: each LayerNorm
    and attention of the stack once a forward, each backward once.  A GAN
    iteration runs G three times: the supervised and the G term with
    dropout and backward, the D term in eval mode without gradient."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class

    with torch.device("meta"):
        module = get_model_class(model_type).build_module(Config(text_model_cfg(model_type)))
    stack = module.G if model_type == "gan_phone2char" else module
    n_ln, n_attn = count_layer_norms(stack), count_attention(stack)
    train = 2 if model_type == "gan_phone2char" else 1
    step = {"layer_norm_fwd": train * n_ln, "layer_norm_bwd": train * n_ln,
            "flash_attention_fwd_dropout": train * n_attn, "flash_bwd_stats": train * n_attn,
            "flash_attention_bwd_dkv": train * n_attn, "flash_attention_bwd_dq": train * n_attn}
    if model_type == "gan_phone2char":
        step.update(layer_norm_fwd=3 * n_ln, flash_attention_fwd=n_attn)
    return {"step": step, "forward": {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_attn}}


def text_train_run(model_type, argv, main, launches, micro_batches=None) -> dict:
    """One phone2char training CLI run on the card between counter reads:
    TEXT_STEPS optimizer steps, finite losses, a dev pass (with its
    dev_wer for the CTC models), and exactly the module-counted launches:
    a micro-batch's (an iteration's for the GAN, `micro_batches` of them)
    and a forward's for each dev batch, twice for the CTC models (the dev
    loss, then the greedy decode of the dev WER)."""
    from openasr_torch.utils.checkpoint import load_package

    per = text_launches(model_type)
    exp = os.path.dirname(argv[0])
    reset_counters()
    t0 = time.time()
    main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    rows = read_metrics(exp)
    tr = [r for r in rows if r["phase"] == "train"]
    cv = [r for r in rows if r["phase"] == "cv" and "batch" in r]
    wers = [r["dev_wer"] for r in rows if "dev_wer" in r]
    epoch = [r for r in rows if r["phase"] == "epoch"]
    pkg = load_package(os.path.join(exp, "last.pkg"))
    micro = len(tr) if micro_batches is None else micro_batches
    ctc = model_type != "Embed_Decoder"
    losses = {k: [round(r[k], 4) for r in tr] for k in (tr[-1] if tr else {})
              if k.endswith("loss")}
    print(f"[text path] {model_type}: {micro} micro-batches, {pkg['solver_state']['step']} "
          f"steps, {len(cv)} dev batch(es), dev WER {wers}, tr_loss "
          f"{[round(r['tr_loss'], 4) for r in epoch]} in {wall:.2f}s wall; {losses}; launches "
          f"{n}; a micro-batch {per['step']}, a forward {per['forward']}")
    require(pkg["solver_state"]["step"] == TEXT_STEPS and len(cv) >= 1 and len(epoch) == 1,
            f"{model_type}: {pkg['solver_state']['step']} steps, {len(cv)} dev batches")
    require(len(wers) == (1 if ctc else 0) and all(0.0 <= w for w in wers),
            f"{model_type}: dev WER records {wers}")
    require(all(np.isfinite(v) for r in rows for k, v in r.items() if k.endswith("loss")),
            f"{model_type}: a non-finite loss")
    want = {k: per["step"].get(k, 0) * micro + per["forward"].get(k, 0) * len(cv)
            * (2 if ctc else 1) for k in n}
    require(n == want, f"{model_type}: launches {n} != {want}")
    launches[("text train", model_type)] = {"total": n, "micro_batches": micro,
                                            "dev_batches": len(cv), "per_step": per["step"],
                                            "wall": wall}
    return {"pkg": os.path.join(exp, "last.pkg"), "wall": wall, "micro_batches": micro,
            "dev_wer": wers, "per": per}


def text_decode(model_type, pkg, test_json, n_utts, extra, launches) -> dict:
    """infer_phone2char on the card between counter reads: a hyp and a ref
    line an utterance, the `WER:` line, and a forward's launches a batch
    (greedy), or the decoder's LayerNorms once a beam step and no
    attention kernel (the beam attends to its caches densely)."""
    import io

    from openasr_torch.bin import infer_phone2char

    out_dir = os.path.join(WORK, f"decode_{model_type}")
    argv = ["--model_type", model_type, "--model_pkg", pkg, "--json_file", test_json,
            "--output_dir", out_dir, "--vocab_phone", TEXT_VOCABS["vocab_phone"],
            "--vocab_char", TEXT_VOCABS["vocab_char"], "--device", "cuda"] + extra
    reset_counters()
    stdout = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(stdout):
        infer_phone2char.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = read_counters()
    last = stdout.getvalue().strip().splitlines()[-1]
    hyps, refs = ([line for line in open(os.path.join(out_dir, name), encoding="utf-8")
                   if line.strip()] for name in ("hyp.txt", "ref.txt"))
    per = text_launches(model_type)["forward"]
    if model_type == "Embed_Decoder":
        per = {"layer_norm_fwd": per["layer_norm_fwd"]}  # the decoder's, once a beam step
    steps = n["layer_norm_fwd"] // per["layer_norm_fwd"]
    want = {k: per.get(k, 0) * steps for k in n}
    unit = "beam steps" if model_type == "Embed_Decoder" else "batches"
    print(f"[text path] decode {model_type} {' '.join(extra)}: {len(hyps)} hyps, '{last}' in "
          f"{wall:.2f}s wall; launches {n} ({steps} {unit})")
    require(len(hyps) == len(refs) == n_utts, f"{model_type}: {len(hyps)} hyp lines for {n_utts}")
    require(last.startswith("WER: "), f"{model_type}: no WER line: {last!r}")
    require(steps > 0 and n == want, f"{model_type} decode: launches {n} != {want}")
    launches[("text decode", model_type)] = n
    return {"wall": wall, "wer": last, "steps": steps}


def text_batch(test_json, n, add_blk, add_eos) -> dict:
    """The `n` shortest pairs of a manifest, collated as the CLIs do."""
    from openasr_torch.data.collate import PhoneCharCollate
    from openasr_torch.data.tokenizer import CharTokenizer

    with open(test_json, encoding="utf-8") as f:
        rows = sorted(json.load(f), key=lambda r: r["phone_length"])[:n]
    collate = PhoneCharCollate(CharTokenizer(TEXT_VOCABS["vocab_phone"]),
                               CharTokenizer(TEXT_VOCABS["vocab_char"], add_blk=add_blk), add_eos)
    return {k: v for k, v in collate(rows).items() if isinstance(v, np.ndarray)}


def text_models(pkg_path, device):
    """The package's model on `device` (f32), dropout off."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(pkg_path)["model"]
    cfg = Config(pkg["configs"])
    (cfg.G or cfg).decoder["dropout_rate"] = 0.0
    model = get_model_class(pkg["model_type"]).create_model(cfg, device=device)
    model.restore(pkg)
    return model


def check_text_against_cpu(runs, test_json, unpaired) -> dict:
    """f32 on the card against the CPU, TF32 off, dropout off, on the two
    shortest test pairs: Embed_Decoder_CTC's logits and one training
    forward's gradients; Embed_Decoder's beam (TEXT_BEAM, TEXT_MAXLEN): the
    1-best scores, and the share of equal n-best lists reported; the GAN's
    three losses (at a fixed alpha) and one step's gradients, D's with the
    penalty's second-order term, the CPU at the card's ReLU decisions (D's
    ConvV2 ReLUs sit above G's attention layers; `ReluMasks`), the flips
    bounded as rounding ties.  Each within TOL_TEXT_CPU of its scale (a
    gradient of its parameter's largest; a key bias of its weight's)."""
    from openasr_torch.data.collate import TokenCollate
    from openasr_torch.data.tokenizer import CharTokenizer
    from openasr_torch.models.layers import TrainRNG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    batch = text_batch(test_json, 2, True, False)
    logits, grads = {}, {}
    for device in ("cuda", "cpu"):
        model = text_models(runs["Embed_Decoder_CTC"]["pkg"], device)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        logits[device] = model.get_logits(tb["phones"], tb["phone_lengths"])[0].cpu()
        losses = model.loss(tb, TrainRNG(0, device), empty_rows=False)
        (losses["ctc_loss"] / losses["n_tokens"]).backward()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
    out["ctc_logits"] = max_err(logits["cuda"], logits["cpu"]) / max(
        float(logits["cpu"].abs().max()), 1.0)
    out["ctc_grads"], ctc_worst = grad_errs(grads["cuda"], grads["cpu"])

    batch = text_batch(test_json, 2, False, True)
    beams = {}
    for device in ("cuda", "cpu"):
        model = text_models(runs["Embed_Decoder"]["pkg"], device)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        beams[device] = [x.cpu() for x in model.batch_beam_decode(
            tb["phones"], tb["phone_lengths"], TEXT_BEAM, TEXT_MAXLEN)]
    (pg, lg, sg), (pc, lc, sc) = beams["cuda"], beams["cpu"]
    out["beam_scores"] = float(((sg[:, 0] - sc[:, 0]).abs()
                                / sc[:, 0].abs().clamp(min=1.0)).max())
    same = [bool(torch.equal(pg[i], pc[i]) and torch.equal(lg[i], lc[i]))
            for i in range(pg.shape[0])]
    out["beam_same_nbest"] = sum(same) / len(same)

    batch = text_batch(test_json, 2, True, False)
    for key, path, tokenizer in (("unpaired_phones", unpaired[0], TEXT_VOCABS["vocab_phone"]),
                                 ("unpaired_text", unpaired[1], TEXT_VOCABS["vocab_char"])):
        with open(path, encoding="utf-8") as f:
            lines = sorted((line.split(maxsplit=1)[1] for line in f),
                           key=lambda t: len(t.split()))[:2]
        tok = TokenCollate(CharTokenizer(tokenizer, add_blk=key == "unpaired_text"))(lines)
        batch[key], batch[key + "_lengths"] = tok["tokens"], tok["token_lengths"]
    alpha = torch.tensor([0.25, 0.75]).reshape(2, 1, 1)
    relus = ReluMasks()
    gan_losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        model = text_models(runs["gan_phone2char"]["pkg"], device)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with relus.installed(device != "cuda"):
            losses = model.loss(tb, TrainRNG(0, device), empty_rows=False, alpha=alpha)
            (losses["ctc_loss"] / losses["n_tokens"] + losses["g_loss"]
             + losses["d_loss"]).backward()
        gan_losses[device] = {k: float(losses[k].detach()) for k in ("ctc_loss", "g_loss", "d_loss")}
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
    out["gan_losses"] = max(abs(gan_losses["cuda"][k] - v) / max(abs(v), 1.0)
                            for k, v in gan_losses["cpu"].items())
    out["gan_grads"], gan_worst = grad_errs(grads["cuda"], grads["cpu"])
    out["relu_flips"] = relus.flips
    flip_abs = max((f["flip_abs_rel"] for f in relus.flipped), default=0.0)
    print(f"[text check] f32 card vs CPU, 2 pairs: Embed_Decoder_CTC logits "
          f"{out['ctc_logits']:.3g}, gradients {out['ctc_grads']:.3g} ({ctc_worst}); "
          f"Embed_Decoder beam {TEXT_BEAM} x {TEXT_MAXLEN}: 1-best scores {out['beam_scores']:.3g} "
          f"of their scale ({sg[:, 0].tolist()} vs {sc[:, 0].tolist()}), equal n-best lists "
          f"{out['beam_same_nbest']:.2f}; GAN losses {gan_losses['cuda']} vs "
          f"{gan_losses['cpu']}: {out['gan_losses']:.3g}, gradients {out['gan_grads']:.3g} "
          f"({gan_worst}), {relus.flips} ReLU inputs flipped, the largest |x| at a flip "
          f"{flip_abs:.3g} of its call's largest (tol {TOL_TEXT_CPU})")
    for key in ("ctc_logits", "ctc_grads", "beam_scores", "gan_losses", "gan_grads"):
        require(out[key] <= TOL_TEXT_CPU, f"text check {key}: card and CPU disagree ({out[key]:.3g})")
    require(relus.flips <= CIF_RELU_MAX_FLIPS and flip_abs <= CIF_RELU_TIE,
            f"{relus.flips} D ReLU flips, the largest at {flip_abs:.3g}: not rounding ties")
    return out


def phase_text(launches) -> dict:
    """The text families on the card (`[text path]`, see the module
    docstring); counters reset just before each run and read just after."""
    from openasr_torch.bin import semi_train_phone2char, train_phone2char
    from openasr_torch.data.manifest import PhoneCharDataset
    from openasr_torch.data.sampler import BudgetBatchSampler

    rng = np.random.RandomState(SEED + 30)
    phones, chars = text_units(TEXT_VOCABS["vocab_phone"]), text_units(TEXT_VOCABS["vocab_char"])
    ctc_cfg, gan_cfg = text_training("Embed_Decoder_CTC"), text_training("gan_phone2char")
    budget, accum = int(ctc_cfg["batch_phones"]), int(ctc_cfg["accumulate_grad_batch"])
    # about accum * (TEXT_STEPS - 0.3) micro-batches: TEXT_STEPS steps
    train_json = write_text_pairs("p2c_train", rng, phones, chars,
                                  total_phones=int(budget * accum * (TEXT_STEPS - 0.3)))
    dev_json = write_text_pairs("p2c_dev", rng, phones, chars, n=16)
    test_json = write_text_pairs("p2c_test", rng, phones, chars, n=16)
    unpaired_bs = int(gan_cfg.get("unpaired_batch_size", 16))  # the semi CLI's default
    n_unpaired = int(gan_cfg["accumulate_grad_batch"]) * TEXT_STEPS * unpaired_bs
    unpaired = (
        write_text("p2c_unpaired_phone", [
            f"up{i} " + " ".join(rng.choice(phones, rng.randint(20, 121)))
            for i in range(n_unpaired)]),
        write_text("p2c_unpaired_text", [
            f"ut{i} " + " ".join(rng.choice(chars, rng.randint(8, 51))) for i in range(64)]))
    train_set = PhoneCharDataset(train_json, feat_range=(1, 1000), label_range=(1, 120))
    n_batches = len(BudgetBatchSampler(train_set, budget, key="phone_length"))
    print(f"[text path] at full width, f32, from the YAMLs as they are (vocabularies "
          f"callhome.IPA {len(phones)} and vocab.char {len(chars)}); cuts: one epoch of "
          f"{TEXT_STEPS} optimizer steps each ({len(train_set)} train pairs of 20-120 phones and "
          f"8-50 characters: {n_batches} micro-batches of batch_phones {budget} at "
          f"accumulate_grad_batch {accum}; the GAN {n_unpaired} unpaired phone lines, "
          f"{n_unpaired // unpaired_bs} iterations), a dev set of 16 pairs, 16 test pairs")
    require(accum * (TEXT_STEPS - 1) < n_batches <= accum * TEXT_STEPS,
            f"{n_batches} micro-batches do not make {TEXT_STEPS} steps")
    data = {"trainset": train_json, "devset": dev_json}
    runs = {}
    for model_type in ("Embed_Decoder_CTC", "Embed_Decoder"):
        cfg = text_config(model_type, os.path.join(WORK, f"exp_{model_type}"), data)
        runs[model_type] = text_train_run(model_type, [cfg], train_phone2char.main, launches)
    cfg = text_config("gan_phone2char", os.path.join(WORK, "exp_gan"),
                      dict(data, unpaired_phone=unpaired[0], unpaired_text=unpaired[1]),
                      G_path=runs["Embed_Decoder_CTC"]["pkg"])
    runs["gan_phone2char"] = text_train_run("gan_phone2char", [cfg], semi_train_phone2char.main,
                                            launches, micro_batches=n_unpaired // unpaired_bs)
    decodes = {
        "greedy": text_decode("Embed_Decoder_CTC", runs["Embed_Decoder_CTC"]["pkg"], test_json,
                              16, ["--add_blk"], launches),
        f"beam {TEXT_BEAM}": text_decode("Embed_Decoder", runs["Embed_Decoder"]["pkg"],
                                         test_json, 16, ["--nbest", str(TEXT_BEAM), "--maxlen",
                                                         str(TEXT_MAXLEN)], launches),
    }
    check = check_text_against_cpu(runs, test_json, unpaired)
    return {"runs": runs, "decodes": decodes, "check": check, "train_json": train_json}


def text_train_shape(train_json) -> dict:
    """The Embed_Decoder_CTC training run's largest batch by attention work
    (B T^2): B, T (the padded phones) and the phone counts."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import PhoneCharDataset
    from openasr_torch.data.sampler import BudgetBatchSampler

    ds = PhoneCharDataset(train_json, feat_range=(1, 1000), label_range=(1, 120))
    budget = int(text_training("Embed_Decoder_CTC")["batch_phones"])
    best = None
    for batch in BudgetBatchSampler(ds, budget, key="phone_length").batches:
        lens = np.array([ds[i]["phone_length"] for i in batch])
        t = quantize(int(lens.max()))
        if best is None or len(batch) * t * t > best["b"] * best["t"] ** 2:
            best = {"b": len(batch), "t": t, "lens": lens}
    return best


def text_rows(text, errs, launches):
    """Rows 4p and 5+6p: the attention forward (dropout 0.1) and the whole
    backward at the Embed_Decoder_CTC training run's largest batch
    [B, T_phones, T_phones, 8, 64] with its phone lengths, each held to its
    plain version there and timed beside SDPA with the same key-length
    mask; their launches from the run."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    shape = text_train_shape(text["train_json"])
    b, t, lens = shape["b"], shape["t"], shape["lens"]
    tr = launches[("text train", "Embed_Decoder_CTC")]
    print(f"[text rows] the Embed_Decoder_CTC training path's largest batch: B {b}, T {t}, "
          f"phones {lens.tolist()}")
    rng = np.random.RandomState(SEED + 31)
    common = {"launches_per_micro_batch": tr["per_step"]["flash_attention_fwd_dropout"]}
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        row = attention_fwd_row(b, 8, 64, t, t, False, lens, dtype, rng, errs, DROPOUT)
        rows.append({"name": f"flash_attention_fwd_dropout_phone2char[{name}]", **row, **common,
                     "launches": tr["total"]["flash_attention_fwd_dropout"],
                     "launches_are": "dropout forward calls of the Embed_Decoder_CTC training "
                                     "run (f32)",
                     "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, its own "
                                   "Philox mask, a bool key-padding mask)",
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype]})
        at = attention_bwd_times(b, 8, 64, t, t, False, lens, dtype, rng, cold=False)
        args = at["kernel_args"][:6] + at["kernel_args"][7:]
        got, want = flash_attention_bwd(*args), flash_attention_bwd_reference(*args)
        err = (0.0, 0.0)
        for g, w in zip(got, want):
            e, scale = scaled_err(g, w)
            err = (max(err[0], e), max(err[1], e / scale))
        print(f"[text rows] flash backward {name} [{b}, {t}, {t}, 8, 64] with phone lengths, "
              f"dropout 0.1: err {err[0]:.3g}, scaled {err[1]:.3g} (tol {TOL_FLASH_BWD[dtype]})")
        require(err[1] <= TOL_FLASH_BWD[dtype], "the backward disagrees at the phone2char shape")
        rows.append({
            "name": f"flash_attention_bwd_phone2char[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"], **common,
            "launches": tr["total"]["flash_attention_bwd_dkv"],
            "launches_are": "backward calls of the Embed_Decoder_CTC training run (f32), each "
                            "launching statistics, dK/dV and dQ once",
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1, a bool key-padding "
                          "mask) forward + backward minus forward (graph replay)",
        })
    return rows


# --------------------------------------------------------------- moe path

MOE_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-moe.yaml")
# the card-vs-CPU routing replay (ROADMAP queue 3 item 9's rule for MoE):
# at most MOE_MAX_FLIPS tokens routed otherwise on the CPU, each a rounding
# tie: the gates of its card pick and of its CPU pick within MOE_GATE_TIE of
# the layer's largest gate
MOE_MAX_FLIPS = 16
MOE_GATE_TIE = 1e-5


def moe_model_cfg(router="topk") -> dict:
    """The model section of conv-ctc-transformer-moe.yaml as it is, at the
    smoke test's vocabulary; `router="expert_choice"` is the variant the
    phase writes (the YAML is not edited)."""
    import yaml

    with open(MOE_YAML) as f:
        model = yaml.safe_load(f)["model"]
    model["decoder"]["vocab_size"] = FLAGSHIP["decoder"]["vocab_size"]
    if router != "topk":
        model["encoder"]["moe"]["router"] = router
    return model


class RouteReplay:
    """The MoE layers' discrete choices (every `moe.top_indices` call: the
    topk router's expert picks a token, expert_choice's token picks an
    expert), recorded in call order on one forward and replayed on
    another, as `ReluMasks` replays ReLU decisions.  The replay counts the
    tokens routed otherwise than recorded (topk: the tokens whose picks
    differ; expert_choice: the tokens that enter or leave an expert's
    slots) and keeps each call's largest gate margin among them, |gate of
    the recorded pick - gate of the own pick| over the call's largest
    gate."""

    def __init__(self, router: str):
        from openasr_torch.models import moe

        self.router, self.plain, self.picks, self.mode = router, moe.top_indices, [], None
        self.flips, self.margins, self.calls = 0, [], 0

    def top_indices(self, values, k):
        own = self.plain(values, k)
        if self.mode == "record":
            self.picks.append(own.detach().clone())
            return own
        card = self.picks[self.calls].to(values.device)
        self.calls += 1
        rows = (card != own).any(dim=-1)
        if bool(rows.any()):
            v = values.detach()
            gap = (v.gather(-1, card) - v.gather(-1, own)).abs()[card != own]
            if self.router == "topk":
                n = int(rows.sum())
            else:
                n = sum(len(set(card[tuple(r)].tolist()) ^ set(own[tuple(r)].tolist()))
                        for r in rows.nonzero())
            self.flips += n
            self.margins.append(float(gap.max()) / float(v.max()))
        return card

    def installed(self, mode):
        """`mode`: "record", "replay", or None (each layer's own choices)."""
        from openasr_torch.models import moe

        @contextlib.contextmanager
        def patch():
            self.mode, self.calls = mode, 0
            if mode is not None:
                moe.top_indices = self.top_indices
            try:
                yield
            finally:
                moe.top_indices = self.plain

        return patch()


def check_moe_against_cpu(pkg_path, feats, router) -> dict:
    """The f32 MoE model (conv-ctc-transformer-moe.yaml at full width, the
    f32 run's package; for expert_choice the same weights under that
    router) on the card against the CPU, TF32 off, on two utterances: the
    deterministic forward's CTC and decoder logits, and one step's
    gradients of the solver's objective (ce / n_tokens + ctc / n_seqs +
    moe_aux_loss), 1e-3 of each parameter's largest gradient (the
    k-projection biases against their weights'), the CPU at the card's
    routing (`RouteReplay`, which counts where the CPU's own routing
    differs)."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg_path)["model"]
    cfg = Config(moe_model_cfg(router))
    pkg["configs"]["encoder"]["moe"] = dict(cfg.encoder["moe"])
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED + 41))
    replay = RouteReplay(router)
    outs, grads = {}, {}
    t0 = time.time()
    for tag, device, mode in (("cuda", "cuda", "record"), ("cpu", "cpu", "replay")):
        model = get_model_class("conv-ctc-transformer").create_model(cfg, device=device)
        model.restore(pkg)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with replay.installed(mode):
            with torch.no_grad():
                ctc, _, ce = model.module(tb["feats"], tb["feat_lengths"], tb["ids"])
            losses = model.loss(tb, None, label_smooth=0.1, empty_rows=False)
        total = (losses["ce_loss"] / losses["n_tokens"] + losses["ctc_loss"] / losses["n_seqs"]
                 + losses["moe_aux_loss"])
        total.backward()
        outs[tag] = (ctc.cpu(), ce.cpu(), float(losses["moe_aux_loss"].detach()))
        grads[tag] = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
    card, mine = outs["cuda"], outs["cpu"]
    e_ctc, e_ce = max_err(card[0], mine[0]), max_err(card[1], mine[1])
    worst, worst_name = grad_errs(grads["cuda"], grads["cpu"])
    margin = max(replay.margins, default=0.0)
    print(f"[moe check] {router} f32 card vs CPU, 2 utts {list(batch['feats'].shape)}, "
          f"{time.time() - t0:.1f}s: ctc_fc logits err {e_ctc:.3g}, decoder logits err "
          f"{e_ce:.3g} (tol 1e-3); one step's gradients, {len(grads['cpu'])} parameters, the "
          f"CPU at the card's routing: worst err {worst:.3g} of the gradient's max abs "
          f"({worst_name}; tol 1e-3); moe_aux_loss card {card[2]:.6g}, CPU {mine[2]:.6g}; "
          f"{replay.flips} token(s) the CPU's own routing sends otherwise in "
          f"{len(replay.picks)} routing calls (at most {MOE_MAX_FLIPS}), the largest gate "
          f"margin {margin:.3g} of its layer's largest gate (tol {MOE_GATE_TIE})")
    require(bool(torch.isfinite(card[0]).all() and torch.isfinite(card[1]).all()),
            f"non-finite MoE logits on the card ({router})")
    require(replay.flips <= MOE_MAX_FLIPS and margin <= MOE_GATE_TIE,
            f"{replay.flips} tokens routed otherwise, the largest margin {margin:.3g}: not "
            "rounding ties")
    require(e_ctc <= 1e-3 and e_ce <= 1e-3, f"MoE logits: card and CPU disagree ({router})")
    require(worst <= 1e-3, f"MoE gradient of {worst_name} disagrees: {worst:.3g} ({router})")
    return {"logits_err": max(e_ctc, e_ce), "grad_err": worst, "flips": replay.flips,
            "margin": margin, "calls": len(replay.picks)}


def moe_layer_split(shapes) -> dict:
    """Device ms (CUDA-graph replay, warm L2) of one MoE layer of the
    config (8 GLU experts, top-2, capacity factor 1.25) at the training
    path's largest batch [B, T', 512] with its encoder lengths, forward and
    backward, by stage: the router and the combine tensor (`route`), the
    dispatch einsum, the expert products (`expert_ffn`) and the combine
    einsum; beside them the whole layer and the dense GLU FFN
    (models/layers.py:FeedForward) at the same shape; f32 and bf16
    (autocast).  Each stage takes milliseconds, so 5 calls a graph, 4
    replays."""
    from openasr_torch.models import init_parameters
    from openasr_torch.models.layers import FeedForward
    from openasr_torch.models.moe import MoEFeedForward

    b, t, lens = shapes["b"], shapes["t"], shapes["enc_lens"]
    enc = moe_model_cfg()["encoder"]
    d, f, moe = int(enc["d_model"]), int(enc["dim_feedforward"]), enc["moe"]
    gen = torch.Generator().manual_seed(SEED + 43)
    layer = MoEFeedForward(d, f, int(moe["num_experts"]), int(moe["top_k"]),
                           float(moe["capacity_factor"]), enc["activation"], 0.0)
    dense = FeedForward(d, f, enc["activation"])
    for m in (layer, dense):
        init_parameters(m, gen)
        m.to("cuda")
    pad = (torch.arange(t)[None, :] < torch.from_numpy(lens)[:, None]).to("cuda")
    out = {"shape": [b, t, d]}
    for dtype in DTYPES:
        def ac():
            return torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False,
                                  enabled=dtype == torch.bfloat16)

        x = torch.randn(b, t, d, device="cuda", requires_grad=True)
        with ac():
            combine = layer.route(x, pad).detach().requires_grad_(True)
            xin = layer.dispatch(combine, x).detach().requires_grad_(True)
            y_e = layer.expert_ffn(xin).detach().requires_grad_(True)
        weights = [p for p in layer.parameters() if p is not layer.router.weight
                   and p is not layer.router.bias]
        stages = {
            "route": (lambda: layer.route(x, pad), [x, layer.router.weight, layer.router.bias]),
            "dispatch": (lambda: layer.dispatch(combine, x), [x]),
            "experts": (lambda: layer.expert_ffn(xin), [xin] + weights),
            "combine": (lambda: layer.combine(y_e, combine), [y_e, combine]),
            "moe layer": (lambda: layer(x, None, pad), [x] + list(layer.parameters())),
            "dense ffn": (lambda: dense(x), [x] + list(dense.parameters())),
        }
        row = {}
        for name, (fn, inputs) in stages.items():
            def fwd(fn=fn):
                with ac():
                    return fn()

            grad_out = torch.randn_like(fwd())
            row[name] = {"fwd": device_ms(fwd, 5, 4),
                         "bwd": backward_ms(fwd, inputs, grad_out, 5, 4)}
        row["capacity"] = int(combine.shape[-1])
        out[DTYPE_NAME[dtype]] = row
    return out


def phase_moe(train_json, dev_json, vocab, test_json, train_feats, launches) -> dict:
    """conv-ctc-transformer-moe.yaml at full width (`[moe path]`): one epoch
    through the train CLI in f32 and bf16 from one seeded package (the
    flagship run's cut: 128 utterances, 2 steps and a dev batch), with
    `moe_aux_loss` finite and positive in every logged row and each run's
    launches those of the flagship's steps; the f32 package's 8 test
    utterances through the infer CLI (attention beam 5, maxlen 40; CTC
    greedy, the package's encoder and CTC head as a conv-ctc package); card
    vs CPU for both routers (`check_moe_against_cpu`); the layer's split
    (`moe_layer_split`).  The int8 export is the serving path's kind
    "beam moe int8".  Counters set to 0 just before each run, read just
    after."""
    from openasr_torch.bin import infer, train
    from openasr_torch.config import Config
    from openasr_torch.models.speech import ConvCTCModule
    from openasr_torch.utils.checkpoint import load_package, save_package

    t_phase = time.time()
    cfg = moe_model_cfg()
    per = per_step_launches(cfg)
    require(per == per_step_launches(FLAGSHIP),
            f"an MoE step's launches {per} are not the flagship's {per_step_launches(FLAGSHIP)}")
    print(f"[moe path] cuts: {MOE_YAML} as it is (d512 x 6+6, layers 1, 3 and 5 with 8 GLU "
          f"experts, top-2, capacity factor 1.25, aux weight 0.01) at vocabulary 4233 with "
          f"random weights from seed {SEED}; one epoch of the flagship run's 128 random-"
          f"feature utterances (2 steps and a dev batch), f32 and bf16; decode 8 utterances; "
          f"the export one bucket, beam {SERVE_BEAM}, {SERVE_MAXLEN} steps; expert_choice only "
          f"in the card-vs-CPU check")
    out = {"runs": {}, "per": per}
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        exp = os.path.join(WORK, f"exp_moe_{name}")
        os.makedirs(exp)
        save_flagship_package(os.path.join(exp, "last.pkg"),
                              {"epoch": 0, "step": 0, "tr_loss": [], "cv_loss": []}, cfg)
        path = train_config(train_json, dev_json, vocab, exp, dtype, MOE_YAML)
        reset_counters()
        t0 = time.time()
        train.main([path, "--continue-training", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        rows = read_metrics(exp)
        tr = [r for r in rows if r["phase"] == "train"]
        cv = [r for r in rows if r["phase"] == "cv"]
        aux = [r.get("moe_aux_loss") for r in tr + cv]
        losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
        print(f"[moe path] train {name}: {len(tr)} steps + {len(cv)} dev batch(es) in "
              f"{wall:.2f}s wall; losses {[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
              f"{[round(r['ce_loss'], 4) for r in tr]} (ce); moe_aux_loss (per token, as "
              f"logged) train {[r['moe_aux_loss'] for r in tr]}, dev "
              f"{[r['moe_aux_loss'] for r in cv]}; launches {n}")
        require(len(tr) >= 2 and len(cv) >= 1, f"{len(tr)} steps, {len(cv)} dev batches")
        require(all(a is not None and np.isfinite(a) and a > 0 for a in aux),
                f"moe_aux_loss not finite and positive in every row: {aux}")
        require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
        want = {k: 0 for k in n}
        for k, c in per["train"].items():
            want[k] += c * len(tr)
        for k, c in per["dev"].items():
            want[k] += c * len(cv)
        require(n == want, f"launches {n} != {want} ({per['train']} a step, {per['dev']} a "
                           f"dev batch)")
        launches[("moe train", dtype)] = {"total": n, "steps": len(tr), "dev_batches": len(cv)}
        out["runs"][name] = {"wall": wall, "steps": len(tr), "aux": aux,
                             "pkg": os.path.join(exp, "last.pkg")}
    pkg_path = out["runs"]["float32"]["pkg"]
    n_batches = decode_batches(test_json)
    pkg = load_package(pkg_path)["model"]
    ctc_pkg = os.path.join(WORK, "moe_ctc.pkg")
    configs = dict(pkg["configs"], type="conv-ctc",
                   decoder={"vocab_size": pkg["configs"]["decoder"]["vocab_size"]})
    save_package({"model_type": "conv-ctc", "configs": configs,
                  "components": {"encoder": pkg["components"]["encoder"],
                                 "fc": pkg["components"]["ctc_fc"]}}, ctc_pkg)
    with torch.device("meta"):
        ctc_forward = module_launches(ConvCTCModule(Config(configs)))["forward"]
    out["decodes"] = {}
    for name, model_type, model_pkg, extra in (
            ("attention beam", "conv-ctc-transformer", pkg_path, ["--nbest", "5", "--maxlen", "40"]),
            ("ctc greedy", "conv-ctc", ctc_pkg, [])):
        hyp = os.path.join(WORK, f"hyp_moe_{name.replace(' ', '_')}.txt")
        reset_counters()
        t0 = time.time()
        infer.main(["--model_type", model_type, "--model_pkg", model_pkg, "--vocab_path", vocab,
                    "--json_file", test_json, "--output", hyp, "--add_blk", "--offline",
                    "--batch_frames", "36000", "--device", "cuda"] + extra)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[moe path] decode {name}: {len(lines)} hyps in {wall:.2f}s wall, {n_batches} "
              f"batch(es); launches {n}")
        require(len(lines) == 8, f"{len(lines)} hyp lines for 8 utterances")
        require(n["flash_attention_fwd"] == 6 * n_batches, f"flash launched "
                                                           f"{n['flash_attention_fwd']} times")
        if name == "ctc greedy":
            require(n["layer_norm_fwd"] == ctc_forward["layer_norm_fwd"] * n_batches,
                    f"layer_norm launched {n['layer_norm_fwd']} times")
        else:
            require(n["layer_norm_fwd"] >= 13 * n_batches,
                    f"layer_norm launched {n['layer_norm_fwd']} times")
        launches[("moe decode", name)] = n
        out["decodes"][name] = {"wall": wall, "launches": n}
    out["check"] = {router: check_moe_against_cpu(pkg_path, train_feats, router)
                    for router in ("topk", "expert_choice")}
    t0 = time.time()
    out["split"] = moe_layer_split(train_shapes(train_json))
    print(f"[moe path] the layer's split timed in {time.time() - t0:.1f}s")
    card = nvidia_smi()
    for dtype in ("float32", "bfloat16"):
        s = out["split"][dtype]
        print(f"[moe layer] {dtype} at [{', '.join(map(str, out['split']['shape']))}] "
              f"(capacity {s['capacity']}), device ms forward / backward: "
              + "; ".join(f"{k} {v['fwd']:.4f} / {v['bwd']:.4f}" for k, v in s.items()
                          if isinstance(v, dict)) + f" ({card})")
    out["wall"] = time.time() - t_phase
    return out


# ----------------------------------------------------------- serving path
#
# Each artifact kind is exported, served and timed by a worker process of
# its own (`chip_smoke.py --serving-worker KIND`), all started together: a
# torch.export trace and its serialization are single-threaded host work of
# some milliseconds a graph node, so the seven exports run on seven of the
# machine's cores at once.  The workers hold each exported program to the
# live decode and count both calls' launches as they go; their timed runs
# wait until every worker has loaded its artifact and then take turns
# (a file lock), so that no export or other timing shares the host or the
# card with them.

SERVE_DIR = os.path.join(WORK, "serving")
SERVE_CARD = os.path.join(SERVE_DIR, "card")
SERVE_KINDS = ("beam", "beam int8", "beam lm", "ctc_beam", "streaming", "streaming online",
               "stream_beam", "beam moe int8")
SERVE_BEAM = 5
# the attention beams' steps in the exported programs (the live CLI decode
# takes 40): the graph grows with steps x layers, and its export, save and
# load take milliseconds a node on the host
SERVE_MAXLEN = 8
# the device CTC beam's graph grows with the encoder frames: its bucket
# takes each decode utterance's first 32 feature frames (7 encoder frames)
SERVE_CTC_FRAMES = 32
SERVE_TIMED = 5
# int8 weights against f32, as tests/test_quant.py:72 holds them: scores
# within 0.05 + 0.05 |score|.  At the flagship's random weights the beams'
# scores lie close, so a 1-best may swap: each must be equal unless the f32
# top two lie within twice the largest score change the int8 weights made
TOL_INT8_SCORES = 0.05


def serve_job(pkg, ctc_pkg, lm_pkg, stream_pkg, moe_pkg, vocab, test_feats, wtest) -> dict:
    """The workers' inputs, written to SERVE_DIR/job.json: the packages (the
    MoE one the [moe path]'s f32 run's),
    the decode utterances' features and waves (padded, .npy), a hotword
    file, and the online streaming model's package (random weights from
    SEED, as `phase_streaming_online` builds it)."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import save_package

    os.makedirs(SERVE_DIR, exist_ok=True)
    utts = sorted(test_feats)
    x, lens = padded_features(test_feats, utts)
    np.save(os.path.join(SERVE_DIR, "feats.npy"), x)
    np.save(os.path.join(SERVE_DIR, "lens.npy"), lens)
    wl = np.array([wtest[u].shape[0] for u in sorted(wtest)])
    w = np.zeros((len(wl), quantize(int(wl.max()))), np.float32)
    for i, u in enumerate(sorted(wtest)):
        w[i, : wl[i]] = wtest[u]
    np.save(os.path.join(SERVE_DIR, "waves.npy"), w)
    np.save(os.path.join(SERVE_DIR, "wave_lens.npy"), wl)
    online = get_model_class("conv-ctc-transformer").create_model(
        stream_model_cfg(online=True), device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    online_pkg = os.path.join(SERVE_DIR, "stream_online.pkg")
    save_package({"model": online.package()}, online_pkg)
    chars = [line.strip() for line in open(vocab, encoding="utf-8")]
    hot = write_text("serve_hot.txt", [" ".join(chars[i: i + 3]) for i in (10, 200, 3000)])
    job = {"pkg": pkg, "ctc_pkg": ctc_pkg, "lm_pkg": lm_pkg, "stream_pkg": stream_pkg,
           "moe_pkg": moe_pkg, "online_pkg": online_pkg, "vocab": vocab, "hot": hot, "kinds": list(SERVE_KINDS)}
    with open(os.path.join(SERVE_DIR, "job.json"), "w") as f:
        json.dump(job, f)
    return job


def start_serving(job) -> dict:
    """Start one worker a kind (`serving_worker`), at the lowest priority:
    each exports its program on the host while this process drives the
    later paths, then waits for `finish_serving` to let it onto the card."""
    procs = {}
    for kind in SERVE_KINDS:
        log = open(os.path.join(SERVE_DIR, f"{kind.replace(' ', '_')}.log"), "w")
        procs[kind] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serving-worker", kind],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, preexec_fn=lambda: os.nice(19)),
            log)
    return procs


def stop_serving(procs) -> None:
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
        log.close()


def finish_serving(procs) -> dict:
    """Let the workers onto the card (SERVE_CARD), wait for all, print
    their reports; every worker must exit 0."""
    open(SERVE_CARD, "w").close()
    results, failed = {}, []
    t0 = time.time()
    for kind, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, 900 - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        name = kind.replace(" ", "_")
        with open(os.path.join(SERVE_DIR, f"{name}.log")) as f:
            print(f.read().rstrip())
        path = os.path.join(SERVE_DIR, f"{name}.json")
        if rc != 0 or not os.path.exists(path):
            failed.append(f"{kind} (rc {rc})")
            continue
        with open(path) as f:
            results[kind] = json.load(f)
    print(f"[time] serving workers done in {time.time() - t0:.1f}s after their go onto the card")
    require(not failed, f"serving workers failed: {failed}")
    return results


def serve_load(path):
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(path)
    return pkg.get("model", pkg)


def serve_model(path, model_type="conv-ctc-transformer"):
    from openasr_torch.models import get_model_class

    pkg = serve_load(path)
    model = get_model_class(model_type).create_model(pkg["configs"], device="cuda")
    model.restore(pkg)
    return model


def serve_turn(kind, timed: dict) -> dict:
    """Wait until every worker is ready, then, holding the lock, time each
    of `timed` (name -> fn, a batch or tick that ends synchronized): one
    warm-up call each, then SERVE_TIMED rounds in turn; median wall ms."""
    import fcntl

    ready = os.path.join(SERVE_DIR, "ready")
    os.makedirs(ready, exist_ok=True)
    open(os.path.join(ready, kind.replace(" ", "_")), "w").close()
    t0 = time.time()
    while len(os.listdir(ready)) < len(SERVE_KINDS) and time.time() - t0 < 600:
        time.sleep(0.5)
    with open(os.path.join(SERVE_DIR, "timing.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        walls = {name: [] for name in timed}
        for fn in timed.values():
            fn()
        for _ in range(SERVE_TIMED):
            for name, fn in timed.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t) * 1e3)
        fcntl.flock(lock, fcntl.LOCK_UN)
    ms = {name: float(np.median(w)) for name, w in walls.items()}
    print(f"[serving path] {kind}: warm wall ms, median of {SERVE_TIMED}: " + ", ".join(
        f"{name} {v:.3f}" for name, v in ms.items()))
    return ms


def same_launches(kind, live_fn, exported_fn) -> dict:
    """Both calls' kernel launches (counters set to 0 just before each and
    read just after): required equal."""
    reset_counters()
    live_fn()
    live = read_counters()
    reset_counters()
    exported_fn()
    exported = read_counters()
    print(f"[serving path] {kind}: launches live {live}, exported {exported}")
    require(live == exported, f"{kind}: the exported call's launches differ from the live call's")
    return exported


def nbest_tie_close(name, got, want, tol) -> dict:
    """int8 against f32 (TOL_INT8_SCORES): scores within tol + tol |score|;
    each 1-best equal unless the reference's top two lie within twice the
    largest score difference e (a tie the int8 weights can swap)."""
    g_t, g_l, g_s = (a.cpu().numpy() for a in got)
    w_t, w_l, w_s = (a.cpu().numpy() for a in want)
    e = float(np.abs(g_s - w_s).max())
    top = [g_t[i, 0, : g_l[i, 0]].tolist() == w_t[i, 0, : w_l[i, 0]].tolist()
           for i in range(len(g_s))]
    gaps = [float(w_s[i, 0] - w_s[i, 1]) for i in range(len(w_s))]
    lists = sum(g_t[i].tolist() == w_t[i].tolist() for i in range(len(g_s)))
    print(f"[serving path] {name}: scores err {e:.3g} (tol {tol} + {tol} |score|); 1-best "
          f"equal {sum(top)} of {len(top)} (f32 top-two gaps where not: "
          f"{[round(g, 4) for g, t in zip(gaps, top) if not t]}), n-best lists equal "
          f"{lists} of {len(top)}")
    require(np.allclose(g_s, w_s, rtol=tol, atol=tol), f"{name}: scores differ by {e:.3g}")
    require(all(t or gap <= 2 * e for t, gap in zip(top, gaps)),
            f"{name}: a 1-best differs off a tie")
    return {"scores_err": e, "top1_equal": sum(top), "lists_equal": lists}


def exact_nbest(name, got, want) -> float:
    """Tokens and lengths equal, scores within 1e-5 (rtol and atol)."""
    for g, w, what in zip(got[:2], want[:2], ("tokens", "lengths")):
        require(torch.equal(g.cpu(), w.cpu()), f"{name}: {what} differ")
    e = float((got[2].float() - want[2].float()).abs().max())
    require(torch.allclose(got[2].float(), want[2].float(), rtol=1e-5, atol=1e-5),
            f"{name}: scores differ by {e:.3g}")
    return e


def serve_export(kind, export_fn, loader_cls, path) -> tuple:
    """Export (host work), wait for the go onto the card (SERVE_CARD: the
    main process's timed kernel rows are done), then load on the card."""
    t0 = time.time()
    export_fn(path)
    export_s = time.time() - t0
    t_wait = time.time()
    while not os.path.exists(SERVE_CARD):
        require(time.time() - t_wait < 1200, f"{kind}: no go onto the card")
        time.sleep(0.2)
    with contextlib.suppress(PermissionError):
        os.setpriority(os.PRIO_PROCESS, 0, 0)
    t0 = time.time()
    loader = loader_cls(path, device="cuda")
    load_s = time.time() - t0
    programs = getattr(loader, "_fns", None) or {"init": loader._init, "tick": loader._tick}
    nodes = sum(len(list(fn.graph.nodes)) for fn in programs.values())
    size = os.path.getsize(path)
    print(f"[serving path] {kind}: exported in {export_s:.1f}s (trace and save), "
          f"loaded in {load_s:.1f}s, {size / 1e6:.2f} MB, {nodes} graph nodes")
    return loader, {"export_s": export_s, "load_s": load_s, "bytes": size, "nodes": nodes}


def serve_beam(kind, job) -> dict:
    """The flagship's attention beam (f32 weights, int8 weights, or the
    Transformer LM fused at LM_WEIGHT), or the MoE model's with int8
    weights exported through `bin/export_decode.py --int8`, over the 8
    decode utterances in one bucket, against the live `batch_beam_decode`."""
    from openasr_torch import quant, serving
    from openasr_torch.bin import export_decode

    moe = kind == "beam moe int8"
    pkg_path = job["moe_pkg"] if moe else job["pkg"]
    model = serve_model(pkg_path)
    x = torch.from_numpy(np.load(os.path.join(SERVE_DIR, "feats.npy"))).cuda()
    lens = torch.from_numpy(np.load(os.path.join(SERVE_DIR, "lens.npy"))).cuda()
    lm = load_lm(job["lm_pkg"], "cuda") if kind == "beam lm" else None
    lm_kw = {"lm": lm, "lm_weight": LM_WEIGHT} if lm is not None else {}
    int8 = kind in ("beam int8", "beam moe int8")
    path = os.path.join(SERVE_DIR, kind.replace(" ", "_") + ".zip")

    def export(p):
        if moe:
            export_decode.main(["--model_type", "conv-ctc-transformer", "--model_pkg", pkg_path,
                                "--vocab_path", job["vocab"], "--add_blk", "--out", p,
                                "--buckets", "x".join(map(str, x.shape[:2])),
                                "--nbest", str(SERVE_BEAM), "--maxlen", str(SERVE_MAXLEN),
                                "--platforms", "cuda", "--int8", "--device", "cuda"])
        else:
            serving.export_beam_decode(
                model, [tuple(x.shape[:2])], p, beam_size=SERVE_BEAM,
                max_decode_len=SERVE_MAXLEN, platforms=("cuda",),
                weights="int8" if int8 else "float32", **lm_kw)

    dec, rec = serve_export(kind, export, serving.ExportedDecoder, path)
    params = dec.prepare_params(serve_load(pkg_path))
    call_kw = {"lm_params": dec.prepare_lm_params(serve_load(job["lm_pkg"]))} if lm else {}
    n_params = sum(p.numel() * p.element_size() for p in model.module.parameters())
    rec["param_bytes"] = n_params
    rec["input_bytes"] = sum(p.numel() * p.element_size() for p in params)
    require(rec["bytes"] < 0.2 * n_params, f"{kind}: the artifact holds {rec['bytes']} bytes "
                                           f"beside {n_params} of parameters")

    def exported():
        return dec(params, x, lens, **call_kw)

    live_model = model
    if int8:
        # the live decode with the same weights: the quantized package
        # dequantized into a second model
        from openasr_torch.models import get_model_class

        pkg = serve_load(pkg_path)
        live_model = get_model_class("conv-ctc-transformer").create_model(
            pkg["configs"], device="cuda")
        state = quant.dequantize_params(quant.bridge_quantized(
            pkg["model_type"], quant.quantize_params(pkg["components"])))
        live_model.module.load_state_dict(state)

    def live(full=False):
        return live_model.batch_beam_decode(x, lens, beam_size=SERVE_BEAM,
                                            max_decode_len=SERVE_MAXLEN,
                                            stop_when_finished=not full, **lm_kw)

    with torch.inference_mode():
        got, want = exported(), live()
        rec["scores_err"] = exact_nbest(f"{kind}: exported vs live", got, want)
        print(f"[serving path] {kind}: exported vs live on the card: n-best equal, scores "
              f"err {rec['scores_err']:.3g}")
        if int8:
            f32 = model.batch_beam_decode(x, lens, beam_size=SERVE_BEAM,
                                          max_decode_len=SERVE_MAXLEN)
            rec["vs_f32"] = nbest_tie_close(f"{kind}: int8 vs f32 weights", got, f32,
                                            TOL_INT8_SCORES)
        rec["launches"] = same_launches(kind, lambda: live(full=True), exported)
        rec["ms"] = serve_turn(kind, {"exported": exported, "live": live})
    return rec


def serve_ctc_beam(kind, job) -> dict:
    """conv-ctc's device prefix beam of 10 with the Transformer LM and the
    hotword file, over each decode utterance's first SERVE_CTC_FRAMES
    frames (lengths 32 down to 25), against the live search on the live
    model's log-probs."""
    from openasr_torch import serving
    from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
    from openasr_torch.models.lm import make_lm_fusion
    from openasr_torch.ops.ctc_beam_device import build_context_tables, ctc_prefix_beam_device

    model = serve_model(job["ctc_pkg"], "conv-ctc")
    lm = load_lm(job["lm_pkg"], "cuda")
    tok = CharTokenizer(job["vocab"], add_blk=True)
    phrases = load_context_phrases(tok, job["hot"])
    x = torch.from_numpy(np.load(os.path.join(SERVE_DIR, "feats.npy"))[:, :SERVE_CTC_FRAMES])
    x = x.cuda()
    lens = torch.arange(SERVE_CTC_FRAMES, SERVE_CTC_FRAMES - x.shape[0], -1,
                        dtype=torch.int32, device="cuda")
    vocab = tok.unit_num()
    path = os.path.join(SERVE_DIR, "ctc_beam.zip")
    dec, rec = serve_export(kind, lambda p: serving.export_beam_decode(
        model, [tuple(x.shape[:2])], p, beam_size=CTC_BEAM, platforms=("cuda",),
        ctc_device_beam=True, lm=lm, lm_weight=LM_WEIGHT, context_phrases=phrases,
        context_weight=2.0), serving.ExportedDecoder, path)
    params = dec.prepare_params(serve_load(job["ctc_pkg"]))
    lm_params = dec.prepare_lm_params(serve_load(job["lm_pkg"]))
    tables = build_context_tables(phrases, vocab)

    def exported():
        return dec(params, x, lens, lm_params=lm_params)

    def live():
        logits, len_logits = model.get_logits(x, lens)
        lp = torch.log_softmax(logits.float(), dim=-1)
        step_fn, cache = make_lm_fusion(lm, lp.shape[0] * CTC_BEAM, lp.shape[1] + 1)
        return ctc_prefix_beam_device(lp, len_logits, blank=vocab - 1, beam=CTC_BEAM,
                                      lm_step_fn=step_fn, init_lm_cache=cache,
                                      lm_weight=LM_WEIGHT, context_tables=tables,
                                      context_weight=2.0)

    with torch.inference_mode():
        rec["scores_err"] = exact_nbest(f"{kind}: exported vs live", exported(), live())
        print(f"[serving path] {kind}: exported vs live on the card: n-best equal, scores "
              f"err {rec['scores_err']:.3g}")
        rec["launches"] = same_launches(kind, live, exported)
        rec["ms"] = serve_turn(kind, {"exported": exported, "live": live})
    return rec


def serve_stream_inputs(online):
    x = np.load(os.path.join(SERVE_DIR, "waves.npy" if online else "feats.npy"))
    lens = np.load(os.path.join(SERVE_DIR, "wave_lens.npy" if online else "lens.npy"))
    return x, lens


def serve_streaming(kind, job) -> dict:
    """The streaming tick at B 8 (offline: the trained streaming package
    over the decode features; online: the online model over the decode
    waves, one fbank launch a tick): every tick's encoder states and CTC
    logits exported against live (TOL_STREAM of max(1, |x|))."""
    from openasr_torch import serving
    from openasr_torch.streaming import StreamingRecognizer

    online = kind == "streaming online"
    pkg_path = job["online_pkg"] if online else job["stream_pkg"]
    model = serve_model(pkg_path)
    rec_live = StreamingRecognizer(model)
    x, lens = serve_stream_inputs(online)
    b = x.shape[0]
    path = os.path.join(SERVE_DIR, kind.replace(" ", "_") + ".zip")
    st, rec = serve_export(kind, lambda p: serving.export_streaming_step(
        model, [b], p, platforms=("cuda",)), serving.ExportedStreamer, path)
    params = st.prepare_params(serve_load(pkg_path))
    unit = rec_live.chunk_samples if online else rec_live.chunk_feats
    n = -(-x.shape[1] // unit)
    xp = np.pad(x, [(0, 0), (0, n * unit - x.shape[1])] + [(0, 0)] * (x.ndim - 2))
    chunks = [torch.from_numpy(xp[:, i * unit:(i + 1) * unit]).cuda() for i in range(n)]
    clens = [torch.from_numpy(np.clip(lens - i * unit, 0, unit)).cuda() for i in range(n)]
    err = 0.0
    with torch.inference_mode():
        s_live, s_exp = rec_live.init_state(b), st.init_state(b)
        for i in range(n):
            s_live, o_live = rec_live.step(s_live, chunks[i], clens[i])
            s_exp, o_exp = st.step(params, s_exp, chunks[i], clens[i])
            require(torch.equal(o_live["valid"], o_exp["valid"]), f"{kind}: valid differs")
            for key in ("enc", "logits"):
                e = max_err(o_exp[key], o_live[key])
                scale = max(1.0, float(o_live[key].abs().max()))
                require(e <= TOL_STREAM * scale, f"{kind} tick {i}: {key} err {e:.3g}")
                err = max(err, e / scale)
        print(f"[serving path] {kind}: {n} ticks exported vs live on the card: enc and "
              f"logits err {err:.3g} of max(1, |x|) (tol {TOL_STREAM})")
        rec.update(ticks=n, err=err)
        state = {"live": rec_live.init_state(b), "exported": st.init_state(b)}
        rec["launches"] = same_launches(
            kind, lambda: rec_live.step(state["live"], chunks[0], clens[0]),
            lambda: st.step(params, state["exported"], chunks[0], clens[0]))
        require(rec["launches"]["layer_norm_fwd"] == STREAM_TICK_LN
                and rec["launches"]["fbank"] == int(online), f"{kind}: a tick's launches")
        rec["ms"] = serve_turn(kind, {
            "exported": lambda: st.step(params, state["exported"], chunks[0], clens[0]),
            "live": lambda: rec_live.step(state["live"], chunks[0], clens[0])})
    return rec


def serve_stream_beam(kind, job) -> dict:
    """The streaming prefix beam of 10 with the Transformer LM and the
    hotword file at B 8 and the streaming model's chunk (16), fed each
    tick's log-softmax of the live streaming tick's logits: every tick's
    n-best exported against the live `ctc_beam_stream_step` (equal, scores
    within 1e-5)."""
    from openasr_torch import serving
    from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
    from openasr_torch.models.lm import make_lm_step_spec
    from openasr_torch.ops.ctc_beam_device import (
        build_context_tables,
        ctc_beam_stream_init,
        ctc_beam_stream_step,
    )
    from openasr_torch.streaming import StreamingRecognizer

    model = serve_model(job["stream_pkg"])
    rec_live = StreamingRecognizer(model)
    lm = load_lm(job["lm_pkg"], "cuda")
    spec = make_lm_step_spec(lm)
    tok = CharTokenizer(job["vocab"], add_blk=True)
    phrases = load_context_phrases(tok, job["hot"])
    tables = build_context_tables(phrases, tok.unit_num())
    x, lens = serve_stream_inputs(False)
    b, unit = x.shape[0], rec_live.chunk_feats
    n = -(-x.shape[1] // unit)
    cap = n * rec_live.chunk
    path = os.path.join(SERVE_DIR, "stream_beam.zip")
    sb, rec = serve_export(kind, lambda p: serving.export_stream_beam(
        p, batch=b, beam=STREAM_BEAM, chunk=rec_live.chunk, max_frames=cap,
        vocab_size=tok.unit_num(), blank=rec_live.blank, platforms=("cuda",), lm=lm,
        lm_weight=LM_WEIGHT, context_phrases=phrases, context_weight=2.0),
        serving.ExportedStreamBeam, path)
    lm_params = sb.prepare_lm_params(serve_load(job["lm_pkg"]))
    xp = np.pad(x, [(0, 0), (0, n * unit - x.shape[1]), (0, 0)])
    beam_kw = dict(lm_step_fn=spec["step_fn"], lm_weight=LM_WEIGHT, context_tables=tables,
                   context_weight=2.0)

    def live_init():
        return ctc_beam_stream_init(b, STREAM_BEAM, cap, spec["step_fn"],
                                    spec["init_cache_fn"](b * STREAM_BEAM, cap + 1),
                                    num_phrases=len(phrases), device="cuda")

    err = 0.0
    with torch.inference_mode():
        state = rec_live.init_state(b)
        ticks = []
        for i in range(n):
            piece = torch.from_numpy(xp[:, i * unit:(i + 1) * unit]).cuda()
            state, out = rec_live.step(state, piece, np.clip(lens - i * unit, 0, unit))
            ticks.append((torch.log_softmax(out["logits"], dim=-1), out["valid"]))
        s_live, s_exp = live_init(), sb.init_state(lm_params)
        for i, (lp, valid) in enumerate(ticks):
            s_live, n_live = ctc_beam_stream_step(s_live, lp, valid, rec_live.blank,
                                                  STREAM_BEAM, **beam_kw)
            s_exp, n_exp = sb.step(s_exp, lp, valid, lm_params)
            err = max(err, exact_nbest(f"{kind} tick {i}", n_exp, n_live))
        print(f"[serving path] {kind}: {n} ticks exported vs live on the card: n-best equal "
              f"every tick, scores err {err:.3g}")
        rec.update(ticks=n, scores_err=err)
        lp, valid = ticks[0]
        state = {"live": live_init(), "exported": sb.init_state(lm_params)}
        rec["launches"] = same_launches(
            kind, lambda: ctc_beam_stream_step(state["live"], lp, valid, rec_live.blank,
                                               STREAM_BEAM, **beam_kw),
            lambda: sb.step(state["exported"], lp, valid, lm_params))
        rec["ms"] = serve_turn(kind, {
            "exported": lambda: sb.step(state["exported"], lp, valid, lm_params),
            "live": lambda: ctc_beam_stream_step(state["live"], lp, valid, rec_live.blank,
                                                 STREAM_BEAM, **beam_kw)})
    return rec


SERVE_WORKERS = {"beam": serve_beam, "beam int8": serve_beam, "beam lm": serve_beam,
                 "ctc_beam": serve_ctc_beam, "streaming": serve_streaming,
                 "streaming online": serve_streaming, "stream_beam": serve_stream_beam,
                 "beam moe int8": serve_beam}


def serving_worker(kind) -> int:
    """One kind of the [serving path], in its own process (see SERVE_DIR)."""
    sys.path.insert(0, ROOT)
    # full f32, as the infer CLI sets it: cuDNN would run the convolutions
    # in TF32 otherwise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(SERVE_DIR, "job.json")) as f:
        job = json.load(f)
    try:
        res = SERVE_WORKERS[kind](kind, job)
    except PhaseError as e:
        print(f"[serving path] {kind}: FAILED: {e}")
        return 1
    finally:
        ready = os.path.join(SERVE_DIR, "ready", kind.replace(" ", "_"))
        if not os.path.exists(ready):  # (a failed worker releases the others)
            os.makedirs(os.path.dirname(ready), exist_ok=True)
            open(ready, "w").close()
    with open(os.path.join(SERVE_DIR, kind.replace(" ", "_") + ".json"), "w") as f:
        json.dump(res, f)
    return 0


def load_package_configs(path) -> dict:
    from openasr_torch.utils.checkpoint import load_package

    pkg = load_package(path)
    return pkg.get("model", pkg)["configs"]


# ------------------------------------------------------------ parallel path

PARALLEL_DIR = os.path.join(WORK, "parallel")
PARALLEL_STEPS = 3
# The [parallel path]'s flagship and MoE pairs and the [model path]'s
# pairs run at GRID_LAYERS encoder and decoder layers (the YAMLs' 6 cut;
# the widths as they are): two ranks hold to one at any depth, and the run
# keeps within its time limit.  The MoE YAML keeps its experts in layer 1.
GRID_LAYERS = 2
GRID_SECTIONS = {"encoder": {"num_layers": GRID_LAYERS}, "decoder": {"num_layers": GRID_LAYERS}}
TOL_PARALLEL = 1e-3        # two ranks against one: the flagship card check's
# The step-1 gradient that the ranks reduced (Adam's first moment after one
# update, f32: (1 - b1) times the clipped gradient), per leaf, of the
# leaf's largest magnitude or a tenth of the largest of any leaf (the CPU
# tests' rule: a gradient that is rounding noise about 0 is held to the
# scale of the others).  Half a gradient, a rank's share without the
# reduction, is off by about 0.5.
TOL_PARALLEL_GRAD = 1e-4
# A pair with an f64 step-1 gradient (`f64`, computed by the one-rank run,
# its CTC loss in float64 too) holds the two ranks' f32 gradient to it as
# well as to one rank's: "sign" (GRU-CTC, whose f32 step-1 gradient sits
# some 5e-3 of scale off float64, which the rank split, summing in another
# order, moves by some 1e-3: the f32 CTC loss over its batch's 1435
# frames, about 1e4 nats a sequence, puts the logits' gradient 7.5e-3 off
# float64, on an H100 as on the CPU, while every other op's f32 backward
# stays within 8e-5 of float64 (the [wave check], ROADMAP queue 3 item
# 39); the JAX package's CTC rounds in f32 alike, its f32 gradient as far
# from float64 as the port's, tests/test_torch_gru_ctc_precision.py) no
# worse than twice one rank's f32 distance plus TOL_PARALLEL_GRAD, and its
# parameters to Adam's 2 lr a step (its first
# updates are +-lr by each element's gradient sign, which f32 does not fix
# for an element whose gradient is below that error); "rounding" (the
# model axis's pairs, whose two ranks sit some 1e-5 of scale off one rank)
# TOL_PARALLEL_GRAD against one rank and, against the f64 gradient, no
# further than TOL_PARALLEL_F64 times one rank's distance, so that the gap
# between them is shown to be f32 rounding (the flagship's and the MoE
# YAML's pairs read 0.93 and 0.91 times on an H100).
TOL_PARALLEL_F64 = 1.5
# BatchNorm running statistics after the first step (the global batch's,
# from equal weights), of their scale
TOL_PARALLEL_STATS = 1e-5
TOL_PARALLEL_WORLD1 = 1e-6  # --distributed at world 1 against the plain CLI


def plain_f64_layers():
    """A context in which the model layers' attention and LayerNorm run as
    plain PyTorch in their inputs' dtype: float64 for `f64_first_moment`,
    which neither the kernels nor their plain versions (f32 inside) take.
    Dropout 0, no chunk mask and no empty row, as the pairs train."""
    from unittest import mock

    from openasr_torch.models import layers

    def attention(q, k, v, kv_lengths=None, causal=False, dropout_rate=0.0, dropout_seed=0,
                  chunk_mask=None):
        require(dropout_rate == 0.0 and chunk_mask is None, "f64 attention: dropout or chunks")
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(q.shape[-1]))
        valid = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        valid = (torch.tril(valid) if causal else valid)[None, None]
        if kv_lengths is not None:
            keys = torch.arange(k.shape[1], device=q.device)
            valid = valid & (keys < kv_lengths.to(q.device)[:, None])[:, None, None, :]
            require(bool((kv_lengths > 0).all()), "f64 attention: an empty row")
        p = torch.softmax(torch.where(valid, s, torch.full_like(s, -1e30)), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v), None

    def layer_norm(x, scale, bias, eps=1e-6):
        mu = x.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) - mu * mu + eps)
        return (x - mu) * rstd * scale + bias, mu[..., 0], rstd[..., 0]

    return mock.patch.multiple(layers, flash_attention=attention, fused_layer_norm=layer_norm)


def f64_first_moment(solver, model_cfg, batch, empty_rows) -> dict:
    """Adam's first moment after step 1, (1 - b1) times the clipped
    gradient, of the solver's first step computed in float64: a copy of
    the model at the same seeded weights, the batch's floats in f64, the
    solver's loss and draws (its rng reseeded as its step reseeds it), the
    attention and LayerNorm plain in f64 (`plain_f64_layers`)."""
    from openasr_torch.models import get_model_class

    ref = get_model_class(model_cfg["type"]).create_model(
        model_cfg, device=solver.device, generator=torch.Generator().manual_seed(SEED))
    ref.module.double()
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    model, solver.model = solver.model, ref
    try:
        solver.rng.reseed((solver.seed << 32) + solver.step * 8191 + solver._niter)
        with plain_f64_layers():
            solver.total_loss(solver.model_losses(batch64, solver.rng, empty_rows)).backward()
    finally:
        solver.model = model
    grads = {n: p.grad for n, p in ref.module.named_parameters() if n in solver.params}
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    scale = solver.grad_max_norm / norm if 0 < solver.grad_max_norm <= norm else 1.0
    return {n: (0.1 * scale * g).cpu().numpy() for n, g in grads.items()}


def job_config(job: dict) -> tuple:
    """A [parallel path] job's data, model and training sections: its
    YAML's, dropout 0, the job's changes to model sections (`sections`),
    f32 Adam moments, the job's training changes, the vocabulary's
    size."""
    import yaml

    from openasr_torch.data.tokenizer import CharTokenizer

    with open(job["yaml"]) as f:
        cfg = yaml.safe_load(f)
    model_cfg, training = cfg["model"], cfg["training"]
    for sec in ("encoder", "decoder"):
        for key in ("dropout_rate", "dropout"):
            if key in (model_cfg.get(sec) or {}):
                model_cfg[sec][key] = 0.0
    for sec, change in job.get("sections", {}).items():
        model_cfg[sec].update(change)
    training.update(print_inteval=1000, adam_mu_dtype="float32", **job["training"])
    tokenizer = CharTokenizer(job["vocab"], add_blk=model_cfg.get("add_blk", False))
    model_cfg["decoder"]["vocab_size"] = tokenizer.unit_num()
    return {**cfg["data"], **job["data"]}, model_cfg, training


def job_batches(job, data, model_cfg, training, rank=0, world=1) -> list:
    """The first PARALLEL_STEPS batches of rank `rank`'s rows of a job's
    loader at the global budget (`build_loaders(ndata=job["ndata"])`)."""
    from openasr_torch.bin.train import build_loaders
    from openasr_torch.data.tokenizer import CharTokenizer

    tokenizer = CharTokenizer(job["vocab"], add_blk=model_cfg.get("add_blk", False))
    loader_cfg = dict(model_cfg, signal={**model_cfg.get("signal", {}),
                                         **job.get("signal", {})})
    tr, _ = build_loaders(data, training, loader_cfg, tokenizer,
                          ndata=job["ndata"], rank=rank, world=world)
    batches = []
    for batch in tr:
        batches.append(batch)
        if len(batches) == PARALLEL_STEPS:
            break
    return batches


def parallel_train(job: dict, grid, go=None) -> dict:
    """Train `job`'s model PARALLEL_STEPS steps as a rank of `grid` (a
    `Grid`: one rank in this process, or gloo on cuda:0, or NCCL with a
    card a rank) on its data row's rows of the first batches
    of the loaders of the global budget (`build_loaders(ndata=job["ndata"])`),
    with counters reset just before and read just after (once the file
    `go` exists, when given); -> the steps' losses (summed over the data
    group), launches and collectives a step (`calls`, `bytes` on the data
    group, `model_calls`, `model_bytes` on the model group), the step's
    wall, the step-1 gradient (Adam's first moment after one update, f32),
    the LayerNorms a step ran on T-shards (`sharded_ln`, from the host's
    shapes: {a rank's rows [B T / M]: LayerNorms} a step), on a grid with a
    pipe axis the pipe group's collectives a step (`pipe_calls`,
    `pipe_bytes`) and each step's batch, encoder length and microbatch
    count (`microbatches`), and the package (every rank gathers; rank 0's
    returned)."""
    from openasr_torch.models import get_model_class
    from openasr_torch.parallel.data_parallel import full_expert_tables
    from openasr_torch.parallel.pipeline import microbatch_count
    from openasr_torch.solvers import get_solver_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = grid.data
    rank, world = group.rank, group.world
    data, model_cfg, training = job_config(job)
    training.update(exp_dir=os.path.join(PARALLEL_DIR, f"exp_{job['tag']}_{grid.world}"))
    batches = job_batches(job, data, model_cfg, training, rank, world)
    model = get_model_class(model_cfg["type"]).create_model(
        model_cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    solver = get_solver_class(model_cfg["type"])(model, training, batches, [],
                                                 device=group.device, group=grid)
    shares, stats1, starts, grad_step = [], {}, [], solver.grad_step
    sharded_ln, microbatches = [], []
    ln_in = {part: count_layer_norms(getattr(model.module, part))
             for part in ("encoder", "decoder") if hasattr(model.module, part)}
    g1, g64, lrs, apply_update = {}, {}, [], solver.apply_update

    def recording(batch, empty_rows):
        if model.tp is not None:
            b, t = model.batch_inputs(batch)[0].shape[:2]
            t = int(model.module.encoder_lengths(np.asarray([t]))[0])
            u = batch["ids"].shape[1] if "ids" in batch else 1
            sites = {}
            for part, n in (("encoder", t), ("decoder", u)):
                if ln_in.get(part) and model.tp.shards_time(n):
                    rows = b * n // model.tp.size
                    sites[rows] = sites.get(rows, 0) + ln_in[part]
            sharded_ln.append(sites)
        if job.get("f64") and grid.world == 1 and not g64:
            g64.update(f64_first_moment(solver, model_cfg, batch, empty_rows))
        torch.cuda.synchronize()
        starts.append(time.time())
        losses = grad_step(batch, empty_rows)
        if solver._pipe_ctx is not None:
            b, t = model.batch_inputs(batch)[0].shape[:2]
            microbatches.append({"b": int(b), "t": int(model.module.encoder_lengths(
                np.asarray([t]))[0]), "m": microbatch_count(b, solver._pipe_ctx[1])})
        shares.append(solver.total_loss(solver.global_counts(losses)).detach())
        if not stats1:
            stats1.update((n, b.detach().cpu().numpy().copy())
                          for n, b in model.module.named_buffers())
        return losses

    def recording_update():
        lrs.append(solver.current_lr())
        apply_update()
        if len(lrs) == 1:  # a collective: every rank gathers, rank 0 keeps
            # (its collectives are the check's, not the step's)
            counts = [(c, dict(c)) for g in grid.groups().values() for c in (g.calls, g.bytes)]
            mu = solver.dp.full_state(solver.optimizer.state_dict())["mu"]
            for c, before in counts:
                c.clear()
                c.update(before)
            if grid.rank == 0:
                g1.update((n, np.asarray(v, np.float32)) for n, v in mu.items())

    solver.grad_step, solver.apply_update = recording, recording_update
    t_wait = time.time()
    while go is not None and not os.path.exists(go):
        require(time.time() - t_wait < 600, "no go from the [parallel path]")
        time.sleep(0.05)
    reset_counters()
    grid.reset_counts()
    t0 = time.time()
    solver.iter_one_epoch()
    torch.cuda.synchronize()
    wall = time.time() - t0
    # each step's wall, from one step's start to the next's; the first
    # carries a fresh process's lazy set-up (cuBLAS, NCCL communicators)
    step_walls = np.diff(starts + [t0 + wall]).tolist()
    n = read_counters()
    calls, nbytes = dict(group.calls), dict(group.bytes)
    mcalls, mbytes = dict(grid.model.calls), dict(grid.model.bytes)
    pcalls, pbytes = dict(grid.pipe.calls), dict(grid.pipe.bytes)
    losses = group.all_reduce(torch.stack(shares)).tolist()
    pkg = solver.package()
    with full_expert_tables(model.module), model.full_tables(), model.full_stacks():
        params = {n: p.detach().float().cpu().numpy()
                  for n, p in model.module.named_parameters()
                  if n in solver.params or (model.pipe_group is not None and ".stack." in n)}
    first = grid.rank == 0
    return {"losses": losses, "wall": wall, "step_walls": step_walls,
            "warm_step": float(np.mean(step_walls[1:])), "steps": solver.step,
            "stats1": stats1, "lrs": lrs, "g1": g1 if first else None, "g64": g64,
            "f64": job.get("f64"),
            "params": params if first else None,
            "zero1": bool(training.get("zero1", True)) and world > 1,
            "launches": {k: v / solver.step for k, v in n.items() if v},
            "launch_totals": n, "sharded_ln": sharded_ln,
            "calls": {k: v / solver.step for k, v in calls.items()},
            "bytes": {k: v / solver.step for k, v in nbytes.items()},
            "model_calls": {k: v / solver.step for k, v in mcalls.items()},
            "model_bytes": {k: v / solver.step for k, v in mbytes.items()},
            "pipe_calls": {k: v / solver.step for k, v in pcalls.items()},
            "pipe_bytes": {k: v / solver.step for k, v in pbytes.items()},
            "microbatches": microbatches,
            "experts": [name for name, kind in zip(solver.dp.names, solver.dp.kind)
                        if kind == "expert"],
            "backend": grid.backend, "pkg": pkg["model"] if first else None}


def parallel_worker(job_path, rank=None, world=None, port=None) -> int:
    """One rank of the [parallel path] (see `phase_parallel`): over gloo on
    cuda:0 with the given coordinates, or over NCCL from torchrun's
    environment without them (`parallel_cards`); it trains the file's jobs
    in turn on one group (they share its grid), job i's result in
    `<job_path>.<i>.<rank>`."""
    import pickle

    from openasr_torch.parallel import init_distributed, new_group
    from openasr_torch.parallel.mesh import destroy

    with open(job_path, "rb") as f:
        jobs = pickle.load(f)
    model = jobs[0].get("model", 1)
    pipe = jobs[0].get("pipe", 1)
    group = (init_distributed("cuda", model=model, pipe=pipe) if rank is None else
             new_group(int(rank), int(world), f"tcp://localhost:{port}", "gloo", "cuda:0",
                       model, pipe=pipe))
    try:
        for i, job in enumerate(jobs):
            res = parallel_train(job, group, go=None if rank is None else f"{job_path}.{i}.go")
            out = f"{job_path}.{i}.{group.rank}"
            with open(out + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(out + ".tmp", out)
    finally:
        destroy(group)
    return 0


def start_ranks(jobs: list) -> dict:
    """Start two ranks (gloo on cuda:0, two processes of this script) for
    `jobs`, which share a grid: they set up (imports, group), then for each
    job in turn set up its data and model and wait for `finish_pair`'s
    go."""
    import pickle
    import socket

    os.makedirs(PARALLEL_DIR, exist_ok=True)
    job_path = os.path.join(PARALLEL_DIR, f"jobs_{jobs[0]['tag']}.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(jobs, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # half the host's threads each: two ranks that each take all of them
    # slow each other's host work
    env = {**os.environ, "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker",
                               job_path, str(r), "2", str(port)], cwd=ROOT, env=env)
             for r in range(2)]
    return {"jobs": jobs, "path": job_path, "procs": procs}


def stop_ranks(ranks) -> None:
    for p in ranks["procs"]:
        if p.poll() is None:
            p.kill()


def finish_pair(ranks: dict, i: int) -> tuple:
    """Job i of `start_ranks`'s: (the one-rank run, trained in this process
    first, then the two ranks' runs, trained after it, so that the timed
    steps do not overlap)."""
    import pickle

    from openasr_torch.parallel import Grid

    job, path, procs = ranks["jobs"][i], ranks["path"], ranks["procs"]
    one = parallel_train(job, Grid.single("cuda:0"))
    open(f"{path}.{i}.go", "w").close()
    outs = [f"{path}.{i}.{r}" for r in range(2)]
    t0 = time.time()
    while not all(os.path.exists(o) for o in outs):
        codes = [p.poll() for p in procs]
        require(None in codes and all(c in (None, 0) for c in codes)
                and time.time() - t0 < 300, f"[parallel path] {job['tag']}: ranks {codes}")
        time.sleep(0.05)
    if i == len(ranks["jobs"]) - 1:
        codes = [p.wait(timeout=300) for p in procs]
        require(codes == [0, 0], f"[parallel path] {job['tag']}: ranks exited {codes}")
    two = []
    for out in outs:
        with open(out, "rb") as f:
            two.append(pickle.load(f))
    return one, two


def scaled_tree_err(got, want) -> float:
    """Largest |got - want| over max(1, |want|) of any leaf of two
    component trees."""
    got, want = dict(leaves(got)), dict(leaves(want))
    require(set(got) == set(want), "the packages' leaves differ")
    return max(float(np.abs(got[k] - want[k]).max()) / max(1.0, float(np.abs(want[k]).max()))
               for k in want)


def floor_grad_errs(got: dict, want: dict) -> dict:
    """Per leaf of two NumPy gradient trees, |got - want| over the leaf's
    largest |want| or a tenth of the largest of any leaf (the CPU tests'
    rule)."""
    require(set(got) == set(want), "the step-1 gradients' leaves differ")
    floor = 0.1 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()), floor)
            for k, v in want.items()}


def check_pair(tag, one, two, want_per_step=None, phase="parallel path") -> dict:
    """N ranks (`two`, rank order) against one: the same steps, losses
    within TOL_PARALLEL, the step-1 reduced gradient within
    TOL_PARALLEL_GRAD of one rank's (where the one-rank run computed the
    f64 gradient, `g64`: no further from it than twice one rank's f32
    distance plus TOL_PARALLEL_GRAD), final parameters within TOL_PARALLEL
    (with an f64 reference: Adam's 2 lr a step); each rank's launches a
    step (`want_per_step`).  With the f64 gradient (`g64`, the rule
    `one["f64"]`: TOL_PARALLEL_F64's comment) the two ranks are also held
    to it."""
    steps = [one["steps"]] + [r["steps"] for r in two]
    require(steps == [PARALLEL_STEPS] * len(steps), f"{tag}: steps {steps}")
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(two[0]["losses"],
                                                               one["losses"]))
    errs = floor_grad_errs(two[0]["g1"], one["g1"])
    grad_leaf = max(errs, key=errs.get)
    grad_err = errs[grad_leaf]
    got, want = two[0]["params"], one["params"]
    require(set(got) == set(want) == set(one["g1"]), "the parameters' leaves differ")
    perr = {k: float(np.abs(got[k] - v).max()) / max(1.0, float(np.abs(v).max()))
            for k, v in want.items()}
    param_leaf = max(perr, key=perr.get)
    param_err = perr[param_leaf]
    param_tol, f64 = TOL_PARALLEL, ""
    grad_ok = grad_err <= TOL_PARALLEL_GRAD
    d_one = d_two = None
    if one["g64"]:
        e_one = floor_grad_errs(one["g1"], one["g64"])
        e_two = floor_grad_errs(two[0]["g1"], one["g64"])
        d_one, d_two = max(e_one.values()), max(e_two.values())
        if one["f64"] == "sign":
            grad_ok = d_two <= 2.0 * d_one + TOL_PARALLEL_GRAD
            param_tol = 2.0 * sum(one["lrs"])
        else:
            grad_ok = grad_ok and d_two <= TOL_PARALLEL_F64 * d_one
        f64 = (f"; the f64 step-1 gradient: one rank {d_one:.3g} off it (worst leaf "
               f"{max(e_one, key=e_one.get)}), two ranks {d_two:.3g} (worst leaf "
               f"{max(e_two, key=e_two.get)})")
    print(f"[{phase}] {tag}: {len(two)} ranks ({two[0]['backend']}; ZeRO-1 "
          f"{'on' if two[0]['zero1'] else 'off'}) vs one: losses {two[0]['losses']} vs "
          f"{one['losses']} (err {loss_err:.3g}); step-1 gradient {grad_err:.3g} of scale "
          f"(worst leaf {grad_leaf}){f64}; parameters {param_err:.3g} (worst leaf "
          f"{param_leaf}; held to {param_tol:.3g}); step walls "
          f"{[round(w, 3) for w in two[0]['step_walls']]} s ({len(two)} ranks) vs "
          f"{[round(w, 3) for w in one['step_walls']]} s (one); a rank's launches a step "
          f"{' / '.join(str(r['launches']) for r in two)}; collectives a step "
          f"{two[0]['calls']}, bytes {two[0]['bytes']}"
          + (f"; on the model group {two[0]['model_calls']}, bytes {two[0]['model_bytes']}"
             if two[0].get("model_calls") else ""))
    require(loss_err <= TOL_PARALLEL and grad_ok and param_err <= param_tol,
            f"{tag}: two ranks off one rank (losses {loss_err:.3g}, step-1 gradient "
            f"{grad_err:.3g} at {grad_leaf}{f64}, parameters {param_err:.3g} at {param_leaf})")
    if want_per_step is not None:
        for r, res in enumerate(two):
            require(res["launches"] == want_per_step,
                    f"{tag}: rank {r} launches a step {res['launches']} != {want_per_step}")
    return {"loss_err": loss_err, "param_err": param_err, "grad_err": grad_err,
            "f64_one": d_one, "f64_two": d_two, "model_calls": two[0].get("model_calls"), "model_bytes": two[0].get("model_bytes"),
            "warm_two": two[0]["warm_step"],
            "warm_one": one["warm_step"], "launches": two[0]["launches"], "calls": two[0]["calls"],
            "bytes": two[0]["bytes"], "zero1": two[0]["zero1"]}


def start_world1(corpora, vocab) -> dict:
    """(a): the train CLI with --distributed under torchrun at world 1
    (NCCL) on the flagship YAML for 3 steps and the dev pass, started
    ahead of the phase (its start-up is host work); the phase runs the
    plain CLI and `finish_world1` compares the two."""
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    cfgs = {}
    for tag in ("distributed", "plain"):
        exp = os.path.join(PARALLEL_DIR, f"exp_cli_{tag}")
        os.makedirs(exp)
        cfgs[tag] = train_config(corpora["train"], corpora["dev"], vocab, exp, torch.float32)
    log = open(os.path.join(PARALLEL_DIR, "torchrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "openasr_torch.bin.train", cfgs["distributed"], "--distributed"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "t0": time.time(), "cfgs": cfgs}


def stop_world1(world1) -> None:
    if world1["proc"].poll() is None:
        world1["proc"].kill()
    world1["log"].close()


def finish_world1(world1) -> dict:
    from openasr_torch.utils.checkpoint import load_package

    out = {}
    proc, cfgs = world1["proc"], world1["cfgs"]
    try:
        proc.wait(timeout=300)
    finally:
        stop_world1(world1)
    log_path = os.path.join(PARALLEL_DIR, "torchrun.log")
    # torchrun's run: from its start to its log's last write
    out["cli_wall"] = os.path.getmtime(log_path) - world1["t0"]
    with open(log_path) as f:
        log = f.read()
    require(proc.returncode == 0, f"torchrun --distributed failed:\n{log[-3000:]}")
    require("rank 0 of 1 on cuda:0 (nccl)" in log, "no NCCL data group logged")
    pkgs = {tag: load_package(os.path.join(PARALLEL_DIR, f"exp_cli_{tag}", "last.pkg"))
            for tag in cfgs}
    steps = [p["solver_state"]["step"] for p in pkgs.values()]
    err = scaled_tree_err(pkgs["distributed"]["model"]["components"],
                          pkgs["plain"]["model"]["components"])
    print(f"[parallel path] --distributed under torchrun at world 1 (NCCL) vs the plain CLI: "
          f"{steps} steps (+ dev), parameters {err:.3g} of scale; torchrun's run "
          f"{out['cli_wall']:.1f} s (started with the [text path]), the plain CLI's "
          f"{world1['plain_wall']:.1f} s")
    require(steps[0] == steps[1] >= PARALLEL_STEPS and err <= TOL_PARALLEL_WORLD1,
            f"--distributed world 1: steps {steps}, parameters {err:.3g}")
    out["world1_err"] = err
    return out


def flagship_step_launches(layers=None) -> dict:
    """A flagship training step's launches at dropout 0 (plain attention
    forwards), at `layers` encoder and decoder layers (default the YAML's)."""
    depth = {} if layers is None else {"num_layers": layers}
    per = per_step_launches({**FLAGSHIP,
                             "encoder": {**FLAGSHIP["encoder"], "dropout_rate": 0, **depth},
                             "decoder": {**FLAGSHIP["decoder"], "dropout_rate": 0, **depth}})
    want = {**per["train"]}
    want["flash_attention_fwd"] = want.pop("flash_attention_fwd_dropout")
    return {k: float(v) for k, v in want.items()}


def parallel_pairs(ranks) -> dict:
    """(b) the flagship, (c) GRU-CTC and expert parallelism: each job's two
    ranks against the one-rank run."""
    out = {}
    one, two = finish_pair(ranks, 0)
    out["flagship"] = check_pair("flagship", one, two, flagship_step_launches(GRID_LAYERS))
    require(out["flagship"]["zero1"], "ZeRO-1 did not run at two ranks")

    one, two = finish_pair(ranks, 1)
    out["gru_ctc"] = check_pair("gru_ctc", one, two)
    require(one["stats1"] and set(one["stats1"]) == set(two[0]["stats1"]), "no BatchNorm stats")
    stats_err = max(float(np.abs(two[0]["stats1"][k] - v).max()) / max(1.0, float(np.abs(v).max()))
                    for k, v in one["stats1"].items())
    final_err = scaled_tree_err(two[0]["pkg"]["batch_stats"], one["pkg"]["batch_stats"])
    print(f"[parallel path] gru_ctc BatchNorm running statistics, two ranks vs one: "
          f"{stats_err:.3g} of scale after step 1, {final_err:.3g} after step {PARALLEL_STEPS}")
    require(stats_err <= TOL_PARALLEL_STATS, f"gru_ctc batch_stats {stats_err:.3g}")
    out["gru_ctc"]["stats_err"] = stats_err

    one, two = finish_pair(ranks, 2)
    require(two[0]["experts"], "no expert table is rank-local")
    out["moe"] = check_pair("moe (expert parallel)", one, two)
    return out


def parallel_corpora(chars) -> dict:
    """The [parallel path]'s corpora, written at the start (the [wave
    check]'s CPU run reads the wave corpus while the kernels build)."""
    rng = np.random.RandomState(SEED + 40)
    train_json, _ = write_corpus("ptrain", rng, chars, 240, (400, 512), (20, 24))
    dev_json, _ = write_corpus("pdev", rng, chars, 4, (400, 512), (20, 24))
    wave_json, _ = write_wave_corpus("pwave", rng, chars, 18, (120000, 200000), (5, 20))
    return {"train": train_json, "dev": dev_json, "wave": wave_json}


GRU_CTC_CPU = os.path.join(WORK, "gru_ctc_cpu.pkl")


def start_gru_ctc_cpu(job) -> dict:
    """The CPU's share of the [wave check], `gru_ctc_precision(job, "cpu")`,
    in a process of this script at the lowest priority on half the host's
    threads, while this one builds the kernels and drives the card; ->
    {"proc", "job"}."""
    import pickle

    with open(GRU_CTC_CPU, "wb") as f:
        pickle.dump(job, f)
    env = {**os.environ, "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gru-ctc-cpu"],
                            cwd=ROOT, env=env, preexec_fn=lambda: os.nice(19))
    return {"proc": proc, "job": job}


def gru_ctc_cpu_worker() -> int:
    import pickle

    with open(GRU_CTC_CPU, "rb") as f:
        job = pickle.load(f)
    res = gru_ctc_precision(job, "cpu")
    with open(GRU_CTC_CPU + ".out", "wb") as f:
        pickle.dump(res, f)
    return 0


def gru_ctc_cpu_result(started) -> dict:
    import pickle

    rc = started["proc"].wait(timeout=600)
    require(rc == 0, f"the [wave check]'s CPU process exited {rc}")
    with open(GRU_CTC_CPU + ".out", "rb") as f:
        return {**pickle.load(f), "job": started["job"]}


def parallel_jobs(vocab, corpora) -> list:
    """(b)-(d)'s jobs: the flagship and the MoE YAML at GRID_LAYERS layers,
    libri's GRU-CTC, at two ranks' budget."""
    data = {"trainset": corpora["train"], "devset": corpora["train"], "vocab_path": vocab}
    return [{"tag": "flagship", "yaml": FLAGSHIP_YAML, "vocab": vocab, "data": data, "ndata": 2,
             "training": {"batch_frames": 18000}, "sections": GRID_SECTIONS},
            gru_ctc_job(vocab, corpora["wave"]),
            {"tag": "moe", "yaml": MOE_YAML, "vocab": vocab, "data": data, "ndata": 2,
             "training": {"batch_frames": 18000}, "sections": GRID_SECTIONS}]


def phase_parallel(ranks, world1) -> dict:
    """Data parallelism on the card (`[parallel path]`): (a) the train CLI
    with --distributed under torchrun at world 1 (NCCL, `start_world1`)
    against the plain CLI; (b) the flagship at full width and GRID_LAYERS
    layers, dropout 0, f32, two ranks over gloo on cuda:0 against one rank,
    3 steps of the flagship's global batch (18000 frames a rank); (c) the
    same for the libri GRU-CTC config (its BatchNorm statistics over the
    global batch); (d) expert parallelism (conv-ctc-transformer-moe.yaml at
    GRID_LAYERS layers); ZeRO-1 on at two ranks.  The ranks
    (`start_ranks(parallel_jobs(...))`) were started a phase ahead and
    have set up meanwhile."""
    from openasr_torch.bin import train

    t_phase = time.time()
    out = {}
    train.main([world1["cfgs"]["plain"], "--device", "cuda"])
    world1["plain_wall"] = time.time() - t_phase
    pairs = parallel_pairs(ranks)
    out.update(finish_world1(world1), **pairs)
    out["wall"] = time.time() - t_phase
    print(f"[parallel path] the phase {out['wall']:.1f}s")
    return out


# ------------------------------------------------------------ model path

TP_SHAPE_HEADS = 4         # a tp2 rank's heads at the flagship's 8


def model_job(tag, yaml_path, vocab, data, sequence_parallel) -> dict:
    return {"tag": tag, "yaml": yaml_path, "vocab": vocab, "data": data, "ndata": 1,
            "model": 2, "training": {"batch_frames": 18000,
                                     "sequence_parallel": sequence_parallel},
            "f64": "rounding", "sections": GRID_SECTIONS}


def check_layer_norm_split(tag, two) -> dict:
    """Each rank's LayerNorm backward launches: the dx-only mode exactly at
    the sites that ran on T-shards (`sharded_ln`, from the host's shapes),
    the partials mode at the others; -> rank 0's counts and `dx_rows`, its
    dx-only launches by their row count (a rank's B T / 2 or B U / 2)."""
    out = {}
    for r, res in enumerate(two):
        n = res["launch_totals"]
        want_dx = sum(sum(s.values()) for s in res["sharded_ln"])
        total = n["layer_norm_fwd"]
        require(n["layer_norm_bwd_dx"] == want_dx and n["layer_norm_bwd"] == total - want_dx,
                f"[model path] {tag}: rank {r} LayerNorm backwards {n['layer_norm_bwd']} + "
                f"dx-only {n['layer_norm_bwd_dx']}, want {total - want_dx} + {want_dx}")
        dx_rows = {}
        for sites in res["sharded_ln"]:
            for rows, k in sites.items():
                dx_rows[rows] = dx_rows.get(rows, 0) + k
        out[r] = {"dx": n["layer_norm_bwd_dx"], "partials": n["layer_norm_bwd"],
                  "sharded_a_step": [sum(s.values()) for s in res["sharded_ln"]],
                  "dx_rows": dx_rows}
    print(f"[model path] {tag}: a rank's LayerNorm backwards over {PARALLEL_STEPS} steps, "
          f"dx-only (row 2) / partials (row 3): "
          + "; ".join(f"rank {r} {v['dx']} / {v['partials']} (sharded sites a step "
                      f"{v['sharded_a_step']}; dx-only launches by rows [n, 512]: "
                      f"{v['dx_rows']})" for r, v in out.items()))
    return out[0]


def tp_attention_times(shapes, errs) -> dict:
    """The attention kernels at a tp2 rank's encoder shape [B, T', 4, 64]
    (the flagship's largest batch, half its heads), dropout 0.1 as the
    training path runs them: the forward held to its plain version, device
    ms of the kernels, the plain versions and SDPA, and the bounds."""
    rng = np.random.RandomState(SEED + 70)
    b, t = shapes["b"], shapes["t"]
    lens = np.asarray(shapes["enc_lens"])
    out = {}
    for dtype in DTYPES:
        fwd = attention_fwd_row(b, TP_SHAPE_HEADS, 64, t, t, False, lens, dtype, rng, errs,
                                DROPOUT)
        bwd = attention_bwd_times(b, TP_SHAPE_HEADS, 64, t, t, False, lens, dtype, rng,
                                  cold=False)
        out[DTYPE_NAME[dtype]] = {
            "fwd": {k: fwd[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bwd": {k: bwd[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
        print(f"[model path] attention at a tp2 rank's [{b}, {t}, {TP_SHAPE_HEADS}, 64] "
              f"{DTYPE_NAME[dtype]}: forward (row 4) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in out[DTYPE_NAME[dtype]]["fwd"].items())
              + " ms; backward (rows 5+6) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in out[DTYPE_NAME[dtype]]["bwd"].items()) + " ms")
    return out


def model_jobs(vocab, chars) -> list:
    rng = np.random.RandomState(SEED + 41)
    train_json, _ = write_corpus("mtrain", rng, chars, 160, (400, 512), (20, 24))
    data = {"trainset": train_json, "devset": train_json, "vocab_path": vocab}
    return [model_job("tp_flagship_sp", FLAGSHIP_YAML, vocab, data, True),
            model_job("tp_flagship", FLAGSHIP_YAML, vocab, data, False),
            model_job("tp_moe", MOE_YAML, vocab, data, True)]


def phase_model(ranks, shapes, errs) -> dict:
    """Tensor and sequence parallelism on the card (`[model path]`): the
    flagship YAML with sequence parallelism on and off, and the MoE YAML,
    each on a dp1 x tp2 grid of two gloo ranks on cuda:0 (`start_ranks(
    model_jobs(...))`, started a phase ahead) against one rank; then the
    attention kernels at a rank's shape."""
    t_phase = time.time()
    jobs = ranks["jobs"]
    out = {}
    for i, job in enumerate(jobs):
        tag = job["tag"]
        one, two = finish_pair(ranks, i)
        out[tag] = check_pair(tag, one, two, phase="model path")
        out[tag]["ln"] = check_layer_norm_split(tag, two)
        out[tag]["launches_two"] = [r["launches"] for r in two]
    require(out["tp_flagship"]["ln"]["dx"] == 0, "sequence parallelism off ran a dx-only one")
    require(out["tp_flagship_sp"]["ln"]["dx"] > 0, "no T-sharded site ran a dx-only LayerNorm "
                                                  "backward")
    out["attention"] = tp_attention_times(shapes, errs)
    out["wall"] = time.time() - t_phase
    print(f"[model path] the phase {out['wall']:.1f}s")
    return out


# ------------------------------------------------------------ pipe path

PIPE_DIR = os.path.join(WORK, "pipe")
PIPE_STAGES = 2
PIPE_MICROBATCH = 4
# remat on against off: the same kernels recompute the same activations
# from the same inputs and replayed generators, so the step is the plain
# step's up to what differs between two runs of the plain step itself (the
# CUDA CTC loss's backward accumulates with atomics): remat's gradients no
# further from the plain step's than twice a second plain run's, plus
# TOL_REMAT of max(1, |g|); the losses equal
TOL_REMAT = 1e-7
REMAT_UTTS = 41


def pipe_yaml(**encoder) -> str:
    """The flagship YAML with encoder.pipeline: true (and `encoder`), the
    run's own copy."""
    import yaml

    with open(FLAGSHIP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["encoder"].update(pipeline=True, **encoder)
    path = os.path.join(PIPE_DIR, "flagship_pipeline.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def pipe_step_launches(m: int) -> dict:
    """A pp2 rank's launches in a flagship step (dropout 0) whose batch ran
    m microbatches: its stage's 3 encoder layers m times (2 LayerNorms and
    one attention each), the replicated rest (the encoder's final LayerNorm,
    the decoder) once; each forward's backward too."""
    one = flagship_step_launches()
    layers = FLAGSHIP["encoder"]["num_layers"]
    held = layers // PIPE_STAGES
    return {k: v + (2 if k.startswith("layer_norm") else 1) * (held * m - layers)
            for k, v in one.items()}


def check_pipe_launches(two) -> dict:
    """Each rank's launches over the steps equal `pipe_step_launches` of
    each step's microbatch count, exactly; -> rank 0's a step."""
    for r, res in enumerate(two):
        want = {}
        for step in res["microbatches"]:
            for k, v in pipe_step_launches(step["m"]).items():
                want[k] = want.get(k, 0) + v
        got = {k: v for k, v in res["launch_totals"].items() if v}
        require(got == {k: int(v) for k, v in want.items() if v},
                f"[pipe path] rank {r} launches {got} != {want}")
    return two[0]["launches"]


def remat_batch(feats, n, rng) -> dict:
    """n training utterances, padded as the collate pads them, with random
    targets of 20-24 tokens."""
    from openasr_torch.data.collate import gen_causal_targets

    utts = sorted(feats)[:n]
    x, lengths = padded_features(feats, utts)
    toks = [list(rng.randint(3, 4232, size=rng.randint(20, 25))) for _ in utts]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True)
    return {"feats": x, "feat_lengths": lengths, "ids": ids.astype(np.int64),
            "labels": labels, "paddings": paddings}


def check_remat(feats) -> dict:
    """One f32 training step of the flagship (dropout 0.1) with
    `encoder.remat` and `decoder.remat` on, against the same step with them
    off, run twice: the same seeded weights, batch and generators; the
    losses equal, remat's gradients as close to the plain step's as a
    second plain run's (`TOL_REMAT`), and the peak device memory of each."""
    from openasr_torch.models import get_model_class
    from openasr_torch.models.layers import TrainRNG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = remat_batch(feats, REMAT_UTTS, np.random.RandomState(SEED + 80))
    out = {}
    for remat in (False, "again", True):
        cfg = {**FLAGSHIP, "encoder": {**FLAGSHIP["encoder"], "remat": remat is True},
               "decoder": {**FLAGSHIP["decoder"], "remat": remat is True}}
        model = get_model_class("conv-ctc-transformer").create_model(
            cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rng = TrainRNG(SEED, "cuda")
        losses = model.loss(tb, rng, label_smooth=0.1,
                            empty_rows=model.has_empty_rows(batch["feat_lengths"]))
        total = losses["ce_loss"] / losses["n_tokens"] + losses["ctc_loss"] / losses["n_seqs"]
        total.backward()
        torch.cuda.synchronize()
        out[remat] = {"loss": float(total.detach()), "peak_bytes":
                      torch.cuda.max_memory_allocated() - base,
                      "grads": {n: p.grad.detach().clone()
                                for n, p in model.module.named_parameters()}}
        del model, tb, losses, total
    off, on = out[False], out[True]
    loss_err = abs(on["loss"] - off["loss"]) / max(1.0, abs(off["loss"]))

    def worst(run):
        errs = {n: max_err(run["grads"][n], g) / max(1.0, float(g.abs().max()))
                for n, g in off["grads"].items()}
        return max(errs.values()), max(errs, key=errs.get)

    grad_err, grad_leaf = worst(on)
    again_err, again_leaf = worst(out["again"])
    print(f"[pipe path] remat: one f32 flagship step, dropout 0.1, {REMAT_UTTS} utterances "
          f"(T {batch['feats'].shape[1]}): loss {on['loss']:.6f} with remat vs "
          f"{off['loss']:.6f} without (err {loss_err:.3g}); gradients {grad_err:.3g} of "
          f"max(1, |g|) off the plain step's (worst leaf {grad_leaf}), a second plain run "
          f"{again_err:.3g} off it (worst leaf {again_leaf}; remat held to twice that + "
          f"{TOL_REMAT}); torch.cuda.max_memory_allocated over the step "
          f"{on['peak_bytes'] / 2**20:.1f} MiB with remat, {off['peak_bytes'] / 2**20:.1f} "
          f"MiB without")
    require(loss_err == 0.0 and grad_err <= 2 * again_err + TOL_REMAT,
            f"remat changed the step: loss {loss_err:.3g}, gradients {grad_err:.3g} "
            f"(a second plain run {again_err:.3g})")
    return {"loss_err": loss_err, "grad_err": grad_err, "again_err": again_err,
            "peak_mib": {"remat": on["peak_bytes"] / 2**20, "plain": off["peak_bytes"] / 2**20}}


def pipe_decode(model_pkg, vocab, test_json) -> dict:
    """Decode the test utterances through bin/infer.py with the pp2 run's
    stacked package and with the same package after
    `bin/stack_encoder_pkg.py --unstack` (whose configs then take
    encoder.pipeline: false, as a user's YAML would: the tool, like the
    JAX one, converts the weights only): the hypotheses equal."""
    from openasr_torch.bin import infer, stack_encoder_pkg
    from openasr_torch.utils.checkpoint import load_package, save_package

    stacked = os.path.join(PIPE_DIR, "pp2.pkg")
    save_package({"model": model_pkg, "optim_state": None}, stacked)
    unstacked = os.path.join(PIPE_DIR, "pp2_unstacked.pkg")
    stack_encoder_pkg.main([stacked, unstacked, "--unstack"])
    pkg = load_package(unstacked)
    pkg["model"]["configs"]["encoder"]["pipeline"] = False
    save_package(pkg, unstacked)
    hyps, walls = {}, {}
    for tag, path in (("stacked", stacked), ("unstacked", unstacked)):
        hyp = os.path.join(PIPE_DIR, f"hyp_{tag}.txt")
        t0 = time.time()
        infer.main(["--model_type", "conv-ctc-transformer", "--model_pkg", path,
                    "--vocab_path", vocab, "--json_file", test_json, "--output", hyp,
                    "--add_blk", "--nbest", "5", "--maxlen", "40", "--batch_frames", "36000",
                    "--offline", "--device", "cuda"])
        walls[tag] = time.time() - t0
        with open(hyp, encoding="utf-8") as f:
            hyps[tag] = [line for line in f if line.strip()]
    n = len(json.load(open(test_json)))
    print(f"[pipe path] decode of {n} utterances with the pp2 run's stacked package "
          f"({walls['stacked']:.2f}s) and unstacked ({walls['unstacked']:.2f}s): "
          f"{sum(a == b for a, b in zip(hyps['stacked'], hyps['unstacked']))} of "
          f"{len(hyps['stacked'])} hypotheses equal")
    require(len(hyps["stacked"]) == n and hyps["stacked"] == hyps["unstacked"],
            "the stacked and unstacked packages decode otherwise")
    return walls


def pipe_rows(step, launches, errs) -> list:
    """Rows 1, 3, 4 and 5+6 at a stage's microbatch shape of the pp2 run's
    batch of the most microbatches ([B / m T', 512]; [B / m, T', 8, 64], f32),
    each held to its plain version, with device ms of the kernel, the plain
    version and the library call, the bound, and rank 0's launches over
    the run."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )
    from openasr_torch.kernels.layer_norm import (
        fused_layer_norm,
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    dtype, dm, h, d = torch.float32, 512, 8, 64
    mb, t = step["b"] // step["m"], step["t"]
    rng = np.random.RandomState(SEED + 81)
    note = (f"a pp2 stage's microbatch of the [pipe path]'s batch of the most microbatches "
            f"(B {step['b']}, m {step['m']}); launches: rank 0's over its {PARALLEL_STEPS} "
            "steps")
    rows = []
    n = mb * t
    x, g, beta = ln_inputs(n, dm, dtype, rng)
    dy = torch.from_numpy(rng.randn(n, dm).astype(np.float32)).cuda()
    y, mean, rstd = fused_layer_norm(x, g, beta)
    e_fwd = max_err(y, layer_norm_reference(x, g, beta)[0])
    got = layer_norm_bwd(x, dy, g, mean, rstd)
    want = layer_norm_bwd_reference(x, dy, g, mean, rstd)
    e_bwd = max(scaled_err(a, b)[0] / scaled_err(a, b)[1] for a, b in zip(got, want))
    require(e_fwd <= TOL_LN[dtype] and e_bwd <= TOL_LN_BWD[dtype],
            f"[pipe path] LayerNorm at [{n}, {dm}]: forward {e_fwd:.3g}, backward {e_bwd:.3g}")
    xl, gl, bl = (z.clone().requires_grad_() for z in (x, g, beta))
    for name, replaces, err, kernel, plain, library, nbytes, ops, key in (
        ("layer_norm_fwd_pipe[float32]", "openasr_tpu/kernels/layer_norm.py:56", e_fwd,
         lambda: fused_layer_norm(x, g, beta), lambda: layer_norm_reference(x, g, beta),
         lambda: F.layer_norm(x, (dm,), g, beta, 1e-6),
         2 * n * dm * 4 + 2 * n * 4 + 2 * dm * 4, 8 * n * dm, "layer_norm_fwd"),
        ("layer_norm_bwd_pipe[float32]", "openasr_tpu/kernels/layer_norm.py:85", e_bwd,
         lambda: layer_norm_bwd(x, dy, g, mean, rstd),
         lambda: layer_norm_bwd_reference(x, dy, g, mean, rstd), None,
         3 * n * dm * 4 + 2 * n * 4 + 3 * dm * 4, 13 * n * dm, "layer_norm_bwd"),
    ):
        rows.append({
            "name": name, "route": "cuda", "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": replaces, "shape": [n, dm], "launches": launches[key],
            "launches_are": note, "max_abs_err": err,
            "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": (device_ms(library) if library is not None else
                           backward_ms(lambda: F.layer_norm(xl, (dm,), gl, bl, 1e-6),
                                       (xl, gl, bl), dy)),
            **bound(nbytes, ops, torch.float32)})
    lens = np.full(mb, t, np.int32)
    fwd = attention_fwd_row(mb, h, d, t, t, False, lens, dtype, rng, errs, 0.0)
    rows.append({"name": "flash_attention_fwd_pipe[float32]", **fwd,
                 "launches": launches["flash_attention_fwd"], "launches_are": note,
                 "max_abs_err": errs[("flash_attention_fwd", dtype)]})
    bwd = attention_bwd_times(mb, h, d, t, t, False, lens, dtype, rng, cold=False)
    args = bwd["kernel_args"][:6] + bwd["kernel_args"][7:]
    e_att = max(scaled_err(a, b)[0] / scaled_err(a, b)[1]
                for a, b in zip(flash_attention_bwd(*args), flash_attention_bwd_reference(*args)))
    require(e_att <= TOL_FLASH_BWD[dtype], f"[pipe path] attention backward {e_att:.3g}")
    rows.append({
        "name": "flash_attention_bwd_pipe[float32]", "route": "cuda",
        "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: delta :468, "
                    "dK/dV :238, dQ :327)",
        "shape": bwd["shape"], "launches": launches["flash_attention_bwd_dkv"],
        "launches_are": note + " (dK/dV launches; dQ and the statistics alike)",
        "max_abs_err": e_att, "dropout_rate": DROPOUT,
        **{k: bwd[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    for r in rows:
        print(f"[pipe path] {r['name']} {r['shape']}: err {r['max_abs_err']:.3g}, device ms "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}); "
              f"launches {r['launches']}")
    return rows


def pipe_jobs(vocab, chars) -> list:
    os.makedirs(PIPE_DIR)
    rng = np.random.RandomState(SEED + 42)
    train_json, _ = write_corpus("pptrain", rng, chars, 160, (400, 512), (20, 24))
    data = {"trainset": train_json, "devset": train_json, "vocab_path": vocab}
    return [{"tag": "pp2_flagship", "yaml": pipe_yaml(), "vocab": vocab, "data": data,
             "ndata": 1, "pipe": PIPE_STAGES, "f64": "rounding",
             "training": {"batch_frames": 18000, "pipeline_microbatch": PIPE_MICROBATCH}}]


def phase_pipe(ranks, vocab, test_json, train_feats, errs) -> dict:
    """Pipeline parallelism on the card (`[pipe path]`): the flagship YAML
    with encoder.pipeline: true, f32, dropout 0, at pp2 (two gloo ranks on
    cuda:0, layers 0-2 and 3-5, `pipeline_microbatch` 4) against one rank
    running the same stacked layers in order, 3 steps, with the one rank's
    f64 step-1 gradient; each rank's launches held exactly to its layers
    times each step's microbatches plus the replicated parts; remat on
    against off; the pp2 package decoded stacked and unstacked; rows 1,
    3-6 at a stage's microbatch shape."""
    t_phase = time.time()
    one, two = finish_pair(ranks, 0)
    out = check_pair("pp2 flagship", one, two, phase="pipe path")
    out["launches"] = check_pipe_launches(two)
    steps = two[0]["microbatches"]
    require([s["m"] for s in steps] == [s["m"] for s in two[1]["microbatches"]],
            "the stages ran other microbatch counts")
    bubbles = [(PIPE_STAGES - 1) / (s["m"] + PIPE_STAGES - 1) for s in steps]
    print(f"[pipe path] pp2 batches (B, T', m): {[(s['b'], s['t'], s['m']) for s in steps]}; "
          f"bubble shares (S - 1) / (m + S - 1) {[round(b, 3) for b in bubbles]}; a rank's "
          f"launches a step {' / '.join(str(r['launches']) for r in two)} (one rank "
          f"{one['launches']}); the pipe group a step: calls {two[0]['pipe_calls']}, bytes "
          f"{two[0]['pipe_bytes']}; warm step wall {two[0]['warm_step']:.3f} s at two ranks "
          f"vs {one['warm_step']:.3f} s at one")
    out.update(microbatches=steps, bubbles=bubbles, pipe_calls=two[0]["pipe_calls"],
               pipe_bytes=two[0]["pipe_bytes"], one_launches=one["launches"])
    out["remat"] = check_remat(train_feats)
    out["decode"] = pipe_decode(two[0]["pkg"], vocab, test_json)
    most = max(steps, key=lambda s: (s["m"], s["b"], s["t"]))
    out["rows"] = pipe_rows(most, two[0]["launch_totals"], errs)
    out["wall"] = time.time() - t_phase
    print(f"[pipe path] the phase {out['wall']:.1f}s")
    return out


def parallel_cards(n: int) -> int:
    """`chip_smoke.py --parallel-cards N`, on a machine with N cards: the
    [parallel path]'s flagship and MoE jobs over NCCL, a card a rank (N
    ranks under torchrun, `--parallel-worker` from its environment), 3 steps
    of the flagship's 36000-frame global batch (36000 / N frames a rank)
    against one rank on cuda:0, held and printed as the phase's pairs."""
    import pickle

    from openasr_torch.parallel import Grid

    require(torch.cuda.device_count() >= n, f"{n} cards asked, "
                                            f"{torch.cuda.device_count()} present")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    phase_build()
    vocab, chars = write_vocab()
    rng = np.random.RandomState(SEED + 40)
    train_json, _ = write_corpus("ptrain", rng, chars, 240, (400, 512), (20, 24))
    data = {"trainset": train_json, "devset": train_json, "vocab_path": vocab}
    for tag, yaml_path, want, model in (
            ("flagship", FLAGSHIP_YAML, flagship_step_launches(), 1),
            ("moe", MOE_YAML, None, 1),
            (f"flagship dp{n // 2} x tp2", FLAGSHIP_YAML, None, 2)):
        job = {"tag": f"{tag}_cards".replace(" ", ""), "yaml": yaml_path, "vocab": vocab,
               "data": data, "ndata": n // model, "model": model,
               "training": {"batch_frames": 36000 * model // n}}
        job_path = os.path.join(PARALLEL_DIR, f"job_{job['tag']}.pkl")
        with open(job_path, "wb") as f:
            pickle.dump([job], f)
        one = parallel_train(job, Grid.single("cuda:0"))
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", str(n), os.path.abspath(__file__),
                              "--parallel-worker", job_path], cwd=ROOT, timeout=600)
        require(res.returncode == 0, f"{tag} over {n} cards: torchrun exited {res.returncode}")
        ranks = []
        for r in range(n):
            with open(f"{job_path}.0.{r}", "rb") as f:
                ranks.append(pickle.load(f))
        check_pair(f"{tag} over {n} cards", one, ranks, want)
    print(nvidia_smi())
    return 0


# ------------------------------------------------------------------ main

# --------------------------------------------------------------- tools path

TOOLS_FLASH_SHAPES = [(8, 256), (16, 2048)]
# plot_attention and the converted package, card against CPU, f32
TOL_TOOLS = 1e-3


def raw_kernel_counts(path) -> list:
    """The `[profile]` reading before utils/trace.py: every `kernel` event
    of the trace whose name holds a port kernel's, counted as it stands."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for n in PORT_KERNELS:
            if n in e.get("name", ""):
                calls, us = found.get(n, (0, 0.0))
                found[n] = (calls + 1, us + float(e.get("dur", 0.0)))
    return [(n, c, us) for n, (c, us) in sorted(found.items())]


def reference_checkpoint(model_cfg, rng) -> dict:
    """A reference (eastonYi/OpenASR) package of conv-ctc-transformer at
    `model_cfg`'s widths, in its layout (`{name}_config` / `{name}_state`,
    torch's Linear, Conv2d and packed MultiheadAttention weights), drawn
    from `rng` at a trained model's scale (1 / sqrt(fan in))."""
    enc_cfg, dec_cfg = dict(model_cfg["encoder"]), dict(model_cfg["decoder"])
    d, v = int(enc_cfg["d_model"]), int(dec_cfg["vocab_size"])
    ff = int(enc_cfg["dim_feedforward"])
    wide = 2 * ff if enc_cfg["activation"] == "glu" else ff

    def t(*shape, mean=0.0):
        std = 0.02 if len(shape) == 1 else 1.0 / float(np.sqrt(np.prod(shape[1:])))
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
        return torch.from_numpy(x)

    def layer(sd, p, attns, norms):
        for a in attns:
            sd.update({f"{p}.{a}.in_proj_weight": t(3 * d, d), f"{p}.{a}.in_proj_bias": t(3 * d),
                       f"{p}.{a}.out_proj.weight": t(d, d), f"{p}.{a}.out_proj.bias": t(d)})
        sd.update({f"{p}.linear1.weight": t(wide, d), f"{p}.linear1.bias": t(wide),
                   f"{p}.linear2.weight": t(d, ff), f"{p}.linear2.bias": t(d)})
        for n in norms:
            sd.update({f"{p}.{n}.weight": t(d, mean=1.0), f"{p}.{n}.bias": t(d)})

    layers = int(enc_cfg["sub"]["layer_num"])
    enc = {"sub.affine.weight": t(d, 32 * (int(enc_cfg["input_dim"]) - 2 * layers)),
           "sub.affine.bias": t(d), "transformer_encoder.norm.weight": t(d, mean=1.0),
           "transformer_encoder.norm.bias": t(d)}
    for i in range(layers):
        enc.update({f"sub.conv.subsample/conv{i}.weight": t(32, 1 if i == 0 else 32, 3, 3),
                    f"sub.conv.subsample/conv{i}.bias": t(32)})
    for i in range(int(enc_cfg["num_layers"])):
        layer(enc, f"transformer_encoder.layers.{i}", ("self_attn",), ("norm1", "norm2"))
    dec = {"emb.weight": t(v, d), "output_affine.bias": t(v)}
    for i in range(int(dec_cfg["num_layers"])):
        layer(dec, f"transformer_block.layers.{i}", ("self_attn", "multihead_attn"),
              ("norm1", "norm2", "norm3"))
    return {"splayer_config": dict(model_cfg["signal"]), "encoder_config": enc_cfg,
            "encoder_state": enc, "decoder_config": dec_cfg, "decoder_state": dec,
            "ctc_fc_state": {"weight": t(v, d)}}


def tools_bench_flash() -> list:
    from openasr_torch.bin import bench_flash

    try:
        return bench_flash.run(TOOLS_FLASH_SHAPES, torch.device("cuda"))
    except RuntimeError as e:
        raise PhaseError(f"bench_flash: {e}") from e


def tools_profile_step() -> dict:
    """profile_step --model online --trace --ops at bench.py's shape, bf16."""
    from openasr_torch.bin import profile_step

    out = profile_step.main(["--model", "online", "--trace", "--ops"])
    split = out["trace"]["split"]
    total = sum(c["share"] for c in split["classes"].values()) + split["idle_share"]
    require(abs(total - 1.0) <= 1e-6, f"class shares and idle sum to {total}")
    zero = [c for c in ("attention", "layer_norm", "fbank") if split["classes"][c]["ms"] <= 0]
    require(not zero, f"profile_step: no device time in {zero}")
    named = {n for n, _, _ in port_kernels(out["trace"]["kernels"])}
    require(named == set(PORT_KERNELS),
            f"profile_step's trace lacks {sorted(set(PORT_KERNELS) - named)}")
    return out


def tools_profile_readers(logdir) -> None:
    """The `[profile]` window's trace: the raw count against utils/trace.py."""
    path = profile_trace(logdir)
    raw, reader = raw_kernel_counts(path), profile_report(logdir)
    print("[tools path] the [profile] trace, raw count: " + "; ".join(
        f"{n} {c} {us:.1f} us" for n, c, us in raw))
    print("[tools path] the [profile] trace, utils/trace.py: " + "; ".join(
        f"{n} {c} {us:.1f} us" for n, c, us in reader))
    same = (len(raw) == len(reader) and all(
        a[:2] == b[:2] and abs(a[2] - b[2]) <= 1e-6 * max(1.0, a[2])
        for a, b in zip(raw, reader)))
    require(same, "the two readings of the [profile] trace differ")


def tools_plot_attention(pkg, vocab, test_json) -> dict:
    """plot_attention on the card and on the CPU (.npz: matplotlib blocked)."""
    import io

    from openasr_torch.bin import plot_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maps = {}
    blocked = sys.modules.get("matplotlib", False)
    sys.modules["matplotlib"] = None
    try:
        for device in ("cuda", "cpu"):
            out = os.path.join(WORK, f"attention_{device}")
            with contextlib.redirect_stdout(io.StringIO()):
                plot_attention.main([
                    "--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                    "--vocab_path", vocab, "--json_file", test_json, "--output_dir", out,
                    "--utts", "2", "--offline", "--add_blk", "--device", device])
            maps[device] = {n: np.load(os.path.join(out, n))["attn"]
                            for n in sorted(os.listdir(out))}
    finally:
        if blocked is False:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = blocked
    card, cpu = maps["cuda"], maps["cpu"]
    require(card.keys() == cpu.keys() and len(card) == 18,
            f"attention maps {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    require(all(np.isfinite(a).all() for a in card.values()), "non-finite attention maps")
    err = max(float(np.abs(card[n] - cpu[n]).max()) for n in card)
    require(err <= TOL_TOOLS, f"plot_attention maps card vs CPU {err:.3g} > {TOL_TOOLS}")
    return {"maps": len(card), "err": err}


def tools_convert_reference(feats) -> dict:
    """A seeded reference checkpoint at the flagship's widths through
    convert_reference_pkg, the package on the card against the CPU."""
    import io

    from openasr_torch.bin import convert_reference_pkg
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_checkpoint(FLAGSHIP, np.random.default_rng(SEED))
    ref_pt, out = os.path.join(WORK, "reference.pt"), os.path.join(WORK, "converted.pkg")
    torch.save({"model": ref}, ref_pt)  # a solver checkpoint
    del ref
    with contextlib.redirect_stdout(io.StringIO()) as log:
        convert_reference_pkg.main([ref_pt, out, "--model_type", "conv-ctc-transformer"])
    pkg = load_package(out)
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED))
    outs = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(pkg["configs"],
                                                                      device=device)
        model.restore(pkg)
        x, lens, ids = (torch.from_numpy(batch[k]).to(device)
                        for k in ("feats", "feat_lengths", "ids"))
        with torch.inference_mode():
            enc, elens = model.module.encode(x, lens)
            ctc, _, _ = model.module(x, lens, ids)
        outs[device] = [t.float().cpu() for t in (enc, elens, ctc)]
    (enc_g, el_g, ctc_g), (enc_c, el_c, ctc_c) = outs["cuda"], outs["cpu"]
    require(torch.equal(el_g, el_c), "converted model: encoder lengths differ")
    require(bool(torch.isfinite(ctc_g).all()), "converted model: non-finite CTC logits")
    valid = (torch.arange(enc_g.shape[1])[None, :] < el_c[:, None])[..., None]
    e_enc = max_err(enc_g * valid, enc_c * valid)
    e_ctc = max_err(ctc_g * valid, ctc_c * valid)
    require(e_enc <= TOL_TOOLS and e_ctc <= TOL_TOOLS,
            f"converted model card vs CPU: encoder {e_enc:.3g}, CTC logits {e_ctc:.3g}")
    return {"log": log.getvalue().strip(), "enc_err": e_enc, "ctc_err": e_ctc}


def phase_tools(pkg, vocab, test_json, test_feats) -> dict:
    """The tools on the card: bench_flash, profile_step, the two trace
    readings, plot_attention and convert_reference_pkg."""
    t0 = time.time()
    flash = tools_bench_flash()
    profile = tools_profile_step()
    tools_profile_readers(os.path.join(WORK, "exp_train_bfloat16", "profile"))
    maps = tools_plot_attention(pkg, vocab, test_json)
    converted = tools_convert_reference(test_feats)
    return {"flash": flash, "profile": profile, "maps": maps, "converted": converted,
            "wall": time.time() - t0}


def print_tools(tools) -> None:
    """The `[tools path]` summary line."""
    split, ops = tools["profile"]["trace"]["split"], tools["profile"]["ops"]
    print("[tools path] bench_flash (B, T): " + "; ".join(
        f"({r['b']}, {r['t']}) fwd {r['flash_fwd']:.1f} vs SDPA {r['sdpa_fwd']:.1f} us "
        f"({r['sdpa_fwd'] / r['flash_fwd']:.2f}x), f+b {r['flash_fb']:.1f} vs "
        f"{r['sdpa_fb']:.1f} us ({r['sdpa_fb'] / r['flash_fb']:.2f}x), chain errors "
        f"{r['err_fwd']:.3g} / {r['err_grad']:.3g}" for r in tools["flash"])
        + f"; profile_step online bf16: step wall {tools['profile']['trace']['wall_ms']:.3f} ms "
          f"without the profiler, window {split['span_ms']:.3f} ms a step with it, "
          + ", ".join(f"{c} {r['ms']:.3f} ms ({100 * r['share']:.1f}%)"
                      for c, r in split["classes"].items())
        + f", idle {100 * split['idle_share']:.1f}%; {ops['f32_count']} f32-operand "
          f"matmul/conv calls, {ops['gflop']:.1f} GFLOP a step; plot_attention "
          f"{tools['maps']['maps']} maps card vs CPU {tools['maps']['err']:.3g}; converted "
          f"reference checkpoint ({tools['converted']['log']}) card vs CPU encoder "
          f"{tools['converted']['enc_err']:.3g}, CTC logits {tools['converted']['ctc_err']:.3g}"
          f"; the phase {tools['wall']:.1f}s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--serving-worker"]:
        return serving_worker(sys.argv[2])
    if sys.argv[1:2] == ["--gru-ctc-cpu"]:
        return gru_ctc_cpu_worker()
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(*sys.argv[2:6])
    if sys.argv[1:2] == ["--parallel-cards"]:
        try:
            return parallel_cards(int(sys.argv[2]))
        except PhaseError as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    errs, launches = {}, {}
    clock = PhaseClock()
    gru_cpu = serving = world1 = None
    grids = []
    try:
        rng = np.random.RandomState(SEED)
        vocab, chars = write_vocab()
        test_json, test_feats = write_corpus("test", rng, chars, 8, (600, 1200), (12, 12))
        train_json, train_feats = write_corpus("train", rng, chars, 128, (400, 512), (20, 24))
        dev_json, _ = write_corpus("dev", rng, chars, 16, (400, 512), (20, 24))
        wtest_json, wtest = write_wave_corpus("wtest", rng, chars, 8, (160000, 217600),
                                              (12, 12))
        wtrain_json, wtrain = write_wave_corpus("wtrain", rng, chars, 128, (64000, 83200),
                                                (20, 24))
        wdev_json, _ = write_wave_corpus("wdev", rng, chars, 16, (64000, 83200), (20, 24))
        pcorpora = parallel_corpora(chars)
        clock.done("corpora", "corpora written")
        gru_cpu = start_gru_ctc_cpu(gru_ctc_job(vocab, pcorpora["wave"]))
        phase_build()
        clock.done("build", "kernels built")
        shapes = train_shapes(train_json)
        wbatch = online_train_batch(wtrain_json, wtrain)
        print(f"[shapes] training path's largest batch: B {shapes['b']}, T' {shapes['t']}, "
              f"U {shapes['u']}; online: B {len(wbatch['utts'])}")
        phase_layer_norm(errs)
        phase_layer_norm_bwd(errs, shapes["b"] * shapes["t"])
        phase_flash(errs)
        phase_flash_bwd(errs, shapes)
        phase_fbank(errs, wbatch, wtest)
        clock.done("kernel checks")
        phase_train_head_dim_16(vocab, chars, rng, launches)

        pkg = os.path.join(WORK, "flagship.pkg")
        save_flagship_package(pkg)
        phase_decode(pkg, vocab, test_json, launches)
        check_logits_against_cpu(pkg, test_feats)
        clock.done("decode path")
        ctc_pkg = os.path.join(WORK, "ctc.pkg")
        save_ctc_package(ctc_pkg)
        phase_ctc_decode(ctc_pkg, vocab, chars, test_json, launches)
        beams = check_ctc_beams(ctc_pkg, test_feats)
        clock.done("ctc decode path")
        per = phase_train(train_json, dev_json, vocab, launches)
        check_grads_against_cpu(pkg, train_feats)
        ctc_cost = check_ctc_loss_cost(shapes)
        clock.done("training path")
        online_pkg = os.path.join(WORK, "flagship_online.pkg")
        save_flagship_package(online_pkg, model_cfg=online_model())
        phase_decode(online_pkg, vocab, wtest_json, launches, online=True)
        check_features_against_cpu(wtest)
        clock.done("online decode path")
        phase_train(wtrain_json, wdev_json, vocab, launches, online=True)
        clock.done("online training path")
        gate = phase_recipe_gate()
        check_saturated_attention()
        clock.done("recipe gate")
        phase_stock_optimizers(vocab, chars, rng)
        phase_preemption(vocab, chars, rng)
        phase_jax_package()
        clock.done("stock optimizers, preemption and jax package")
        cif = phase_cif(rng, launches)
        clock.done("cif path")
        lm = phase_lm(rng, launches, pkg, ctc_pkg, vocab, test_json, test_feats, cif)
        clock.done("lm path")
        stream = phase_streaming_train(vocab, chars, rng, launches)
        stream["decode"] = phase_streaming_decode(
            stream["pkg"], vocab, test_json, test_feats, lm["runs"]["transformer_lm float32"]["pkg"],
            launches)
        stream["online"] = phase_streaming_online(wtest_json, wtest, launches)
        clock.done("streaming path")
        wave = phase_wave(vocab, chars, launches, gru_cpu)
        clock.done("wave path")
        # each grid phase's processes start a phase ahead: their start-up
        # (imports, the group, data, model) is host work
        world1 = start_world1(pcorpora, vocab)
        grids.append(start_ranks(parallel_jobs(vocab, pcorpora)))
        text = phase_text(launches)
        clock.done("text path")
        moe = phase_moe(train_json, dev_json, vocab, test_json, train_feats, launches)
        clock.done("moe path")
        # the serving workers export on the host from here on, below this
        # process's priority, and go onto the card once the timed rows are
        # done: their timed turns share the machine with nothing else
        serving = start_serving(serve_job(
            pkg, ctc_pkg, lm["runs"]["transformer_lm float32"]["pkg"], stream["pkg"],
            moe["runs"]["float32"]["pkg"], vocab, test_feats, wtest))
        grids.append(start_ranks(model_jobs(vocab, chars)))
        parallel = phase_parallel(grids[0], world1)
        clock.done("parallel path")
        grids.append(start_ranks(pipe_jobs(vocab, chars)))
        tp = phase_model(grids[1], shapes, errs)
        clock.done("model path")
        pp = phase_pipe(grids[2], vocab, test_json, train_feats, errs)
        clock.done("pipe path")
        torch.cuda.empty_cache()
        rows, row_s = [], {}
        for group, make in (
                ("fwd", lambda: fwd_rows(test_feats, errs, launches)),
                ("train", lambda: train_rows(shapes, errs, launches, per,
                                             tp["tp_flagship_sp"]["ln"])),
                ("head dim", lambda: head_dim_rows(shapes, errs, launches)),
                ("fbank", lambda: fbank_rows(wbatch, wtest, errs, launches)),
                ("cif", lambda: cif_rows(cif, errs, launches)),
                ("lm", lambda: lm_rows(lm, errs, launches)),
                ("streaming", lambda: streaming_rows(stream, errs, launches)),
                ("wave", lambda: wave_rows(wave, errs, launches)),
                ("text", lambda: text_rows(text, errs, launches)), ("pipe", lambda: pp["rows"])):
            t_group = time.time()
            rows += make()
            row_s[group] = time.time() - t_group
        print("[time] kernel rows by group (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in row_s.items()))
        clock.done("kernel rows")
        tools = phase_tools(pkg, vocab, test_json, test_feats)
        clock.done("tools path")
        serve = finish_serving(serving)
        clock.done("serving path")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:  # every process this run started
        if serving is not None:
            stop_serving(serving)
        if world1 is not None:
            stop_world1(world1)
        for ranks in grids:
            stop_ranks(ranks)
        if gru_cpu is not None and gru_cpu["proc"].poll() is None:
            gru_cpu["proc"].kill()
        shutil.rmtree(WORK, ignore_errors=True)
    clock.done("cleanup", "work directory removed")
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cold = (f" (cold L2 {r['cold_ms']:.4f}, cold - warm {r['cold_extra_ms']:+.4f} in "
                f"[{r['cold_extra_range_ms'][0]:+.4f}, {r['cold_extra_range_ms'][1]:+.4f}])"
                if "cold_ms" in r else "")
        print(f"[time] {r['name']} {r['shape']}: device ms kernel {r['ms']:.4f}{cold}, "
              f"plain {r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}); launches {r['launches']}")
    print(f"[time] total {time.time() - clock.start:.1f}s")
    print(f"[time] ctc beams a batch of 8 (339 frames, vocab 4233, beam {CTC_BEAM}): " + "; ".join(
        f"{k} log-probs: device {r['device_ms']:.2f} ms (enqueued in {r['enqueue_ms']:.2f}), "
        f"host {r['host_ms']:.2f} ms"
        for k, r in beams.items()))
    print("[cif path] " + "; ".join(
        f"decode {k}: {r['ms']:.1f} ms a batch of {r['b']} (beam {CIF_BEAM}, {CIF_MAXLEN} steps)"
        for k, r in cif["decode"].items())
        + f"; card vs CPU: logits {cif['check']['logits_err']:.3g}, gradients "
          f"{cif['check']['grad_err']:.3g}, fire margin {cif['check']['fire_margin']:.3g}; "
          f"launches a decode batch {cif['per_decode']}")
    print("[lm path] " + "; ".join(
        f"{k}: dev perplexity {r['ppl']:.2f}, {r['wall']:.2f}s wall" for k, r in lm["runs"].items())
        + "; " + "; ".join(
        f"{k} beam {r['ms']:.1f} ms fused vs {r['plain_ms']:.1f} ms unfused a batch of {r['b']} "
        f"(beam {r['beam']}), card vs CPU scores {r['cpu_score_diff']:.3g}"
        for k, r in lm["beams"].items())
        + f"; the device CTC beam's LM cache gather "
          f"{lm['beams']['device ctc']['cache_gather']['ms']:.4f} ms a frame"
        + f"; step vs batch forward {lm['step']}; gradients card vs CPU "
          f"{ {k: round(v['grad_err'], 6) for k, v in lm['check'].items()} }; launches a "
          f"training step {launches[('lm train', 'transformer_lm float32')]['per_step']}")
    sd = stream["decode"]
    print("[streaming path] " + "; ".join(
        f"tick {name} {dt}: {r['device_ms']:.3f} ms device, {r['wall_ms']:.3f} ms wall"
        for (name, dt), r in sd["times"].items())
        + f"; launches a tick {sd['per_tick']}, online {stream['online']['launches']} in "
          f"{stream['online']['ticks']} ticks; streamed vs batch: encoder "
          f"{sd['checks']['enc_err']:.3g}, logits {sd['checks']['logits_err']:.3g}, online "
          f"encoder {stream['online']['enc_err']:.3g}; training gradients card vs CPU "
          f"{stream['grad_err']:.3g}; launches a training step "
          f"{launches[('streaming train', torch.float32)]['per_step']}")
    print("[wave path] " + "; ".join(
        f"wav2vec {k}: {r['micro_batches']} micro-batches in {r['wall']:.2f}s wall"
        for k, r in wave["runs"].items())
        + f"; cpc {wave['cpc']['wall']:.2f}s, gru_ctc {wave['gru']['wall']:.2f}s wall "
          f"({WAVE_STEPS} steps each); decodes "
        + ", ".join(f"{k} {r['wall']:.2f}s" for k, r in wave["decodes"].items())
        + f"; card vs CPU: wav2vec logits {wave['check']['logits_err']:.3g}, gradients vs "
          f"float64 {wave['check']['grad_err']:.3g} (the CPU f32's "
          f"{wave['check']['grad_err_cpu']:.3g}), cpc loss {wave['losses']['cpc']:.3g}, gru_ctc "
          f"loss {wave['losses']['gru_ctc']:.3g}; freeze gate move ratio "
          f"{wave['gate_ratio']:.3f}; launches a wav2vec micro-batch {wave['per']['step']}, "
          f"a forward {wave['per']['forward']}; cpc and gru_ctc none")
    tc = text["check"]
    print("[text path] " + "; ".join(
        f"{k}: {r['micro_batches']} micro-batches in {r['wall']:.2f}s wall, launches a "
        f"micro-batch {r['per']['step']}, dev WER {r['dev_wer']}" for k, r in text["runs"].items())
        + "; decodes " + ", ".join(f"{k} {r['wall']:.2f}s ({r['wer']})"
                                   for k, r in text["decodes"].items())
        + f"; card vs CPU: Embed_Decoder_CTC logits {tc['ctc_logits']:.3g}, gradients "
          f"{tc['ctc_grads']:.3g}; Embed_Decoder 1-best scores {tc['beam_scores']:.3g}, equal "
          f"n-best {tc['beam_same_nbest']:.2f}; GAN losses {tc['gan_losses']:.3g}, gradients "
          f"{tc['gan_grads']:.3g} ({tc['relu_flips']} ReLU flips)")
    mc = moe["check"]
    print("[moe path] " + "; ".join(
        f"train {k}: {r['steps']} steps in {r['wall']:.2f}s wall" for k, r in moe["runs"].items())
        + "; decodes " + ", ".join(f"{k} {r['wall']:.2f}s" for k, r in moe["decodes"].items())
        + "; card vs CPU at the card's routing: " + "; ".join(
            f"{k} logits {r['logits_err']:.3g}, gradients {r['grad_err']:.3g} ({r['flips']} "
            f"tokens routed otherwise, margin {r['margin']:.3g})" for k, r in mc.items())
        + f"; launches a step {moe['per']['train']} (the flagship's); the phase "
          f"{moe['wall']:.1f}s")
    pf = parallel["flagship"]
    print(f"[parallel path] --distributed at world 1 vs plain {parallel['world1_err']:.3g}; "
          + "; ".join(f"{k}: two ranks vs one losses {parallel[k]['loss_err']:.3g}, step-1 "
                      f"gradient {parallel[k]['grad_err']:.3g}, parameters "
                      f"{parallel[k]['param_err']:.3g}, warm step wall "
                      f"{parallel[k]['warm_two']:.3f} vs {parallel[k]['warm_one']:.3f} s"
                      for k in ("flagship", "gru_ctc", "moe"))
          + f"; gru_ctc statistics {parallel['gru_ctc']['stats_err']:.3g}; a rank's launches a "
            f"flagship step {pf['launches']}, collectives {pf['calls']}, bytes {pf['bytes']}; "
            f"the phase {parallel['wall']:.1f}s")
    print("[model path] dp1 x tp2 (gloo, cuda:0): " + "; ".join(
        f"{k}: two ranks vs one losses {tp[k]['loss_err']:.3g}, step-1 gradient "
        f"{tp[k]['grad_err']:.3g} (to the f64 one: one rank {tp[k]['f64_one']:.3g}, two "
        f"{tp[k]['f64_two']:.3g}), parameters {tp[k]['param_err']:.3g}, warm step wall "
        f"{tp[k]['warm_two']:.3f} vs {tp[k]['warm_one']:.3f} s, LayerNorm backwards dx-only / "
        f"partials {tp[k]['ln']['dx']} / {tp[k]['ln']['partials']}, a step's collectives data "
        f"{tp[k]['calls']} model {tp[k]['model_calls']}"
        for k in ("tp_flagship_sp", "tp_flagship", "tp_moe"))
        + f"; the phase {tp['wall']:.1f}s")
    print(f"[pipe path] pp2 x dp1 (gloo, cuda:0) vs one rank: losses {pp['loss_err']:.3g}, "
          f"step-1 gradient {pp['grad_err']:.3g} (to the f64 one: one rank {pp['f64_one']:.3g}, "
          f"two {pp['f64_two']:.3g}), parameters {pp['param_err']:.3g}, warm step wall "
          f"{pp['warm_two']:.3f} vs {pp['warm_one']:.3f} s; microbatches "
          f"{[s['m'] for s in pp['microbatches']]}, bubble shares "
          f"{[round(b, 3) for b in pp['bubbles']]}; a rank's launches a step {pp['launches']}; "
          f"the pipe group a step {pp['pipe_calls']}, bytes {pp['pipe_bytes']}; remat "
          f"loss {pp['remat']['loss_err']:.3g}, gradients {pp['remat']['grad_err']:.3g} (a "
          f"second plain run {pp['remat']['again_err']:.3g}), peak "
          f"MiB {pp['remat']['peak_mib']['remat']:.1f} vs {pp['remat']['peak_mib']['plain']:.1f}"
          f"; the phase {pp['wall']:.1f}s")
    print(f"[ctc loss] flagship batch forward + backward: {ctc_cost['ms']['rewrite']:.4f} ms "
          f"with the last-blank rewrite, {ctc_cost['ms']['parent']:.4f} ms without; the short "
          f"rows: card vs CPU {ctc_cost['short']['err']:.3g}, the rewrite's shares "
          f"{ctc_cost['short']['shares']}")
    print(f"[recipe gate] CER {gate['cer']} after {gate['steps']} steps "
          f"({GATE_EPOCHS} epochs, train rows x{GATE_REPEAT}); train {gate['train_s']:.2f}s, "
          f"decode {gate['decode_s']:.2f}s wall; launches a step {gate['per_step']}")
    print_tools(tools)
    card = nvidia_smi()
    print("[serving path] " + "; ".join(
        f"{k}: export {r['export_s']:.1f}s, load {r['load_s']:.1f}s, {r['bytes'] / 1e6:.2f} MB, "
        f"{r['nodes']} nodes, warm wall ms exported {r['ms']['exported']:.3f} vs live "
        f"{r['ms']['live']:.3f}" for k, r in serve.items()) + f" ({card})")
    print(clock.line())
    print(card)
    print(json.dumps({"kernels": rows}))
    # the run drives one card (cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
