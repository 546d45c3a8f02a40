#!/usr/bin/env python3
"""Smoke run of the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. build the hand-written CUDA kernels (csrc/affine_conv3x3.cu: K2, the
   ResBlock conv, and K3, the head) from this checkout with nvcc and print
   the build time and the compiler's report;
2. run the kernels and their plain PyTorch version on the card at every
   fused conv shape of the full-width U-Net at 256px
   (``probes.conv_times.path_conv_shapes``: four ResBlock shapes and the
   linear 128->3 head), bf16, at B=2 with and without the residual and the
   moments and at B=4 (the serving batch) and B=8 (the eval CLI's) in the
   two forms the U-Net runs; y must agree within rtol = atol = 2e-2 and the
   moments within 1e-3 of their largest magnitude; at B=4 and B=8 each call
   is timed (CUDA-graph replay and events) beside its plain version, cuDNN's
   conv alone and its bound;
3. one forward of the full-width U-Net (base=128, ch_mult=(1,2,2),
   z_dim=512, 256px, B=2, bf16) through the kernels and through the plain
   versions: ||eps_kernel - eps_plain|| / ||eps_plain|| < 2e-2; then the
   kernel path's forward device time (CUDA-graph replay) at B=4 and B=16;
4. serving: a ClipCodec is saved as a .pt store (random weights from
   --seed; no trained weights exist offline), reloaded, and answers three
   decompress requests of 1, 3 and 6 frames at 256px, DDIM-50,
   batch_size=4. Outputs must be finite, in [-1, 1] and of the right
   shape, and the kernels must have launched exactly 29 x 50 x batches
   times in those requests, at each conv shape its calls per forward x 50
   x batches.

The SD-1.5 latent path (``models/sd``, ``cli/reconstruct_sd_diffusion.py``):

5. build flash attention (csrc/flash_attention.cu) and the fused
   transformer MLP (csrc/transformer_mlp.cu); all three sources are
   compiled at once, one nvcc each, when the run starts;
6. each kernel against its plain version on the card in bf16 at the shapes
   of SD-1.5 at 512px with CFG batched, for requests of one embedding (UNet
   batch 2) and of four (batch 8): flash attention at (BH, N, D) =
   (16|64, 4096, 40), (16|64, 1024, 80), (1|4, 4096, 512), normal and
   extreme logits, out within rtol = atol = 2e-2 and lse within 1e-3;
   flash attention recorded at every shape: events and CUDA-graph ms of
   the kernel and of SDPA, plain ms and the bound. The MLP (K6) at (R, C,
   F) = (8192|32768, 320, 1280), (2048|8192, 640, 2560), (512|2048, 1280,
   5120), (128, 1280, 5120) and the ragged (200, 1280, 5120): mlp_up
   against mlp_up_plain, mlp_down against mlp_down_plain on the same h,
   and the pair against mlp_plain, each within rtol = atol = 2e-2;
   mlp_down must run unsplit at some shape and split at another. Recorded
   at each of the seven: each kernel's ms (CUDA-graph replay and events),
   plain ms and bound, F.linear alone beside mlp_down, and the pair's ms,
   plain ms and bound beside cuBLAS's unfused bf16 MLP (for scale);
7. one forward of the SD-1.5 UNet (random weights from --seed, bf16,
   64x64 latents, batch 2, a (2, 8, 768) context) and one VAE decode at
   512px, each through the kernels, through the plain versions and through
   the plain versions in fp32: kernel vs plain relative difference < 2e-2,
   the kernel path at most 1.1x as far from fp32 as the plain path, 10
   flash + 16 MLP launches per UNet forward and 1 flash launch per decode;
8. serving: the UNet, VAE and adapter are saved as diffusers-layout .pt
   files, reloaded through the SD CLI's loader, and answer three requests
   of one embedding and one of four at 512px, dpmpp-10, guidance 5, CFG
   batched. Outputs must be finite and of the right shape, and the kernels
   must have launched steps x (10, 16) per forward plus 1 flash per decode,
   each K6 kernel once per MLP, at each (R, C, F) its calls per forward.

SD adapter training (``train/sd_diffusion_train.py``, ``cli/precompute_latents.py``):

9. the flash-attention backward (csrc/flash_attention_bwd.cu: the dq kernel
   and the dk/dv kernel) against the plain fp32 backward at the training
   shapes of SD-1.5 at 512px, batch 4: (BH, N, D) = (32, 4096, 40),
   (32, 1024, 80), (4, 4096, 512), and extreme logits at the first; dq, dk
   and dv within rtol = 2e-2 and atol = 2e-2 of each gradient's largest
   magnitude; ms of each kernel (events and CUDA-graph replay), of the
   plain versions and of SDPA's backward (for scale, not a plain version),
   recorded at every shape;
10. the adapter's gradient through SD-1.5 at full width (one 64x64 latent,
   the same injected t and noise, the default loss with its VAE decodes) on
   the kernel path, on the plain path and on the plain path in fp32, at
   --seed and --seed + 1: the kernel path at most 1.1x as far from fp32 as
   the plain path;
11. training: the port's precompute path encodes 8 seeded 512px images,
   then ``train_sd_diffusion`` runs 2 epochs at batch 4 on the kernel path.
   The loss must be finite, the adapter must change, the final adapter must
   load through the SD CLI's loader and sample a finite dpmpp-10 image, and
   every step must launch 12 flash forwards (10 in the UNet, 1 in each VAE
   decode), 10 of each backward kernel (the first UNet self-attention sees
   no input that needs a gradient) and 16 fused MLPs. Seconds per step,
   training img/s and peak device memory are printed.

Pixel-decoder training (``train/diffusion_train.py``, ``cli/train.py``):

12. K1, the fused GroupNorm+SiLU (csrc/groupnorm_silu.cu: one persistent
   cooperative launch that reads x from device memory once; ptxas must
   report 0 spill bytes), against its plain version (the slab partials,
   then the normalisation from them) and against ``group_norm_silu_plain``
   at the four training shapes of the full-width U-Net at 256px, batch 8,
   bf16 ((H, W, C) = (256, 256, 128), (128, 128, 128), (64, 64, 256),
   (32, 32, 512), 8 groups: 8, 2, 1 and 1 rounds on 132 SMs), one fp32
   case, a ragged shape (3, 37, 29, 64) in both types and a sample larger
   than a round (1, 512, 512, 128): y within rtol = atol = 2e-2 (bf16) or
   1e-4 (fp32), its slab partials within 1e-5 of their largest magnitude,
   one launch per call, two calls bit-equal; one call
   captured in a CUDA graph and replayed twice, bit-equal to eager; the
   autograd Function's dx, dscale, dbias at (8, 64, 64, 256) within 2e-2
   of each gradient's largest magnitude of plain autograd; at each training
   shape the kernel's ms (the device time of 20 calls replayed from a CUDA
   graph, and events around 20 calls from Python), the plain versions' ms,
   ``F.group_norm`` + ``F.silu`` (for scale) and the bound;
13. the full-width U-Net in its training form (``fused_pallas=False``) at
   256px, batch 2: the loss and every parameter's gradient for the same
   injected t and noise on the kernel path, on the plain path and on the
   plain path in fp32, at --seed and --seed + 1: the kernel path at most
   1.1x as far from fp32 as the plain path, every gradient finite and
   nonzero, 28 launches of K1 per forward and none of K2/K3;
14. training: 16 seeded PNG images, ``train_diffusion`` for 2 epochs at
   batch 8 (``data_workers=2``) at full width, bf16, 256px: the loss finite,
   the parameters changed, 28 x 4 launches of K1 (4, 8, 8 and 8 x 4 at
   the four shapes); the final
   checkpoint loads through ``ClipCodec.load`` and answers a request of 2
   frames at DDIM-50 through K2/K3 (29 x 50 launches), finite and in
   [-1, 1]; one ``remat=True`` step (56 launches of K1); then
   seconds per step, img/s and peak device memory over 5 synchronized steps
   after 2 warm-ups.

The attention probes (``probes/attn_probe.py``, the port of bench_attn_probe.py):

15. build csrc/flash_attention_probe.cu; hold each of its 21 kernels at D =
   40 (P1's six modes and tiles, P2's exp2 and row-sum forms, P3's two
   query tiles; 4096 rows leave the tq = 192 kernels a partial last query tile)
   against its plain version at (8, 4096, 40) in bf16, at normal logits and
   (all but ``nomax``) at extreme ones: softmax outputs within rtol = atol
   = 2e-2 and within 2e-2 of their largest magnitude, ``noexp`` and
   ``dotonly`` within 2e-2 of their largest magnitude, P2's row sums within
   2e-2 relative; then run the probe at (64, 4096, 40), printing its lines:
   every variant timed, four correctness lines within 2e-2 of an fp32
   oracle, one counted launch per call the probe made outside CUDA-graph
   capture (the graphs' replays reported beside); ms of each kernel (P1
   ``full`` at K4's tile (192, 128), P3 at tq = 192, P2 poly2 + mxu-sum at
   (192, 128) alone on a v that has its ones column, and its wrapper
   ``fast_flash_acc``, which builds that column), its plain version, SDPA,
   K4 and P1 ``exp2`` at that shape.

The compress side (``encoders/``, ``codecs/``, ``io/store.py``, ``codec.py``,
``cli/encode_images.py``; no TPU kernel is on it, so it adds no kernel):

16. a random CLIP ViT-B/32 (``encoders.clip.init_params`` from --seed:
   matrices normal(0, 0.02), LayerNorm 1 and 0) saved as an openai-layout
   .pt; 130 seeded PNGs of mixed sizes (two whose scaled long side leaves
   (dim - 224) % 4 == 3) and a corrupt file go through
   ``cli.encode_images.main`` at batch 64, bf16, on the card (three batches,
   the last padded), then 8 more through ``--append``. Checks: 130 kept, the
   corrupt file skipped, every embedding finite with |norm - 1| < 1e-3;
   the codebook bit-equal to numpy's fp32 recomputation and every code to
   numpy's IEEE round-half-even((x - zero) / scale); the append grows the
   manifest by 8 and leaves every old frame byte-identical; the u8 LUT
   input bit-equal to host-normalized input, with the tower in fp32; the
   bf16 embeddings within 2e-2 (row ||delta|| / ||fp32||) of the fp32
   tower's; ``ClipCodec.compress`` of 8 images decodes back
   (``decode_embeddings_host``) to cosine >= 0.99; the text tower on seeded
   ids (B = 64, EOT at varied positions) finite and unit. Without
   zstd engine (``bitstream.zstd_engine()`` None) frames carry the raw codes and
   the run says so. Printed: PIL preprocess ms per image, encode img/s from
   uint8 arrays at batch 64, the tower's forward device ms at B = 64 (CUDA
   graph replay) beside its FLOPs (``encoders.clip.vision_flops``) over
   989 TFLOP/s.

Inversion guidance and evaluation (``StableDiffusionDecoder.sample_with_inversion``,
the SD CLI's inversion branch, ``eval/``, ``cli/eval.py``):

17. the flash-attention backward at the shape a guided step runs it, the
   SD-1.5 VAE decode's mid-block at batch 1, (BH, N, D) = (1, 4096, 512),
   normal and extreme logits, at phase 9's tolerances, timed as phase 9
   times; the latent gradient of one guided step (VAE decode of the
   x0-prediction, then phase 16's random ViT-B/32 in bf16 through the CLI's
   ``clip_embed_fn``) on the kernel path, on the plain path and on the
   plain path in fp32 (VAE and tower), at --seed and --seed + 1: the kernel
   path at most 1.1x as far from fp32 as the plain path, one flash forward
   and one of each backward kernel per gradient; then the SD CLI's ``main``
   with its default flags (ddim-30, guidance 5, inv_weight 1 every step,
   backend auto -> clip at dim 512, 512px) and only the required paths and
   the weights' variables set (phase 8's files, phase 16's tower), entered
   at a frame that carries the raw codes where no zstd engine exists: it
   writes a 512x512 PNG and launches per request 30 x (10 + 1) + 1 flash
   forwards, 30 of each backward kernel and 30 x 16 of each MLP kernel;
   then s/request with inv_weight 1 and 0 in turns (1, 0, 0, 1), the
   device busy share (profiled kernel time over the fastest unprofiled
   wall) and peak device memory;
18. ``cli.eval.main`` over phase 14's 16 images and its trained full-width
   decoder at its defaults (256px, DDIM-50, batch 8), with a seeded random
   LPIPS-VGG16 in the ``lpips`` layout and phase 16's tower, so all four
   metrics are on: every record's metrics finite, the printed means the
   records' means, 28 x 50 x 2 launches of K2 and 50 x 2 of K3, at each
   conv shape its calls per forward x 50 x 2; for the same
   reconstructions the uint8 images bit-equal on the card and the CPU,
   PSNR and SSIM within 1e-5 of the CPU's, LPIPS of two images within 1e-4
   relative of the CPU's fp32; printed: eval img/s and the time in
   sampling, in each metric and in the rest.

Retrieval (``index/``, ``cli/search_text.py``; csrc/u8_ip_scan.cu, whose two
entry points stand in for XLA programs, not Pallas kernels: the JAX package
lets XLA fuse the u8 -> f32 convert into the dot of ``_u8_search_jit``,
``index/search.py:97``, and ``_ivf_u8_search``, ``index/ivf.py:117``):

19. 1M unit rows at D = 512 from a seeded generator on the card, fitted and
   quantized by ``codecs/quantizer.py`` (row 0 copied to 64 rows of the
   first 100,000, another row to 11 rows). 19a: ``u8_ip_scores`` at (Q, N)
   = (1, 1M), (64, 1M) and (3, 1000) at D = 100, ``u8_ip_probe`` on the
   IVF index of 19c at Q = 1 and 64 probing 8 lists and all 316: within
   1e-5 of the plain version, the copies of one row bit-identical; ms by
   CUDA-graph replay and events, plain ms, ``torch.matmul`` (or the fp32
   IVF's einsum) of the fp32 dequantized matrix for scale, and the bound
   (codes and inv read once, scores written once, over 3.35 TB/s, or the
   kernel's products, three bf16 parts of the query, 3 x 2 Q N D over 989
   TFLOP/s; beside it an fp32 scan's 2 Q N D over 67 TFLOP/s), and how each
   probe's pairs fall on the lists and the kernel's blocks
   (``index_times.probe_skew``). 19b: ``U8FlatIPIndex`` against ``FlatIPIndex``
   over the dequantized, renormalized matrix at N = 1M, k = 10, Q = 1 and
   64: sorted scores within 1e-5, ids equal wherever neighbouring scores
   differ by more than 1e-5 (near-tie places counted), one kernel launch a
   search; the row held 11 times returns its ten lowest ids in order. 19c:
   ``build_ivf_index`` and ``build_ivf_index_u8`` over the first 100,000
   rows at the CLI's defaults (nlist 316, nprobe 8: the u8 builder's
   subsampled train path), each built twice and bit-equal, build seconds;
   recall@10 at nprobe 8 printed; at nprobe = nlist the flat index's hits
   under the near-tie rule; one probe launch a u8 search. 19d:
   ``cli.search_text.main`` over phase 16's store (138 frames, its random
   ViT-B/32 in bf16, a synthetic merges file) for ``--query``,
   ``--query_image`` and ``--query_clp``, each exact, ``--u8``, ``--ivf``
   and ``--u8 --ivf`` (IVF probing all 12 lists, so all four forms are
   exact): 10 lines each, the four forms' paths equal at every place the
   printed scores decide, ``--query_clp`` of a store frame first at
   ``1.0000``; launches exactly 6 ``u8_ip_scores`` and 7 ``u8_ip_probe`` in
   19b-19d, counted by shape. 19e: device ms a search (CUDA-graph replay,
   events) of the four indexes at Q = 1 and 64, resident bytes, the host
   wall of one CLI query after the build, the phase's peak device memory.

Serving and export (``deploy.py``, ``serve.py``, ``cli/export_decoder.py``;
no new kernel: the artifacts replay K2/K3 and K4/K6 from CUDA graphs):

20. 20a: ``cli.export_decoder.main`` writes the pixel artifact from phase 4's
   checkpoint at its defaults with ``--output uint8`` (256px, DDIM-50,
   batch 16) and the SD artifact from phase 8's files at its defaults
   (ddim-30, 512px, batch 1, CFG batched). 20b: each loaded, its first
   call capturing the whole sampler in one CUDA graph; two replays of a
   seed bit-equal, another seed differs; a replay launches exactly 28 x 50
   K2 and 50 K3 (by shape: its calls per forward x 50) or 30 x 10 + 1 K4
   and 30 x 16 of each K6 kernel (by shape, phase 8's tally); the pixel
   uint8 images within one level of the eager sampler from the same x_T
   and equal in >= 99.9% of pixels; the SD images, at guidance 5 and 2
   from one capture, within 2e-2 (||delta|| / ||eager||) of the eager
   sampler; a call's device ms (events) beside the eager wall. 20c:
   ``serve.serve`` on 127.0.0.1 at a free port, both artifacts behind it,
   phase 16's store and tower, phase 19's merges file: /healthz; 64
   /decompress from 32 clients (gather 20 ms): img/s, p50/p95, the
   micro-batcher's fill rate; lone requests, their wall beside the replay's
   device ms (the busy share); 3 /decompress_sd (seeds 0, 1, 0: the first
   and last PNGs equal); /embed within 1e-6 of the host dequantization;
   /search, /search_image with a store frame (its own image first, score
   > 0.999) and with a PNG; 400 (a seed in micro-batched mode, a bad
   frame, a bad format), 404, 412 (both artifacts), 413. Launches of the
   whole HTTP run exact: each program's eager warm-up and its replays.

The DINOv2 front end (``encoders/dino.py``, ``cli/encode_images_dino.py``, the
SD CLIs' DINO paths; the JAX DINO tower reaches no Pallas kernel, so it adds
no kernel, and its path runs K4, K5 and K6 through the SD UNet and VAE):

21. a random DINOv2 ViT-B/14 (``encoders.dino.init_params`` from --seed:
   matrices normal(0, 0.02), LayerNorm and LayerScale 1) saved under HF
   ``Dinov2Model`` names and read through ``$CLIP_CODEC_DINO_WEIGHTS`` or
   ``--weights``. 21a: ``cli.encode_images_dino.main`` over phase 16's 130
   PNGs and its corrupt file (bf16, batch 16, on the card): 130 kept, the
   rows unit, the codebook (eps 1e-6) bit-equal to numpy's fp32
   recomputation, every code numpy's round-half-even, ``codec_meta.npz``'s
   ``dim`` an int64 768; the bf16 tower within 2e-2 (row ||delta|| /
   ||fp32||) of the fp32 tower on the same 518px inputs; printed: host
   preprocess ms an image, img/s from preprocessed arrays, the forward's
   device ms at B = 16 (CUDA-graph replay) beside ``dino_flops`` over 989
   TFLOP/s. 21b: phase 11's 8 images through the DINO CLI and
   ``cli.precompute_latents``; the adapter's gradient with both terms on
   (clip_w 0.1, LPIPS on that step; phase 18's LPIPS file) on the kernel
   path, the plain path and the plain path in fp32 (UNet, VAE and DINO
   tower) at --seed and --seed + 1, at most 1.1x as far from fp32 as the
   plain path, phase 11's tally a loss and backward; s/step at batch 4 with
   the DINO term, and with LPIPS too, beside phase 11's; ``cli.train_sd.main``
   for 2 epochs at batch 4 with ``--perc_every 2`` and both variables set:
   every step gets the bf16 tower, LPIPS and 256px images, LPIPS on steps 0
   and 2, losses finite, the adapter changed, 4 x phase 11's tally, peak
   memory. 21c: the trained adapter through the SD CLI's loader; one guided
   step's latent gradient through ``dino_embed_fn`` (kernel, plain, fp32
   VAE and tower) at two seeds, <= 1.1x, one K4 and one K5 pair each; the
   SD CLI's ``main`` at its default flags on a frame of 21b's dim-768 store
   (backend auto -> dino): a 512x512 PNG and phase 17's launches a request;
   s/request, busy share and peak memory beside phase 17's CLIP backend.

int8 serving (``ops/int8.py``, ``csrc/int8_conv.cu``: the quantize pass,
the implicit-GEMM int8 conv on the codes, and the absmax reduction,
counterparts of XLA programs; the conv's act form, which quantizes its bf16
or fp32 activations in shared memory, is checked and timed but on no model
path, being slower than the pair at every path shape;
the int8 paths also run K1 in every pixel ResBlock, K3, and K4 in the SD
self-attention, never K2 or K6):

22. 22a: ``csrc/int8_conv.cu`` built with the others at the start; the
   shapes of every int8 conv call of one forward of each full-width path
   (the pixel U-Net at B = 16 and B = 1, SD-1.5 at 64x64 latents, CFG
   batched, with the adapter's 8-token context), each forward (dynamic)
   bit-equal to the same forward through the act form, plus to_k/to_v on a
   77-token context (check
   only); at each shape, the kernels against their plain versions bit for
   bit: absmax, codes and scale (dynamic, and static at half the absmax,
   saturating), the codes-in conv's int32 accumulator, fp32 and bf16
   outputs, and the act form's from bf16 and fp32 activations, dynamic and
   static at half the absmax; at the pixel artifact's shapes and
   ``SD_TIMED`` each timed (CUDA-graph replay and events; absmax at the
   dynamic server's B = 1 shapes) beside its plain version (events; the
   conv's float64 product), the act form beside the paths' pair
   (``int8_quantize`` then the codes-in conv, one graph),
   its bound (int8 operations over 1,979 TOP/s, or bytes: the act form's
   read of bf16 activations), ``torch._int_mm``
   for the GEMMs, ``torch.linalg.vector_norm(x, inf)`` for absmax, and
   cuDNN's bf16 conv for scale; K1's codes-out form
   (``group_norm_silu_int8``) at the four pixel GroupNorm shapes at B = 16,
   bf16 and fp32, at the output's absmax, half of it and a power-of-two s: codes and scale
   bit-equal to K1 then ``int8_quantize``, the scale bit-equal and the codes
   within one of its plain version (whose SiLU is exact), two graph replays
   bit-equal, timed in bf16 beside that pair and K1 alone with its bytes
   bound, and both again at the power-of-two s. 22b: ``cli.export_decoder --int8`` from
   phase 4's checkpoint at its defaults with ``--output uint8`` (the
   artifact and ``<artifact>.quant.pt``); its replay (exactly 31 x 50 int8
   convs, 28 x 50 ``group_norm_silu_int8`` and 3 x 50 quantize passes, no
   K1, 50 K3, no absmax, act form, K2 or K6) bit-equal across a seed, to
   its own eager int8 sampler from the same x_T and to the replay of the
   path before the codes-out form (K1, then ``int8_quantize``: a
   decompressor captured under that dispatch, the two timed in turns); one
   static-int8 forward's eps bit-equal to the act form's (every layer) and
   against the bf16 forward's; a start-up
   without the sidecar stops with JAX's message naming it; then ``serve``
   behind the artifact answers 64 /decompress from 32 clients (img/s,
   p50/p95 beside phase 20c's bf16 artifact), launches exact. 22c:
   ``cli.reconstruct_diffusion --int8`` beside the bf16 CLI (calibration:
   3 fp passes, 28 K1 and one K3 each; then the static forwards of 22b);
   ``serve --int8`` with no artifact, one /decompress (dynamic: 28 K1, 31
   quantize passes and 31 absmax a forward);
   ``cli.reconstruct_sd_diffusion --int8 --inv_weight 0`` (6 fp calibration
   passes, then ddim-30: every int8 layer of the UNet once a forward, 10
   K4, no K6) and the SD int8 artifact from ``cli.export_decoder --sd
   --int8`` behind ``--sd_artifact`` (3 requests, seeds 0, 1, 0), each
   beside the bf16 times of phases 17 and 20, launches exact.

The data axis (``parallel/``, the trainers' and CLIs' ``--data_parallel``, the
sharded indexes and the data-sharded pixel artifact; no new kernel: the ranks
run K1, K2/K3, K4-K6 and ``u8_ip_scores``):

23. two ranks started as two launcher nodes on this machine
   (``parallel.launch.spawn_ranks``), so both drive cuda:0 and talk over
   gloo, then one rank alone under a one-rank launcher environment, which
   picks NCCL; each rank runs ``probes.dp_rank`` (the kernels are built by
   now, so no rank compiles). 23a: ``cli.train --data_parallel`` at full
   width (256px, base 128, global batch 8, 4 a rank) over 20 seeded images,
   3 steps, the last with 4 real rows (rank 1's half all padding), against
   ``cli.train --distributed`` on the one rank: losses and the first
   step's gradient summed over the ranks (||g_2 - g_1|| / ||g_1||) within
   2e-2, the two ranks' parameters bit-equal after the run, the same start,
   each rank's K1 launches the one-rank run's (28 a step, at batch 4 by
   shape); the parameters' update over the run (||d(theta_3 - theta_0)|| /
   ||theta_3 - theta_0||) and s/step of both, printed. 23b: ``cli.train_sd`` the same way at SD-1.5 512px,
   global batch 4, 2 steps over phase 11's images and latents (phase 8's
   weights), each rank launching phase 11's tally a step. 23c: 1M unit rows
   at D = 512 drawn on every rank, the sharded fp32 and u8 exact indexes
   against the single ones at k = 10, Q = 1 and 64: scores within 1e-5,
   ids equal wherever neighbouring scores differ by more than 1e-5, one
   ``u8_ip_scores`` a u8 search a rank; a rank's device ms (its scoring and
   top-k) and a whole search's wall, resident bytes a rank; then
   ``cli.search_text`` on phase 16's store with and without
   ``--data_parallel`` (fp32 and ``--u8``): the same 10 lines, from rank 0
   only. 23d: the data-sharded pixel artifact (B = 16, DDIM-50) exported
   and loaded over the two ranks from phase 4's checkpoint: each rank's
   rows within one uint8 level of the single-device artifact at the rank's
   batch (8) fed the same rows of the seed's global x_T, and equal in >=
   99.9% of pixels (phase 20's bound); the images against the single-device
   artifact at B = 16 printed beside that artifact's own B = 16 against
   B = 8 (bf16 at another batch, through the first step's clip); a call's
   K2 and K3 launches exact a rank (28 x 50 and 50), a replay's device ms a
   rank. 23e: the backends chosen
   (``cpu:gloo,cuda:gloo`` for the two ranks, ``cpu:gloo,cuda:nccl`` for
   the one). Two ranks sharing one card measure correctness and overhead,
   not scaling. Phase 23's wall time is printed.
24. the model axis (``probes.mp_rank`` a rank; two ranks sharing the card
   over gloo on a (1, 2) mesh, then one NCCL rank on (1, 1)). 24a: K1's
   split entries (``group_norm_silu_stats``, with and without a shift, and
   ``group_norm_silu_apply``) against their plain versions at the spatial
   U-Net's half-height shapes (B = 16 at 256px, and phase 26's B = 2 at
   512px, bf16), an fp32 case and a ragged
   one: partials within 1e-5 of the sums of |terms|, the normalisation
   within phase 13's rtol = atol (2e-2 bf16, 1e-4 fp32) of plain and of
   the one-shot plain GroupNorm+SiLU; each timed (CUDA-graph replay and
   events) beside plain, the one-launch K1, ``F.group_norm`` + ``F.silu``
   and its bound. 24b: the tensor-parallel SD-1.5 UNet (phase 8's weights,
   bf16) at UNet batch 2, 64x64 latents, a 77-token context: the ranks' eps
   bit-equal, their distance from the fp32 plain path at most 1.1x the
   one-rank forward's (and within 1.5x that distance of the one-rank
   forward), each rank launching K4 on its 4 heads ((8, 4096, 40) and (8,
   1024, 80)) and both stages of K6 on F/2; a forward's device ms a rank.
   24c: the tensor-parallel SD artifact (512px, ddim-10, batch 1): over
   gloo ``replay == "eager"`` and a request's distance from the fp32 plain
   sampler at most 1.1x the single-device artifact's (and within 1.5x that
   distance of it), s/request; on the NCCL rank ``replay == "graph"`` and
   images bit-equal to the single-device artifact. 24d: ``sample_spatial_sharded`` of phase 14's
   checkpoint (256px, B = 16, H over 2): fp32, 3 DDIM steps on a linear
   schedule, within 1e-3 of the unsharded direct form (plain GroupNorm;
   printed beside the one-launch K1's), then bf16 DDIM-50 timed, K1's split
   launches by shape exact. 24e: the spatial artifact from the same
   checkpoint: JAX's header keys and values, the mesh-shape refusal,
   ``replay == "eager"``, images within 1e-3 of 24d's bf16 sample at the
   same seed. K4 and K6 are also checked and timed at the tensor-parallel
   shapes, and ``mlp_down``'s split counts at F/2 printed. Phase 24's wall
   time is printed; two ranks sharing one card measure correctness and
   overhead, not scaling.

The modules with no TPU kernel of their own (phase 25, after 24; phase 8's
SD files, phase 14's store):

25. 25a: the store codec frames with the native engine
   (``io/native.py``, ``csrc/store_codec.cpp`` over the card machine's
   libzstd): 10,000 code rows of D = 512 framed and read back equal as a
   batch and frame by frame (the same bytes), through ``write_store`` and
   ``Store.read_codes``, bad magic, a truncated header, a corrupt payload
   and a decompression bomb refused; us a frame for each. 25b: a
   full-width pixel U-Net (base 128, (1, 2, 2), z 512, seeded) written as
   ``diffusion_unet_final.msgpack`` by the numpy ``convert_unet`` and the
   port's flax writer into a store of real frames; ``ClipCodec.load`` takes
   it, and its DDIM-50 256px decompress of 4 frames is bit-equal to the same
   weights' from a ``.pt`` store, 29 x 50 launches each; phase 8's adapter
   written as a JAX ``.msgpack`` gives the SD CLI's PNG (``--adapter``,
   dpmpp-10, inv_weight 0) bit-equal to its ``.pt``'s. 25c:
   ``CLIPCondDecoder`` (192 -> 512px) and ``FeatureToImageDecoderLite``
   (256 -> 64px) at B = 16: bf16 within 2e-2 (relative norm) of fp32, the
   bf16 forward's device ms, ``reconstruct_image_from_bitstream`` on a real
   frame, then 5 ``train_direct_decoder`` steps on phase 14's 16 images at
   batch 16 (s/step, peak memory). 25d: ``ddpm_sample`` through the
   full-width U-Net at B = 2, 256px: on a 50-step schedule the kernel path
   within 2e-2 (relative norm) of the plain path on the same injected
   noise; then the full T = 1000 run through the kernels, finite, each of
   K1, K2 and K3 launched exactly its per-forward tally x 1000, its seconds.
   25e: ``utils.profiling.trace`` around one forward writes a Chrome trace
   naming the ``annotate`` region and a K2 kernel, and ``nan_checked``
   raises on an injected NaN. Every time is printed beside the card's name
   and power limit.

Spatially sharded training (``train_diffusion(spatial=True)``,
``cli.train --spatial_shard``; phase 26, after 25):

26. ``probes.mp_rank spatial_train`` on two ranks sharing the card over gloo
   on a (1, 2) mesh, the image height split over them, then on one NCCL
   rank unsharded: the full-width pixel U-Net (base 128, (1, 2, 2), z 512,
   seeded weights) at 512px, global batch 2. On two seeded batches with
   injected t and noise: the fp32 loss within 1e-4 (relative) and each
   parameter's gradient, summed over the mesh, within 1e-3 of its largest
   magnitude of the unsharded step's (phase 24's spatial bound); the bf16
   spatial gradient at most 1.1x as far from the fp32 plain unsharded
   step's as the unsharded bf16 step's, at --seed and --seed + 1 (phase
   13's check); the ranks' losses equal; K1's split form 28 + 28 launches
   a forward (4, 8, 8, 8 by level) and none in the backward. Then
   ``cli.train --spatial_shard 2`` (one rank: ``--distributed``) for 3
   steps over 6 seeded images: every step 28 + 28 split launches by shape,
   the ranks' losses equal and within 2e-2 of one rank's; s/step, peak
   device memory a rank (below the unsharded rank's) and the collectives a
   step are printed. Two ranks sharing one card measure correctness and
   overhead, not scaling.

The line before the last is the kernels' JSON record (K2 and K3: one
record per path shape at B=4 with its launches in phase 4, at B=8 with
its launches in phase 18 and at B=16 with its launches in phase 20c
(``"phase": 20``); K4 and K6 also once more with phase 20c's launches,
by shape; K5: the training shapes' records with their
launches in phase 11, then one per kernel at (1, 4096, 512) with its
launches in phase 17's default request; mlp_up and
mlp_down: one record per MLP shape with its launches in phase 8; K1: one
record per training shape with its launches in phase 14; u8_ip_scores and
u8_ip_probe: one record per timed shape with its launches in phase 19b-19d
(0 at the check-only D = 100 shape); the int8 kernels one record per
timed phase 22a shape with its launches by shape over 22b's HTTP run and
22c (``"phase": 22``; the act form's by both activation kinds: 0, as no
path runs it; K1's codes-out form one record per pixel GroupNorm shape at
B = 16, ``library_ms`` null, the pair it replaces beside it); K4, the K5 pair and K6 once more with
phase 21's launches (21b's CLI training plus 21c's CLI request, ``"phase":
21``, beside the timed record's numbers: K4's and K6's first shape, K5's
(1, 4096, 512)); K1, K2, K3, K4, the K5 pair, K6 and ``u8_ip_scores`` once more
with phase 23's launches summed over the two ranks (``"phase": 23``,
beside the timed record's numbers as for phase 21), ``library_ms`` null (no one PyTorch
call takes uint8 codes and fp32 queries) and ``matmul_ms`` beside it for
scale; K1's split entries one record per phase 24a shape, and K4 and K6 one
record per tensor-parallel shape, each with its phase 24 launches by shape
summed over the two ranks (``"phase": 24``; K1's split entries at phase 26's
shapes with phase 26's CLI steps' launches, ``"phase": 26``); K2 and K3 once more with
phase 25's launches (25b's two decompresses and 25d's DDPM runs,
``"phase": 25``, beside the first path shape's timed numbers); ``bound_ms``: the
largest of the bytes each kernel must move over 3.35 TB/s, its flops over
989 TFLOP/s, the H100 SXM's HBM rate and dense bf16 peak (for the u8
kernels their three-part bf16 products, 3 x 2 flops a query x code byte),
or 67 TFLOP/s, its fp32 rate outside the tensor cores, for K1, and,
for the attention kernels, its exponentials over the exp unit's 16 per
clock per SM (or a polynomial exp2's instructions over the FMA pipe's 128
lanes per clock per SM) at the card's SM count and maximum SM clock, at
the timed shape,
counting the work the function needs, not a kernel's recompute;
``bound_unit`` names the largest); the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device the script exits non-zero and
prints no result. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
REPLACES = "clip_codec_tpu/ops/pallas_resblock.py:72"
# The full-width U-Net at 256px (its fused convs: probes.conv_times.path_conv_shapes).
PX_BASE, PX_CH_MULT, SERVE_BATCH, WIDE_BATCH = 128, (1, 2, 2), 4, 16
EVAL_BATCH = 8  # cli.eval's default --batch_size (phase 18)
LAUNCHES_PER_FORWARD = 29  # 14 ResBlocks x 2 + the head
SIZE, STEPS = 256, 50

CSRC = "clip_codec_tpu_torch/csrc"
KERNELS = {  # name -> (library, TPU kernel it replaces)
    "affine_silu_conv3x3": ("affine_conv3x3", REPLACES),
    "affine_conv3x3": ("affine_conv3x3", REPLACES),
    "flash_attention": ("flash_attention", "clip_codec_tpu/ops/pallas_attention.py:63"),
    "mlp_up": ("transformer_mlp", "clip_codec_tpu/ops/pallas_mlp.py:78"),
    "mlp_down": ("transformer_mlp", "clip_codec_tpu/ops/pallas_mlp.py:78"),
    "flash_attention_bwd_dq": ("flash_attention_bwd", "clip_codec_tpu/ops/pallas_attention.py:181"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", "clip_codec_tpu/ops/pallas_attention.py:212"),
    "group_norm_silu": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:53, "
                                          "clip_codec_tpu/ops/pallas_groupnorm.py:69"),
    # K1's split form (phase 24): the JAX original's two pallas_calls
    "group_norm_silu_stats": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:98"),
    "group_norm_silu_apply": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:107"),
    "flash_probe_variant": ("flash_attention_probe", "bench_attn_probe.py:103"),
    "flash_probe_fast": ("flash_attention_probe", "bench_attn_probe.py:214"),
    "flash_probe_single_pass": ("flash_attention_probe", "bench_attn_probe.py:281"),
    # XLA programs, not Pallas kernels: XLA fuses the u8 -> f32 convert into the dot
    "u8_ip_scores": ("u8_ip_scan", "clip_codec_tpu/index/search.py:97"),
    "u8_ip_probe": ("u8_ip_scan", "clip_codec_tpu/index/ivf.py:117"),
    # XLA programs too: JAX's int8 conv and dense (lax conv / dot_general on int8 operands), their
    # activation codes and the dynamic absmax; the act form is the quantize and the product of one layer
    "int8_conv_act": ("int8_conv", "clip_codec_tpu/ops/int8.py:68, clip_codec_tpu/ops/int8.py:70, "
                                   "clip_codec_tpu/ops/int8.py:96, clip_codec_tpu/ops/int8.py:98, "
                                   "clip_codec_tpu/ops/int8.py:200, clip_codec_tpu/ops/int8.py:201"),
    "int8_conv_nhwc": ("int8_conv", "clip_codec_tpu/ops/int8.py:70, clip_codec_tpu/ops/int8.py:98, "
                                    "clip_codec_tpu/ops/int8.py:201"),
    "int8_quantize": ("int8_conv", "clip_codec_tpu/ops/int8.py:68, clip_codec_tpu/ops/int8.py:96, "
                                   "clip_codec_tpu/ops/int8.py:200"),
    "absmax": ("int8_conv", "clip_codec_tpu/ops/int8.py:67, clip_codec_tpu/ops/int8.py:198"),
    # K1's codes-out form: K1, and the static codes of the conv after it (an XLA expression in JAX)
    "group_norm_silu_int8": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:53, "
                                               "clip_codec_tpu/ops/pallas_groupnorm.py:69, "
                                               "clip_codec_tpu/ops/int8.py:96"),
}
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12  # H100 SXM: HBM3 rate, dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# Per clock per SM: ex2 on the exp unit, fp32 lanes of the FMA pipe (CUDA
# guide, compute capability 9.0); unit_rates scales them by the card's SM
# count and maximum SM clock.
EXP2_PER_CLOCK_SM, FMA_LANES_PER_CLOCK_SM = 16, 128
# SD-1.5 at 512px (64x64 latents), CFG batched: UNet batch 2 for a request of
# one embedding (VAE batch 1), 8 for a request of four (VAE batch 4).
FLASH_SHAPES = [(16, 4096, 40), (16, 1024, 80), (1, 4096, 512),
                (64, 4096, 40), (64, 1024, 80), (4, 4096, 512)]  # (BH, N, D)
MLP_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
              (32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120)]  # (R, C, F)
MLP_RAGGED = (200, 1280, 5120)  # rows that fill no 128-row tile, with a split mlp_down
SD_FLASH_PER_FORWARD, SD_MLP_PER_FORWARD = 10, 16
FP32_RATIO = 1.1  # kernel path's distance from fp32, at most this x the plain path's
SD_SIZE, SD_STEPS, SD_GUIDANCE = 512, 10, 5.0
SD_REQUESTS = (1, 1, 1, 4)  # embeddings per request
# SD-1.5 training at 512px, batch 4: 8 heads at 64x64 and 32x32, the VAE's one head.
# Then the VAE decode's mid-block at batch 1, which every guided step of
# inversion backpropagates through.
FLASH_BWD_SHAPES = [(32, 4096, 40), (32, 1024, 80), (4, 4096, 512), (1, 4096, 512)]  # (BH, N, D)
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_EPOCHS = 8, 4, 2
# Per training step: flash forward 10 in the UNet + 1 per VAE decode (of
# lat0_hat and of lat0); each backward kernel at 9 UNet self-attentions (the
# first sees no input that needs a gradient) + the lat0_hat decode; the MLP
# at all 16 transformer blocks (its backward runs no kernel).
TRAIN_LAUNCHES = {"flash_attention": 12, "flash_attention_bwd_dq": 10, "flash_attention_bwd_dkv": 10,
                  "transformer_mlp": 16, "mlp_up": 16, "mlp_down": 16}
# Pixel training: (H, W, C) of every GroupNorm+SiLU of the full-width U-Net
# at 256px (2, 4, 4 and 4 ResBlocks, two calls each: 28 per forward), batch 8.
GN_SHAPES = [(256, 256, 128), (128, 128, 128), (64, 64, 256), (32, 32, 512)]
GN_TAIL, GN_GROUPS, GN_BATCH = (3, 37, 29, 64), 8, 8
GN_LARGE = (1, 512, 512, 128)  # one sample (67 MB in bf16) larger than a round of the blocks' buffers
GN_PER_FORWARD = 28
PX_IMAGES, PX_BATCH, PX_EPOCHS = 16, 8, 2
PX_MODEL = dict(base=128, ch_mult=(1, 2, 2))  # the reference's U-Net, as DiffusionTrainConfig's defaults
# The attention probes: checked against plain at PROBE_CHECK_SHAPE, run and timed at
# FLASH_SHAPES[3], SD-1.5's first-level self-attention at UNet batch 8.
PROBE_CHECK_SHAPE, PROBE_SHAPE = (8, 4096, 40), FLASH_SHAPES[3]
POLY_INSTRUCTIONS = 5  # + deg: round-down add, 2 subtracts, deg FMAs, max, shift-add into the exponent
# The compress side: cli.encode_images at its default batch over 130 images (3
# batches, the last padded), then 8 more appended.
CLIP_IMAGES, CLIP_APPEND, CLIP_BATCH = 130, 8, 64
# Inversion (phase 17): the SD CLI at its default flags, ddim-30 with every
# step guided, CFG batched, 512px, one embedding. A request runs 30 UNet
# forwards (10 flash, 16 MLP each), 30 guided VAE decodes (one K4 and one K5
# pair each, at FLASH_BWD_SHAPES[3]) and the final decode (one K4).
INV_STEPS = 30
INV_LAUNCHES = {"flash_attention": INV_STEPS * (SD_FLASH_PER_FORWARD + 1) + 1, "flash_attention_bwd_dq": INV_STEPS,
                "flash_attention_bwd_dkv": INV_STEPS, "transformer_mlp": INV_STEPS * SD_MLP_PER_FORWARD,
                "mlp_up": INV_STEPS * SD_MLP_PER_FORWARD, "mlp_down": INV_STEPS * SD_MLP_PER_FORWARD}
# Retrieval (phase 19), D = 512 as bench_index.py: exact search over RET_N rows,
# IVF at the search CLI's defaults over the first RET_IVF_N; k = 10; Q = 1 and 64.
RET_N, RET_IVF_N, RET_K, RET_Q = 1_000_000, 100_000, 10, (1, 64)
RET_SMALL = (3, 1000, 100)  # (Q, N, D): a D that is no multiple of 16
RET_NEAR = 1e-5  # score tolerance, and the gap under which two places are a near tie
# Serving (phase 20): bench_serve.py's defaults, the pixel artifact at WIDE_BATCH
# (the export CLI's default batch); the SD artifact at the export CLI's
# defaults (ddim-30, 512px, batch 1).
ART_REQUESTS, ART_CLIENTS, ART_WAIT_MS = 64, 32, 20.0
# The DINOv2 front end (phase 21): ViT-B/14 at 518px, cli.encode_images_dino's
# batch of 16 over phase 16's images; SD training and inversion on a dim-768 store.
DINO_BATCH = 16
# The data axis (phase 23): two ranks sharing the card over gloo, one NCCL rank alone. Pixel training at
# global batch 8 over 20 images: 3 steps, the last of 4 real rows, so rank 1's half of it is all padding (weight
# 0); SD training at global batch 4 over phase 11's 8 images: 2 steps. Losses and the first step's gradient,
# summed over the ranks, within DP_TOL of one rank's (bf16 at another per-rank batch).
DP_PX_IMAGES, DP_TRAIN_BATCH, DP_TOL, DP_TIMEOUT = 20, {"train": 8, "train_sd": 4}, 2e-2, 420.0
# The model axis (phase 24): two ranks sharing the card over gloo on a (1, 2) mesh, one NCCL rank on (1, 1).
# Tensor parallelism at the SD artifact's shape (one embedding, CFG batched: UNet batch 2, 64x64 latents, a
# 77-token context): each rank's 4 of 8 heads through K4, its F/2 GEGLU columns through K6. Spatial sharding of
# the full-width pixel U-Net at 256px, B = 16, H split in two: K1's split form at each level's half-height shape.
MP_TP_BATCH, MP_CTX, MP_SD_STEPS, MP_REPS = 2, 77, SD_STEPS, 5
MP_TP_FLASH = [(8, 4096, 40), (8, 1024, 80)]  # (BH, N, D) a rank
MP_TP_MLP = [(8192, 320, 640), (2048, 640, 1280), (512, 1280, 2560), (128, 1280, 2560)]  # (R, C, F / 2)
MP_GN_SHAPES = [(WIDE_BATCH, H // 2, W, C) for H, W, C in GN_SHAPES]
MP_GN_CALLS = (4, 8, 8, 8)  # GroupNorm+SiLU calls a forward at each of MP_GN_SHAPES
# The fp32 check: a few DDIM steps on a 20-step linear schedule, as the JAX package's own spatial test (its
# alpha-bar stays O(1); at 1000 steps the first x0 divides eps by sqrt(alpha-bar) ~ 6e-3 and amplifies fp32
# reassociation 160-fold). The spatial sample against the unsharded direct form: the same operations summed in
# other orders (halo'd convs may take other cuDNN algorithms, the cross-rank GroupNorm totals), images in [-1, 1].
MP_CHECK_STEPS, MP_CHECK_TIMESTEPS, MP_FP32_TOL = 3, 20, 1e-3
# The tensor-parallel forward and request against the one-rank ones: both bf16 paths round at other places and
# sit about the bf16 noise floor of this random-weight UNet apart (phase 7 records 0.7-1.6e-2), so the check that
# discriminates is the fp32 ratio of phases 7/10/13/17: TP's distance from the fp32 plain path over the one-rank
# path's, at most MP_TP_RATIO (an extra independent error of ~0.46x the floor fails it). The distance between the
# two bf16 paths is held to MP_TP_FLOOR x the one-rank path's distance from fp32 as a coarse sanity bound.
MP_TP_RATIO, MP_TP_FLOOR = 1.1, 1.5
MP_TIMEOUT = 600.0
MP_K1 = ("group_norm_silu_stats", "group_norm_silu_apply")
# Spatially sharded training (phase 26): the full-width pixel U-Net at 512px, global batch 2, the height split
# over two ranks sharing the card over gloo on a (1, 2) mesh, against one NCCL rank's unsharded step; the CLI for
# 3 steps over 6 images. K1's split form at each level's half-height shape, MP_GN_CALLS of each a forward. The
# fp32 bounds are phase 24's spatial ones (loss relative, each gradient against its largest magnitude); the bf16
# check is phase 13's fp32 ratio.
ST_SIZE, ST_BATCH, ST_IMAGES, ST_STEPS, ST_TIMEOUT = 512, 2, 6, 3, 600.0
ST_GN_SHAPES = [(ST_BATCH, H * ST_SIZE // SIZE // 2, W * ST_SIZE // SIZE, C) for H, W, C in GN_SHAPES]
ST_LOSS_TOL, ST_GRAD_TOL = 1e-4, MP_FP32_TOL


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


@functools.cache
def unit_rates() -> dict:
    """Per second on card 0: ex2 on the exp unit and lanes of the FMA pipe,
    from its SM count and its maximum SM clock."""
    import torch

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sm_per_s = torch.cuda.get_device_properties(0).multi_processor_count * float(smi.stdout.strip()) * 1e6
    return {"exp unit": EXP2_PER_CLOCK_SM * sm_per_s, "FMA pipe": FMA_LANES_PER_CLOCK_SM * sm_per_s,
            "max SM clock MHz": float(smi.stdout.strip())}


def bound_terms(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S, exps: float = 0.0,
                fma: float = 0.0) -> dict:
    """ms of each limit: bytes over HBM, flops over the tensor cores (or the
    fp32 rate), exponentials over the exp unit, FMA-pipe instructions."""
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": flops / flops_per_s * 1e3,
            "exp unit": exps / unit_rates()["exp unit"] * 1e3 if exps else 0.0,
            "FMA pipe": fma / unit_rates()["FMA pipe"] * 1e3 if fma else 0.0}


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S, exps: float = 0.0,
          fma: float = 0.0):
    """(bound_ms, bound_by, bound_unit): the least time the card could take,
    the largest of ``bound_terms``. ``bound_unit`` names that term;
    ``bound_by`` folds the exp unit and the FMA pipe into "operations",
    the two values the kernels record's format allows."""
    terms = bound_terms(nbytes, flops, flops_per_s, exps, fma)
    unit = max(terms, key=terms.get)
    return terms[unit], ("bytes" if unit == "bytes" else "operations"), unit


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time of ``fn`` per call with no host work between the calls:
    ``iters`` calls captured in a CUDA graph and replayed (where the host's
    enqueue of one call takes longer than the device's work, ``cuda_ms``
    measures the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_convs(rc):
    """Route the model's two kernel entry points to their plain versions."""
    saved = rc.affine_silu_conv3x3, rc.affine_conv3x3

    def silu(x, A, B, w9, bias, add=None, want_moments=False):
        return rc.affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=False)

    def lin(x, A, B, w9, bias, add=None, want_moments=False):
        return rc.affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=True)

    rc.affine_silu_conv3x3, rc.affine_conv3x3 = silu, lin
    try:
        yield
    finally:
        rc.affine_silu_conv3x3, rc.affine_conv3x3 = saved


def reset_launches(rc) -> None:
    rc.affine_silu_conv3x3.launches = 0
    rc.affine_conv3x3.launches = 0


def start_builds():
    """Compile every kernel library at once, one nvcc each; returns
    name -> future of (library path, seconds from the start)."""
    from clip_codec_tpu_torch.ops import _build

    t0 = time.perf_counter()

    def one(name):
        return _build.build(name), time.perf_counter() - t0

    names = sorted({lib for lib, _ in KERNELS.values()})
    pool = ThreadPoolExecutor(max_workers=len(names))
    futures = {name: pool.submit(one, name) for name in names}
    pool.shutdown(wait=False)
    return futures


def phase_build(builds, names=("affine_conv3x3",)):
    for name in names:
        try:
            lib, dt = builds[name].result()
        except RuntimeError as e:
            raise PhaseError(f"build of {name}.cu failed: {e}") from e
        print(f"build: {lib.name} in {dt:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
                if name == "groupnorm_silu" and "spill" in line:
                    check("0 bytes spill stores, 0 bytes spill loads" in line,
                          f"{name}.cu spills: {line.strip()}")


def _inputs(torch, gen, B, H, W, cin, cout, dev):
    x = torch.randn((B, H, W, cin), generator=gen, device=dev).to(torch.bfloat16)
    A = 0.5 + torch.rand((B, cin), generator=gen, device=dev)
    Bv = 0.1 * torch.randn((B, cin), generator=gen, device=dev)
    w9 = (torch.randn((9, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    add = torch.randn((B, H, W, cout), generator=gen, device=dev).to(torch.bfloat16)
    return x, A, Bv, w9, bias, add


def _conv_bound(B, H, W, cin, cout, use_add, mom):
    """(bound_ms, bound_by, bound_unit) of one conv call: x read, y written,
    weights, the affine, bias, the residual and the moments once each."""
    px = B * H * W
    nbytes = (px * cin * 2 + 2 * B * cin * 4 + 9 * cin * cout * 2 + cout * 4 + px * cout * 2
              + (px * cout * 2 if use_add else 0) + (B * 2 * cout * 4 if mom else 0))
    return bound(nbytes, 2 * 9 * cin * cout * px)


def phase_kernels(torch, rc, seed, dev, batches=(2, SERVE_BATCH, EVAL_BATCH, WIDE_BATCH), checked=(2,)):
    """Kernel vs plain at every fused conv shape of the full-width U-Net at
    256px and each of ``batches``: at a batch in ``checked`` every
    combination of residual and moments, untimed; at the others (B=4 the
    serving batch, B=8 the eval CLI's, B=16 the exported artifact's, phase
    20) the two forms the U-Net runs, each timed. Returns per-kernel
    records, one per timed path shape and batch."""
    import torch.nn.functional as F

    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    gen = torch.Generator(device=dev).manual_seed(seed)
    records = {"affine_silu_conv3x3": [], "affine_conv3x3": []}
    errs = {"affine_silu_conv3x3": 0.0, "affine_conv3x3": 0.0}
    for batch in batches:
        shapes = path_conv_shapes(PX_BASE, PX_CH_MULT, SIZE, batch)
        for (B, H, W, cin, cout), calls in shapes:
            linear = (B, H, W, cin, cout) == shapes[-1][0]  # the head: K3
            name = "affine_conv3x3" if linear else "affine_silu_conv3x3"
            fn = rc.affine_conv3x3 if linear else rc.affine_silu_conv3x3
            if linear:
                forms = [(False, False)]
            elif B in checked:
                forms = [(a, m) for a in (False, True) for m in (False, True)]
            else:
                forms = [(False, True), (True, False)]  # a ResBlock's conv1 and conv2
            timed = {}
            for use_add, mom in forms:
                x, A, Bv, w9, bias, add = _inputs(torch, gen, B, H, W, cin, cout, dev)
                add = add if use_add else None
                y, m = fn(x, A, Bv, w9, bias, add, mom)
                y_ref, m_ref = rc.affine_conv3x3_plain(x, A, Bv, w9, bias, add, mom, linear=linear)
                torch.cuda.synchronize()
                yf, rf = y.float(), y_ref.float()
                err = (yf - rf).abs().max().item()
                ok = bool(((yf - rf).abs() <= 2e-2 + 2e-2 * rf.abs()).all().item())
                mom_rel = 0.0
                if mom:
                    for k in range(2):
                        scale = m_ref[:, k].abs().max().item()
                        mom_rel = max(mom_rel, (m[:, k] - m_ref[:, k]).abs().max().item() / max(scale, 1e-30))
                tag = f"{name} B={B} {H}x{W} {cin}->{cout} add={int(use_add)} moments={int(mom)}"
                line = f"kernel-check: {tag} max_abs_err={err:.3e} moments_rel_err={mom_rel:.3e}"
                if B not in checked:
                    call = lambda: fn(x, A, Bv, w9, bias, add, mom)
                    act = x.permute(0, 3, 1, 2)
                    wt = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                    b_ms, b_by, b_unit = _conv_bound(B, H, W, cin, cout, use_add, mom)
                    t = dict(ms=graph_ms(torch, call), events_ms=cuda_ms(torch, call),
                             plain_ms=cuda_ms(torch, lambda: rc.affine_conv3x3_plain(
                                 x, A, Bv, w9, bias, add, mom, linear=linear), iters=3, warmup=1),
                             library_ms=graph_ms(torch, lambda: F.conv2d(act, wt, padding=1)),
                             bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit)
                    timed["moments" if mom else "add" if use_add else "linear"] = t
                    line += (f" ms={t['ms']:.4f} (graph) events_ms={t['events_ms']:.4f} plain_ms={t['plain_ms']:.4f}"
                             f" cudnn_bf16_conv_only_ms={t['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_unit})"
                             f" kernel_TFLOPs={2 * 9 * cin * cout * B * H * W / 1e9 / t['ms']:.1f}")
                print(line)
                check(ok, f"{tag}: y outside rtol=atol=2e-2 (max abs err {err})")
                check(mom_rel <= 1e-3, f"{tag}: moments rel err {mom_rel} > 1e-3")
                errs[name] = max(errs[name], err)
            if timed:
                # One record per path shape; K2's two forms run equally often, so its
                # numbers are their means (each form's own beside them).
                rec = {k: sum(t[k] for t in timed.values()) / len(timed)
                       for k in ("ms", "events_ms", "plain_ms", "library_ms", "bound_ms")}
                first = next(iter(timed.values()))
                rec.update(bound_by=first["bound_by"], bound_unit=first["bound_unit"], shape=[B, H, W, cin, cout],
                           calls_per_forward=calls, forms=timed,
                           library="cuDNN bf16 conv alone, for scale (no one call computes the fused function)")
                records[name].append(rec)
    for name, recs in records.items():
        for rec in recs:
            rec["max_abs_err"] = errs[name]
    return records


def full_unet(torch, seed, dev):
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params

    net = CLIPCondUNet(z_dim=512, base=128, ch_mult=(1, 2, 2), time_dim=256, img_ch=3,
                       dtype=torch.bfloat16)
    init_params(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def phase_forward(torch, rc, net, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((2, SIZE, SIZE, 3), generator=gen, device=dev)
    z = torch.nn.functional.normalize(torch.randn((2, 512), generator=gen, device=dev), dim=-1)
    t = torch.tensor([999, 412], dtype=torch.int32, device=dev)
    with torch.no_grad():
        reset_launches(rc)
        eps_k = net(x, z, t).float()
        n = rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches
        with plain_convs(rc):
            eps_p = net(x, z, t).float()
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: net(x, z, t), iters=5, warmup=1)
        with plain_convs(rc):
            p_ms = cuda_ms(torch, lambda: net(x, z, t), iters=5, warmup=1)
    rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    print(f"unet-forward: base=128 ch_mult=(1,2,2) {SIZE}px B=2 bf16 rel_err={rel:.3e} "
          f"launches={n} kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f}")
    check(bool(torch.isfinite(eps_k).all().item()), "U-Net eps not finite")
    check(tuple(eps_k.shape) == (2, SIZE, SIZE, 3), f"U-Net eps shape {tuple(eps_k.shape)}")
    check(n == LAUNCHES_PER_FORWARD, f"U-Net forward launched {n} kernels, expected {LAUNCHES_PER_FORWARD}")
    check(rel < 2e-2, f"U-Net kernel vs plain path rel err {rel} >= 2e-2")
    # Device time of a forward on the kernel path, with no host time between
    # its kernels: forwards replayed from a CUDA graph, at the serving batch
    # and at the wide one.
    for B in (SERVE_BATCH, WIDE_BATCH):
        xb = torch.randn((B, SIZE, SIZE, 3), generator=gen, device=dev)
        zb = torch.nn.functional.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
        tb = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
        with torch.no_grad():
            g_ms = graph_ms(torch, lambda: net(xb, zb, tb), iters=5)
            e_ms = cuda_ms(torch, lambda: net(xb, zb, tb), iters=5, warmup=1)
        print(f"unet-forward: B={B} {SIZE}px kernel path device_ms={g_ms:.4f} (CUDA-graph replay) "
              f"events_ms={e_ms:.4f}")


def make_store(torch, net, seed, store: Path):
    import numpy as np

    from clip_codec_tpu_torch.utils.config import ModelConfig

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((256, 512)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    zero = feats.min(0)
    scale = (np.maximum(feats.max(0) - zero, np.float32(1e-8)) / np.float32(255)).astype(np.float32)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=scale, zero=zero)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save(sd, store / "diffusion_unet_final.pt")
    ModelConfig.infer_from_state_dict(sd).save(store)
    return np.clip(np.round((feats - zero) / scale), 0, 255).astype(np.uint8)


def phase_serve(torch, rc, net, seed, dev, card):
    import numpy as np

    from clip_codec_tpu_torch.codec import ClipCodec

    store = ROOT / "build" / "chip_smoke" / "store"
    codes = make_store(torch, net, seed, store)
    codec = ClipCodec.load(store, device=dev)
    check(codec.net is not None, "ClipCodec.load found no decoder")

    from clip_codec_tpu_torch.io.bitstream import compress_frames

    frames = frame_engine("serve")

    sizes, batch_size, steps = (1, 3, 6), 4, STEPS
    batches = sum(-(-n // batch_size) for n in sizes)
    requests = []
    s = 0
    for n in sizes:
        q = codes[s : s + n]
        s += n
        requests.append(compress_frames(q) if frames else q)

    torch.cuda.synchronize()
    reset_launches(rc)
    shapes = collections.Counter()  # launches by (H, W, Cin, Cout), through the wrappers' one launcher
    launch = rc._launch

    def tally(x, A, B, w9, bias, add, want_moments, linear):
        shapes[(*x.shape[1:], w9.shape[2])] += 1
        return launch(x, A, B, w9, bias, add, want_moments, linear)

    rc._launch = tally
    times = []
    try:
        for n, req in zip(sizes, requests):
            t0 = time.perf_counter()
            if frames:
                out = codec.decompress(req, size=SIZE, steps=steps, batch_size=batch_size, seed=seed)
            else:
                out = codec.decompress_codes(req, size=SIZE, steps=steps, batch_size=batch_size, seed=seed)
            times.append(time.perf_counter() - t0)
            check(out.shape == (n, SIZE, SIZE, 3), f"request of {n}: output shape {out.shape}")
            check(bool(np.isfinite(out).all()), f"request of {n}: non-finite output")
            check(float(np.abs(out).max()) <= 1.0, f"request of {n}: output outside [-1, 1]")
    finally:
        rc._launch = launch
    launches = {"affine_silu_conv3x3": rc.affine_silu_conv3x3.launches,
                "affine_conv3x3": rc.affine_conv3x3.launches}
    total = sum(launches.values())
    for n, dt in zip(sizes, times):
        print(f"serve: request of {n} frames ({-(-n // batch_size)} batch of {batch_size}, DDIM-{steps}, "
              f"{SIZE}px) {dt:.3f} s on {card}")
    print(f"serve: {sum(sizes)} images in {sum(times):.3f} s = {sum(sizes) / sum(times):.3f} img/s "
          f"(padded rows included in the work: {batches * batch_size} rows) on {card}; "
          f"launches={launches}")
    check(total == LAUNCHES_PER_FORWARD * steps * batches,
          f"kernel launches {total} != 29 x {steps} x {batches}")
    check(launches["affine_conv3x3"] == steps * batches, "head kernel launch count")
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    want = {shape[1:]: calls * steps * batches for shape, calls in
            path_conv_shapes(PX_BASE, PX_CH_MULT, SIZE, batch_size)}
    print(f"serve: launches by (H, W, Cin, Cout): {dict(shapes)}")
    check(dict(shapes) == want, f"launches by shape {dict(shapes)} != {want}")
    launches["by_shape"] = dict(shapes)
    return launches


# ------------------------------------------------------------ the SD path


def reset_sd_launches(attn, mlp) -> None:
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd_dq.launches = 0
    attn.flash_attention_bwd_dkv.launches = 0
    mlp.transformer_mlp.launches = 0
    mlp.mlp_up.launches = 0
    mlp.mlp_down.launches = 0


def sd_launches(attn, mlp) -> dict:
    return {"flash_attention": attn.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": attn.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": attn.flash_attention_bwd_dkv.launches,
            "transformer_mlp": mlp.transformer_mlp.launches, "mlp_up": mlp.mlp_up.launches,
            "mlp_down": mlp.mlp_down.launches}


@contextlib.contextmanager
def plain_sd_kernels(attn, mlp):
    """Route the SD blocks' kernel entry points (flash forward and backward,
    the fused MLP) to their plain versions."""
    saved = attn.flash_attention_fwd, attn.flash_attention_bwd, mlp.transformer_mlp

    def mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo, packed=None):
        return mlp.mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo)

    attn.flash_attention_fwd, attn.flash_attention_bwd = attn.flash_attention_plain, attn.flash_attention_bwd_plain
    mlp.transformer_mlp = mlp_plain
    try:
        yield
    finally:
        attn.flash_attention_fwd, attn.flash_attention_bwd, mlp.transformer_mlp = saved


def _randn(torch, gen, shape, dev, scale=1.0, dtype=None):
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return x if dtype is None else x.to(dtype)


def phase_sd_kernels(torch, attn, mlp, seed, dev):
    """Flash attention and the fused MLP against their plain versions at the
    SD-1.5 512px shapes, bf16; returns per-kernel records."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rec = {"flash_attention": flash_cases(torch, attn, gen, dev, FLASH_SHAPES)}
    rec.update(phase_mlp_kernels(torch, mlp, gen, dev))
    return rec


def flash_cases(torch, attn, gen, dev, shapes):
    """K4 against its plain version at each (BH, N, D) of ``shapes``, normal
    and extreme logits, bf16, timed beside SDPA at normal logits; the record
    (the first shape's times, every shape's under ``shapes``)."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    rec = {"max_abs_err": 0.0}
    for BH, N, D in shapes:
        for q_scale in (1.0, 30.0):
            q = _randn(torch, gen, (BH, N, D), dev, q_scale, bf)
            k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, bf) for _ in range(2))
            out, lse = attn.flash_attention_fwd(q, k, v)
            ref, lse_ref = attn.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = bool(((out.float() - ref.float()).abs() <= 2e-2 + 2e-2 * ref.float().abs()).all().item())
            tag = f"flash_attention (BH, N, D)=({BH}, {N}, {D}) {'extreme' if q_scale > 1 else 'normal'} logits"
            line = f"kernel-check: {tag} max_abs_err={err:.3e} lse_abs_err={lse_err:.3e}"
            if q_scale == 1.0:
                k_ms = cuda_ms(torch, lambda: attn.flash_attention_fwd(q, k, v))
                kg_ms = graph_ms(torch, lambda: attn.flash_attention_fwd(q, k, v))
                p_ms = cuda_ms(torch, lambda: attn.flash_attention_plain(q, k, v), iters=5)
                sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])
                lib_ms, libg_ms = cuda_ms(torch, sdpa), graph_ms(torch, sdpa)
                tflops = 4 * BH * N * N * D / 1e9 / k_ms
                # exps: one exp2 per score, what softmax needs (the tiling's alphas are the kernel's own)
                b_ms, b_by, b_unit = bound(4 * BH * N * D * 2 + BH * N * 4, 4 * BH * N * N * D, exps=BH * N * N)
                line += (f" ms={k_ms:.4f} graph_ms={kg_ms:.4f} plain_ms={p_ms:.4f}"
                         f" sdpa_library_not_plain_ms={lib_ms:.4f} sdpa_graph_ms={libg_ms:.4f}"
                         f" bound_ms={b_ms:.4f} ({b_unit}) kernel_TFLOPs={tflops:.1f}")
                # every path shape; the record's own keys are the first shape's
                rec.setdefault("shapes", []).append(
                    dict(shape=[BH, N, D], ms=k_ms, graph_ms=kg_ms, plain_ms=p_ms, library_ms=lib_ms,
                         library_graph_ms=libg_ms, bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit))
                if (BH, N, D) == tuple(shapes[0]):
                    rec.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                               bound_unit=b_unit, timed_at=tag)
            print(line)
            check(ok, f"{tag}: out outside rtol=atol=2e-2 (max abs err {err})")
            check(lse_err <= 1e-3, f"{tag}: lse abs err {lse_err} > 1e-3")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


def _mlp_bounds(R, C, Fh):
    """(bound_ms, bound_by, bound_unit) of mlp_up (x, the LayerNorm vectors,
    wh and wg, the biases read, h written; 4 R C F FLOP), of mlp_down (h and
    wo read, y written; 2 R C F) and of the pair (the function: x, every
    weight and vector read, y written; 6 R C F). h's round trip is the
    design's own cost, not the function's."""
    vec = 2 * C * 4 + 2 * Fh * 4
    return (bound(R * C * 2 + vec + 2 * C * Fh * 2 + R * Fh * 2, 4 * R * C * Fh),
            bound(R * Fh * 2 + C * Fh * 2 + R * C * 2, 2 * R * C * Fh),
            bound(2 * R * C * 2 + vec + 3 * C * Fh * 2, 6 * R * C * Fh))


def phase_mlp_kernels(torch, mlp, gen, dev, shapes=tuple(MLP_SHAPES), ragged=MLP_RAGGED):
    """K6's two kernels (mlp_up: the LayerNorm pre-pass and the GEGLU
    product; mlp_down: the out-projection, with its split sum where it
    splits), each against its plain piece on the same input, and the pair
    against mlp_plain, at every ``shapes`` entry and the ``ragged`` one (if
    any); timed at ``shapes``. Returns one record per kernel and shape."""
    import torch.nn.functional as F

    from clip_codec_tpu_torch.probes.mlp_times import cublas_unfused

    recs = {"mlp_up": [], "mlp_down": []}
    errs = {"mlp_up": 0.0, "mlp_down": 0.0}
    splits_seen = set()
    bf = torch.bfloat16
    for R, C, Fh in list(shapes) + ([ragged] if ragged else []):
        x = _randn(torch, gen, (R, C), dev, 1.0, bf)
        lns, lnb = 1 + _randn(torch, gen, (C,), dev, 0.1), _randn(torch, gen, (C,), dev, 0.1)
        wh, wg = (_randn(torch, gen, (C, Fh), dev, C ** -0.5) for _ in range(2))
        bh, bg = (_randn(torch, gen, (Fh,), dev, 0.1) for _ in range(2))
        wo = _randn(torch, gen, (Fh, C), dev, Fh ** -0.5)
        packed = mlp.pack_weights(wh, wg, wo)
        args = (x, lns, lnb, wh, bh, wg, bg, wo)
        splits = mlp.kernel_splits(R, C, Fh, dev)
        splits_seen.add(splits > 1)
        h = mlp.mlp_up(*args[:7], packed=packed)
        h_ref = mlp.mlp_up_plain(*args[:7])
        y = mlp.mlp_down(h_ref, wo, packed)
        y_ref = mlp.mlp_down_plain(h_ref, wo)
        y2 = mlp.transformer_mlp(*args, packed=packed)
        ref = mlp.mlp_plain(*args)
        torch.cuda.synchronize()
        tag = f"(R, C, F)=({R}, {C}, {Fh}) splits={splits}"
        line = f"kernel-check: mlp {tag}"
        for name, got, want in (("mlp_up", h, h_ref), ("mlp_down", y, y_ref), ("pair", y2, ref)):
            d = (got.float() - want.float()).abs()
            err = d.max().item()
            line += f" {name}_max_abs_err={err:.3e}"
            check(bool((d <= 2e-2 + 2e-2 * want.float().abs()).all().item()),
                  f"{name} {tag}: outside rtol=atol=2e-2 of its plain version (max abs err {err})")
            if name in errs:
                errs[name] = max(errs[name], err)
        if (R, C, Fh) == ragged:
            print(line)
            continue
        pair = lambda: mlp.transformer_mlp(*args, packed=packed)
        up = lambda: mlp.mlp_up(*args[:7], packed=packed)
        down = lambda: mlp.mlp_down(h_ref, wo, packed)
        unfused = cublas_unfused(*args)
        t = dict(pair_ms=cuda_ms(torch, pair), pair_graph_ms=graph_ms(torch, pair),
                 pair_plain_ms=cuda_ms(torch, lambda: mlp.mlp_plain(*args), iters=3, warmup=1),
                 cublas_unfused_ms=cuda_ms(torch, unfused), cublas_unfused_graph_ms=graph_ms(torch, unfused))
        (ub, uby, uu), (db, dby, du), (pb, pby, pu) = _mlp_bounds(R, C, Fh)
        t.update(pair_bound_ms=pb, pair_bound_by=pby)
        for name, fn, plain, lib, (b_ms, b_by, b_unit) in (
                ("mlp_up", up, lambda: mlp.mlp_up_plain(*args[:7]), None, (ub, uby, uu)),
                ("mlp_down", down, lambda: mlp.mlp_down_plain(h_ref, wo), lambda: F.linear(h_ref, packed[1]),
                 (db, dby, du))):
            r = dict(shape=[R, C, Fh], ms=graph_ms(torch, fn), events_ms=cuda_ms(torch, fn),
                     plain_ms=cuda_ms(torch, plain, iters=3, warmup=1),
                     library_ms=None if lib is None else graph_ms(torch, lib),
                     bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit, **t)
            if name == "mlp_down":
                r["splits"] = splits
            recs[name].append(r)
            line += (f" {name}_ms={r['ms']:.4f} (graph) events_ms={r['events_ms']:.4f} plain_ms={r['plain_ms']:.4f}"
                     f" bound_ms={b_ms:.4f} ({b_unit})")
            if lib is not None:
                line += f" F.linear_library_ms={r['library_ms']:.4f}"
        line += (f" pair_ms={t['pair_ms']:.4f} pair_graph_ms={t['pair_graph_ms']:.4f}"
                 f" pair_plain_ms={t['pair_plain_ms']:.4f} pair_bound_ms={pb:.4f} ({pu})"
                 f" cublas_unfused_library_not_plain_ms={t['cublas_unfused_ms']:.4f}"
                 f" (graph {t['cublas_unfused_graph_ms']:.4f}) kernel_TFLOPs={6 * R * C * Fh / 1e9 / t['pair_graph_ms']:.1f}")
        print(line)
    if ragged:  # mlp_down's two epilogues: bf16 from registers, and fp32 partials + the sum kernel
        check(splits_seen == {False, True}, "MLP shapes must run mlp_down both with and without a split")
    for name, rs in recs.items():
        for r in rs:
            r["max_abs_err"] = errs[name]
    return recs


def sd_models(torch, seed, dev):
    from clip_codec_tpu_torch.models import init_params
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SD15_VAE, AutoencoderKL, SDClipAdapter, SDUNet

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    with torch.device(dev):
        unet = SDUNet(SD15_UNET, dtype=torch.bfloat16)
        vae = AutoencoderKL(SD15_VAE, dtype=torch.bfloat16)
        adapter = SDClipAdapter(512, SD15_UNET.cross_dim, 1024, 8)
    return [init_params(m, gen).eval() for m in (unet, vae, adapter)]


def phase_sd_forward(torch, attn, mlp, unet, vae, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.tensor([981, 401], dtype=torch.int32, device=dev)
    ctx = torch.randn((2, 8, 768), generator=gen, device=dev)
    z = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    with torch.no_grad():
        reset_sd_launches(attn, mlp)
        eps_k = unet(lat, t, ctx).float()
        n_fwd = (attn.flash_attention_fwd.launches, mlp.transformer_mlp.launches)
        reset_sd_launches(attn, mlp)
        img_k = vae.decode(z).float()
        n_dec = (attn.flash_attention_fwd.launches, mlp.transformer_mlp.launches)
        with plain_sd_kernels(attn, mlp):
            eps_p = unet(lat, t, ctx).float()
            img_p = vae.decode(z).float()
            # The same weights in fp32 on the plain versions: how far each
            # bf16 path is from it says how large bf16's own noise is here.
            unet.compute_dtype = vae.compute_dtype = torch.float32
            try:
                eps_32, img_32 = unet(lat, t, ctx), vae.decode(z)
            finally:
                unet.compute_dtype = vae.compute_dtype = torch.bfloat16
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: unet(lat, t, ctx), iters=5, warmup=1)
        d_ms = cuda_ms(torch, lambda: vae.decode(z), iters=3, warmup=1)
        with plain_sd_kernels(attn, mlp):
            p_ms = cuda_ms(torch, lambda: unet(lat, t, ctx), iters=5, warmup=1)
            dp_ms = cuda_ms(torch, lambda: vae.decode(z), iters=3, warmup=1)
    def rel_to(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    rel, rel_d = rel_to(eps_k, eps_p), rel_to(img_k, img_p)
    u32 = rel_to(eps_k, eps_32), rel_to(eps_p, eps_32)
    v32 = rel_to(img_k, img_32), rel_to(img_p, img_32)
    print(f"sd-unet-forward: SD-1.5 64x64 latents B=2 bf16 rel_err={rel:.3e} launches(flash, mlp)={n_fwd} "
          f"kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f} to_fp32(kernel, plain)="
          f"({u32[0]:.3e}, {u32[1]:.3e}) ratio={u32[0] / u32[1]:.4f}")
    print(f"sd-vae-decode: SD-1.5 512px B=1 bf16 rel_err={rel_d:.3e} launches(flash, mlp)={n_dec} "
          f"kernel_path_ms={d_ms:.3f} plain_path_ms={dp_ms:.3f} to_fp32(kernel, plain)="
          f"({v32[0]:.3e}, {v32[1]:.3e}) ratio={v32[0] / v32[1]:.4f}")
    check(bool(torch.isfinite(eps_k).all().item()), "SD UNet eps not finite")
    check(tuple(eps_k.shape) == (2, 64, 64, 4), f"SD UNet eps shape {tuple(eps_k.shape)}")
    check(bool(torch.isfinite(img_k).all().item()), "VAE decode not finite")
    check(tuple(img_k.shape) == (1, SD_SIZE, SD_SIZE, 3), f"VAE decode shape {tuple(img_k.shape)}")
    check(n_fwd == (SD_FLASH_PER_FORWARD, SD_MLP_PER_FORWARD), f"UNet forward launches {n_fwd}")
    check(n_dec == (1, 0), f"VAE decode launches {n_dec}")
    check(rel < 2e-2, f"SD UNet kernel vs plain path rel err {rel} >= 2e-2")
    check(rel_d < 2e-2, f"VAE decode kernel vs plain path rel err {rel_d} >= 2e-2")
    # Both bf16 paths sit at bf16's noise floor from each other, so the
    # discriminating check is against fp32: the kernel path may be at most
    # 10% further from it than the plain path.
    check(u32[0] <= FP32_RATIO * u32[1], f"SD UNet: kernel path {u32[0]} from fp32 > {FP32_RATIO} x plain's {u32[1]}")
    check(v32[0] <= FP32_RATIO * v32[1], f"VAE decode: kernel path {v32[0]} from fp32 > {FP32_RATIO} x plain's {v32[1]}")


def sd_embeddings(seed, n):
    """(n, 512) L2-normalised embeddings as the CLI reads them: through .clp
    frames where a zstd engine exists, else from the codes directly."""
    import numpy as np

    from clip_codec_tpu_torch.codecs.quantizer import dequantize_l2norm_host

    rng = np.random.default_rng(seed + 5)
    codes = rng.integers(0, 256, (n, 512), dtype=np.uint8)
    scale = np.full(512, 2.0 / 255.0, np.float32)
    zero = np.full(512, -1.0, np.float32)
    if not frame_engine("sd"):
        return dequantize_l2norm_host(codes, scale, zero).astype(np.float32)
    from clip_codec_tpu_torch.io.bitstream import write_bitstream
    from clip_codec_tpu_torch.train.train_decoder import decode_embedding

    store = ROOT / "build" / "chip_smoke" / "sd"
    np.savez(store / "codec_meta.npz", scale=scale, zero=zero)
    z = []
    for i, row in enumerate(codes):
        write_bitstream(row.tobytes(), 512, store / f"img{i}.clp")
        z.append(decode_embedding(store / f"img{i}.clp", store))
    return np.concatenate(z)


def phase_sd_serve(torch, attn, mlp, unet, vae, adapter, seed, dev, card):
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli

    store = ROOT / "build" / "chip_smoke" / "sd"
    store.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # diffusers' fp16 layout for the frozen towers, the reference fp32 adapter
    for name, mod, dt in (("unet", unet, torch.float16), ("vae", vae, torch.float16),
                          ("adapter", adapter, torch.float32)):
        torch.save({k: v.detach().to("cpu", dt) for k, v in mod.state_dict().items()}, store / f"{name}.pt")
    t1 = time.perf_counter()
    dec = cli.load_decoder(store / "unet.pt", store / "vae.pt", store / "adapter.pt", dev, heads=8)
    t2 = time.perf_counter()
    print(f"sd-serve: saved weights in {t1 - t0:.2f} s, loaded through the CLI's loader in {t2 - t1:.2f} s")
    z_all = sd_embeddings(seed, sum(SD_REQUESTS))

    torch.cuda.synchronize()
    reset_sd_launches(attn, mlp)
    shapes = collections.Counter()  # mlp_up launches by (R, C, F), through its one launcher
    launch_up = mlp._launch_up

    def tally(x, *rest):
        shapes[(x.numel() // x.shape[-1], x.shape[-1], rest[2].shape[0])] += 1
        return launch_up(x, *rest)

    mlp._launch_up = tally
    times, s = [], 0
    try:
        for n in SD_REQUESTS:
            z = z_all[s:s + n]
            s += n
            t0 = time.perf_counter()
            img = cli.sample_images(dec, z, SD_SIZE, steps=SD_STEPS, sampler="dpmpp", guidance=SD_GUIDANCE,
                                    seed=seed).float().cpu()
            times.append(time.perf_counter() - t0)
            check(tuple(img.shape) == (n, SD_SIZE, SD_SIZE, 3), f"SD request of {n}: output shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all().item()), f"SD request of {n}: non-finite output")
    finally:
        mlp._launch_up = launch_up
    launches = {k: sd_launches(attn, mlp)[k] for k in ("flash_attention", "transformer_mlp", "mlp_up", "mlp_down")}
    for n, dt in zip(SD_REQUESTS, times):
        print(f"sd-serve: request of {n} embedding(s) (CFG batched, UNet batch {2 * n}, dpmpp-{SD_STEPS}, "
              f"guidance {SD_GUIDANCE}, {SD_SIZE}px) {dt:.3f} s on {card}")
    print(f"sd-serve: {sum(SD_REQUESTS)} images in {sum(times):.3f} s = {sum(SD_REQUESTS) / sum(times):.3f} img/s "
          f"on {card}; launches={launches}")
    n_mlp = len(SD_REQUESTS) * SD_STEPS * SD_MLP_PER_FORWARD
    want = {"flash_attention": len(SD_REQUESTS) * (SD_STEPS * SD_FLASH_PER_FORWARD + 1),
            "transformer_mlp": n_mlp, "mlp_up": n_mlp, "mlp_down": n_mlp}
    check(launches == want, f"SD kernel launches {launches} != {want}")
    from clip_codec_tpu_torch.probes.mlp_times import unet_mlp_shapes

    want_shapes = collections.Counter()
    for n in SD_REQUESTS:  # CFG batched: UNet batch 2n
        for shape, calls in unet_mlp_shapes(2 * n):
            want_shapes[shape] += calls * SD_STEPS
    print(f"sd-serve: mlp launches by (R, C, F): {dict(shapes)}")
    check(shapes == want_shapes, f"MLP launches by shape {dict(shapes)} != {dict(want_shapes)}")
    launches["mlp_by_shape"] = dict(shapes)
    return launches


# ------------------------------------------------------ SD adapter training


def _sdpa_bwd_ms(torch, q, k, v, dout):
    """SDPA's backward alone at the same shape: one library call computing
    dq, dk and dv, the work of K5's pair (for scale, not a plain version)."""
    import torch.nn.functional as F

    qs, ks, vs = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs)
    return cuda_ms(torch, lambda: torch.autograd.grad(o, (qs, ks, vs), dout[None], retain_graph=True))


def flash_bwd_records() -> dict:
    return {"flash_attention_bwd_dq": {"max_abs_err": 0.0}, "flash_attention_bwd_dkv": {"max_abs_err": 0.0}}


def flash_bwd_cases(torch, attn, gen, dev, cases, rec) -> list:
    """K5's two kernels against the plain backward for each ((BH, N, D),
    q_scale) case, timed at normal logits; raises each record's max_abs_err
    and returns the timed shapes' dicts."""
    bf = torch.bfloat16
    timed = []
    for (BH, N, D), q_scale in cases:
        q = _randn(torch, gen, (BH, N, D), dev, q_scale, bf)
        k, v, dout = (_randn(torch, gen, (BH, N, D), dev, 1.0, bf) for _ in range(3))
        out, lse = attn.flash_attention_fwd(q, k, v)
        lse2, dvec = attn._bwd_stats(out, lse, dout)
        got = attn.flash_attention_bwd(q, k, v, out, lse, dout)
        want = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        tag = f"flash_attention_bwd (BH, N, D)=({BH}, {N}, {D}) {'extreme' if q_scale > 1 else 'normal'} logits"
        errs, rels = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            scale = w.abs().max().item()
            errs[name] = (g - w).abs().max().item()
            rels[name] = errs[name] / scale
            ok = bool(((g - w).abs() <= 2e-2 * (w.abs() + scale)).all().item())
            check(ok, f"{tag}: {name} outside rtol = atol = 2e-2 of its scale {scale:.3e} "
                      f"(max abs err {errs[name]:.3e})")
        del got, want
        line = (f"kernel-check: {tag} max_abs_err(dq, dk, dv)=({errs['dq']:.3e}, {errs['dk']:.3e}, "
                f"{errs['dv']:.3e}) relative to each max |grad|=({rels['dq']:.3e}, {rels['dk']:.3e}, "
                f"{rels['dv']:.3e})")
        rec["flash_attention_bwd_dq"]["max_abs_err"] = max(rec["flash_attention_bwd_dq"]["max_abs_err"], errs["dq"])
        rec["flash_attention_bwd_dkv"]["max_abs_err"] = max(rec["flash_attention_bwd_dkv"]["max_abs_err"],
                                                            errs["dk"], errs["dv"])
        if q_scale == 1.0:
            args = (q, k, v, dout, lse2, dvec)
            dq_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dq(*args))
            dkv_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dkv(*args))
            dqg_ms = graph_ms(torch, lambda: attn.flash_attention_bwd_dq(*args))
            dkvg_ms = graph_ms(torch, lambda: attn.flash_attention_bwd_dkv(*args))
            pdq_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dq_plain(*args), iters=3, warmup=1)
            pdkv_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dkv_plain(*args), iters=3, warmup=1)
            lib_ms = _sdpa_bwd_ms(torch, q, k, v, dout)
            prod = 2 * BH * N * N * D  # flops of one (N, N, D) product
            io = 4 * BH * N * D * 2 + 2 * BH * N * 4  # q, k, v, dout bf16 + lse, dvec fp32, read once
            exps = BH * N * N  # p = exp2(s - lse2), recomputed in each kernel, once in the pair's own work
            bq = bound(io + BH * N * D * 2, 3 * prod, exps=exps)  # dq: S, dP, dS K
            bkv = bound(io + 2 * BH * N * D * 2, 4 * prod, exps=exps)  # dk, dv: S, dP, P^T dO, dS^T Q
            bpair = bound(io + 3 * BH * N * D * 2, 5 * prod, exps=exps)  # the backward's own work, no recompute
            line += (f" dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} plain_dq_ms={pdq_ms:.4f} plain_dkv_ms={pdkv_ms:.4f}"
                     f" sdpa_bwd_library_not_plain_ms={lib_ms:.4f} dq_TFLOPs={3 * prod / 1e9 / dq_ms:.1f}"
                     f" dkv_TFLOPs={4 * prod / 1e9 / dkv_ms:.1f} useful_TFLOPs={5 * prod / 1e9 / (dq_ms + dkv_ms):.1f}"
                     f" bound_ms(dq, dkv)=({bq[0]:.4f}, {bkv[0]:.4f}) pair_bound_ms={bpair[0]:.4f}"
                     f" graph_ms(dq, dkv)=({dqg_ms:.4f}, {dkvg_ms:.4f})")
            shape = dict(shape=[BH, N, D], dq_ms=dq_ms, dkv_ms=dkv_ms, pair_ms=dq_ms + dkv_ms, dq_graph_ms=dqg_ms,
                         dkv_graph_ms=dkvg_ms, plain_dq_ms=pdq_ms, plain_dkv_ms=pdkv_ms, library_ms=lib_ms,
                         dq_bound=bq, dkv_bound=bkv, dq_bound_ms=bq[0], dkv_bound_ms=bkv[0], pair_bound_ms=bpair[0],
                         bound_by=bpair[1], bound_unit=bpair[2], timed_at=tag)
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                rec[name].setdefault("shapes", []).append(shape)
            timed.append(shape)
        print(line)
        del q, k, v, dout, out, lse, lse2, dvec
        torch.cuda.empty_cache()
    return timed


def bwd_kernel_records(shape: dict, rec: dict) -> dict:
    """The dq and the dk/dv kernel's records at one timed shape: each row's
    bound counts its own products (the split recomputes S and dP in both);
    library_ms, pair_ms and pair_bound_ms are of the whole backward, which
    one SDPA backward call computes."""
    pair = dict(library_ms=shape["library_ms"], library_covers="dq, dk and dv", pair_ms=shape["pair_ms"],
                pair_bound_ms=shape["pair_bound_ms"], timed_at=shape["timed_at"])
    out = {}
    for name, key in (("flash_attention_bwd_dq", "dq"), ("flash_attention_bwd_dkv", "dkv")):
        b_ms, b_by, b_unit = shape[f"{key}_bound"]
        out[name] = dict(shape=shape["shape"], ms=shape[f"{key}_ms"], plain_ms=shape[f"plain_{key}_ms"],
                         bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit, max_abs_err=rec[name]["max_abs_err"],
                         **pair)
    return out


def phase_flash_bwd(torch, attn, seed, dev):
    """K5's two kernels against the plain backward at the training shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    rec = flash_bwd_records()
    cases = [(shape, 1.0) for shape in FLASH_BWD_SHAPES[:3]] + [(FLASH_BWD_SHAPES[0], 30.0)]
    first = flash_bwd_cases(torch, attn, gen, dev, cases, rec)[0]
    # every training shape on both rows; the records' own keys are the first shape's
    for name, r in bwd_kernel_records(first, rec).items():
        rec[name].update(r)
    return rec


def train_batch(torch, seed, dev, B):
    """Seeded (z, lat0, weight, t, noise) of one SD-1.5 training batch: unit
    (B, 512) embeddings, (B, 64, 64, 4) latents and noise, t in [0, 1000)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.nn.functional.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
    lat0, noise = (torch.randn((B, 64, 64, 4), generator=gen, device=dev) for _ in range(2))
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
    return z, lat0, torch.ones(B, device=dev), t, noise


def _grad_vector(torch, adapter):
    return torch.cat([p.grad.detach().float().flatten() for p in adapter.parameters()])


def phase_train_grad(torch, attn, mlp, unet, vae, adapter, seed, dev):
    """The adapter's gradient on the kernel, plain and fp32 plain paths."""
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder
    from clip_codec_tpu_torch.train.sd_diffusion_train import SDTrainConfig, make_optimizer, make_sd_train_step

    dec = StableDiffusionDecoder(unet, vae, adapter)
    step = make_sd_train_step(dec, make_optimizer(adapter, 1e-4), SDTrainConfig())
    for s in (seed, seed + 1):
        z, lat0, w, t, noise = train_batch(torch, s + 7, dev, 1)

        def grad():
            adapter.zero_grad(set_to_none=True)
            loss = step.loss_fn(z, lat0, w, t, noise)
            loss.backward()
            return loss.item(), _grad_vector(torch, adapter)

        reset_sd_launches(attn, mlp)
        loss_k, g_k = grad()
        n = sd_launches(attn, mlp)
        with plain_sd_kernels(attn, mlp):
            loss_p, g_p = grad()
            unet.compute_dtype = vae.compute_dtype = torch.float32
            try:
                loss_32, g_32 = grad()
            finally:
                unet.compute_dtype = vae.compute_dtype = torch.bfloat16
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"train-grad: seed {s} SD-1.5 64x64 latent B=1 t={int(t.item())} loss(kernel, plain, fp32)="
              f"({loss_k:.6f}, {loss_p:.6f}, {loss_32:.6f}) rel(g_kernel, g_plain)={rel(g_k, g_p):.3e} "
              f"to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) ratio={rk / rp:.4f} launches={n}")
        check(bool(torch.isfinite(g_k).all().item()) and g_k.norm().item() > 0, "adapter gradient not finite or zero")
        check(rk <= FP32_RATIO * rp, f"adapter gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check(n == TRAIN_LAUNCHES, f"one loss and backward launched {n}, expected {TRAIN_LAUNCHES}")
    adapter.zero_grad(set_to_none=True)


def _train_store(seed, store: Path):
    """8 seeded PNG images with .clp frames; returns their codes where no
    zstd engine exists (the store is then entered at the codes), else None."""
    import json

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed + 8)
    images = rng.integers(0, 256, (TRAIN_IMAGES, 96, 128, 3), dtype=np.uint8)  # resized to 512 on load
    codes = rng.integers(0, 256, (TRAIN_IMAGES, 512), dtype=np.uint8)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32), zero=np.full(512, -1.0, np.float32))
    for i, im in enumerate(images):
        Image.fromarray(im).save(store / f"img{i}.png")
    recs = [{"image": str(store / f"img{i}.png"), "bitstream": str(store / f"img{i}.clp")} for i in range(TRAIN_IMAGES)]
    (store / "manifest.json").write_text(json.dumps(recs))
    if not frame_engine("train"):
        return codes  # the store is entered at the codes
    from clip_codec_tpu_torch.io.bitstream import compress_frames

    for i, frame in enumerate(compress_frames(codes)):
        (store / f"img{i}.clp").write_bytes(frame)
    return None


def phase_train(torch, attn, mlp, unet, vae, adapter, seed, dev, card):
    """Precompute latents, train 2 epochs, load the adapter and sample.
    Returns the training's launches and the steady-state s/step."""
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.cli.precompute_latents import precompute_latents
    from clip_codec_tpu_torch.io import store as store_mod
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder
    from clip_codec_tpu_torch.train.sd_diffusion_train import (SDTrainConfig, make_optimizer, make_sd_train_step,
                                                                train_sd_diffusion)

    store = ROOT / "build" / "chip_smoke" / "train"
    codes = _train_store(seed, store)
    t0 = time.perf_counter()
    reset_sd_launches(attn, mlp)
    precompute_latents(store, vae, size=SD_SIZE, batch_size=TRAIN_BATCH,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    n_pre = sd_launches(attn, mlp)["flash_attention"]
    print(f"train-precompute: {TRAIN_IMAGES} images at {SD_SIZE}px through the VAE encoder in "
          f"{time.perf_counter() - t0:.3f} s; flash launches {n_pre}")
    check(n_pre == TRAIN_IMAGES // TRAIN_BATCH, f"precompute launched flash {n_pre} times")

    before = {k: v.detach().clone() for k, v in adapter.state_dict().items()}
    dec = StableDiffusionDecoder(unet, vae, adapter)
    cfg = SDTrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=seed, log_every=1)
    saved_read = store_mod.Store.read_codes
    if codes is not None:
        store_mod.Store.read_codes = lambda self: codes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_sd_launches(attn, mlp)
    t0 = time.perf_counter()
    try:
        final = train_sd_diffusion(store, dec, save_dir=store / "out", config=cfg)
    finally:
        store_mod.Store.read_codes = saved_read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sd_launches(attn, mlp)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    changed = max((adapter.state_dict()[k] - v).abs().max().item() for k, v in before.items())
    print(f"train: {TRAIN_EPOCHS} epochs x {TRAIN_IMAGES // TRAIN_BATCH} steps at batch {TRAIN_BATCH}, SD-1.5 "
          f"{SD_SIZE}px, bf16 UNet/VAE, fp32 adapter and AdamW: {wall:.3f} s in all (checkpoints and first-step "
          f"set-up included), peak device memory {peak:.2f} GiB on {card}; adapter max change {changed:.3e}; "
          f"launches={launches}")
    check(launches == want, f"training launches {launches} != {want}")
    check(changed > 0, "the adapter did not change")
    sd_dir = ROOT / "build" / "chip_smoke" / "sd"
    ld = cli.load_decoder(sd_dir / "unet.pt", sd_dir / "vae.pt", final, dev, heads=8)
    img = cli.sample_images(ld, torch.zeros((1, 512)).numpy() + 512 ** -0.5, SD_SIZE, steps=SD_STEPS,
                            sampler="dpmpp", guidance=SD_GUIDANCE, seed=seed).float()
    check(tuple(img.shape) == (1, SD_SIZE, SD_SIZE, 3) and bool(torch.isfinite(img).all().item()),
          "sampling with the trained adapter failed")
    del ld

    # steady-state steps on one batch, for the step time
    step = make_sd_train_step(dec, make_optimizer(adapter, cfg.lr), cfg)
    batch = train_batch(torch, seed + 9, dev, TRAIN_BATCH)
    losses = [step(*batch) for _ in range(2)]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for _ in range(n_timed):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_timed
    check(all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    print(f"train-step: batch {TRAIN_BATCH}, SD-1.5 {SD_SIZE}px: {s_step:.4f} s per step = "
          f"{TRAIN_BATCH / s_step:.3f} img/s over {n_timed} synchronized steps on {card}; loss "
          f"{losses[-1].item():.6f}")
    return launches, s_step


# ------------------------------------------------------ pixel-decoder training


def reset_gn_launches(gn) -> None:
    gn.group_norm_silu.launches = 0


def gn_launches(gn, rc) -> tuple:
    """(K1, K2 + K3) launches since the last resets."""
    return gn.group_norm_silu.launches, rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches


@contextlib.contextmanager
def plain_k1(gn):
    """Route the ResBlocks' GroupNorm+SiLU to its plain version."""
    saved = gn.group_norm_silu
    gn.group_norm_silu = gn.group_norm_silu_plain
    try:
        yield
    finally:
        gn.group_norm_silu = saved


@contextlib.contextmanager
def gn_shape_tally(gn, shapes):
    """Count K1's launches by (B, H, W, C) into ``shapes`` (through the wrapper's one launcher)."""
    launch = gn._launch

    def tally(x, *args):
        shapes[tuple(x.shape)] += 1
        return launch(x, *args)

    gn._launch = tally
    try:
        yield
    finally:
        gn._launch = launch


def _gn_inputs(torch, gen, shape, dev, dtype):
    C = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    return x, 1 + 0.2 * torch.randn((C,), generator=gen, device=dev), 0.2 * torch.randn((C,), generator=gen, device=dev)


def phase_groupnorm(torch, gn, seed, dev):
    """K1 against its plain version at the training shapes, an fp32 case,
    a ragged shape and a sample larger than a round; returns its records,
    one per training shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    G, bf = GN_GROUPS, torch.bfloat16
    recs, worst = [], 0.0
    cases = [((GN_BATCH, H, W, C), bf) for H, W, C in GN_SHAPES]
    cases += [((GN_BATCH, 64, 64, 256), torch.float32), (GN_TAIL, bf), (GN_TAIL, torch.float32), (GN_LARGE, bf)]
    for shape, dtype in cases:
        x, scale, bias = _gn_inputs(torch, gen, shape, dev, dtype)
        n0 = gn.group_norm_silu.launches
        with torch.no_grad():
            y = gn.group_norm_silu(x, (scale, bias), G)
            y_again, part = gn._launch(x, scale, bias, G, gn.GN_EPS)  # the wrapper's launch, with its partials
        torch.cuda.synchronize()
        check(gn.group_norm_silu.launches == n0 + 2, f"group_norm_silu {shape}: not one launch per call")
        part_ref = gn.group_norm_silu_stats_plain(x, G)
        y_pieces = gn.group_norm_silu_norm_plain(x, part_ref, scale, bias, G)
        y_ref = gn.group_norm_silu_plain(x, (scale, bias), G)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        pl = gn.plan(*shape, G, x.element_size())
        tag = (f"group_norm_silu {tuple(shape)} G={G} {str(dtype).split('.')[-1]} slabs={pl.slabs}x{pl.slab_rows}"
               f" rows rounds={pl.rounds} per_round={pl.per_round} grid={pl.grid} ring={pl.ring}")
        part_err = max(((part[:, :, k] - part_ref[:, :, k]).abs().max() / part_ref[:, :, k].abs().max()).item()
                       for k in range(2))
        check(part_err <= 1e-5, f"{tag}: slab partials off their plain version by {part_err} of their largest")
        errs = {}
        for name, want in (("plain", y_pieces), ("group_norm_silu_plain", y_ref)):
            a, b = y.float(), want.float()
            errs[name] = (a - b).abs().max().item()
            check(bool(((a - b).abs() <= tol + tol * b.abs()).all().item()),
                  f"{tag}: vs {name} outside rtol=atol={tol} (max abs err {errs[name]})")
        check(torch.equal(y, y_again), f"{tag}: two calls differ")
        worst = max(worst, errs["plain"])
        line = (f"kernel-check: {tag} max_abs_err(vs plain)={errs['plain']:.3e} partials_rel_err={part_err:.2e} "
                f"vs_group_norm_silu_plain={errs['group_norm_silu_plain']:.3e} bit_equal_across_calls=True")
        if dtype == bf and (shape[1:] in [tuple(s) for s in GN_SHAPES]):
            B, H, W, C = shape
            call = lambda: gn.group_norm_silu(x, (scale, bias), G)
            with torch.no_grad():
                ms, events_ms = graph_ms(torch, call), cuda_ms(torch, call)
                plain_ms = cuda_ms(torch, lambda: gn.group_norm_silu_norm_plain(
                    x, gn.group_norm_silu_stats_plain(x, G), scale, bias, G), iters=5)
                pp_ms = cuda_ms(torch, lambda: gn.group_norm_silu_plain(x, (scale, bias), G), iters=5)
                xc, sb, bb = x.permute(0, 3, 1, 2), scale.to(bf), bias.to(bf)  # NCHW view, channels_last
                lib = lambda: F.silu(F.group_norm(xc, G, sb, bb, 1e-5))
                lib_ms, lib_events_ms = graph_ms(torch, lib), cuda_ms(torch, lib)
            n = B * H * W * C
            b_ms, b_by, b_unit = bound(2 * n * 2, 11 * n, FP32_FLOPS_PER_S)  # x read once, y written once
            line += (f" ms={ms:.4f} (graph) events_ms={events_ms:.4f} plain_ms={plain_ms:.4f}"
                     f" plain_group_norm_silu_ms={pp_ms:.4f} library_ms={lib_ms:.4f} (graph; events"
                     f" {lib_events_ms:.4f}) bound_ms={b_ms:.4f} ({b_unit}) pct_of_bound={100 * b_ms / ms:.1f}"
                     f" TBps={2 * n * 2 / ms / 1e9:.3f}")
            recs.append(dict(shape=list(shape), ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_unit=b_unit, library_ms=lib_ms,
                             library="F.group_norm + F.silu (bf16, NCHW view), for scale; the port never calls it",
                             rounds=pl.rounds, slabs_per_sample=pl.slabs))
        print(line)
        del x, y, y_again, part, part_ref, y_pieces, y_ref

    # one call captured in a CUDA graph and replayed twice: bit-equal to eager
    x, scale, bias = _gn_inputs(torch, gen, (GN_BATCH, 128, 128, 128), dev, bf)
    with torch.no_grad():
        want = gn.group_norm_silu(x, (scale, bias), G)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph):
            got = gn.group_norm_silu(x, (scale, bias), G)
        torch.cuda.current_stream().wait_stream(side)
        for _ in range(2):
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            check(torch.equal(got, want), "group_norm_silu: a CUDA graph replay differs from the eager call")
    print(f"kernel-check: group_norm_silu {(GN_BATCH, 128, 128, 128)} bf16: two CUDA graph replays bit-equal to eager")
    del graph, got, want

    # the autograd Function's gradients: the backward recomputes the plain version
    shape = (GN_BATCH, 64, 64, 256)
    x, scale, bias = _gn_inputs(torch, gen, shape, dev, bf)
    g = torch.randn(shape, generator=gen, device=dev).to(bf)
    leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
    got = torch.autograd.grad(gn.group_norm_silu(leaves[0], tuple(leaves[1:]), G), leaves, g)
    want = torch.autograd.grad(gn.group_norm_silu_plain(leaves[0], tuple(leaves[1:]), G), leaves, g)
    rels = []
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        rels.append((a.float() - b.float()).abs().max().item() / b.float().abs().max().item())
        check(rels[-1] <= 2e-2, f"group_norm_silu backward {name}: rel err {rels[-1]} > 2e-2")
    print(f"kernel-check: group_norm_silu backward {shape} bf16 rel_err(dx, dscale, dbias)="
          f"({rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e})")
    for rec in recs:
        rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return {"group_norm_silu": recs}


def px_net(torch, seed, dev, remat=False):
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params

    with torch.device(dev):
        net = CLIPCondUNet(z_dim=512, **PX_MODEL, time_dim=256, img_ch=3, dtype=torch.bfloat16,
                           fused_pallas=False, remat=remat)
    return init_params(net, torch.Generator(device=dev).manual_seed(seed))


def px_batch(torch, seed, dev, B, size=SIZE):
    """Seeded (x0, z, weight, t, noise) of one training batch at ``size`` px."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.rand((B, size, size, 3), generator=gen, device=dev) * 2 - 1
    z = torch.nn.functional.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
    noise = torch.randn((B, size, size, 3), generator=gen, device=dev)
    return x0, z, torch.ones(B, device=dev), t, noise


def px_step(torch, net, dev, remat=False):
    from clip_codec_tpu_torch.diffusion import NoiseSchedule
    from clip_codec_tpu_torch.train.diffusion_train import DiffusionTrainConfig, make_train_step
    from clip_codec_tpu_torch.train.optim import make_optimizer

    cfg = DiffusionTrainConfig(**PX_MODEL, remat=remat)
    return make_train_step(net, NoiseSchedule.create(cfg.timesteps, cfg.schedule, device=dev),
                           make_optimizer(net, cfg.lr), cfg)


def phase_px_grad(torch, gn, rc, seed, dev):
    """Every parameter's gradient on the kernel, plain and fp32 plain paths."""
    net = px_net(torch, seed, dev)
    step = px_step(torch, net, dev)
    for s in (seed, seed + 1):
        batch = px_batch(torch, s + 11, dev, 2)

        def grad():
            net.zero_grad(set_to_none=True)
            loss = step.loss_fn(*batch)
            loss.backward()
            grads = [p.grad.detach().float().flatten() for p in net.parameters()]
            return loss.item(), grads

        rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
        reset_gn_launches(gn)
        loss_k, gk = grad()
        n = gn_launches(gn, rc)
        with plain_k1(gn):
            loss_p, gp = grad()
            net.compute_dtype = torch.float32
            try:
                loss_32, g32 = grad()
            finally:
                net.compute_dtype = torch.bfloat16
        bad = [name for (name, _), g in zip(net.named_parameters(), gk)
               if not (bool(torch.isfinite(g).all().item()) and g.abs().max().item() > 0)]
        g_k, g_p, g_32 = (torch.cat(g) for g in (gk, gp, g32))
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"px-train-grad: seed {s} {PX_MODEL} {SIZE}px B=2 t={batch[3].tolist()} "
              f"loss(kernel, plain, fp32)=({loss_k:.6f}, {loss_p:.6f}, {loss_32:.6f}) rel(g_kernel, g_plain)="
              f"{rel(g_k, g_p):.3e} to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) ratio={rk / rp:.4f} "
              f"launches(K1, K2+K3)={n}")
        check(not bad, f"parameters with a non-finite or zero gradient: {bad[:5]}")
        check(rk <= FP32_RATIO * rp, f"U-Net gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check(n == (GN_PER_FORWARD, 0), f"one loss and backward launched {n}")
    del net, step
    torch.cuda.empty_cache()


def _px_store(seed, store: Path):
    """16 seeded PNG images with .clp frames; returns the codes, and whether
    the frames were written (a zstd engine present)."""
    import json

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed + 12)
    images = rng.integers(0, 256, (PX_IMAGES, 96, 128, 3), dtype=np.uint8)  # resized to 256 on load
    codes = rng.integers(0, 256, (PX_IMAGES, 512), dtype=np.uint8)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32), zero=np.full(512, -1.0, np.float32))
    for i, im in enumerate(images):
        Image.fromarray(im).save(store / f"img{i}.png")
    recs = [{"image": str(store / f"img{i}.png"), "bitstream": str(store / f"img{i}.clp")} for i in range(PX_IMAGES)]
    (store / "manifest.json").write_text(json.dumps(recs))
    if not frame_engine("px-train"):
        return codes, False  # the store is entered at the codes
    from clip_codec_tpu_torch.io.bitstream import compress_frames

    for i, frame in enumerate(compress_frames(codes)):
        (store / f"img{i}.clp").write_bytes(frame)
    return codes, True


def phase_px_train(torch, gn, rc, seed, dev, card):
    """train_diffusion for 2 epochs, decompress with the result, one remat
    step, then the steady-state step time."""
    import numpy as np

    from clip_codec_tpu_torch.codec import ClipCodec
    from clip_codec_tpu_torch.io import store as store_mod
    from clip_codec_tpu_torch.train import diffusion_train as dtr

    store = ROOT / "build" / "chip_smoke" / "train_px"
    codes, frames = _px_store(seed, store)
    init = {k: v.detach().clone() for k, v in px_net(torch, seed, dev).state_dict().items()}
    cfg = dtr.DiffusionTrainConfig(out_size=SIZE, epochs=PX_EPOCHS, batch_size=PX_BATCH, **PX_MODEL,
                                   data_workers=2, seed=seed, log_every=1)
    losses = []
    saved_step, saved_read = dtr.make_train_step, store_mod.Store.read_codes

    def recording(*a, **k):
        step = saved_step(*a, **k)

        def rec(*args):
            losses.append(step(*args))
            return losses[-1]

        return rec

    dtr.make_train_step = recording
    if not frames:
        store_mod.Store.read_codes = lambda self: codes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
    reset_gn_launches(gn)
    shapes = collections.Counter()
    t0 = time.perf_counter()
    try:
        with gn_shape_tally(gn, shapes):
            final = dtr.train_diffusion(store, save_dir=store / "out", config=cfg, device=dev)
    finally:
        dtr.make_train_step, store_mod.Store.read_codes = saved_step, saved_read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = gn_launches(gn, rc)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps = PX_EPOCHS * -(-PX_IMAGES // PX_BATCH)
    trained = torch.load(final, map_location=dev, weights_only=True)
    changed = max((trained[k] - v).abs().max().item() for k, v in init.items())
    finite = all(bool(torch.isfinite(v).all().item()) for v in trained.values())
    print(f"px-train: {PX_EPOCHS} epochs x {steps // PX_EPOCHS} steps at batch {PX_BATCH}, {PX_MODEL} "
          f"{SIZE}px, bf16 activations, fp32 parameters and AdamW: {wall:.3f} s in all (PNG decode, checkpoints "
          f"and first-step set-up included), peak device memory {peak:.2f} GiB on {card}; losses "
          f"{[round(float(l), 6) for l in losses]}; parameters max change {changed:.3e}; "
          f"launches(K1, K2+K3)={n}; K1 by (B, H, W, C): {dict(shapes)}")
    check(len(losses) == steps and all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    check(finite and changed > 0, "the trained parameters are not finite or did not change")
    check(n == (GN_PER_FORWARD * steps, 0), f"training launches {n}")
    want = {(PX_BATCH, H, W, C): calls * steps for (H, W, C), calls in zip(GN_SHAPES, (4, 8, 8, 8))}
    check(dict(shapes) == want, f"K1 launches by shape {dict(shapes)} != {want}")
    launches = {"gn_by_shape": dict(shapes)}

    # serve the trained decoder through ClipCodec and K2/K3
    codec = ClipCodec.load(store, weights=final, device=dev)
    rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
    reset_gn_launches(gn)
    t0 = time.perf_counter()
    if frames:
        from clip_codec_tpu_torch.io.bitstream import compress_frame

        out = codec.decompress([compress_frame(r.tobytes()) for r in codes[:2]], size=SIZE, steps=STEPS,
                               batch_size=2, seed=seed)
    else:
        out = codec.decompress_codes(codes[:2], size=SIZE, steps=STEPS, batch_size=2, seed=seed)
    dt = time.perf_counter() - t0
    n = gn_launches(gn, rc)
    print(f"px-train-serve: the trained decoder answers a request of 2 frames (DDIM-{STEPS}, {SIZE}px) in "
          f"{dt:.3f} s on {card}; launches(K1, K2+K3)={n}")
    check(out.shape == (2, SIZE, SIZE, 3) and bool(np.isfinite(out).all()) and float(np.abs(out).max()) <= 1.0,
          "the trained decoder's output is not finite, in [-1, 1] and (2, 256, 256, 3)")
    check(n == (0, LAUNCHES_PER_FORWARD * STEPS), f"decompress launches {n}")
    del codec, trained, init

    batch = px_batch(torch, seed + 13, dev, PX_BATCH)
    net = px_net(torch, seed, dev, remat=True)
    reset_gn_launches(gn)
    loss = px_step(torch, net, dev, remat=True)(*batch)
    n = gn_launches(gn, rc)
    print(f"px-train-remat: one remat step at batch {PX_BATCH}: loss {loss.item():.6f} "
          f"launches(K1, K2+K3)={n}")
    check(bool(torch.isfinite(loss).item()), "remat step loss not finite")
    check(n[0] == 2 * GN_PER_FORWARD, f"remat step launches {n}")
    del net
    torch.cuda.empty_cache()

    net = px_net(torch, seed, dev)
    step = px_step(torch, net, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(*batch) for _ in range(2)]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for _ in range(n_timed):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    print(f"px-train-step: batch {PX_BATCH}, {PX_MODEL} {SIZE}px: {s_step:.4f} s per step = "
          f"{PX_BATCH / s_step:.3f} img/s over {n_timed} synchronized steps, peak device memory {peak:.2f} GiB "
          f"on {card}; loss {losses[-1].item():.6f}")
    del net, step
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ attention probes (P1-P3)


def probe_launches(ap) -> dict:
    return {"flash_probe_variant": ap.flash_variant.launches, "flash_probe_fast": ap.fast_flash_acc.launches,
            "flash_probe_single_pass": ap.single_pass.launches}


def reset_probe_launches(ap) -> None:
    ap.flash_variant.launches = ap.fast_flash_acc.launches = ap.single_pass.launches = 0


def _rel_to_max(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def _softmax_ok(got, want, tol: float = 2e-2) -> bool:
    """Within rtol = atol = ``tol`` elementwise and within ``tol`` of want's
    largest magnitude: at normal logits the output's values are ~0.02, so
    the elementwise atol alone would let a dropped key tile pass."""
    got, want = got.float(), want.float()
    return (bool(((got - want).abs() <= tol + tol * want.abs()).all().item())
            and _rel_to_max(got, want) <= tol)


def phase_probe_kernels(torch, ap, seed, dev):
    """Every probe kernel against its plain version at PROBE_CHECK_SHAPE, bf16,
    normal and (all but nomax) extreme logits; returns per-kernel records."""
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    BH, N, D = PROBE_CHECK_SHAPE
    q = _randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16)
    k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16) for _ in range(2))
    inputs = {"normal": q, "extreme": (q.float() * 30).to(torch.bfloat16)}
    rec = {name: {"max_abs_err": 0.0} for name in probe_launches(ap)}

    def record(name, tag, results):
        print(f"kernel-check: {tag} (BH, N, D)=({BH}, {N}, {D}) " + " ".join(
            f"{logits}: max_abs_err={err:.3e} rel_to_max={rel:.3e}" for logits, (err, rel, _) in results.items()))
        for logits, (err, _, ok) in results.items():
            check(ok, f"{tag} {logits} logits: outside its tolerance (max abs err {err:.3e})")
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    for mode, tq, tk in ap.P1_TILES:
        results = {}
        for logits, qq in inputs.items():
            if logits == "extreme" and mode == "nomax":
                continue  # overflows by design
            got, want = ap.flash_variant(qq, k, v, tq, tk, mode), ap.flash_variant_plain(qq, k, v, tk, mode)
            rel = _rel_to_max(got, want)
            ok = rel <= 2e-2 if mode in ("noexp", "dotonly") else _softmax_ok(got, want)
            results[logits] = ((got.float() - want.float()).abs().max().item(), rel, ok)
        record("flash_probe_variant", f"flash_probe_variant {mode} (tq, tk)=({tq}, {tk})", results)
    for deg, mxu, tq, tk in ap.P2_TILES:
        results = {}
        for logits, qq in inputs.items():
            acc, want = ap.fast_flash_acc(qq, k, v, tq, tk, deg, mxu), ap.fast_flash_plain(qq, k, v, tk, deg, mxu)
            out, out_ref = (a[..., :D] / a[..., D:] for a in (acc, want))
            ok = (_softmax_ok(out.to(torch.bfloat16), out_ref.to(torch.bfloat16))
                  and bool(((acc[..., D] - want[..., D]).abs() <= 2e-2 * want[..., D].abs()).all().item()))
            results[logits] = ((out - out_ref).abs().max().item(), _rel_to_max(acc, want), ok)
        record("flash_probe_fast", f"flash_probe_fast deg={deg} {'mxu' if mxu else 'vpu'}-sum (tq, tk)=({tq}, {tk})",
               results)
    for tq in ap.P3_TILES:
        results = {}
        for logits, qq in inputs.items():
            got, want = ap.single_pass(qq, k, v, tq), ap.single_pass_plain(qq, k, v)
            results[logits] = ((got.float() - want.float()).abs().max().item(), _rel_to_max(got, want),
                               _softmax_ok(got, want))
        record("flash_probe_single_pass", f"flash_probe_single_pass tq={tq}", results)
    del q, k, v, inputs
    torch.cuda.empty_cache()
    return rec


def phase_probe(torch, ap, seed, dev, rec):
    """The probe's entry point at PROBE_SHAPE (its lines printed), its launch
    counts, then each kernel's, plain version's and SDPA's ms there."""
    import torch.nn.functional as F

    from clip_codec_tpu_torch.ops import attention as attn
    from clip_codec_tpu_torch.probes import attn_probe

    BH, N, D = PROBE_SHAPE
    reset_probe_launches(ap)
    res = attn_probe.run(dev, BH, N, D, seed)
    launches = probe_launches(ap)
    wrappers = {"flash_probe_variant": "flash_variant", "flash_probe_fast": "fast_flash_acc",
                "flash_probe_single_pass": "single_pass"}
    want = {name: res["calls"][w]["eager"] for name, w in wrappers.items()}
    replayed = {name: res["calls"][w]["replayed"] for name, w in wrappers.items()}
    print(f"probe: launches={launches}, eager calls={want}, launched by CUDA-graph replays={replayed}")
    check(launches == want, f"probe launches {launches} != one per eager wrapper call {want}")
    for label, err in res["errors"].items():
        check(err <= 2e-2, f"probe correctness: {label} max|delta|/max|oracle| = {err} > 2e-2")

    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    q, k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16) for _ in range(3))
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
    k4_ms = cuda_ms(torch, lambda: attn.flash_attention_fwd(q, k, v))  # the production forward the probe ablates
    exp2_ms = cuda_ms(torch, lambda: ap.flash_variant(q, k, v, 192, 128, "exp2"))  # P1 exp2, beside P2
    vk = ap.fast_v(v, True)  # P2's kernel alone reads v with its ones column
    io = 4 * BH * N * D * 2  # q, k, v read and out written, bf16
    prod = 2 * BH * N * N * D  # flops of one (N, N, D) product
    # Each bound counts what the function needs: Q.K^T and P.V, one exponential
    # per score. The online rescale's alphas and P3's second Q.K^T are the
    # kernels' own choices, left out (P3's own work is reported beside it).
    cases = {
        # name: (timed at, kernel, plain, bound args, library ms)
        "flash_probe_variant": ("full (tq, tk)=(192, 128)", lambda: ap.flash_variant(q, k, v, 192, 128, "full"),
                                lambda: ap.flash_variant_plain(q, k, v, 128, "full"),
                                dict(nbytes=io, flops=2 * prod, exps=BH * N * N), sdpa_ms),
        "flash_probe_single_pass": ("tq=192", lambda: ap.single_pass(q, k, v, 192),
                                    lambda: ap.single_pass_plain(q, k, v),
                                    dict(nbytes=io, flops=2 * prod, exps=BH * N * N), sdpa_ms),
        # q, k and the ones-column v (48 wide) read, the fp32 (D + 1)-wide accumulator written;
        # poly2 on the FMA pipe; no PyTorch call computes it
        "flash_probe_fast": ("poly2 + mxu-sum (tq, tk)=(192, 128), raw accumulator, kernel alone",
                             lambda: ap.fast_flash_kernel(q, k, vk, 192, 128, 2, True),
                             lambda: ap.fast_flash_plain(q, k, v, 128, 2, True),
                             dict(nbytes=BH * N * (2 * D * 2 + ap.fast_v_width(D, True) * 2 + (D + 1) * 4),
                                  flops=2 * prod, fma=(POLY_INSTRUCTIONS + 2) * BH * N * N), None),
    }
    for name, (timed, kernel, plain, bargs, lib_ms) in cases.items():
        k_ms = cuda_ms(torch, kernel)
        p_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        b_ms, b_by, b_unit = bound(**bargs)
        terms = bound_terms(**bargs)
        tag = f"{name} {timed} at (BH, N, D)=({BH}, {N}, {D})"
        print(f"probe-kernel: {tag} ms={k_ms:.4f} plain_ms={p_ms:.4f} sdpa_library_ms={sdpa_ms:.4f} "
              f"k4_ms={k4_ms:.4f} bound_ms={b_ms:.4f} ({b_unit}; "
              + ", ".join(f"{u} {t:.4f}" for u, t in terms.items()) + ")")
        rec[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit,
                         timed_at=tag, k4_ms=k4_ms)
    wrapper_ms = cuda_ms(torch, lambda: ap.fast_flash_acc(q, k, v, 192, 128, 2, True))  # the ones column included
    print(f"probe-kernel: flash_probe_fast wrapper (fast_flash_acc, builds the ones column) ms={wrapper_ms:.4f}; "
          f"beside it K4 {k4_ms:.4f}, P1 exp2 (192, 128) {exp2_ms:.4f}, SDPA {sdpa_ms:.4f}")
    rec["flash_probe_fast"].update(wrapper_ms=wrapper_ms, p1_exp2_ms=exp2_ms, sdpa_ms_for_scale=sdpa_ms)
    # P3's own work: Q.K^T in both sweeps and P.V
    rec["flash_probe_single_pass"]["two_sweep_bound_ms"] = bound(io, 3 * prod, exps=BH * N * N)[0]
    for name in wrappers:
        rec[name]["graph_replay_launches"] = replayed[name]
    labels = {"flash_probe_variant": next(lb for lb, tq, tk, mode in attn_probe.P1_VARIANTS
                                          if (mode, tq, tk) == ("full", 192, 128)),
              "flash_probe_fast": next(lb for lb, tq, tk, deg, mxu in attn_probe.P2_VARIANTS
                                       if (deg, mxu, tq, tk) == (2, True, 192, 128)),
              "flash_probe_single_pass": next(lb for lb, tq in attn_probe.P3_VARIANTS if tq == 192)}
    for name, label in labels.items():
        rec[name]["probe_graph_ms"] = res["times"][label]["graph_ms"]
    rec["flash_probe_fast"]["probe_graph_wrapper_ms"] = res["times"][f"{labels['flash_probe_fast']} wrapper"]["graph_ms"]
    del q, k, v, vk
    torch.cuda.empty_cache()
    return launches

# ------------------------------------------------------- the compress side (CLIP ViT-B/32)


def frame_engine(tag: str) -> bool:
    """Whether a zstd engine frames ``.clp`` records on this machine (the
    native codec on the card machine, which has no zstandard); prints which."""
    from clip_codec_tpu_torch.io.bitstream import zstd_engine

    engine = zstd_engine()
    print(f"{tag} frames: {f'real zstd frames ({engine})' if engine else 'raw codes (no zstd engine)'}")
    return engine is not None


def raw_frames(have_zstd: bool):
    """With no zstd engine a frame carries the raw codes behind its magic
    and length: the store writer, the manifest, ``ClipCodec`` and the server
    run as they are and only the zstd payload is left out (the codes are
    what the phases hold)."""
    from clip_codec_tpu_torch.probes.serve_times import raw_frames as framed

    return framed(have_zstd)


def _clip_images(seed, d: Path, n: int, corrupt: bool) -> list:
    """``n`` seeded PNGs of mixed sizes and aspect ratios; the first two
    scale to a long side with (dim - 224) % 4 == 3, where the center crop's
    round-half-even differs from floor division; plus one corrupt file."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    sizes = [(224, 227), (231, 224)] + [tuple(int(v) for v in rng.integers(160, 400, 2)) for _ in range(n - 2)]
    paths = []
    for i, (w, h) in enumerate(sizes):
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)  # smooth-ish content
        img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
        paths.append(d / f"img{i:03d}.png")
        img.save(paths[-1])
    if corrupt:
        (d / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n not a png")
    return [str(p) for p in paths]


def phase_compress(torch, seed, dev, card):
    """CLIP ViT-B/32 at full width, bf16, batch 64, through cli.encode_images
    (write, then --append), ClipCodec.compress and the text tower; its
    numbers beside the card's bound."""

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch import encoders
    from clip_codec_tpu_torch.cli import encode_images
    from clip_codec_tpu_torch.codec import ClipCodec
    from clip_codec_tpu_torch.encoders.clip import (VIT_B_32, CLIPModel, init_params, normalize_u8, preprocess_pil,
                                                    preprocess_pil_u8, vision_flops)
    from clip_codec_tpu_torch.io import store as store_mod

    root = ROOT / "build" / "chip_smoke" / "compress"
    store, weights = root / "store", root / "clip_vit_b32.pt"
    t0 = time.perf_counter()
    model = init_params(CLIPModel(VIT_B_32), torch.Generator().manual_seed(seed + 16))
    root.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), weights)
    del model
    _clip_images(seed + 16, root / "images", CLIP_IMAGES, corrupt=True)
    extra = _clip_images(seed + 17, root / "more", CLIP_APPEND, corrupt=False)
    print(f"compress: random ViT-B/32 (openai layout, seed {seed + 16}) saved and {CLIP_IMAGES} + {CLIP_APPEND} "
          f"PNGs + 1 corrupt written in {time.perf_counter() - t0:.3f} s")
    shutil.rmtree(store, ignore_errors=True)
    have_zstd = frame_engine("compress")
    if not have_zstd:
        print("compress frames: no zstd engine: frames carry the raw codes (no zstd payload); the codebook, "
              "codes, manifest and append are held as they are")

    made, written, appended = [], [], []
    real_encoder, real_write, real_append = encoders.ClipEncoder, store_mod.write_store, store_mod.append_store

    def encoder(**kw):
        made.append(real_encoder(**kw))
        return made[-1]

    def write(*a, **kw):
        written.append(a)
        return real_write(*a, **kw)

    def append(store_dir, feats, image_paths):
        appended.append((feats.cpu().numpy(), list(image_paths)))
        return real_append(store_dir, feats, image_paths)

    encoders.ClipEncoder, store_mod.write_store, store_mod.append_store = encoder, write, append
    try:
        with raw_frames(have_zstd):
            t0 = time.perf_counter()
            encode_images.main(["--img_dir", str(root / "images"), "--out_dir", str(store), "--weights",
                                str(weights), "--batch_size", str(CLIP_BATCH)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            frames0 = {p.name: p.read_bytes() for p in store.glob("*.clp")}
            n0 = len(json.loads((store / "manifest.json").read_text()))
            encode_images.main(["--img_dir", str(root / "more"), "--out_dir", str(store), "--weights",
                                str(weights), "--append"])
            st = store_mod.Store.open(store)
            old_same = all((store / name).read_bytes() == blob for name, blob in frames0.items())
            codes = st.read_codes()
    finally:
        encoders.ClipEncoder, store_mod.write_store, store_mod.append_store = real_encoder, real_write, real_append
    enc = made[0]
    check(enc.model.dtype == torch.bfloat16 and enc.device.type == "cuda", "the CLI's encoder is not bf16 on the card")
    _, feats, kept, scale, zero, q = written[0][:6]
    norms = np.linalg.norm(feats, axis=1)
    print(f"compress-cli: {len(kept)} of {CLIP_IMAGES + 1} files encoded (batch {CLIP_BATCH}, bf16, ViT-B/32 at "
          f"224px: {-(-len(kept) // CLIP_BATCH)} batches, the last padded) and stored in {cli_s:.3f} s (weights "
          f"load included); |norm - 1| max {np.abs(norms - 1).max():.3e}; append: {n0} -> {len(st)} records, old "
          f"frames byte-identical: {old_same}")
    check(len(kept) == CLIP_IMAGES and all("corrupt" not in p for p in kept), "the corrupt file was not skipped")
    check(bool(np.isfinite(feats).all()) and float(np.abs(norms - 1).max()) < 1e-3, "embeddings not finite and unit")
    rng_ = np.maximum(feats.max(0) - feats.min(0), np.float32(1e-8))
    check(np.array_equal(np.asarray(scale).view(np.uint32), (rng_ / np.float32(255)).view(np.uint32))
          and np.array_equal(np.asarray(zero).view(np.uint32), feats.min(0).view(np.uint32)),
          "fit_affine's scale and zero are not bit-equal to numpy's")
    want_q = np.clip(np.round((feats - zero) / scale), 0, 255).astype(np.uint8)
    y = (feats - zero) / scale
    near = int((np.abs(np.abs(y - np.floor(y)) - 0.5) < 1e-3).sum())
    check(np.array_equal(q, want_q), f"codes differ from numpy's in {int((q != want_q).sum())} places")
    (xa, pa), = appended
    want_a = np.clip(np.round((xa - st.zero) / st.scale), 0, 255).astype(np.uint8)
    check(len(st) == n0 + CLIP_APPEND and old_same and sorted(pa) == sorted(extra), "the append did not grow the store by 8 "
          "and keep every old frame")
    check(np.array_equal(codes[:n0], q) and np.array_equal(codes[n0:], want_a), "stored codes differ from numpy's")
    print(f"compress-codes: codebook and {q.size + want_a.size} codes bit-equal to numpy (IEEE divide, round half "
          f"to even); {near} quotients within 1e-3 of a .5 tie")

    # the u8 LUT path and bf16 against fp32, on the card
    u8 = np.stack([preprocess_pil_u8(Image.open(p)) for p in kept[:CLIP_BATCH]])
    host = np.stack([preprocess_pil(Image.open(p)) for p in kept[:CLIP_BATCH]])
    f32 = real_encoder(weights_path=str(weights), dtype=torch.float32, device=dev)
    stds = []
    hooks = [blk.register_forward_hook(lambda m, a, out: stds.append(float(out.float().std())))
             for blk in f32.model.visual.transformer.resblocks]
    lut = normalize_u8(torch.from_numpy(u8).to(dev), f32._table).cpu().numpy()
    z_u8 = f32.encode_image_array(u8)
    for h in hooks:
        h.remove()
    z_host = f32.encode_image_array(host)
    z_bf = enc.encode_image_array(u8)
    print(f"compress-weights: std of the vision stream after each of the 12 blocks (fp32): "
          f"{[round(v, 3) for v in stds]}")
    check(all(0.05 < v < 20 for v in stds), "the random tower's activations are not O(1)")
    rel = float((np.linalg.norm(z_bf - z_u8, axis=1) / np.linalg.norm(z_u8, axis=1)).max())
    print(f"compress-dtypes: u8 LUT input bit-equal to host-normalized input: pixels {np.array_equal(lut, host)}, "
          f"fp32 embeddings {np.array_equal(z_u8, z_host)}; bf16 vs fp32 tower max row ||delta||/||fp32|| {rel:.4e}; "
          f"bf16 CLI rows vs bf16 re-encode max |delta| {float(np.abs(feats[:CLIP_BATCH] - z_bf).max()):.3e}")
    check(np.array_equal(lut, host) and np.array_equal(z_u8, z_host), "the u8 LUT path is not bit-equal to host input")
    check(rel < 2e-2, f"bf16 embeddings {rel} from fp32 (limit 2e-2)")
    del f32

    # ClipCodec.compress of 8 images, decoded back on the host
    imgs = [Image.open(p) for p in extra]
    codec = ClipCodec(st.scale, st.zero, device=dev, encoder=enc)
    with raw_frames(have_zstd):
        blobs = codec.compress(imgs)
        back = codec.decode_embeddings_host(blobs)
    z8 = enc.encode_image_array(np.stack([preprocess_pil_u8(im) for im in imgs]))
    cos = np.sum(back * z8, axis=1)
    print(f"compress-codec: ClipCodec.compress of {len(imgs)} images -> {len(blobs)} frames of "
          f"{sorted({len(b) for b in blobs})} bytes; decoded cosine to the embeddings min {cos.min():.6f}")
    check(len(blobs) == len(imgs) and float(cos.min()) >= 0.99, f"compress round trip cosine {cos.min()}")

    # the text tower on seeded token ids, EOT at varied positions
    rng = np.random.default_rng(seed + 18)
    tok = rng.integers(1, VIT_B_32.eos_token_id - 1, (CLIP_BATCH, VIT_B_32.context_length))
    tok[:, 0] = VIT_B_32.eos_token_id - 1  # <|startoftext|>
    for i, e in enumerate(rng.integers(2, VIT_B_32.context_length, CLIP_BATCH)):
        tok[i, e], tok[i, e + 1:] = VIT_B_32.eos_token_id, 0
    zt = enc.embed_tokens(torch.from_numpy(tok)).cpu().numpy()
    tn = np.linalg.norm(zt, axis=1)
    print(f"compress-text: text tower at B={CLIP_BATCH}, L={VIT_B_32.context_length}: finite "
          f"{bool(np.isfinite(zt).all())}, |norm - 1| max {np.abs(tn - 1).max():.3e}")
    check(bool(np.isfinite(zt).all()) and float(np.abs(tn - 1).max()) < 1e-3, "text embeddings not finite and unit")

    # time: host preprocess per image; u8 arrays -> embeddings on the host; the tower's device time
    t0 = time.perf_counter()
    u8_all = [preprocess_pil_u8(Image.open(p)) for p in kept]
    pre_ms = (time.perf_counter() - t0) / len(kept) * 1e3
    from clip_codec_tpu_torch.encoders import _batched_encode

    embed = lambda x: enc.embed_images(torch.from_numpy(x)).cpu().numpy()
    _batched_encode(u8_all, lambda a: a, embed, CLIP_BATCH, VIT_B_32.embed_dim)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _batched_encode(u8_all, lambda a: a, embed, CLIP_BATCH, VIT_B_32.embed_dim)
        walls.append(time.perf_counter() - t0)
    x = normalize_u8(torch.from_numpy(u8).to(dev), enc._table)
    with torch.no_grad():
        fwd = lambda: enc.model.encode_image(x)
        g_ms = graph_ms(torch, fwd)
        e_ms = cuda_ms(torch, fwd)
    flops = vision_flops(VIT_B_32, CLIP_BATCH)
    b_ms = flops / BF16_FLOPS_PER_S * 1e3
    print(f"compress-time: PIL open + decode + resize + crop {pre_ms:.3f} ms per image (host); u8 arrays -> "
          f"embeddings on the host, {len(kept)} images in {-(-len(kept) // CLIP_BATCH)} batches of {CLIP_BATCH}: "
          f"{[round(w, 5) for w in walls]} s = {len(kept) / min(walls):.1f} img/s; the tower's forward at "
          f"B={CLIP_BATCH}: {g_ms:.4f} ms device (CUDA-graph replay), {e_ms:.4f} ms (events); {flops / 1e9:.1f} "
          f"GFLOP (vision_flops) over 989 TFLOP/s = {b_ms:.4f} ms bound, {flops / g_ms / 1e9:.1f} TFLOP/s "
          f"achieved, on {card}")
    del enc, codec, made
    torch.cuda.empty_cache()


# ------------------------------------------------ inversion guidance (SD CLI)


def device_ms(torch, fn) -> float:
    """The sum of the card's kernel times in one call of ``fn`` (profiler).
    Only the device's activity is recorded: a request's tens of thousands of
    host ops would take a minute to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_inversion(torch, attn, mlp, seed, dev, card):
    """K5 at the guided decode's shape; one guided step's latent gradient on
    the kernel, plain and fp32 plain paths; the SD CLI at its default flags
    with its launches; s/request with and without inversion. Returns the
    K5 records at that shape, the CLI request's launches and, with inversion
    on, its s/request, busy share and peak memory."""

    import numpy as np

    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding
    from clip_codec_tpu_torch.encoders import ClipEncoder
    from clip_codec_tpu_torch.io.bitstream import write_bitstream
    from clip_codec_tpu_torch.models.sd.decoder import sd_step_coefficients

    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    rec = flash_bwd_records()
    shape = flash_bwd_cases(torch, attn, gen, dev, [(FLASH_BWD_SHAPES[3], 1.0), (FLASH_BWD_SHAPES[3], 30.0)],
                            rec)[0]
    records = bwd_kernel_records(shape, rec)

    sd_dir, clip_w = ROOT / "build" / "chip_smoke" / "sd", ROOT / "build" / "chip_smoke" / "compress" / "clip_vit_b32.pt"
    dec = cli.load_decoder(sd_dir / "unet.pt", sd_dir / "vae.pt", sd_dir / "adapter.pt", dev, heads=8)
    enc = ClipEncoder(weights_path=str(clip_w), device=dev)
    embed = cli.clip_embed_fn(enc.model)
    _, co = sd_step_coefficients(INV_STEPS)
    i = INV_STEPS // 2
    for s in (seed, seed + 1):
        g = torch.Generator(device=dev).manual_seed(s + 21)
        lat, eps = (torch.randn((1, 64, 64, 4), generator=g, device=dev) for _ in range(2))
        z = torch.nn.functional.normalize(torch.randn((1, 512), generator=g, device=dev), dim=-1)

        def grad():
            return dec.inversion_grad(lat, eps, float(co["c_noise"][i]), float(co["c_x0"][i]), embed, z).flatten()

        reset_sd_launches(attn, mlp)
        g_k = grad()
        n = sd_launches(attn, mlp)
        with plain_sd_kernels(attn, mlp):
            g_p = grad()
            dec.vae.compute_dtype = enc.model.visual.dtype = torch.float32
            try:
                g_32 = grad()
            finally:
                dec.vae.compute_dtype = enc.model.visual.dtype = torch.bfloat16
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"inv-grad: seed {s} SD-1.5 VAE + ViT-B/32, 64x64 latent B=1, step {i} of ddim-{INV_STEPS}: "
              f"rel(g_kernel, g_plain)={rel(g_k, g_p):.3e} to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) "
              f"ratio={rk / rp:.4f} launches={n}")
        check(bool(torch.isfinite(g_k).all().item()) and g_k.norm().item() > 0, "latent gradient not finite or zero")
        check(rk <= FP32_RATIO * rp, f"latent gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check((n["flash_attention"], n["flash_attention_bwd_dq"], n["flash_attention_bwd_dkv"]) == (1, 1, 1),
              f"one guided step's gradient launched {n}")

    # the CLI at its default flags: only the required paths and the weights' variables
    inv_dir = ROOT / "build" / "chip_smoke" / "inversion"
    inv_dir.mkdir(parents=True, exist_ok=True)
    have_zstd = frame_engine("inversion")
    codes = np.random.default_rng(seed + 22).integers(0, 256, 512, dtype=np.uint8)
    weights = dict(CLIP_CODEC_SD_UNET_WEIGHTS=sd_dir / "unet.pt", CLIP_CODEC_SD_VAE_WEIGHTS=sd_dir / "vae.pt",
                   CLIP_CODEC_CLIP_WEIGHTS=clip_w)
    np.savez(inv_dir / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32),
             zero=np.full(512, -1.0, np.float32))
    out = inv_dir / f"img0-{INV_STEPS}-5-1.png"
    out.unlink(missing_ok=True)
    with raw_frames(have_zstd), mock.patch.dict(os.environ, {k: str(v) for k, v in weights.items()}):
        write_bitstream(codes.tobytes(), 512, inv_dir / "img0.clp")
        z = decode_embedding(inv_dir / "img0.clp", inv_dir)
        torch.cuda.synchronize()
        reset_sd_launches(attn, mlp)
        t0 = time.perf_counter()
        cli.main(["--store_dir", str(inv_dir), "--bitstream", str(inv_dir / "img0.clp"), "--adapter",
                  str(sd_dir / "adapter.pt")])
        cli_s = time.perf_counter() - t0
    launches = sd_launches(attn, mlp)
    from PIL import Image

    png = np.asarray(Image.open(out))
    print(f"inv-cli: reconstruct_sd_diffusion.main at its default flags (ddim-{INV_STEPS}, guidance 5, inv_weight 1 "
          f"every step, backend auto -> clip, 512px){'' if have_zstd else ' from a raw-code frame (no zstd engine)'}: "
          f"{out.name} {png.shape} in {cli_s:.3f} s (weights load included) on {card}; launches={launches}")
    check(png.shape == (SD_SIZE, SD_SIZE, 3) and int(png.max()) > int(png.min()), f"{out.name}: {png.shape}")
    check(launches == INV_LAUNCHES, f"inversion request launches {launches} != {INV_LAUNCHES}")

    # s/request with and without the guidance, in turns; busy share and peak memory
    run = lambda w: cli.sample_images(dec, z, SD_SIZE, steps=INV_STEPS, guidance=SD_GUIDANCE, seed=seed,
                                      inv_weight=w, embed_fn=embed)
    times = {1.0: [], 0.0: []}
    peak = {}
    for w in (1.0, 0.0, 0.0, 1.0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        img = run(w)
        torch.cuda.synchronize()
        times[w].append(time.perf_counter() - t0)
        peak[w] = torch.cuda.max_memory_allocated(dev) / 2**30
        check(bool(torch.isfinite(img.float()).all().item()), f"inv_weight {w}: non-finite image")
    busy = {w: device_ms(torch, lambda: run(w)) / 1e3 / min(times[w]) for w in times}
    print(f"inv-time: request of 1 embedding, ddim-{INV_STEPS}, 512px, CFG batched: inv_weight 1 "
          f"{[round(t, 4) for t in times[1.0]]} s, inv_weight 0 {[round(t, 4) for t in times[0.0]]} s; device busy "
          f"(profiled kernel time / fastest unprofiled wall) {100 * busy[1.0]:.1f}% and {100 * busy[0.0]:.1f}%; "
          f"peak device memory {peak[1.0]:.2f} and {peak[0.0]:.2f} GiB on {card}")
    del dec, enc, embed
    torch.cuda.empty_cache()
    return records, launches, {"s": times[1.0], "busy": busy[1.0], "peak": peak[1.0], "s_inv0": times[0.0]}


# ------------------------------------------------------------ evaluation


def phase_eval(torch, rc, seed, dev, card):
    """cli.eval over phase 14's store with its trained decoder, all four
    metrics on; launches by shape, the card's metrics against the CPU's,
    the records against the printed means. Returns K2/K3 launches by shape."""
    import io

    import numpy as np

    from clip_codec_tpu_torch import diffusion
    from clip_codec_tpu_torch.cli import eval as cli_eval
    from clip_codec_tpu_torch.eval import lpips as lpips_mod
    from clip_codec_tpu_torch.eval import metrics as tm
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    root = ROOT / "build" / "chip_smoke" / "eval"
    root.mkdir(parents=True, exist_ok=True)
    lp_file = root / "lpips_vgg.pt"
    torch.save(lpips_mod.init_params(lpips_mod.LPIPS(), torch.Generator().manual_seed(seed + 23)).state_dict(), lp_file)
    store = ROOT / "build" / "chip_smoke" / "train_px"
    weights = store / "out" / "diffusion_unet_final.pt"
    clip_w = ROOT / "build" / "chip_smoke" / "compress" / "clip_vit_b32.pt"
    have_zstd = frame_engine("eval")

    seen, spent = [], collections.Counter()

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            if name == "psnr":
                seen.append((a[0].clone(), a[1].clone(), out.cpu()))
            return out
        return wrapper

    saved = {n: getattr(cli_eval, n) for n in ("psnr_batch", "ssim_batch", "lpips_batch", "clip_similarity_batch")}
    make_sampler = diffusion.make_sampler

    def sampler(*a, **k):
        smp = make_sampler(*a, **k)
        smp.sample = timed("sampling", smp.sample)
        return smp

    shapes = collections.Counter()
    launch = rc._launch

    def tally(x, A, B, w9, bias, add, want_moments, linear):
        shapes[(*x.shape[1:], w9.shape[2])] += 1
        return launch(x, A, B, w9, bias, add, want_moments, linear)

    text = io.StringIO()
    for n, fn in saved.items():
        setattr(cli_eval, n, timed(n.split("_")[0], fn))
    diffusion.make_sampler, rc._launch = sampler, tally
    try:
        with raw_frames(have_zstd), mock.patch.dict(os.environ, {"CLIP_CODEC_LPIPS_WEIGHTS": str(lp_file),
                                                               "CLIP_CODEC_CLIP_WEIGHTS": str(clip_w)}):
            _px_store(seed, store)  # phase 14's images and codes, framed here
            torch.cuda.synchronize()
            reset_launches(rc)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                cli_eval.main(["--store_dir", str(store), "--weights", str(weights), "--out_json",
                               str(root / "metrics.json")])
            wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(cli_eval, n, fn)
        diffusion.make_sampler, rc._launch = make_sampler, launch
    lines = text.getvalue().splitlines()
    for line in lines:
        print(f"eval-cli: {line}")
    recs = json.loads((root / "metrics.json").read_text())
    n_img = len(recs)
    batches = -(-PX_IMAGES // EVAL_BATCH)
    n = (rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches)
    metrics_s = sum(v for k, v in spent.items() if k != "sampling")
    print(f"eval-time: {n_img} images, {batches} batches of {EVAL_BATCH}, DDIM-{STEPS}, {SIZE}px, all four metrics: "
          f"{wall:.3f} s = {n_img / wall:.3f} img/s (scorers' load included); sampling {spent['sampling']:.3f} s, "
          f"metrics {metrics_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in spent.items() if k != 'sampling')}), "
          f"the rest (weights, scorers, images) {wall - spent['sampling'] - metrics_s:.3f} s on {card}; "
          f"launches(K2, K3)={n}")
    check(n_img == PX_IMAGES and len(lines) == 4, f"{n_img} records, {len(lines)} lines")
    for key in ("psnr", "ssim", "lpips", "clip_sim"):
        vals = [r[key] for r in recs]
        check(all(np.isfinite(vals)), f"{key}: not finite in every record")
    means = [float(re.search(r": (\S+)", line).group(1)) for line in lines]
    for key, fmt, m in zip(("psnr", "ssim", "lpips", "clip_sim"), ("{:.2f}", "{:.4f}", "{:.4f}", "{:.4f}"), means):
        check(fmt.format(np.mean([r[key] for r in recs])) == fmt.format(m), f"{key}: the records' mean is not {m}")
    check(n == ((LAUNCHES_PER_FORWARD - 1) * STEPS * batches, STEPS * batches), f"eval launches {n}")
    want = {shape[1:]: calls * STEPS * batches for shape, calls in
            path_conv_shapes(PX_BASE, PX_CH_MULT, SIZE, EVAL_BATCH)}
    check(dict(shapes) == want, f"eval launches by shape {dict(shapes)} != {want}")

    # the card's metrics against the CPU's on the same reconstructions
    lp_cpu = lpips_mod.LPIPSModel.from_checkpoint(lp_file, device="cpu")
    worst = {"u8": True, "psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    for bi, (orig, recon, ps) in enumerate(seen):
        oc, rcpu = orig.cpu(), recon.cpu()
        worst["u8"] &= all(torch.equal(tm._u8_float(t).cpu(), tm._u8_float(t.cpu())) for t in (orig, recon))
        worst["psnr"] = max(worst["psnr"], (ps - tm.psnr_batch(oc, rcpu)).abs().max().item())
        ss = tm.ssim_batch(orig, recon).cpu()
        worst["ssim"] = max(worst["ssim"], (ss - tm.ssim_batch(oc, rcpu)).abs().max().item())
        if bi == 0:  # LPIPS in fp32 on the host's CPU: two images of the first batch
            lc = lp_cpu.distance(oc[:2], rcpu[:2])
            lg = torch.tensor([recs[j]["lpips"] for j in range(2)])
            worst["lpips"] = ((lg - lc).abs() / lc.abs()).max().item()
    print(f"eval-cpu: the same reconstructions on the host's CPU: uint8 images bit-equal {worst['u8']}; max |delta| "
          f"PSNR {worst['psnr']:.3e} dB, SSIM {worst['ssim']:.3e}; LPIPS (2 images, fp32) max relative "
          f"{worst['lpips']:.3e}")
    check(worst["u8"], "uint8 images differ between the card and the CPU")
    check(worst["psnr"] <= 1e-5 and worst["ssim"] <= 1e-5, f"PSNR/SSIM on the card vs the CPU: {worst}")
    check(worst["lpips"] <= 1e-4, f"LPIPS on the card vs the CPU: {worst['lpips']}")
    torch.cuda.empty_cache()
    return {"eval_by_shape": dict(shapes)}


# ------------------------------------------------------------ retrieval (phase 19)


def _distinct(ref, k: int, tol: float = RET_NEAR):
    """(Q, k) mask of the places whose score, in a descending (Q, k + 1)
    reference, differs from both neighbours by more than ``tol``: the places
    where two searches must return the same id (the near-tie rule)."""
    import numpy as np

    gap = ref[:, :-1] - ref[:, 1:]  # (Q, k): gap to the next place
    before = np.concatenate([np.full((ref.shape[0], 1), np.inf, np.float32), gap[:, :k - 1]], axis=1)
    return (gap[:, :k] > tol) & (before > tol)


def _same_hits(tag, got, ref, k, tol=RET_NEAR):
    """``got`` (scores, ids) of k against ``ref`` of k + 1: sorted scores
    within ``tol``, ids equal at every place the near-tie rule decides;
    returns the count of near-tie places."""
    import numpy as np

    (s, i), (rs, ri) = got, ref
    err = float(np.abs(s - rs[:, :k]).max())
    mask = _distinct(rs, k, tol)
    check(err <= tol, f"{tag}: sorted scores {err:.3e} from the reference (limit {tol})")
    check(bool((i == ri[:, :k])[mask].all()), f"{tag}: ids differ at a place the near-tie rule decides")
    return int((~mask).sum()), err


def _u8_bound(Q, N, D):
    """The u8 score's least time: codes and inv read once, scores written
    once (qs, qz beside them) over HBM, or the kernel's products, three bf16
    parts of the query (3 x 2 Q N D operations) over the tensor cores."""
    return bound(N * D + 4 * N + 4 * Q * N + 4 * Q * (D + 1), 3 * 2.0 * Q * N * D)


def _probe_bound(lists_used, cap, Q, nprobe, D):
    """The probe's least time: each probed list (codes and list_inv) read
    once however many queries probe it, the probe ids, the scores written;
    or its three-part bf16 products over the tensor cores."""
    nbytes = lists_used * cap * (D + 4) + 4 * Q * nprobe * (1 + cap) + 4 * Q * (D + 1)
    return bound(nbytes, 3 * 2.0 * Q * nprobe * cap * D)


def _fp32_fma_ms(shape):
    """An fp32 scan's operations bound, beside the kernel's: one fp32
    product a query x code byte (2 x the shape's product operations) over
    67 TFLOP/s outside the tensor cores."""
    return 2.0 * math.prod(shape) / FP32_FLOPS_PER_S * 1e3


def phase_retrieval(torch, seed, dev, card):
    """Retrieval at D = 512: the u8 kernels against plain (19a), exact search
    over 1M rows (19b), IVF at the CLI's defaults over 100k (19c), the search
    CLI over phase 16's store (19d), times (19e). Returns the kernel records
    (one per shape) and the path's launches (19b-19d)."""
    import gzip
    import io

    import numpy as np

    from clip_codec_tpu_torch.cli import search_text
    from clip_codec_tpu_torch.codecs.quantizer import dequantize_l2norm_host
    from clip_codec_tpu_torch.index import build_index, build_index_u8, build_ivf_index, build_ivf_index_u8
    from clip_codec_tpu_torch.index.search import _rank, search_index
    from clip_codec_tpu_torch.io import store as store_mod
    from clip_codec_tpu_torch.ops import u8_scan as u8
    from clip_codec_tpu_torch.probes import index_times as it

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    rng = np.random.default_rng(seed + 19)
    t0 = time.perf_counter()
    codes, scale, zero = it.make_store(RET_N, gen, dev)
    # 64 copies of one row spread over the IVF's rows, 11 of another over the whole store
    dup = torch.from_numpy(np.sort(rng.choice(np.arange(1, RET_IVF_N), 64, replace=False))).to(dev)
    codes[dup] = codes[0].clone()
    dup = torch.cat([torch.zeros(1, dtype=dup.dtype, device=dev), dup])
    eleven = np.sort(rng.choice(np.arange(RET_IVF_N, RET_N), 11, replace=False))
    codes[torch.from_numpy(eleven).to(dev)] = codes[int(eleven[0])].clone()
    flat = build_index(it.dequantized(codes, scale, zero), device=dev)
    flat_u8 = build_index_u8(codes, scale, zero, device=dev)
    torch.cuda.synchronize()
    print(f"retrieval-data: N={RET_N} unit rows at D={it.D} (seed {seed + 19}) fitted and quantized on the card, "
          f"row 0 copied to 64 rows of the first {RET_IVF_N}, row {eleven[0]} to 11 rows; exact fp32 and u8 indexes "
          f"built in {time.perf_counter() - t0:.3f} s")
    queries = {nq: it.unit_rows(nq, it.D, gen, dev) for nq in RET_Q}

    # IVF over the first 100k at the CLI's defaults, each form built twice
    sub_codes, sub_feats = codes[:RET_IVF_N], flat.feats[:RET_IVF_N]
    ivfs = {}
    for name, build in (("ivf", lambda: build_ivf_index(sub_feats, device=dev)),
                        ("ivf-u8", lambda: build_ivf_index_u8(sub_codes, scale, zero, device=dev))):
        made, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            made.append(build())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        a, b = made
        same = all((getattr(a, f) is None and getattr(b, f) is None) or torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("centroids", "lists", "list_ids", "list_inv"))
        print(f"retrieval-ivf-build: {name} over {RET_IVF_N} rows: nlist {a.nlist}, nprobe {a.nprobe}, cap "
              f"{a.lists.shape[1]} (pad {a.nlist * a.lists.shape[1] / RET_IVF_N:.3f}x); build s {secs[0]:.3f}, "
              f"{secs[1]:.3f} on {card}; second build bit-equal: {same}"
              + (f"; subsampled train path: {RET_IVF_N > 256 * a.nlist}" if name == "ivf-u8" else ""))
        check(a.nlist == round(RET_IVF_N ** 0.5) and a.nprobe == 8, f"{name}: not at the CLI's defaults")
        check(same, f"{name}: two builds of one store differ")
        ivfs[name] = a
        del made, b
    check(RET_IVF_N > 256 * ivfs["ivf-u8"].nlist, "build_ivf_index_u8 did not take its subsampled train path")
    flat_sub = build_index(sub_feats, device=dev)

    # 19a: the kernels against plain at the path's shapes
    records = {"u8_ip_scores": [], "u8_ip_probe": []}

    def record(name, shape, call, plain, b, matmul, ties_of=lambda got: (True, 0)):
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ties, n_copies = ties_of(got)
        rec = dict(shape=list(shape), max_abs_err=err, ms=graph_ms(torch, call), events_ms=cuda_ms(torch, call),
                   plain_ms=cuda_ms(torch, plain, iters=3, warmup=1), library_ms=None,
                   matmul_ms=graph_ms(torch, matmul), bound_ms=b[0], bound_by=b[1], bound_unit=b[2],
                   library="none: no one PyTorch call takes uint8 codes and fp32 queries; matmul_ms is torch.matmul "
                           "of the fp32 dequantized matrix (what the fp32 index runs), for scale")
        print(f"kernel-check: {name} {tuple(shape)} max_abs_err={err:.3e} {n_copies} scores of copies of one row "
              f"bit-identical={ties} "
              f"ms={rec['ms']:.4f} (graph) events_ms={rec['events_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"fp32 matmul_ms={rec['matmul_ms']:.4f} bound_ms={b[0]:.4f} ({b[2]}; the fp32-FMA bound "
              f"{_fp32_fma_ms(shape):.4f})")
        check(err <= RET_NEAR, f"{name} {shape}: {err:.3e} from plain (limit {RET_NEAR})")
        check(ties, f"{name} {shape}: duplicated rows score differently")
        records[name].append(rec)
        return rec

    def same_cols(cols):
        def ties_of(got):
            d = got[:, cols]
            return bool(torch.equal(d, d[:, :1].expand_as(d))), d.numel()
        return ties_of

    dup_cols = dup.cpu().numpy()
    for nq in RET_Q:
        q = queries[nq]
        qs, qz = u8.fold_query(q, flat_u8.scale, flat_u8.zero)
        args = (flat_u8.codes, qs, qz, flat_u8.inv_norms)
        record("u8_ip_scores", (nq, RET_N, it.D), lambda: u8.u8_ip_scores(*args), lambda: u8.u8_ip_scores_plain(*args),
               _u8_bound(nq, RET_N, it.D), it.score_call(flat, q), same_cols(dup_cols))
    sq, sn, sd = RET_SMALL
    small = torch.from_numpy(rng.integers(0, 256, (sn, sd), dtype=np.uint8)).to(dev)
    small[100:164] = small[7]
    s_scale = torch.from_numpy((0.5 + rng.random(sd)).astype(np.float32) / 255).to(dev)
    s_zero = torch.full((sd,), -0.4, device=dev)
    s_idx = build_index_u8(small, s_scale, s_zero, device=dev)
    s_q = it.unit_rows(sq, sd, gen, dev)
    s_args = (small, *u8.fold_query(s_q, s_scale, s_zero), s_idx.inv_norms)
    s_feats = (small.float() * s_scale + s_zero) * s_idx.inv_norms[:, None]
    record("u8_ip_scores", RET_SMALL, lambda: u8.u8_ip_scores(*s_args), lambda: u8.u8_ip_scores_plain(*s_args),
           _u8_bound(sq, sn, sd), lambda: s_q @ s_feats.T, same_cols(np.r_[7, 100:164]))

    iu8 = ivfs["ivf-u8"]
    dup32 = dup.to(torch.int32)
    # the u8 lists dequantized and renormalized: the fp32 IVF's product at the same shape, for scale
    lists32 = (iu8.lists.float() * iu8.scale + iu8.zero) * iu8.list_inv[..., None]
    for nq in RET_Q:
        for nprobe in (iu8.nprobe, iu8.nlist):
            q = queries[nq]
            probe = _rank(q @ iu8.centroids.T, nprobe)[1].to(torch.int32).contiguous()
            qs, qz = u8.fold_query(q, iu8.scale, iu8.zero)
            args = (iu8.lists, iu8.list_inv, probe, qs, qz)
            copies = torch.isin(iu8.list_ids[probe.long()], dup32).reshape(nq, -1)  # pool places of row 0's copies

            def ties_of(got, copies=copies):
                vals = [got[j].flatten()[copies[j]] for j in range(got.shape[0])]
                return all(bool((v == v[0]).all()) for v in vals if v.numel()), int(copies.sum())

            # every list probed: the flat product over the same rows (a gather would be Q x 316 lists)
            scale_call = ((lambda: torch.einsum("qd,qpcd->qpc", q, lists32[probe.long()])) if nprobe < iu8.nlist
                          else it.score_call(flat_sub, q))
            record("u8_ip_probe", (nq, nprobe, iu8.lists.shape[1], it.D), lambda: u8.u8_ip_probe(*args),
                   lambda: u8.u8_ip_probe_plain(*args),
                   _probe_bound(int(torch.unique(probe).numel()), iu8.lists.shape[1], nq, nprobe, it.D),
                   scale_call, ties_of)
            skew = it.probe_skew(probe, iu8.nlist, iu8.lists.shape[1], torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
            print(f"retrieval-probe-skew: Q={nq} nprobe={nprobe}: {skew}")
    del lists32

    # 19b-19d, the path: every launch counted by shape
    tally = collections.Counter()
    saved = u8._launch_scores, u8._launch_probe

    def scores_tallied(codes_, qs_, qz_, inv_):
        tally[("u8_ip_scores", qs_.shape[0], *codes_.shape)] += 1
        return saved[0](codes_, qs_, qz_, inv_)

    def probe_tallied(lists_, inv_, probe_, qs_, qz_):
        tally[("u8_ip_probe", *probe_.shape, *lists_.shape[1:])] += 1
        return saved[1](lists_, inv_, probe_, qs_, qz_)

    u8._launch_scores, u8._launch_probe = scores_tallied, probe_tallied
    u8.u8_ip_scores.launches = u8.u8_ip_probe.launches = 0
    try:
        # 19b: exact search over 1M
        for nq in RET_Q:
            q = queries[nq]
            n0 = u8.u8_ip_scores.launches
            got = flat_u8.search(q, RET_K)
            check(u8.u8_ip_scores.launches == n0 + 1, f"exact-u8 Q={nq}: {u8.u8_ip_scores.launches - n0} launches")
            near, err = _same_hits(f"exact-u8 Q={nq}", got, flat.search(q, RET_K + 1), RET_K)
            print(f"retrieval-exact: N={RET_N} Q={nq} k={RET_K}: u8 vs fp32 index sorted scores max |delta| "
                  f"{err:.3e}, ids equal at every decided place, {near} near-tie places of {nq * RET_K}; one "
                  f"u8_ip_scores launch")
        x = dequantize_l2norm_host(codes[int(eleven[0])].cpu().numpy()[None], scale, zero)
        ids = flat_u8.search(x, RET_K)[1][0]
        print(f"retrieval-ties: a row held 11 times at {eleven.tolist()}: u8 k={RET_K} ids {ids.tolist()}; fp32 "
              f"index {flat.search(x, RET_K)[1][0].tolist()}")
        check(ids.tolist() == eleven[:RET_K].tolist(), "the eleven copies do not rank lowest id first")

        # 19c: IVF at the CLI's defaults over 100k
        for nq in RET_Q:
            q = queries[nq]
            ref = flat_sub.search(q, RET_K + 1)
            for name, idx in ivfs.items():
                n0 = u8.u8_ip_probe.launches
                s, i = idx.search(q, RET_K)
                recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / RET_K for a, b in zip(i, ref[1][:, :RET_K])])
                full = idx.search(q, RET_K, nprobe=idx.nlist)
                launched = u8.u8_ip_probe.launches - n0
                near, err = _same_hits(f"{name} Q={nq} full probe", full, ref, RET_K)
                print(f"retrieval-ivf: {name} N={RET_IVF_N} Q={nq}: recall@{RET_K} at nprobe {idx.nprobe} "
                      f"{recall:.4f} (isotropic random rows: the ANN worst case); nprobe = nlist = {idx.nlist}: "
                      f"the flat index's hits, sorted scores max |delta| {err:.3e}, {near} near-tie places; "
                      f"u8_ip_probe launches {launched}")
                check(launched == (2 if name == "ivf-u8" else 0), f"{name}: {launched} probe launches in 2 searches")

        # 19d: the CLI over phase 16's store, every query kind x index form
        store = ROOT / "build" / "chip_smoke" / "compress" / "store"
        weights = store.parent / "clip_vit_b32.pt"
        bpe = ROOT / "build" / "chip_smoke" / "retrieval" / "bpe.txt.gz"
        bpe.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(bpe, "wt", encoding="utf-8") as f:  # a synthetic merges file, as the tokenizer tests use
            f.write("#version: 0.2\n" + "\n".join(["t h", "th e</w>", "h e", "c a", "ca t</w>", "d o", "do g</w>"])
                    + "\n")
        have_zstd = frame_engine("retrieval")
        manifest = json.loads((store / "manifest.json").read_text())
        n_store = len(manifest)
        nlist = max(1, round(n_store ** 0.5))
        kinds = {"--query": "a photo of a cat", "--query_image": manifest[3]["image"],
                 "--query_clp": manifest[5]["bitstream"]}
        forms = {"exact": [], "u8": ["--u8"], "ivf": ["--ivf", "--nprobe", str(nlist)],
                 "ivf-u8": ["--u8", "--ivf", "--nprobe", str(nlist)]}
        printed, walls = {}, {}
        with raw_frames(have_zstd):
            for kind, value in kinds.items():
                for form, extra in forms.items():
                    out = io.StringIO()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(out):
                        search_text.main(["--store_dir", str(store), "--weights", str(weights), "--bpe", str(bpe),
                                          kind, value] + extra)
                    walls[(kind, form)] = time.perf_counter() - t0
                    printed[(kind, form)] = [line.split("\t") for line in out.getvalue().splitlines()]
            st = store_mod.Store.open(store)
            cli_codes = st.read_codes()
    finally:
        u8._launch_scores, u8._launch_probe = saved
    launches = {"u8_ip_scores": u8.u8_ip_scores.launches, "u8_ip_probe": u8.u8_ip_probe.launches}
    for kind in kinds:
        exact = printed[(kind, "exact")]
        ref = np.array([[float(s) for s, _ in exact] + [-np.inf]], np.float32)
        mask = _distinct(ref, len(exact), 1.5e-4)[0]  # printed to 4 decimals
        for form in forms:
            lines = printed[(kind, form)]
            same = len(lines) == RET_K and all(a[1] == b[1] for a, b, m in zip(lines, exact, mask) if m)
            print(f"retrieval-cli: {kind} {form}: {len(lines)} lines, first {lines[0] if lines else None}, paths "
                  f"equal to exact's at the {int(mask.sum())} decided places: {same}; wall {walls[(kind, form)]:.3f} "
                  f"s (index build and tower load included) on {card}")
            check(same, f"cli {kind} {form}: not {RET_K} lines with exact's paths")
            if kind == "--query_clp":
                check(lines[0] == ["1.0000", manifest[5]["image"]], f"cli --query_clp {form}: first line {lines[0]}")
    want = {("u8_ip_scores", 1, RET_N, it.D): 2, ("u8_ip_scores", 64, RET_N, it.D): 1,
            ("u8_ip_scores", 1, n_store, it.D): 3}
    print(f"retrieval-launches: {dict(tally)}; totals {launches}")
    check(launches["u8_ip_scores"] == 2 + 1 + 3 and launches["u8_ip_probe"] == 4 + 3,
          f"retrieval launches {launches}: want 6 u8_ip_scores (19b 2 + 1, the CLI 3) and 7 u8_ip_probe "
          f"(19c 4, the CLI 3)")
    check(all(tally[k] == v for k, v in want.items()), f"u8_ip_scores launches by shape {dict(tally)}")

    # the CLI's own shapes, timed as 19a times the others
    cli_u8 = build_index_u8(cli_codes, st.scale, st.zero, device=dev)
    cli_ivf = build_ivf_index_u8(cli_codes, st.scale, st.zero, nprobe=nlist, device=dev)
    cli_feats = torch.from_numpy(dequantize_l2norm_host(cli_codes, st.scale, st.zero)).to(dev)
    q = it.unit_rows(1, it.D, gen, dev)
    args = (cli_u8.codes, *u8.fold_query(q, cli_u8.scale, cli_u8.zero), cli_u8.inv_norms)
    record("u8_ip_scores", (1, n_store, it.D), lambda: u8.u8_ip_scores(*args), lambda: u8.u8_ip_scores_plain(*args),
           _u8_bound(1, n_store, it.D), lambda: q @ cli_feats.T)
    probe = torch.arange(cli_ivf.nlist, device=dev, dtype=torch.int32)[None]
    p_args = (cli_ivf.lists, cli_ivf.list_inv, probe, *u8.fold_query(q, cli_ivf.scale, cli_ivf.zero))
    cli_fp = build_ivf_index(cli_feats, nprobe=nlist, device=dev)
    record("u8_ip_probe", (1, cli_ivf.nlist, cli_ivf.lists.shape[1], it.D), lambda: u8.u8_ip_probe(*p_args),
           lambda: u8.u8_ip_probe_plain(*p_args), _probe_bound(cli_ivf.nlist, cli_ivf.lists.shape[1], 1,
                                                                cli_ivf.nlist, it.D),
           lambda: torch.einsum("qd,qpcd->qpc", q, cli_fp.lists[probe.long()]))
    for name, recs in records.items():
        for rec in recs:
            rec["launches"] = tally.get((name, *rec["shape"]), 0)

    # 19e: times
    tables = {"exact": flat, "exact-u8": flat_u8, "ivf": ivfs["ivf"], "ivf-u8": ivfs["ivf-u8"]}
    for name, idx in tables.items():
        n = idx.ntotal
        for nq in RET_Q:
            call = it.search_call(idx, queries[nq])
            print(f"retrieval-time: {name} N={n} Q={nq} k={RET_K}: {graph_ms(torch, call):.4f} ms a search (CUDA-graph "
                  f"replay), {cuda_ms(torch, call):.4f} ms (events); resident {it.resident_bytes(idx)} bytes; "
                  f"on {card}")
        qv = queries[1][0].cpu().numpy()
        paths = [f"img{i}" for i in range(n)]
        walls_ = []
        for _ in range(5):
            t0 = time.perf_counter()
            search_index(qv, idx, paths, k=RET_K)
            walls_.append(time.perf_counter() - t0)
        print(f"retrieval-host: {name} N={n}: one CLI query after the build (search_index, host wall) "
              f"{[round(w * 1e3, 4) for w in walls_]} ms on {card}")
    print(f"retrieval-memory: peak device memory of the phase {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"on {card}")
    del flat, flat_u8, ivfs, codes
    torch.cuda.empty_cache()
    return records, launches


# ------------------------------------------------------------ serving and export (phase 20)


def _tally_captured(torch, counter, key):
    """A launcher wrapped to count, by ``key(*args)``, the calls a CUDA-graph
    capture records (each is launched once by every replay)."""
    def wrap(fn):
        def tallied(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                counter[key(*args, **kw)] += 1
            return fn(*args, **kw)
        return tallied
    return wrap


def phase_artifacts(torch, attn, mlp, rc, seed, dev, card):
    """Export both artifacts through the CLI (20a), replay them against the
    eager samplers (20b), then serve every endpoint over HTTP (20c). Returns
    the launches of 20c, the main path's run, per kernel and shape."""

    from clip_codec_tpu_torch import deploy, serve
    from clip_codec_tpu_torch.cli import export_decoder
    from clip_codec_tpu_torch.cli.search_text import load_features
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes
    from clip_codec_tpu_torch.utils.checkpoint import load_state_dict
    from clip_codec_tpu_torch.weights import sd_checkpoint as ckpt

    build = ROOT / "build" / "chip_smoke"
    px_weights, sd_dir, store = build / "store" / "diffusion_unet_final.pt", build / "sd", build / "compress" / "store"
    out = build / "serve"
    out.mkdir(parents=True, exist_ok=True)
    env = {ckpt.UNET_ENV: str(sd_dir / "unet.pt"), ckpt.VAE_ENV: str(sd_dir / "vae.pt"),
           "CLIP_CODEC_CLIP_WEIGHTS": str(build / "compress" / "clip_vit_b32.pt"),
           "CLIP_BPE_PATH": str(build / "retrieval" / "bpe.txt.gz")}
    have_zstd = frame_engine("artifacts")
    captured = collections.Counter()  # (kernel, shape) -> calls a capture recorded
    saved = rc._launch, attn._launch, mlp._launch_up
    rc._launch = _tally_captured(torch, captured, lambda x, A, B, w9, bias, add, want_moments, linear: (
        "affine_conv3x3" if linear else "affine_silu_conv3x3", (*x.shape[1:], w9.shape[2])))(rc._launch)
    attn._launch = _tally_captured(torch, captured, lambda q, k, v: ("flash_attention", tuple(q.shape)))(attn._launch)
    mlp._launch_up = _tally_captured(torch, captured, lambda x, *r: (
        "mlp_up", (x.numel() // x.shape[-1], x.shape[-1], r[2].shape[0])))(mlp._launch_up)
    try:
        with mock.patch.dict(os.environ, env), raw_frames(have_zstd):
            # 20a: both artifacts through the export CLI at its defaults (pixel: 256px, DDIM-50, batch 16)
            t0 = time.perf_counter()
            export_decoder.main(["--weights", str(px_weights), "--out", str(out / "decoder.torchprog"),
                                 "--output", "uint8"])
            export_decoder.main(["--sd", "--adapter", str(sd_dir / "adapter.pt"), "--out", str(out / "sd.torchprog")])
            px_meta, sd_meta = (deploy.read_artifact_meta(out / n) for n in ("decoder.torchprog", "sd.torchprog"))
            print(f"serve-export: both artifacts in {time.perf_counter() - t0:.2f} s on {card}; pixel {px_meta}; "
                  f"sd {sd_meta}")
            check((px_meta["size"], px_meta["steps"], px_meta["batch_size"], px_meta["output"], px_meta["base"]) ==
                  (SIZE, STEPS, WIDE_BATCH, "uint8", PX_BASE), f"pixel artifact header {px_meta}")
            check((sd_meta["size"], sd_meta["steps"], sd_meta["batch_size"], sd_meta["cfg_batched"]) ==
                  (SD_SIZE, INV_STEPS, 1, True), f"SD artifact header {sd_meta}")

            # 20b: replays against the eager samplers
            feats, _ = load_features(store)
            z = torch.from_numpy(feats[:WIDE_BATCH]).to(dev)
            px = deploy.load_decompressor(out / "decoder.torchprog")
            params = load_state_dict(px_weights)
            t0 = time.perf_counter()
            a = px(params, z, seed=seed)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            check(px.graph is not None, "the pixel artifact did not capture a graph")
            reset_launches(rc)
            b = px(params, z, seed=seed)
            n = {"affine_silu_conv3x3": rc.affine_silu_conv3x3.launches, "affine_conv3x3": rc.affine_conv3x3.launches}
            want_shapes = {("affine_conv3x3" if i == len(shapes) - 1 else "affine_silu_conv3x3", shape[1:]): c * STEPS
                           for shapes in [path_conv_shapes(PX_BASE, PX_CH_MULT, SIZE, WIDE_BATCH)]
                           for i, (shape, c) in enumerate(shapes)}
            px_shapes = {k: v for k, v in captured.items() if k[0] in n}
            print(f"serve-replay: pixel capture + first replay {first:.3f} s on {card}; a replay launched {n}; "
                  f"recorded by shape {px_shapes}")
            check(n == {"affine_silu_conv3x3": 28 * STEPS, "affine_conv3x3": STEPS}, f"launches a replay {n}")
            check(px_shapes == want_shapes, f"recorded by shape {px_shapes} != {want_shapes}")
            check(torch.equal(a, b), "two replays of one seed differ")
            check(not torch.equal(a, px(params, z, seed=seed + 1)), "another seed replays the same images")
            x_T = torch.randn((WIDE_BATCH, SIZE, SIZE, 3), generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
            t0 = time.perf_counter()
            e = px.sample(px.net, z, x_T)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            d = (a.int() - e.int()).abs()
            same = (d == 0).float().mean().item()
            px_ms = cuda_ms(torch, lambda: px(params, z, seed=seed), iters=1, warmup=0)
            print(f"serve-replay: pixel uint8 vs eager from the same x_T: max |delta| {d.max().item()} levels, "
                  f"{same:.6f} of pixels equal; a call (copies in, replay, copy out) {px_ms:.3f} ms device, eager "
                  f"{eager_s:.3f} s wall, batch {WIDE_BATCH} on {card}")
            check(d.max().item() <= 1 and same >= 0.999, f"pixel replay vs eager: {d.max().item()} levels, {same}")
            del px, a, b, e
            torch.cuda.empty_cache()

            sd = deploy.load_sd_decompressor(out / "sd.torchprog")
            sd_params = (ckpt.unet_state_dict(ckpt.read_checkpoint(sd_dir / "unet.pt")),
                         ckpt.vae_state_dict(ckpt.read_checkpoint(sd_dir / "vae.pt")),
                         ckpt.adapter_state_dict(ckpt.read_checkpoint(sd_dir / "adapter.pt")))
            zs = z[:1]
            t0 = time.perf_counter()
            g5 = sd(*sd_params, zs, seed=seed, guidance_scale=SD_GUIDANCE)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            graph = sd.graph
            reset_sd_launches(attn, mlp)
            g5b = sd(*sd_params, zs, seed=seed, guidance_scale=SD_GUIDANCE)
            n_sd = {k: sd_launches(attn, mlp)[k] for k in ("flash_attention", "transformer_mlp", "mlp_up", "mlp_down")}
            g2 = sd(*sd_params, zs, seed=seed, guidance_scale=2.0)
            n_mlp = INV_STEPS * SD_MLP_PER_FORWARD
            want_sd = {"flash_attention": INV_STEPS * SD_FLASH_PER_FORWARD + 1, "transformer_mlp": n_mlp,
                       "mlp_up": n_mlp, "mlp_down": n_mlp}
            from clip_codec_tpu_torch.probes.mlp_times import unet_mlp_shapes

            want_mlp = {("mlp_up", shape): c * INV_STEPS for shape, c in unet_mlp_shapes(2)}
            sd_shapes = {k: v for k, v in captured.items() if k[0] in ("mlp_up", "flash_attention")}
            print(f"serve-replay: SD capture + first replay {first:.3f} s on {card}; a replay launched {n_sd}; "
                  f"recorded by shape {sd_shapes}")
            check(n_sd == want_sd, f"SD launches a replay {n_sd} != {want_sd}")
            check({k: v for k, v in sd_shapes.items() if k[0] == "mlp_up"} == want_mlp, f"MLP by shape {sd_shapes}")
            check(sd.graph is graph, "a guidance value recaptured the SD graph")
            check(torch.equal(g5, g5b), "two SD replays of one seed differ")
            check(not torch.equal(g5, g2), "guidance 2 replays guidance 5's image")
            x_T = torch.randn(sd.latent_shape(), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
            sd_rel = {}
            for g, got in ((SD_GUIDANCE, g5), (2.0, g2)):
                t0 = time.perf_counter()
                e = sd.sample(sd.decoder, zs, x_T, g)
                torch.cuda.synchronize()
                sd_eager_s = time.perf_counter() - t0
                sd_rel[g] = ((got - e).norm() / e.norm()).item()
            sd_ms = cuda_ms(torch, lambda: sd(*sd_params, zs, seed=seed, guidance_scale=SD_GUIDANCE), iters=1, warmup=0)
            print(f"serve-replay: SD vs eager from the same latent ||delta||/||eager|| {sd_rel}; a call {sd_ms:.3f} "
                  f"ms device, eager {sd_eager_s:.3f} s wall (ddim-{INV_STEPS}, CFG batched, {SD_SIZE}px) on {card}")
            check(all(r < 2e-2 for r in sd_rel.values()), f"SD replay vs eager {sd_rel}")
            check(bool(torch.isfinite(g5).all().item()) and tuple(g5.shape) == (1, SD_SIZE, SD_SIZE, 3),
                  f"SD image {tuple(g5.shape)}")
            del sd, g5, g5b, g2, e
            torch.cuda.empty_cache()

            # 20c: the server on 127.0.0.1, every endpoint (counts from 0 just before it starts)
            reset_launches(rc)
            reset_sd_launches(attn, mlp)
            captured.clear()
            t0 = time.perf_counter()
            srv = serve.serve(str(store), weights=str(px_weights), port=0, artifact=str(out / "decoder.torchprog"),
                              batch_wait_ms=ART_WAIT_MS, sd_artifact=str(out / "sd.torchprog"),
                              adapter=str(sd_dir / "adapter.pt"))
            print(f"serve-http: started (both artifacts loaded and captured) in {time.perf_counter() - t0:.2f} s "
                  f"on {card}")
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                launches = _serve_http(torch, srv.server_address, store, card, px_ms, sd_ms, rc, attn, mlp)
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join()
    finally:
        rc._launch, attn._launch, mlp._launch_up = saved
    by_shape = collections.Counter()
    replays = launches.pop("replays")
    for (name, shape), c in captured.items():
        by_shape[(name, shape)] = c * replays["sd" if name in ("flash_attention", "mlp_up") else "pixel"]
    launches["artifact_by_shape"] = by_shape
    del srv
    torch.cuda.empty_cache()
    return launches


def _serve_http(torch, addr, store, card, px_ms, sd_ms, rc, attn, mlp):
    """20c's requests, each status and shape checked; returns the launches
    and the sampler runs of each program."""
    import io as _io

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch.codecs.quantizer import dequantize_l2norm_host
    from clip_codec_tpu_torch.io.store import Store
    from clip_codec_tpu_torch.probes.serve_times import drive, percentiles, request

    def http(addr, method, path, body=None, headers=None):
        return request(addr, path, body, method, headers)[:3]

    view = Store.open(store)
    manifest = json.loads((store / "manifest.json").read_text())
    frames = [Path(r["bitstream"]).read_bytes() for r in manifest]
    status, _, data = http(addr, "GET", "/healthz")
    check((status, json.loads(data)) == (200, {"status": "ok", "dim": 512}), f"/healthz {status} {data[:200]!r}")

    # 64 concurrent /decompress from 32 clients
    dt, lat, res = drive(addr, "/decompress", [frames[i % len(frames)] for i in range(ART_REQUESTS)], ART_CLIENTS)
    for status, _, body, _ in res:
        check(status == 200 and Image.open(_io.BytesIO(body)).size == (SIZE, SIZE), f"/decompress {status}")
    stats = json.loads(http(addr, "GET", "/stats")[2])
    mb = stats["micro_batch"]
    p50, p95 = percentiles(lat)
    print(f"serve-http: {ART_REQUESTS} /decompress from {ART_CLIENTS} clients (DDIM-{STEPS}, {SIZE}px, micro-batch "
          f"{WIDE_BATCH}, gather {ART_WAIT_MS} ms) in {dt:.3f} s = {ART_REQUESTS / dt:.3f} img/s; latency p50 "
          f"{p50:.3f} s p95 {p95:.3f} s; {mb['calls']} replays, fill rate {mb['fill_rate']} on {card}")
    check(mb["batch_size"] == WIDE_BATCH and 0 < mb["fill_rate"] <= 1 and mb["calls"] >= ART_REQUESTS // WIDE_BATCH,
          f"micro-batch stats {mb}")
    lone = [http(addr, "POST", "/decompress", frames[0]) for _ in range(2)]
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        lone.append(http(addr, "POST", "/decompress", frames[1]))
        walls.append(time.perf_counter() - t0)
    check(all(r[0] == 200 for r in lone), "lone /decompress")
    print(f"serve-http: a lone /decompress {min(walls):.3f} s wall; the replay's call {px_ms / 1e3:.3f} s device: "
          f"busy {px_ms / 1e3 / min(walls):.3f} of the request on {card}")

    # 3 /decompress_sd: seeds 0, 1, 0
    sd_out, sd_walls = [], []
    for s in (0, 1, 0):
        t0 = time.perf_counter()
        sd_out.append(http(addr, "POST", f"/decompress_sd?seed={s}&guidance={SD_GUIDANCE}", frames[2]))
        sd_walls.append(time.perf_counter() - t0)
    for status, ctype, body in sd_out:
        check(status == 200 and ctype == "image/png" and Image.open(_io.BytesIO(body)).size == (SD_SIZE, SD_SIZE),
              f"/decompress_sd {status} {body[:200]!r}")
    check(sd_out[0][2] == sd_out[2][2] and sd_out[0][2] != sd_out[1][2], "/decompress_sd seeds")
    print(f"serve-http: 3 /decompress_sd (ddim-{INV_STEPS}, CFG batched, guidance {SD_GUIDANCE}, {SD_SIZE}px) "
          f"{[round(w, 4) for w in sd_walls]} s; the replay's call {sd_ms / 1e3:.3f} s device: busy "
          f"{sd_ms / 1e3 / min(sd_walls):.3f} of the fastest request on {card}")

    # /embed, /search, /search_image on the store
    status, _, data = http(addr, "POST", "/embed", frames[5])
    emb = np.array(json.loads(data)["embedding"], np.float32) if status == 200 else None
    ref = dequantize_l2norm_host(view.read_codes()[5:6], view.scale, view.zero)[0]
    check(status == 200 and emb.shape == (512,) and float(np.abs(emb - ref).max()) <= 1e-6,
          f"/embed {status} {data[:200]!r}")
    status, _, data = http(addr, "GET", "/search?q=a%20photo%20of%20a%20cat&k=10")
    hits = json.loads(data).get("results", [])
    images = {r["image"] for r in manifest}
    check(status == 200 and len(hits) == 10 and all(h["path"] in images for h in hits), f"/search {status} {data[:300]!r}")
    status, _, data = http(addr, "POST", "/search_image?k=5", frames[5])
    hits = json.loads(data).get("results", [])
    check(status == 200 and len(hits) == 5 and hits[0]["path"] == manifest[5]["image"] and hits[0]["score"] > 0.999,
          f"/search_image .clp {status} {data[:300]!r}")
    status, _, data = http(addr, "POST", "/search_image?k=10", Path(manifest[3]["image"]).read_bytes())
    check(status == 200 and len(json.loads(data)["results"]) == 10, f"/search_image png {status} {data[:300]!r}")

    # the error paths
    errors = {
        "seed in micro-batched mode": (http(addr, "POST", "/decompress?seed=1", frames[0]), 400, "seed is per-program"),
        "bad frame": (http(addr, "POST", "/embed", b"garbage"), 400, "Bad magic"),
        "bad format": (http(addr, "POST", "/decompress?format=gif", frames[0]), 400, "unknown format"),
        "unknown endpoint": (http(addr, "GET", "/nope"), 404, "unknown endpoint"),
        "pixel statics": (http(addr, "POST", "/decompress?steps=10", frames[0]), 412, "statics mismatch"),
        "sd statics": (http(addr, "POST", "/decompress_sd?sampler=dpmpp", frames[0]), 412, "statics mismatch"),
        "body too large": (http(addr, "POST", "/embed", headers={"Content-Length": str(1 << 31)}), 413, "limit"),
    }
    for what, ((status, _, data), want, text) in errors.items():
        err = json.loads(data).get("error", "")
        check(status == want and text in err, f"{what}: {status} {err!r}, want {want} with {text!r}")
    body = json.loads(errors["pixel statics"][0][2])
    check(body["requested"] == {"steps": "10"} and body["artifact"] == {"steps": STEPS}, f"412 body {body}")
    print(f"serve-http: /healthz, /embed, /search, /search_image (.clp and png), 400 x3, 404, 412 x2, 413 all as "
          f"expected; /stats {json.loads(http(addr, 'GET', '/stats')[2])}")

    stats = json.loads(http(addr, "GET", "/stats")[2])
    replays = {"pixel": 1 + stats["micro_batch"]["calls"], "sd": 1 + len(sd_out)}  # + the start-up call
    launches = {"affine_silu_conv3x3": rc.affine_silu_conv3x3.launches, "affine_conv3x3": rc.affine_conv3x3.launches,
                **sd_launches(attn, mlp)}
    # each program ran its sampler once eagerly (the warm-up before its capture), then replayed
    want = {"affine_silu_conv3x3": 28 * STEPS * (1 + replays["pixel"]), "affine_conv3x3": STEPS * (1 + replays["pixel"]),
            "flash_attention": (INV_STEPS * SD_FLASH_PER_FORWARD + 1) * (1 + replays["sd"])}
    want.update({k: INV_STEPS * SD_MLP_PER_FORWARD * (1 + replays["sd"])
                 for k in ("transformer_mlp", "mlp_up", "mlp_down")})
    got = {k: launches[k] for k in want}
    print(f"serve-http: launches {got} ({replays} replays after one eager warm-up each) on {card}")
    check(got == want, f"HTTP run launches {got} != {want}")
    return {**got, "replays": {k: 1 + v for k, v in replays.items()},
            "times": {"img_s": ART_REQUESTS / dt, "p50": p50, "p95": p95, "px_ms": px_ms, "sd_ms": sd_ms,
                      "sd_walls": sd_walls}}


# ------------------------------------------------------------ the DINOv2 front end (phase 21)


def _dino_tower_file(torch, seed, path: Path) -> None:
    """A random DINOv2 ViT-B/14 (``encoders.dino.init_params`` from ``seed``)
    saved under HuggingFace ``Dinov2Model`` names, as a released file is read."""
    from clip_codec_tpu_torch.encoders.dino import DINOV2_BASE, DinoV2, init_params
    from clip_codec_tpu_torch.weights.convert_dino import dino_state_dict_to_hf

    model = init_params(DinoV2(DINOV2_BASE), torch.Generator().manual_seed(seed))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dino_state_dict_to_hf(model.state_dict()), path)


def phase_dino_encode(torch, seed, dev, card):
    """21a: the tower in bf16 against fp32; cli.encode_images_dino over phase
    16's images (bf16, batch 16) with its store's checks; the encode's times.
    Returns the tower file."""

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch import encoders
    from clip_codec_tpu_torch.cli import encode_images_dino
    from clip_codec_tpu_torch.encoders import _batched_encode
    from clip_codec_tpu_torch.encoders.dino import DINOV2_BASE, dino_flops, preprocess_dino
    from clip_codec_tpu_torch.io import store as store_mod

    root = ROOT / "build" / "chip_smoke" / "dino"
    weights, store, images = root / "dinov2_vitb14_hf.pt", root / "store", ROOT / "build" / "chip_smoke" / "compress" / "images"
    t0 = time.perf_counter()
    _dino_tower_file(torch, seed + 24, weights)
    print(f"dino: random DINOv2 ViT-B/14 (encoders.dino.init_params, seed {seed + 24}) saved under HF Dinov2Model "
          f"names in {time.perf_counter() - t0:.3f} s")
    shutil.rmtree(store, ignore_errors=True)
    have_zstd = frame_engine("dino-encode")
    made, written = [], []
    real_encoder, real_write = encoders.DinoEncoder, store_mod.write_store

    def encoder(**kw):
        made.append(real_encoder(**kw))
        return made[-1]

    def write(*a, **kw):
        written.append((a, kw))
        return real_write(*a, **kw)

    encoders.DinoEncoder, store_mod.write_store = encoder, write
    try:
        with raw_frames(have_zstd):
            t0 = time.perf_counter()
            encode_images_dino.main(["--img_dir", str(images), "--out_dir", str(store), "--weights", str(weights)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            codes = store_mod.Store.open(store).read_codes()
    finally:
        encoders.DinoEncoder, store_mod.write_store = real_encoder, real_write
    enc = made[0]
    check(enc.model.dtype == torch.bfloat16 and enc.device.type == "cuda", "the DINO CLI's tower is not bf16 on the card")
    (_, feats, kept, scale, zero, q), kw = written[0][0][:6], written[0][1]
    norms = np.linalg.norm(feats, axis=1)
    print(f"dino-cli: {len(kept)} of {CLIP_IMAGES + 1} files encoded (batch {DINO_BATCH}, bf16, ViT-B/14 at 518px: "
          f"{-(-len(kept) // DINO_BATCH)} batches, the last padded) and stored in {cli_s:.3f} s (weights load "
          f"included); |norm - 1| max {np.abs(norms - 1).max():.3e}")
    check(len(kept) == CLIP_IMAGES and all("corrupt" not in p for p in kept), "the corrupt file was not skipped")
    check(bool(np.isfinite(feats).all()) and float(np.abs(norms - 1).max()) < 1e-3, "embeddings not finite and unit")
    rng_ = np.maximum(feats.max(0) - feats.min(0), np.float32(1e-6))  # the DINO writer's eps
    check(np.array_equal(np.asarray(scale).view(np.uint32), (rng_ / np.float32(255)).view(np.uint32))
          and np.array_equal(np.asarray(zero).view(np.uint32), feats.min(0).view(np.uint32)),
          "fit_affine(eps=1e-6)'s scale and zero are not bit-equal to numpy's")
    want_q = np.clip(np.round((feats - zero) / scale), 0, 255).astype(np.uint8)
    check(np.array_equal(q, want_q) and np.array_equal(codes, q),
          f"codes differ from numpy's in {int((q != want_q).sum())} places")
    dim = np.load(store / "codec_meta.npz")["dim"]
    check(kw == {"dim_dtype": "int64"} and dim.dtype == np.int64 and dim.shape == () and int(dim) == 768,
          f"codec_meta.npz dim {dim!r} ({dim.dtype}), not an int64 768")
    print(f"dino-codes: codebook (eps 1e-6) and {q.size} codes bit-equal to numpy (IEEE divide, round half to "
          f"even); codec_meta.npz dim {int(dim)} as {dim.dtype} shape {dim.shape}")

    # bf16 against fp32 on the same 518px inputs
    pix = np.stack([preprocess_dino(np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0)
                    for p in kept[:DINO_BATCH]])
    f32 = real_encoder(weights_path=str(weights), dtype=torch.float32, device=dev)
    stds = []
    hooks = [blk.register_forward_hook(lambda m, a, out: stds.append(float(out.float().std())))
             for blk in f32.model.encoder.resblocks]
    z32 = f32.embed_images(torch.from_numpy(pix)).cpu().numpy()
    for h in hooks:
        h.remove()
    zbf = enc.embed_images(torch.from_numpy(pix)).cpu().numpy()
    rel = float((np.linalg.norm(zbf - z32, axis=1) / np.linalg.norm(z32, axis=1)).max())
    print(f"dino-dtypes: std of the residual stream after each of the 12 blocks (fp32): "
          f"{[round(v, 3) for v in stds]}; bf16 vs fp32 tower max row ||delta||/||fp32|| {rel:.4e}; CLI rows vs "
          f"bf16 re-encode max |delta| {float(np.abs(feats[:DINO_BATCH] - zbf).max()):.3e}")
    check(all(0.05 < v < 20 for v in stds), "the random tower's activations are not O(1)")
    check(rel < 2e-2, f"bf16 embeddings {rel} from fp32 (limit 2e-2)")
    del f32

    # time: host preprocess per image; preprocessed arrays -> embeddings; the tower's device time
    t0 = time.perf_counter()
    pre = [preprocess_dino(np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0) for p in kept]
    pre_ms = (time.perf_counter() - t0) / len(kept) * 1e3
    embed = lambda x: enc.embed_images(torch.from_numpy(x)).cpu().numpy()
    _batched_encode(pre, lambda a: a, embed, DINO_BATCH, 768)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _batched_encode(pre, lambda a: a, embed, DINO_BATCH, 768)
        walls.append(time.perf_counter() - t0)
    x = torch.from_numpy(pix).to(dev)
    with torch.no_grad():
        fwd = lambda: enc.model(x)
        g_ms = graph_ms(torch, fwd)
        e_ms = cuda_ms(torch, fwd)
    flops = dino_flops(DINOV2_BASE, DINO_BATCH)
    print(f"dino-time: PIL open + decode + bilinear resize to 518 + normalize {pre_ms:.3f} ms per image (host); "
          f"preprocessed arrays -> embeddings, {len(kept)} images in {-(-len(kept) // DINO_BATCH)} batches of "
          f"{DINO_BATCH}: {[round(w, 5) for w in walls]} s = {len(kept) / min(walls):.1f} img/s; the tower's forward "
          f"at B={DINO_BATCH}: {g_ms:.4f} ms device (CUDA-graph replay), {e_ms:.4f} ms (events); "
          f"{flops / 1e9:.1f} GFLOP (dino_flops) over 989 TFLOP/s = {flops / BF16_FLOPS_PER_S * 1e3:.4f} ms bound, "
          f"{flops / g_ms / 1e9:.1f} TFLOP/s achieved, on {card}")
    del enc, made, pre
    torch.cuda.empty_cache()
    return weights


def phase_dino_train(torch, attn, mlp, seed, dev, card, weights, s_step_clip):
    """21b: phase 11's images through the DINO CLI and cli.precompute_latents;
    the adapter's gradient with both terms on (kernel, plain, fp32 plain) at
    two seeds; s/step with the terms on; cli.train_sd for 2 epochs with both
    variables set. Returns the store, the final adapter and the CLI's launches."""

    import numpy as np

    from clip_codec_tpu_torch.cli import encode_images_dino, precompute_latents, train_sd
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.encoders import DinoEncoder
    from clip_codec_tpu_torch.encoders.dino import DinoV2
    from clip_codec_tpu_torch.eval.lpips import LPIPS, LPIPSModel
    from clip_codec_tpu_torch.models import init_params
    from clip_codec_tpu_torch.models.sd import SDClipAdapter, StableDiffusionDecoder
    from clip_codec_tpu_torch.train import sd_diffusion_train as tr

    build = ROOT / "build" / "chip_smoke"
    sd_dir, store, lp_file = build / "sd", build / "dino" / "train", build / "eval" / "lpips_vgg.pt"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    for i in range(TRAIN_IMAGES):  # phase 11's images
        shutil.copy(build / "train" / f"img{i}.png", store / f"img{i}.png")
    have_zstd = frame_engine("dino-train")
    env = {"CLIP_CODEC_SD_UNET_WEIGHTS": str(sd_dir / "unet.pt"), "CLIP_CODEC_SD_VAE_WEIGHTS": str(sd_dir / "vae.pt"),
           "CLIP_CODEC_DINO_WEIGHTS": str(weights), "CLIP_CODEC_LPIPS_WEIGHTS": str(lp_file)}
    with raw_frames(have_zstd), mock.patch.dict(os.environ, env):
        encode_images_dino.main(["--img_dir", str(store), "--out_dir", str(store)])
        reset_sd_launches(attn, mlp)
        precompute_latents.main(["--store_dir", str(store), "--size", str(SD_SIZE)])
        n_pre = sd_launches(attn, mlp)["flash_attention"]
    print(f"dino-train-store: {TRAIN_IMAGES} images through cli.encode_images_dino (dim 768) and "
          f"cli.precompute_latents at {SD_SIZE}px; flash launches {n_pre}")
    check(n_pre == TRAIN_IMAGES // TRAIN_BATCH, f"precompute launched flash {n_pre} times")

    unet, vae = cli.load_frozen(sd_dir / "unet.pt", sd_dir / "vae.pt", dev, heads=8)
    with torch.device(dev):
        adapter = SDClipAdapter(768, unet.cfg.cross_dim, 1024, 8)
    init_params(adapter, torch.Generator(device=dev).manual_seed(seed + 25))
    dec = StableDiffusionDecoder(unet, vae, adapter)
    dino = DinoEncoder(weights_path=str(weights), device=dev).model
    lp = LPIPSModel.from_checkpoint(lp_file, dev).model
    step = tr.make_sd_train_step(dec, tr.make_optimizer(adapter, 1e-4), tr.SDTrainConfig(), dino=dino, lpips=lp)

    def batch(s, B):
        gen = torch.Generator(device=dev).manual_seed(s)
        z = torch.nn.functional.normalize(torch.randn((B, 768), generator=gen, device=dev), dim=-1)
        lat0, noise = (torch.randn((B, 64, 64, 4), generator=gen, device=dev) for _ in range(2))
        t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
        gt = torch.rand((B, 256, 256, 3), generator=gen, device=dev) * 2 - 1  # the default out_size
        return z, lat0, torch.ones(B, device=dev), t, noise, gt

    for s in (seed, seed + 1):
        z, lat0, w, t, noise, gt = batch(s + 26, 1)

        def grad():
            adapter.zero_grad(set_to_none=True)
            loss = step.loss_fn(z, lat0, w, t, noise, gt_img=gt, perc_on=True)
            loss.backward()
            return loss.item(), _grad_vector(torch, adapter)

        reset_sd_launches(attn, mlp)
        loss_k, g_k = grad()
        n = sd_launches(attn, mlp)
        with plain_sd_kernels(attn, mlp):
            loss_p, g_p = grad()
            unet.compute_dtype = vae.compute_dtype = dino.dtype = torch.float32
            try:
                loss_32, g_32 = grad()
            finally:
                unet.compute_dtype = vae.compute_dtype = dino.dtype = torch.bfloat16
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"dino-train-grad: seed {s} SD-1.5 64x64 latent B=1 t={int(t.item())} clip_w 0.1 (DINOv2 at 518), "
              f"perc_w 0.1 (LPIPS at 512): loss(kernel, plain, fp32)=({loss_k:.6f}, {loss_p:.6f}, {loss_32:.6f}) "
              f"rel(g_kernel, g_plain)={rel(g_k, g_p):.3e} to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) "
              f"ratio={rk / rp:.4f} launches={n}")
        check(bool(torch.isfinite(g_k).all().item()) and g_k.norm().item() > 0, "adapter gradient not finite or zero")
        check(rk <= FP32_RATIO * rp, f"adapter gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check(n == TRAIN_LAUNCHES, f"one loss and backward launched {n}, expected {TRAIN_LAUNCHES}")

    # steady-state steps at batch 4 with the terms on, LPIPS on and off
    b4 = batch(seed + 28, TRAIN_BATCH)
    s_step = {}
    for on in (False, True):
        losses = [step(*b4, perc_on=on) for _ in range(2)]  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            losses.append(step(*b4, perc_on=on))
        torch.cuda.synchronize()
        s_step[on] = (time.perf_counter() - t0) / 3
        check(all(bool(torch.isfinite(v).item()) for v in losses), "training loss not finite")
    print(f"dino-train-step: batch {TRAIN_BATCH}, SD-1.5 {SD_SIZE}px, DINO term on: {s_step[False]:.4f} s per step, "
          f"with LPIPS too {s_step[True]:.4f} s (3 synchronized steps each), beside phase 11's "
          f"{s_step_clip:.4f} s without the terms, on {card}")
    del dec, unet, vae, adapter, dino, lp, step, b4
    torch.cuda.empty_cache()

    # the CLI: 2 epochs at batch 4, LPIPS every 2nd step
    seen, start = [], {}
    make = tr.make_sd_train_step

    def recording(decoder, optimizer, cfg, ema=None, dino=None, lpips=None):
        start.update({k: v.detach().clone() for k, v in decoder.adapter.state_dict().items()})
        fn = make(decoder, optimizer, cfg, ema, dino=dino, lpips=lpips)

        def wrapped(*a):
            loss = fn(*a)
            seen.append((isinstance(dino, DinoV2) and dino.dtype == torch.bfloat16, isinstance(lpips, LPIPS),
                         tuple(a[5].shape), a[6], loss))
            return loss

        return wrapped

    out = store / "out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tr.make_sd_train_step = recording
    try:
        with raw_frames(have_zstd), mock.patch.dict(os.environ, env):
            reset_sd_launches(attn, mlp)
            t0 = time.perf_counter()
            train_sd.main(["--store_dir", str(store), "--epochs", str(TRAIN_EPOCHS), "--batch_size",
                           str(TRAIN_BATCH), "--perc_every", "2", "--save_dir", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = sd_launches(attn, mlp)
    finally:
        tr.make_sd_train_step = make
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    final = out / "sd_adapter_final.pt"
    trained = torch.load(final, map_location="cpu", weights_only=True)
    changed = max((trained[k] - v.cpu()).abs().max().item() for k, v in start.items())
    losses = [float(r[4]) for r in seen]
    print(f"dino-train: cli.train_sd, {TRAIN_EPOCHS} epochs x {TRAIN_IMAGES // TRAIN_BATCH} steps at batch "
          f"{TRAIN_BATCH}, --perc_every 2, both variables set: {wall:.3f} s in all (weights load and checkpoints "
          f"included), peak device memory {peak:.2f} GiB on {card}; losses {[round(v, 6) for v in losses]}; LPIPS "
          f"on {[r[3] for r in seen]}; adapter max change {changed:.3e}; launches={launches}")
    check(len(seen) == steps and all(r[0] and r[1] and r[2] == (TRAIN_BATCH, 256, 256, 3) for r in seen),
          "the CLI's steps did not get the bf16 DINO tower, LPIPS and the 256px images")
    check([r[3] for r in seen] == [i % 2 == 0 for i in range(steps)], "LPIPS did not run on every 2nd step")
    check(all(np.isfinite(losses)), "training loss not finite")
    check(changed > 0, "the adapter did not change")
    check(launches == want, f"training launches {launches} != {want}")
    return store, final, launches


def phase_dino_inversion(torch, attn, mlp, seed, dev, card, weights, store, final, clip_times):
    """21c: one guided step's latent gradient through the DINO backend
    (kernel, plain, fp32 plain) at two seeds; the SD CLI at its default
    flags on a frame of 21b's store (auto -> dino); s/request, busy share,
    peak memory. Returns the request's launches."""

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding
    from clip_codec_tpu_torch.encoders import DinoEncoder
    from clip_codec_tpu_torch.models.sd.decoder import sd_step_coefficients

    sd_dir = ROOT / "build" / "chip_smoke" / "sd"
    t_start = time.perf_counter()
    dec = cli.load_decoder(sd_dir / "unet.pt", sd_dir / "vae.pt", final, dev, heads=8)  # 21b's adapter
    check(dec.adapter.proj[1].in_features == 768, "the trained adapter does not take 768-d embeddings")
    dino = DinoEncoder(weights_path=str(weights), device=dev).model
    embed = cli.dino_embed_fn(dino)
    _, co = sd_step_coefficients(INV_STEPS)
    i = INV_STEPS // 2
    for s in (seed, seed + 1):
        g = torch.Generator(device=dev).manual_seed(s + 27)
        lat, eps = (torch.randn((1, 64, 64, 4), generator=g, device=dev) for _ in range(2))
        z = torch.nn.functional.normalize(torch.randn((1, 768), generator=g, device=dev), dim=-1)

        def grad():
            return dec.inversion_grad(lat, eps, float(co["c_noise"][i]), float(co["c_x0"][i]), embed, z).flatten()

        reset_sd_launches(attn, mlp)
        g_k = grad()
        n = sd_launches(attn, mlp)
        with plain_sd_kernels(attn, mlp):
            g_p = grad()
            dec.vae.compute_dtype = dino.dtype = torch.float32
            try:
                g_32 = grad()
            finally:
                dec.vae.compute_dtype = dino.dtype = torch.bfloat16
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"dino-inv-grad: seed {s} SD-1.5 VAE + DINOv2 ViT-B/14, 64x64 latent B=1, step {i} of "
              f"ddim-{INV_STEPS}: rel(g_kernel, g_plain)={rel(g_k, g_p):.3e} to_fp32(kernel, plain)=({rk:.3e}, "
              f"{rp:.3e}) ratio={rk / rp:.4f} launches={n}")
        check(bool(torch.isfinite(g_k).all().item()) and g_k.norm().item() > 0, "latent gradient not finite or zero")
        check(rk <= FP32_RATIO * rp, f"latent gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check((n["flash_attention"], n["flash_attention_bwd_dq"], n["flash_attention_bwd_dkv"]) == (1, 1, 1),
              f"one guided step's gradient launched {n}")
    print(f"dino-inv-grad: loads and both seeds in {time.perf_counter() - t_start:.1f} s")

    # the CLI at its default flags on the first frame of 21b's store: dim 768, so auto -> dino
    have_zstd = frame_engine("dino-inversion")
    frame = Path(json.loads((store / "manifest.json").read_text())[0]["bitstream"])
    out = frame.with_name(f"{frame.stem}-{INV_STEPS}-5-1.png")
    out.unlink(missing_ok=True)
    env = {"CLIP_CODEC_SD_UNET_WEIGHTS": str(sd_dir / "unet.pt"), "CLIP_CODEC_SD_VAE_WEIGHTS": str(sd_dir / "vae.pt"),
           "CLIP_CODEC_DINO_WEIGHTS": str(weights)}
    with raw_frames(have_zstd), mock.patch.dict(os.environ, env):
        os.environ.pop("CLIP_CODEC_CLIP_WEIGHTS", None)  # the dino backend needs no CLIP tower
        z = decode_embedding(frame, store)
        torch.cuda.synchronize()
        reset_sd_launches(attn, mlp)
        t0 = time.perf_counter()
        cli.main(["--store_dir", str(store), "--bitstream", str(frame), "--adapter", str(final)])
        cli_s = time.perf_counter() - t0
    launches = sd_launches(attn, mlp)
    png = np.asarray(Image.open(out))
    print(f"dino-inv-cli: reconstruct_sd_diffusion.main at its default flags (ddim-{INV_STEPS}, guidance 5, "
          f"inv_weight 1 every step, backend auto -> dino at dim {z.shape[1]}, 512px)"
          f"{'' if have_zstd else ' from a raw-code frame (no zstd engine)'}: {out.name} {png.shape} in {cli_s:.3f} s "
          f"(weights load included) on {card}; launches={launches}")
    check(z.shape == (1, 768) and cli.resolve_backend("auto", z.shape[1]) == "dino", f"dim {z.shape}")
    check(png.shape == (SD_SIZE, SD_SIZE, 3) and int(png.max()) > int(png.min()), f"{out.name}: {png.shape}")
    check(launches == INV_LAUNCHES, f"inversion request launches {launches} != {INV_LAUNCHES}")

    run = lambda: cli.sample_images(dec, z, SD_SIZE, steps=INV_STEPS, guidance=SD_GUIDANCE, seed=seed,
                                    inv_weight=1.0, embed_fn=embed)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        img = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(img.float()).all().item()), "non-finite image")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    busy = device_ms(torch, run) / 1e3 / min(times)
    prof_s = time.perf_counter() - t0
    check(busy > 0, "the profiler saw no device time")
    print(f"dino-inv-time: request of 1 embedding, ddim-{INV_STEPS}, 512px, CFG batched, inv_weight 1 through "
          f"DINOv2 at 518: {[round(t, 4) for t in times]} s, device busy {100 * busy:.1f}%, peak device memory "
          f"{peak:.2f} GiB; phase 17's CLIP backend {[round(t, 4) for t in clip_times['s']]} s, busy "
          f"{100 * clip_times['busy']:.1f}%, peak {clip_times['peak']:.2f} GiB; on {card} (the profiled request "
          f"{prof_s:.1f} s)")
    del dec, dino, embed
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ int8 serving (phase 22)


Q8_KERNELS = ("int8_conv_act", "int8_conv_nhwc", "int8_quantize", "absmax", "group_norm_silu_int8")
Q8_OFF_PATH = ("int8_conv_act",)  # checked and timed in 22a; no model path launches it
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
PX_INT8_LAYERS = 31  # 28 ResBlock convs + 3 downsample convs
# K1's codes-out form at the pixel artifact's four GroupNorm shapes (B = 16, 8 groups): (H, W, C)
GN_INT8_SHAPES = GN_SHAPES
CLIP_TEXT_TOKENS = 77  # to_k/to_v also checked on a CLIP text context
# 22a times these and checks every other shape only: the pixel artifact's seven conv shapes at B = 16, and of SD-1.5
# (64x64 latents, CFG batched) each level's ResBlock 3x3 conv, to_q, the GEGLU projection, the MLP's
# out-projection and to_k on the 8-token context; int8_quantize at their inputs, absmax at the dynamic
# server's (B = 1) conv inputs. Keys: (xq shape, wq shape, stride, padding).
SD_TIMED = {((2, 64, 64, 320), (320, 3, 3, 320), 1, 1), ((2, 32, 32, 640), (640, 3, 3, 640), 1, 1),
            ((2, 16, 16, 1280), (1280, 3, 3, 1280), 1, 1), ((2, 8, 8, 1280), (1280, 3, 3, 1280), 1, 1),
            ((8192, 1, 1, 320), (320, 1, 1, 320), 1, 0), ((8192, 1, 1, 320), (2560, 1, 1, 320), 1, 0),
            ((8192, 1, 1, 1280), (320, 1, 1, 1280), 1, 0), ((16, 1, 1, 768), (320, 1, 1, 768), 1, 0)}


def q8_launches(q8, gn, rc, attn, mlp) -> dict:
    return {"int8_conv_act": q8.int8_conv2d_act.launches, "int8_conv_nhwc": q8.int8_conv2d.launches,
            "int8_quantize": q8.quantize.launches,
            "absmax": q8.absmax.launches, "group_norm_silu": gn.group_norm_silu.launches,
            "group_norm_silu_int8": gn.group_norm_silu_int8.launches,
            "affine_silu_conv3x3": rc.affine_silu_conv3x3.launches, "affine_conv3x3": rc.affine_conv3x3.launches,
            "flash_attention": attn.flash_attention_fwd.launches, "mlp_up": mlp.mlp_up.launches,
            "mlp_down": mlp.mlp_down.launches}


def reset_q8_launches(q8, gn, rc, attn, mlp) -> None:
    for wrapper in (q8.int8_conv2d_act, q8.int8_linear_act, q8.int8_conv2d, q8.quantize, q8.absmax,
                    gn.group_norm_silu, gn.group_norm_silu_int8):
        wrapper.launches = 0
    reset_launches(rc)
    reset_sd_launches(attn, mlp)


def q8_forward(layers: int, dynamic: bool = False, k1: int = 0, k3: int = 0, k4: int = 0,
               codes_out: int = 0) -> dict:
    """The launches of one int8 forward: a conv per int8 layer on codes from
    a quantize pass (and an absmax when dynamic) or, for ``codes_out`` of
    them, from K1's codes-out form; K1 and K3 in the pixel U-Net, K4 in the
    SD UNet's self-attention, never the act form, K2 or K6."""
    return {"int8_conv_act": 0, "int8_conv_nhwc": layers, "int8_quantize": layers - codes_out,
            "absmax": layers if dynamic else 0, "group_norm_silu_int8": codes_out,
            "group_norm_silu": k1, "affine_silu_conv3x3": 0, "affine_conv3x3": k3, "flash_attention": k4,
            "mlp_up": 0, "mlp_down": 0}


def combined(*terms) -> dict:
    """Sum of (launch dict, count) terms, key by key."""
    out = {}
    for d, n in terms:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v * n
    return out


@contextlib.contextmanager
def q8_tally(torch, q8, gn):
    """The int8 kernels' launches by shape: the conv by (xq shape, wq shape,
    stride, padding), the act form by (x shape, wq shape, stride, padding,
    x's dtype), quantize and absmax by x's shape as (rows, channels), K1's
    codes-out form by x's shape. Eager launches land in ["eager"], calls a
    CUDA-graph capture records in ["captured"] (``fold_captured`` multiplies
    them by the replays)."""
    tally = {"eager": collections.Counter(), "captured": collections.Counter()}
    saved = q8._launch_conv, q8._launch_quantize, q8._launch_absmax, q8._launch_conv_act, gn._launch_int8

    def counted(fn, key):
        def run(*a):
            tally["captured" if torch.cuda.is_current_stream_capturing() else "eager"][key(*a)] += 1
            return fn(*a)
        return run

    q8._launch_conv = counted(saved[0], lambda xq, wq, *rest: (
        "int8_conv_nhwc", (tuple(xq.shape), tuple(wq.shape), rest[3], rest[4])))
    q8._launch_quantize = counted(saved[1], lambda x, am: ("int8_quantize", rows(x.shape)))
    q8._launch_absmax = counted(saved[2], lambda x: ("absmax", rows(x.shape)))
    q8._launch_conv_act = counted(saved[3], lambda x, am, wq, *rest: (
        "int8_conv_act", (tuple(x.shape), tuple(wq.shape), rest[2], rest[3], dtype_name(x.dtype))))
    gn._launch_int8 = counted(saved[4], lambda x, *rest: ("group_norm_silu_int8", tuple(x.shape)))
    try:
        yield tally
    finally:
        q8._launch_conv, q8._launch_quantize, q8._launch_absmax, q8._launch_conv_act, gn._launch_int8 = saved


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def layer_absmax(q8, layer, x):
    """The layer's calibrated absmax (static), else ``absmax(x)``."""
    am = layer.__dict__.get("_x_absmax")
    return q8.absmax(x) if am is None else am


@contextlib.contextmanager
def two_step_codes(q8):
    """The ResBlocks' static int8 convs as before K1's codes-out form: K1's
    output, then ``int8_quantize`` (``ops.int8.static_absmax`` answering
    None: the dispatch the pixel ResBlocks take while calibrating)."""
    saved = q8.static_absmax
    q8.static_absmax = lambda layer: None
    try:
        yield
    finally:
        q8.static_absmax = saved


@contextlib.contextmanager
def act_form_layers(q8):
    """Every int8 layer through ``ops.int8.conv`` and ``linear`` (the static
    ResBlocks too: ``two_step_codes``), and those through the act form
    (absmax when dynamic, then one ``int8_conv_act_nhwc`` launch a layer),
    for a forward to be held against the paths' forms bit for bit."""
    real_conv, real_linear = q8.conv, q8.linear

    def conv(layer, x, dtype, stride=1, padding=1):
        wq, ws = q8.layer_weight(layer)
        x = x.contiguous()
        return q8.int8_conv2d_act(x, layer_absmax(q8, layer, x), wq, ws, q8._bias(layer), stride, padding, dtype)

    def linear(layer, x, dtype):
        wq, ws = q8.layer_weight(layer)
        x = x.contiguous()
        return q8.int8_linear_act(x, layer_absmax(q8, layer, x), wq, ws, q8._bias(layer), dtype)

    q8.conv, q8.linear = conv, linear
    try:
        with two_step_codes(q8):
            yield
    finally:
        q8.conv, q8.linear = real_conv, real_linear


def rows(shape) -> tuple:
    """An elementwise pass's shape as (rows, channels): a Linear's
    (..., K) input and the conv kernel's (M, 1, 1, K) view of it alike."""
    n = 1
    for d in shape[:-1]:
        n *= d
    return (n, shape[-1])


def fold_captured(tally, replays: int) -> None:
    for key, n in tally["captured"].items():
        tally["eager"][key] += n * replays
    tally["captured"].clear()


def int8_path_shapes(torch, q8, gn, seed, dev):
    """22a's shapes: every int8 conv call of one full-width forward of each
    path (the pixel U-Net at B = 16, the artifact's batch, and at B = 1, the
    dynamic server's; SD-1.5 at 64x64 latents, CFG batched, with the
    adapter's 8-token context), plus to_k/to_v on a 77-token context (check
    only); each forward (dynamic int8) also bit-equal to the same forward
    through the act form (``act_form_layers``). Returns {conv key: (path,
    in the main path?)}."""
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli

    shapes = {}
    net = full_unet(torch, seed, dev)
    net.int8 = True
    sd_dir = ROOT / "build" / "chip_smoke" / "sd"
    unet, vae = cli.load_frozen(sd_dir / "unet.pt", sd_dir / "vae.pt", dev, heads=8, int8=True)
    del vae
    gen = torch.Generator(device=dev).manual_seed(seed + 70)
    runs = [(net, "pixel", (torch.randn((B, SIZE, SIZE, 3), generator=gen, device=dev),
                            torch.randn((B, 512), generator=gen, device=dev),
                            torch.full((B,), 500, dtype=torch.int32, device=dev))) for B in (WIDE_BATCH, 1)]
    runs.append((unet, "sd", (torch.randn((2, 64, 64, 4), generator=gen, device=dev),
                              torch.full((2,), 500, dtype=torch.int32, device=dev),
                              torch.randn((2, 8, 768), generator=gen, device=dev))))
    with torch.no_grad():
        for model, path, args in runs:
            with q8_tally(torch, q8, gn) as tally:
                out = model(*args)
            for (name, key), _ in tally["eager"].items():
                check(name != "int8_conv_act", f"{path}: an act-form launch on the path")
                if name == "int8_conv_nhwc" and key not in shapes:
                    shapes[key] = (path, True)
            with act_form_layers(q8):
                act = model(*args)
            check(torch.equal(out, act), f"{path} int8 forward B={args[0].shape[0]}: the act form != the two-launch "
                  f"form (max |delta| {(out.float() - act.float()).abs().max().item()})")
            convs = sum(n for (k, _), n in tally["eager"].items() if k == "int8_conv_nhwc")
            print(f"int8-kernels: {path} int8 forward B={args[0].shape[0]} (dynamic) through the act form bit-equal "
                  f"to the path's two-launch form ({convs} quantize + conv pairs, "
                  f"{sum(n for (k, _), n in tally['eager'].items() if k == 'absmax')} absmax)")
    ctx_rows = 2 * 8
    for (xs, ws, stride, pad) in list(shapes):
        if xs == (ctx_rows, 1, 1, 768):
            shapes[((2 * CLIP_TEXT_TOKENS, 1, 1, 768), ws, stride, pad)] = ("sd, 77-token context", False)
    del net, unet
    torch.cuda.empty_cache()
    return shapes


def phase_int8_kernels(torch, q8, shapes, seed, dev, card):
    """22a: the kernels against their plain versions, bit for bit, at every
    shape of ``shapes``: the act form (bf16 and fp32 activations, dynamic
    and static at half the absmax: ``quantize_plain`` then
    ``int8_conv2d_plain``), the codes-in conv, each with the int32
    accumulator, the fp32 and bf16 outputs, and the codes and scale in
    dynamic and static mode. At the timed shapes (the pixel artifact's and
    ``SD_TIMED``) each kernel timed (CUDA-graph replay, and events) beside
    its plain version (events) and its bound, the act form beside the
    paths' pair (``int8_quantize`` then the codes-in conv, one graph), the
    GEMMs beside ``torch._int_mm`` and the convs beside cuDNN's bf16 conv
    (for scale). Returns the records."""
    import math

    F = torch.nn.functional
    check(SD_TIMED <= set(shapes), f"SD_TIMED shapes not on the path: {SD_TIMED - set(shapes)}")
    int8_ptxas_report()
    gen = torch.Generator(device=dev).manual_seed(seed + 71)
    recs = {name: [] for name in Q8_KERNELS}
    done = {name: set() for name in Q8_KERNELS}
    for (xs, ws, stride, pad), (path, main) in shapes.items():
        cout, k, _, cin = ws
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, k, k), generator=gen, device=dev) / math.sqrt(cin * k * k)
        bias = 0.1 * torch.randn((cout,), generator=gen, device=dev)
        wq, wsc = q8.quantize_weight(w)
        am, am_p = q8.absmax(x), q8.absmax_plain(x)
        xq, s = q8.quantize(x, am)
        xq_p, s_p = q8.quantize_plain(x, am_p)
        check(torch.equal(am, am_p) and torch.equal(xq, xq_p) and torch.equal(s, s_p),
              f"int8 codes {xs} dynamic: kernel != plain")
        half = am_p * 0.5  # a calibrated absmax below max|x|: codes saturate
        check(all(torch.equal(a, b) for a, b in zip(q8.quantize(x, half), q8.quantize_plain(x, half))),
              f"int8 codes {xs} static: kernel != plain")
        acc_p = q8.int8_conv2d_plain(xq, wq, wsc, s, bias, stride, pad, torch.int32)
        errs = {}
        for dt in (torch.int32, torch.float32, torch.bfloat16):
            got = q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad, dt)
            want = q8._epilogue(acc_p, wsc, s, bias, dt).contiguous()
            errs[str(dt).removeprefix("torch.")] = float((got.double() - want.double()).abs().max().item())
            check(torch.equal(got, want), f"int8 conv {xs} x {ws} s{stride} p{pad} {dt}: kernel != plain {errs}")
        act_errs = check_act_form(torch, q8, x, torch.randn(xs, generator=gen, device=dev), wq, wsc, bias, stride, pad)
        torch.cuda.synchronize()
        timed = (path == "pixel" and xs[0] == WIDE_BATCH) or (xs, ws, stride, pad) in SD_TIMED
        if timed:
            time_conv(torch, q8, F, recs, x, w, xq, wq, wsc, s, bias, stride, pad, acc_p, errs, path, card)
            time_act(torch, q8, recs, x, am, wq, wsc, bias, stride, pad, act_errs, path, card)
        n = x.numel()
        for name, call, plain, lib, nbytes, wanted in (
                ("int8_quantize", lambda: q8.quantize(x, am), lambda: q8.quantize_plain(x, am_p), None, 3 * n, timed),
                ("absmax", lambda: q8.absmax(x), lambda: q8.absmax_plain(x),
                 lambda: torch.linalg.vector_norm(x, float("inf")), 2 * n, path == "pixel" and xs[0] == 1)):
            if not wanted or rows(xs) in done[name]:
                continue
            done[name].add(rows(xs))
            k_ms, k_ev = graph_ms(torch, call, iters=10), cuda_ms(torch, call, iters=10)
            p_ms = cuda_ms(torch, plain, iters=3)
            l_ms = None if lib is None else graph_ms(torch, lib, iters=10)
            qb_ms, qb_by, _ = bound(nbytes, 0.0)
            recs[name].append({"shape": list(rows(xs)), "path": path, "ms": k_ms, "events_ms": k_ev, "plain_ms": p_ms,
                               "bound_ms": qb_ms, "bound_by": qb_by, "library_ms": l_ms, "max_abs_err": 0.0})
            print(f"int8-kernels: {name} {rows(xs)} bf16: ms={k_ms:.4f} (graph) events_ms={k_ev:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={qb_ms:.4f} ({qb_by}) library_ms={l_ms} on {card}")
        del x, w, xq, wq, acc_p
    print(f"int8-kernels: bit-equal to the plain versions at all {len(shapes)} shapes "
          f"({sum(not m for _, m in shapes.values())} check-only): absmax, codes and scale dynamic and static, the "
          f"conv's int32, fp32 and bf16 outputs; the act form's from bf16 and fp32 activations, dynamic and "
          f"static at half the absmax")
    int8_replays(torch, q8, gen, dev)
    torch.cuda.empty_cache()
    return recs


GN_INT8_ABSMAX = {"calibrated": "max|y|", "clamped": "half of max|y|",
                  "pow2": "127 * 2^k <= max|y| (s = 2^k: exact ties)"}


def gn_int8_absmax(torch, y, kind: str):
    """The absmax of a ``GN_INT8_ABSMAX`` kind for K1's output ``y``."""
    am = y.float().abs().amax()
    if kind == "clamped":
        return am * 0.5
    if kind == "pow2":
        return 127.0 * torch.exp2(torch.floor(torch.log2(am / 127.0)))
    return am


def phase_gn_int8(torch, gn, q8, seed, dev, card):
    """22a, K1's codes-out form (``group_norm_silu_int8``) at the pixel
    artifact's four GroupNorm shapes (B = 16, 8 groups), bf16 and fp32, at
    the output's absmax, at half of it (codes clamped) and at the largest
    127 * 2^k under it (s a power of two: many exact ties): one launch, the
    codes and the scale bit-equal to the two-launch form it replaces (K1,
    then ``int8_quantize``) and to ``quantize_plain`` of K1's output; against
    its plain version (K1's plain version, whose SiLU is exact where the
    kernel's is approximate, then ``quantize_plain``) the scale bit-equal and
    the codes within one, the share that differs printed. Two CUDA-graph
    replays bit-equal to the eager call. In bf16 each shape timed (graph
    replay, and events) beside the pair in one graph and K1 alone, its plain
    version (events) and its bound (x read once, the codes written once),
    and again with the pair at the power-of-two s. Returns its records."""
    gen = torch.Generator(device=dev).manual_seed(seed + 73)
    G, recs, worst, worst_pair = GN_GROUPS, [], 0.0, 0
    for H, W, C in GN_INT8_SHAPES:
        shape = (WIDE_BATCH, H, W, C)
        for dtype in (torch.bfloat16, torch.float32):
            x, scale, bias = _gn_inputs(torch, gen, shape, dev, dtype)
            sb = (scale, bias)
            with torch.no_grad():
                y = gn.group_norm_silu(x, sb, G)
                for kind in GN_INT8_ABSMAX:
                    am = gn_int8_absmax(torch, y, kind)
                    half = kind == "clamped"
                    n0 = gn.group_norm_silu_int8.launches, gn.group_norm_silu.launches
                    xq, s = gn.group_norm_silu_int8(x, sb, G, am)
                    torch.cuda.synchronize()
                    tag = f"group_norm_silu_int8 {shape} G={G} {dtype_name(dtype)} absmax {GN_INT8_ABSMAX[kind]}"
                    check((gn.group_norm_silu_int8.launches, gn.group_norm_silu.launches) == (n0[0] + 1, n0[1]),
                          f"{tag}: not one launch of its own")
                    pair_q, pair_s = q8.quantize(y, am)
                    worst_pair = max(worst_pair, int((xq.int() - pair_q.int()).abs().max()))
                    check(torch.equal(xq, pair_q) and torch.equal(s, pair_s),
                          f"{tag}: != K1 then int8_quantize ({int((xq != pair_q).sum())} codes differ)")
                    check(torch.equal(xq, q8.quantize_plain(y, am)[0]), f"{tag}: != quantize_plain of K1's y")
                    plain, plain_s = gn.group_norm_silu_int8_plain(x, sb, G, am)
                    d = (xq.int() - plain.int()).abs()
                    err, share = d.max().item(), d.count_nonzero().item() / d.numel()
                    check(torch.equal(s, plain_s) and err <= 1, f"{tag}: vs its plain version: scale "
                          f"{s.item()} / {plain_s.item()}, codes off by up to {err}")
                    clamped = int((xq.abs() == 127).sum())
                    check(clamped > 0 or not half, f"{tag}: no code clamped at half the absmax")
                    worst = max(worst, float(err))
                    print(f"kernel-check: {tag}: codes and scale bit-equal to K1 + int8_quantize and to "
                          f"quantize_plain(K1's y); vs its plain version the scale bit-equal, codes within {err} "
                          f"(a share {share:.3e} differs: K1's SiLU is approximate), {clamped} codes at +-127")
                    del xq, s, pair_q, pair_s, plain, plain_s, d
                if dtype != torch.bfloat16:
                    continue
                am = y.float().abs().amax()
                call = lambda: gn.group_norm_silu_int8(x, sb, G, am)
                want = call()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side), torch.cuda.graph(graph):
                    got = call()
                torch.cuda.current_stream().wait_stream(side)
                for _ in range(2):
                    got[0].zero_()
                    graph.replay()
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"group_norm_silu_int8 {shape}: a CUDA graph replay differs from the eager call")
                del graph, got, want
                pair = lambda: q8.quantize(gn.group_norm_silu(x, sb, G), am)
                k1 = lambda: gn.group_norm_silu(x, sb, G)
                ms, ev_ms = graph_ms(torch, call), cuda_ms(torch, call)
                pair_ms, k1_ms = graph_ms(torch, pair), graph_ms(torch, k1)
                am2 = gn_int8_absmax(torch, y, "pow2")  # s a power of two: the same work, many exact ties
                ms2 = graph_ms(torch, lambda: gn.group_norm_silu_int8(x, sb, G, am2))
                pair_ms2 = graph_ms(torch, lambda: q8.quantize(gn.group_norm_silu(x, sb, G), am2))
                plain_ms = cuda_ms(torch, lambda: gn.group_norm_silu_int8_plain(x, sb, G, am), iters=3, warmup=1)
            n = x.numel()
            # x read once, the codes written once; K1's 11 operations an element and 5 more for the code
            b_ms, b_by, b_unit = bound(3 * n, 16 * n, FP32_FLOPS_PER_S)
            pl = gn.plan(*shape, G, x.element_size())
            print(f"kernel-time: group_norm_silu_int8 {shape} bf16: ms={ms:.4f} (graph) events_ms={ev_ms:.4f}; "
                  f"the pair it replaces (K1 + int8_quantize, one graph) {pair_ms:.4f} ms = {pair_ms / ms:.3f}x; "
                  f"K1 alone {k1_ms:.4f} ms; at a power-of-two s {ms2:.4f} ms, the pair {pair_ms2:.4f} ms; "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_unit}) "
                  f"pct_of_bound={100 * b_ms / ms:.1f} TBps={3 * n / ms / 1e9:.3f}; two graph replays bit-equal; "
                  f"rounds={pl.rounds} ring={pl.ring} grid={pl.grid} on {card}")
            recs.append({"shape": list(shape), "ms": ms, "events_ms": ev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_unit": b_unit, "library_ms": None,
                         "library": "none; the two-launch form it replaces (K1 + int8_quantize) for scale",
                         "pair_ms": pair_ms, "k1_ms": k1_ms, "pair_over_kernel": pair_ms / ms,
                         "pow2_ms": ms2, "pow2_pair_ms": pair_ms2})
            del x, y
    for rec in recs:
        rec["max_abs_err"] = worst  # in codes, against the plain version; the scale bit-equal
        rec["max_abs_err_vs_pair"] = worst_pair  # in codes, against K1 + int8_quantize
    torch.cuda.empty_cache()
    return {"group_norm_silu_int8": recs}


def check_act_form(torch, q8, x, x32, wq, wsc, bias, stride, pad) -> dict:
    """The act form bit-equal to ``quantize_plain`` then ``int8_conv2d_plain``
    on bf16 ``x`` and fp32 ``x32``, dynamic (absmax of x) and static at half
    of it (codes saturate): int32, fp32 and bf16 out. Returns the largest
    |kernel - plain| by case (0 throughout, or the phase has failed)."""
    errs = {}
    for xa in (x, x32):
        am = q8.absmax(xa)
        for mode, a in (("dynamic", am), ("static", am * 0.5)):
            acc = q8.int8_conv2d_act_plain(xa, a, wq, wsc, bias, stride, pad, torch.int32)
            s = q8.act_scale_plain(a)
            for dt in (torch.int32, torch.float32, torch.bfloat16):
                got = q8.int8_conv2d_act(xa, a, wq, wsc, bias, stride, pad, dt)
                want = q8._epilogue(acc, wsc, s, bias, dt).contiguous()
                tag = f"{dtype_name(xa.dtype)} {mode} {dtype_name(dt)}"
                errs[tag] = float((got.double() - want.double()).abs().max().item())
                check(torch.equal(got, want), f"int8 act form {tuple(x.shape)} x {tuple(wq.shape)} s{stride} p{pad} "
                                              f"{tag}: kernel != plain {errs}")
    return errs


def time_act(torch, q8, recs, x, am, wq, wsc, bias, stride, pad, errs, path, card):
    """One timed act-form record (bf16 activations, the dynamic absmax): the
    kernel (graph replay, events) beside the paths' pair, ``int8_quantize``
    then the codes-in conv in one graph; its plain version (events); its bound
    (the bf16 activation read once); ``torch._int_mm`` on the codes for a GEMM
    (the product alone, for scale) and cuDNN's bf16 conv for a 3x3."""
    xs, (cout, k, _, cin) = tuple(x.shape), wq.shape
    B, H, W, _ = xs
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    M, K = B * ho * wo, k * k * cin
    run = lambda: q8.int8_conv2d_act(x, am, wq, wsc, bias, stride, pad, torch.bfloat16)

    def pair():
        codes, s = q8.quantize(x, am)
        return q8.int8_conv2d(codes, wq, wsc, s, bias, stride, pad, torch.bfloat16)

    ms, ev_ms = graph_ms(torch, run, iters=10), cuda_ms(torch, run, iters=10)
    pair_ms = graph_ms(torch, pair, iters=10)
    plain_ms = cuda_ms(torch, lambda: q8.int8_conv2d_act_plain(x, am, wq, wsc, bias, stride, pad, torch.bfloat16),
                       iters=1, warmup=1)
    b_ms, b_by, _ = bound(2 * x.numel() + wq.numel() + 2 * M * cout + 8 * cout, 2.0 * M * cout * K, INT8_OPS_PER_S)
    codes_rec = recs["int8_conv_nhwc"][-1]  # time_conv's record of the same shape, just made
    pl = q8.int8_conv_plan(B, H, W, cin, cout, k, stride, pad,
                           torch.cuda.get_device_properties(x.device).multi_processor_count, 2)
    plan = {"n_tile": pl.n_width, "rows": pl.rows, "mw": pl.mw, "splits": pl.splits, "swap": pl.swap,
            "units": pl.units, "blocks": pl.blocks, "stages": pl.stages}
    # no one PyTorch call quantizes and convolves: library_ms null, _int_mm (the int32 product of the codes
    # alone) and cuDNN's bf16 conv for scale
    rec = {"shape": [list(xs), list(wq.shape), stride, pad, "bfloat16"], "path": path, "ms": ms, "events_ms": ev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "on_path": False,
           "int_mm_ms": codes_rec["library_ms"], "cudnn_bf16_ms": codes_rec["cudnn_bf16_ms"], "pair_ms": pair_ms,
           "pair_over_act": pair_ms / ms,
           "max_abs_err": max(errs.values()), "max_abs_err_by_case": errs, "tops": 2.0 * M * cout * K / ms / 1e9,
           "plan": plan}
    recs["int8_conv_act"].append(rec)
    print(f"int8-kernels: int8_conv_act {path} x {xs} bf16 w {tuple(wq.shape)} s{stride} p{pad}: ms={ms:.4f} (graph) "
          f"events_ms={ev_ms:.4f} the paths' pair (int8_quantize + int8_conv_nhwc) {pair_ms:.4f} ms = "
          f"{pair_ms / ms:.3f}x plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) _int_mm_ms={rec['int_mm_ms']} "
          f"cudnn_bf16_ms={rec['cudnn_bf16_ms']} plan {plan} on {card}")


def int8_ptxas_report() -> None:
    """Registers and spills of each kernel in int8_conv.cu, from the build's
    ``-Xptxas -v`` log; a spill fails the phase."""
    from clip_codec_tpu_torch.ops import _build

    name = None
    for line in _build.library_path("int8_conv").with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            print(f"int8-kernels: ptxas {name}: {line.strip()}")
            if "spill" in line:
                check(" 0 bytes spill stores, 0 bytes spill loads" in line, f"int8_conv.cu spills in {name}: {line}")


def int8_replays(torch, q8, gen, dev) -> None:
    """Two CUDA-graph replays bit-equal to each other and to the plain
    version: SD's 8^2 conv, codes in and the act form, whose plans split K
    (its arrival counters reset themselves, its partials are overwritten),
    and absmax at the dynamic
    server's largest input (one launch, its counter reset by its last
    block)."""
    (xs, ws, stride, pad) = ((2, 8, 8, 1280), (1280, 3, 3, 1280), 1, 1)
    plan = q8.int8_conv_plan(*xs, ws[0], ws[1], stride, pad, torch.cuda.get_device_properties(dev).multi_processor_count)
    check(plan.splits > 1, f"int8 replays: the SD 8^2 conv's plan does not split K: {plan}")
    xq = torch.randint(-127, 128, xs, generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, ws, generator=gen, device=dev, dtype=torch.int8)
    wsc = torch.rand((ws[0],), generator=gen, device=dev) * 1e-3 + 1e-4
    s, bias = torch.full((), 0.02, device=dev), torch.randn((ws[0],), generator=gen, device=dev)
    x = torch.randn((65536, 128), generator=gen, device=dev).to(torch.bfloat16)
    xa = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
    am = torch.full((), 1.5, device=dev)
    plan_a = q8.int8_conv_plan(*xs, ws[0], ws[1], stride, pad, torch.cuda.get_device_properties(dev).multi_processor_count,
                               2)
    check(plan_a.splits > 1, f"int8 replays: the SD 8^2 act form's plan does not split K: {plan_a}")
    for what, run, want in (
            (f"int8_conv_nhwc {xs} x {ws} ({plan.splits} K slices)",
             lambda: q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16),
             q8.int8_conv2d_plain(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16)),
            (f"int8_conv_act {xs} bf16 x {ws} ({plan_a.splits} K slices)",
             lambda: q8.int8_conv2d_act(xa, am, wq, wsc, bias, stride, pad, torch.bfloat16),
             q8.int8_conv2d_act_plain(xa, am, wq, wsc, bias, stride, pad, torch.bfloat16)),
            ("absmax (65536, 128) bf16", lambda: q8.absmax(x), q8.absmax_plain(x))):
        run()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(first, out) and torch.equal(out, want), f"int8 replays: {what}: two replays differ or "
              f"leave the plain version")
        print(f"int8-kernels: {what}: two graph replays bit-equal to each other and to the plain version")
        del graph


def time_conv(torch, q8, F, recs, x, w, xq, wq, wsc, s, bias, stride, pad, acc_p, errs, path, card):
    """One timed int8 conv record: the kernel (graph replay, events), its
    plain version (events), its bound, and ``torch._int_mm`` (a GEMM) or
    cuDNN's bf16 conv (for scale)."""
    xs, (cout, k, _, cin) = tuple(xq.shape), wq.shape
    B, H, W, _ = xs
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    M, K = B * ho * wo, k * k * cin
    run = lambda: q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16)
    ms, ev_ms = graph_ms(torch, run, iters=10), cuda_ms(torch, run, iters=10)
    plain_ms = cuda_ms(torch, lambda: q8.int8_conv2d_plain(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16),
                       iters=1, warmup=1)
    b_ms, b_by, _ = bound(xq.numel() + wq.numel() + 2 * M * cout + 8 * cout, 2.0 * M * cout * K, INT8_OPS_PER_S)
    lib_ms, scale_ms = None, None
    if k == 1:  # a GEMM: torch._int_mm is the one PyTorch call for the same int32 product
        a2, b2 = xq.reshape(M, K), wq.reshape(cout, K).t()
        try:
            check(torch.equal(torch._int_mm(a2, b2), acc_p.reshape(M, cout)), f"_int_mm {xs}: another product")
            lib_ms = graph_ms(torch, lambda: torch._int_mm(a2, b2), iters=10)
        except RuntimeError as e:
            print(f"int8-kernels: torch._int_mm refuses ({M}, {K}) x ({K}, {cout}): {str(e).splitlines()[0]}")
    else:  # no PyTorch call convolves int8 on CUDA: cuDNN's bf16 conv of the same shape, for scale
        xb = x.permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        scale_ms = graph_ms(torch, lambda: F.conv2d(xb, wb, None, stride, pad), iters=10)
    pl = q8.int8_conv_plan(B, H, W, cin, cout, k, stride, pad,
                           torch.cuda.get_device_properties(xq.device).multi_processor_count)
    plan = {"n_tile": pl.n_width, "rows": pl.rows, "mw": pl.mw, "splits": pl.splits, "swap": pl.swap,
            "units": pl.units, "blocks": pl.blocks, "stages": pl.stages}
    rec = {"shape": [list(xs), list(wq.shape), stride, pad], "path": path, "ms": ms, "events_ms": ev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "cudnn_bf16_ms": scale_ms, "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "tops": 2.0 * M * cout * K / ms / 1e9, "plan": plan}
    recs["int8_conv_nhwc"].append(rec)
    print(f"int8-kernels: int8_conv_nhwc {path} x {xs} w {tuple(wq.shape)} s{stride} p{pad}: ms={ms:.4f} (graph) "
          f"events_ms={ev_ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) {rec['tops']:.1f} TOP/s "
          f"_int_mm_ms={lib_ms} cudnn_bf16_ms={scale_ms} plan {plan} on {card}")


def phase_int8(torch, q8, gn, rc, attn, mlp, seed, dev, card, art, inv_times):
    """22b: the main path. ``cli.export_decoder --int8`` (calibration, the
    artifact, its sidecar), the artifact's replay against its own eager int8
    sampler, one int8 forward against the bf16 one, a start-up without the
    sidecar, then ``serve`` behind the artifact answering 64 /decompress from
    32 clients. 22c: ``cli.reconstruct_diffusion --int8`` beside the bf16
    CLI, ``serve --int8`` with no artifact (dynamic), ``cli.reconstruct_sd_diffusion
    --int8 --inv_weight 0`` and the SD int8 artifact behind --sd_artifact.
    Launch counts exact throughout. Returns the int8 kernels' launches by
    shape over the HTTP run of 22b and the runs of 22c."""
    import io

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch import deploy, serve
    from clip_codec_tpu_torch.cli import export_decoder, reconstruct_diffusion, reconstruct_sd_diffusion
    from clip_codec_tpu_torch.cli.search_text import load_features
    from clip_codec_tpu_torch.models import CLIPCondUNet
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SDUNet
    from clip_codec_tpu_torch.probes.serve_times import drive, percentiles, request
    from clip_codec_tpu_torch.utils.checkpoint import load_state_dict
    from clip_codec_tpu_torch.weights import sd_checkpoint as ckpt

    build = ROOT / "build" / "chip_smoke"
    px_weights, sd_dir, store = build / "store" / "diffusion_unet_final.pt", build / "sd", build / "compress" / "store"
    out = build / "int8"
    out.mkdir(parents=True, exist_ok=True)
    env = {ckpt.UNET_ENV: str(sd_dir / "unet.pt"), ckpt.VAE_ENV: str(sd_dir / "vae.pt")}
    manifest = json.loads((store / "manifest.json").read_text())
    frames = [Path(r["bitstream"]).read_bytes() for r in manifest]
    with torch.device("meta"):
        sd_layers = len(q8.int8_layer_names(SDUNet(SD15_UNET)))
    px_fwd = q8_forward(PX_INT8_LAYERS, k3=1, codes_out=GN_PER_FORWARD)  # static: K1 writes 28 layers' codes
    sd_fwd = q8_forward(sd_layers, k4=SD_FLASH_PER_FORWARD)
    times = art["times"]
    launches_by_shape = collections.Counter()

    def counts():
        return q8_launches(q8, gn, rc, attn, mlp)

    def expect(got, want, what):
        print(f"int8-launches: {what}: {got}")
        check(got == {k: want.get(k, 0) for k in got}, f"{what}: launches {got} != {want}")

    def start(srv):
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        return srv.server_address, thread

    def stop(srv, thread):
        srv.shutdown()
        srv.server_close()
        thread.join()

    with mock.patch.dict(os.environ, env), raw_frames(frame_engine("int8")), \
            q8_tally(torch, q8, gn) as tally:
        # 22b: export at the CLI's defaults (256px, DDIM-50, batch 16), uint8 output
        art_path = out / "decoder_int8.torchprog"
        t0 = time.perf_counter()
        export_decoder.main(["--weights", str(px_weights), "--out", str(art_path), "--output", "uint8", "--int8"])
        export_s = time.perf_counter() - t0
        meta = deploy.read_artifact_meta(art_path)
        sidecar = Path(str(art_path) + deploy.QUANT_SUFFIX)
        check(sidecar.exists(), f"no sidecar {sidecar}")
        quant = q8.read_quant(sidecar, dev)
        print(f"int8-export: {art_path.name} + {sidecar.name} ({len(quant)} scales, absmax "
              f"{min(v.item() for v in quant.values()):.3f}..{max(v.item() for v in quant.values()):.3f}) in "
              f"{export_s:.2f} s (calibration included) on {card}; header {meta}")
        check(meta["int8"] is True and (meta["size"], meta["steps"], meta["batch_size"], meta["output"]) ==
              (SIZE, STEPS, WIDE_BATCH, "uint8"), f"int8 artifact header {meta}")
        check(len(quant) == PX_INT8_LAYERS, f"{len(quant)} scales, want {PX_INT8_LAYERS}")

        feats, _ = load_features(store)
        z = torch.from_numpy(feats[:WIDE_BATCH]).to(dev)
        px = deploy.load_decompressor(art_path)
        params = load_state_dict(px_weights)
        t0 = time.perf_counter()
        a = px(params, z, seed=seed, quant=quant)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        reset_q8_launches(q8, gn, rc, attn, mlp)
        b = px(params, z, seed=seed, quant=quant)
        expect(counts(), combined((px_fwd, STEPS)), "a replay of the pixel int8 artifact")
        check(torch.equal(a, b), "two int8 replays of one seed differ")
        x_T = torch.randn((WIDE_BATCH, SIZE, SIZE, 3), generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        t0 = time.perf_counter()
        e = px.sample(px.net, z, x_T)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        d = (a.int() - e.int()).abs()
        ms = cuda_ms(torch, lambda: px(params, z, seed=seed, quant=quant), iters=1, warmup=0)
        print(f"int8-replay: capture + first replay {first:.3f} s; uint8 vs its eager int8 sampler from the same x_T: "
              f"max |delta| {d.max().item()} levels; a call {ms:.3f} ms device (phase 20's bf16 artifact "
              f"{times['px_ms']:.3f} ms), eager {eager_s:.3f} s wall, batch {WIDE_BATCH} on {card}")
        check(torch.equal(a, e), "the int8 replay is not bit-equal to its eager int8 sampler")
        # the path before K1's codes-out form (K1, then int8_quantize, for every ResBlock conv) in a
        # decompressor of its own, captured under that dispatch; the two replays timed in turns
        px_parent = deploy.load_decompressor(art_path)
        reset_q8_launches(q8, gn, rc, attn, mlp)
        with two_step_codes(q8):
            p_img = px_parent(params, z, seed=seed, quant=quant)
        torch.cuda.synchronize()
        check(counts()["group_norm_silu_int8"] == 0 and counts()["group_norm_silu"] == 2 * GN_PER_FORWARD * STEPS,
              f"the two-step decompressor's eager run and first replay: {counts()}")
        check(torch.equal(a, p_img), "the int8 replay's images are not bit-equal to the two-step path's "
              f"(K1, then int8_quantize): max |delta| {(a.int() - p_img.int()).abs().max().item()} levels")
        new_ms, old_ms = [], []
        for turn in ("old", "new", "new", "old"):
            run = px_parent if turn == "old" else px
            (old_ms if turn == "old" else new_ms).append(
                cuda_ms(torch, lambda: run(params, z, seed=seed, quant=quant), iters=1, warmup=0))
        print(f"int8-replay: uint8 bit-equal to the two-step path's (K1, then int8_quantize); a call's device ms, in "
              f"turns: K1's codes-out form {[round(t, 3) for t in new_ms]}, the two-step path "
              f"{[round(t, 3) for t in old_ms]} (batch {WIDE_BATCH}, DDIM-{STEPS}) on {card}")
        del px_parent, p_img
        fp = CLIPCondUNet(z_dim=512, base=PX_BASE, ch_mult=PX_CH_MULT, time_dim=256, dtype=torch.bfloat16,
                          int8=False)
        fp.load_state_dict(params, strict=True)
        fp = fp.to(dev).eval()
        gen = torch.Generator(device=dev).manual_seed(seed + 72)
        xs = (torch.randn((4, SIZE, SIZE, 3), generator=gen, device=dev), z[:4],
              torch.tensor([999, 700, 300, 20], dtype=torch.int32, device=dev))
        with torch.no_grad():
            eps_q, eps_b = px.net(*xs).float(), fp(*xs).float()
            with act_form_layers(q8):
                eps_act = px.net(*xs).float()
        check(torch.equal(eps_q, eps_act), "the static int8 forward: the act form != the path's forms")
        print(f"int8-forward: static int8 eps (B=4, the artifact's net and calibration) through the act form "
              f"(all {PX_INT8_LAYERS} layers) bit-equal to the path's (group_norm_silu_int8 + int8_conv_nhwc "
              f"for the {GN_PER_FORWARD} ResBlock convs, int8_quantize + int8_conv_nhwc for the downsamples)")
        rel = ((eps_q - eps_b).norm() / eps_b.norm()).item()
        print(f"int8-forward: static int8 eps vs the bf16 forward, B=4 at t = 999, 700, 300, 20: "
              f"||delta|| / ||bf16|| {rel:.4e} on {card}")
        check(bool(torch.isfinite(eps_q).all().item()) and rel < 0.5, f"int8 eps {rel}")
        del px, fp, a, b, e, eps_q, eps_b, eps_act
        torch.cuda.empty_cache()

        lone = out / "no_sidecar.torchprog"
        shutil.copyfile(art_path, lone)
        try:
            serve.serve(str(store), weights=str(px_weights), port=0, artifact=str(lone))
            check(False, "an int8 artifact without its sidecar served")
        except ValueError as err:
            want = f"int8 artifact: calibration sidecar {lone}{deploy.QUANT_SUFFIX} not found " \
                   f"(cli.export_decoder --int8 writes it)"
            check(str(err) == want, f"missing sidecar: {err!r}")
            print(f"int8-serve: without the sidecar the server stops at start-up: {err}")

        # the main path: the server behind the int8 artifact, counts from 0 just before it starts
        reset_q8_launches(q8, gn, rc, attn, mlp)
        tally["eager"].clear()
        tally["captured"].clear()
        t0 = time.perf_counter()
        srv = serve.serve(str(store), weights=str(px_weights), port=0, artifact=str(art_path),
                          batch_wait_ms=ART_WAIT_MS)
        started = time.perf_counter() - t0
        addr, thread = start(srv)
        try:
            dt, lat, res = drive(addr, "/decompress", [frames[i % len(frames)] for i in range(ART_REQUESTS)],
                                 ART_CLIENTS)
            for status, _, body, _ in res:
                check(status == 200 and Image.open(io.BytesIO(body)).size == (SIZE, SIZE), f"/decompress {status}")
            mb = json.loads(request(addr, "/stats", method="GET")[2])["micro_batch"]
        finally:
            stop(srv, thread)
        p50, p95 = percentiles(lat)
        replays = 1 + mb["calls"]  # the start-up call and the micro-batches
        print(f"int8-serve: started (artifact loaded, captured) in {started:.2f} s; {ART_REQUESTS} /decompress from "
              f"{ART_CLIENTS} clients in {dt:.3f} s = {ART_REQUESTS / dt:.3f} img/s, p50 {p50:.3f} s p95 {p95:.3f} s, "
              f"{mb['calls']} replays, fill rate {mb['fill_rate']}; phase 20c's bf16 artifact {times['img_s']:.3f} "
              f"img/s, p50 {times['p50']:.3f} s p95 {times['p95']:.3f} s on {card}")
        expect(counts(), combined((px_fwd, STEPS * (1 + replays))),
               f"the HTTP run (one eager warm-up, {replays} replays)")
        fold_captured(tally, replays)

        # 22c: the pixel CLI with --int8 (static, calibrated first) beside the bf16 CLI
        f0 = Path(manifest[0]["bitstream"])
        cli_s = {}
        for flags in ([], ["--int8"]):
            reset_q8_launches(q8, gn, rc, attn, mlp)
            png = out / f"recon{'_int8' if flags else ''}.png"
            t0 = time.perf_counter()
            try:
                reconstruct_diffusion.main(["--store_dir", str(store), "--bitstream", str(f0), "--weights",
                                            str(px_weights), "--out", str(png), "--seed", str(seed)] + flags)
            finally:
                q8.set_int8_conv(False)
            cli_s[bool(flags)] = time.perf_counter() - t0
            check(np.asarray(Image.open(png)).shape == (SIZE, SIZE, 3), f"{png.name}")
        calibration = {"group_norm_silu": GN_PER_FORWARD, "affine_conv3x3": 1}  # an fp pass of the int8 U-Net
        expect(counts(), combined((calibration, 3), (px_fwd, STEPS)), "cli.reconstruct_diffusion --int8")
        # serve --int8, no artifact: ClipCodec with the dynamic int8 U-Net
        q8.set_int8_conv(True)
        try:
            srv = serve.serve(str(store), weights=str(px_weights), port=0)
            addr, thread = start(srv)
            reset_q8_launches(q8, gn, rc, attn, mlp)
            try:
                status, ctype, body, dyn_s = request(addr, f"/decompress?size={SIZE}&steps={STEPS}&seed={seed}",
                                                     frames[0])
            finally:
                stop(srv, thread)
        finally:
            q8.set_int8_conv(False)
        check(status == 200 and Image.open(io.BytesIO(body)).size == (SIZE, SIZE), f"serve --int8: {status}")
        expect(counts(), combined((q8_forward(PX_INT8_LAYERS, dynamic=True, k1=GN_PER_FORWARD, k3=1), STEPS)),
               "serve --int8 /decompress (dynamic)")
        print(f"int8-cli: cli.reconstruct_diffusion (DDIM-{STEPS}, {SIZE}px, one image, weights load included) "
              f"bf16 {cli_s[False]:.3f} s, --int8 {cli_s[True]:.3f} s (calibration included); serve --int8 "
              f"(dynamic) one /decompress {dyn_s:.3f} s on {card}")

        # the SD CLI with --int8 --inv_weight 0 (static, calibrated on both CFG branches)
        reset_q8_launches(q8, gn, rc, attn, mlp)
        t0 = time.perf_counter()
        try:
            reconstruct_sd_diffusion.main(["--store_dir", str(store), "--bitstream", str(f0), "--adapter",
                                           str(sd_dir / "adapter.pt"), "--int8", "--inv_weight", "0", "--out",
                                           str(out / "sd_int8.png")])
        finally:
            q8.set_int8_conv(False)
        sd_cli_s = time.perf_counter() - t0
        check(np.asarray(Image.open(out / "sd_int8.png")).shape == (SD_SIZE, SD_SIZE, 3), "sd_int8.png")
        sd_calibration = {"flash_attention": SD_FLASH_PER_FORWARD}  # an fp pass: 3 timesteps x 2 branches
        sd_request = combined((sd_fwd, INV_STEPS), ({"flash_attention": 1}, 1))  # + the VAE decode
        expect(counts(), combined((sd_calibration, 6), (sd_request, 1)), "cli.reconstruct_sd_diffusion --int8")
        # the SD int8 artifact behind --sd_artifact
        sd_art = out / "sd_int8.torchprog"
        export_decoder.main(["--sd", "--adapter", str(sd_dir / "adapter.pt"), "--out", str(sd_art), "--int8"])
        check(Path(str(sd_art) + deploy.QUANT_SUFFIX).exists(), "no SD sidecar")
        reset_q8_launches(q8, gn, rc, attn, mlp)
        srv = serve.serve(str(store), port=0, sd_artifact=str(sd_art), adapter=str(sd_dir / "adapter.pt"))
        addr, thread = start(srv)
        walls, pngs = [], []
        try:
            for s in (0, 1, 0):
                status, ctype, body, wall = request(addr, f"/decompress_sd?seed={s}&guidance={SD_GUIDANCE}",
                                                    frames[2])
                check(status == 200 and Image.open(io.BytesIO(body)).size == (SD_SIZE, SD_SIZE),
                      f"/decompress_sd {status} {body[:200]!r}")
                walls.append(wall)
                pngs.append(body)
        finally:
            stop(srv, thread)
        check(pngs[0] == pngs[2] and pngs[0] != pngs[1], "/decompress_sd int8 seeds")
        expect(counts(), combined((sd_request, 1 + 1 + len(walls))),
               "the SD int8 artifact (one eager warm-up, the start-up replay, 3 requests)")
        fold_captured(tally, 1 + len(walls))
        print(f"int8-sd: cli.reconstruct_sd_diffusion --int8 --inv_weight 0 (ddim-{INV_STEPS}, {SD_SIZE}px, "
              f"weights load and calibration included) {sd_cli_s:.3f} s (phase 17's bf16 request without the "
              f"weights load {[round(t, 4) for t in inv_times['s_inv0']]} s); the SD int8 artifact's "
              f"/decompress_sd {[round(w, 4) for w in walls]} s (phase 20c's bf16 "
              f"{[round(w, 4) for w in times['sd_walls']]} s) on {card}")
        launches_by_shape.update(tally["eager"])
    return launches_by_shape


# ------------------------------------------------- the data axis (phase 23)


def _dp_px_store(seed, store: Path, have_zstd: bool, n: int = DP_PX_IMAGES) -> None:
    """``n`` seeded PNGs and their frames (raw codes where no zstd engine
    is missing: every rank reads them through ``raw_frames``)."""
    import json

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    rng = np.random.default_rng(seed + 23)
    images = rng.integers(0, 256, (n, 96, 128, 3), dtype=np.uint8)  # resized to out_size on load
    codes = rng.integers(0, 256, (n, 512), dtype=np.uint8)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32), zero=np.full(512, -1.0, np.float32))
    recs = []
    with raw_frames(have_zstd):
        for i, (im, row) in enumerate(zip(images, codes)):
            Image.fromarray(im).save(store / f"img{i}.png")
            write_bitstream(row.tobytes(), 512, store / f"img{i}.clp")
            recs.append({"image": str(store / f"img{i}.png"), "bitstream": str(store / f"img{i}.clp")})
    (store / "manifest.json").write_text(json.dumps(recs))


def _run_ranks(torch, job: dict, world: int, env: dict, timeout: float, probe: str = "dp_rank") -> list:
    """``probes.<probe>`` (``dp_rank``: phase 23, ``mp_rank``: phase 24) on
    ``job`` as ``world`` ranks (launcher nodes of their own, so every rank
    drives cuda:0); each rank's record."""
    import json

    from clip_codec_tpu_torch.parallel.launch import spawn_ranks

    out = Path(job["out"])
    out.mkdir(parents=True, exist_ok=True)
    (out / "job.json").write_text(json.dumps(job))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = spawn_ranks(["-m", f"clip_codec_tpu_torch.probes.{probe}", str(out / "job.json")], world, timeout,
                       env=env, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    for r, (rc, log) in enumerate(runs):
        (out / f"rank{r}.log").write_text(log)
        check(rc == 0, f"{world}-rank run, rank {r} exited {rc}:\n{log[-6000:]}")
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    for r, rec in enumerate(recs):
        check(rec["world"] == world and rec["jax_modules"] == [], f"rank {r}: world {rec['world']}, "
              f"jax modules {rec['jax_modules']}")
        rec["log"] = runs[r][1]
    print(f"{probe[:2]}: {world} rank(s) ran {[t['name'] for t in job['tasks']]} in {wall:.1f} s (process start, "
          f"kernel loads and model builds included), backend {recs[0]['backend']}")
    return recs


def _dp_train_checks(torch, name, two, one, dp, card, want_launches):
    """Phase 23a/23b: the two ranks' trajectory against one rank's."""
    a, b = (t[name] for t in two)
    ref = one[0][name]
    pr = lambda tag: torch.load(dp / tag, weights_only=True)
    start, final0, final1 = pr(f"two/rank0_{name}_start.pt"), pr(f"two/rank0_{name}_final.pt"), \
        pr(f"two/rank1_{name}_final.pt")
    start1, final_one = pr(f"one/rank0_{name}_start.pt"), pr(f"one/rank0_{name}_final.pt")
    g_two, g_one = pr(f"two/rank0_{name}_grad1.pt"), pr(f"one/rank0_{name}_grad1.pt")
    rel_grad = ((g_two - g_one).norm() / g_one.norm()).item()
    check(a["losses"] == b["losses"], f"{name}: the ranks' global losses differ: {a['losses']} {b['losses']}")
    rel_loss = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref["losses"]))
    same = all(torch.equal(final0[k], final1[k]) for k in final0)
    same_start = all(torch.equal(start[k], start1[k]) for k in start)
    d_two = torch.cat([(final0[k] - start[k]).float().flatten() for k in start])
    d_one = torch.cat([(final_one[k] - start1[k]).float().flatten() for k in start])
    rel_upd = ((d_two - d_one).norm() / d_one.norm()).item()
    per_step = lambda r: sorted(r["step_s"][1:])[len(r["step_s"][1:]) // 2]  # the median after the first
    nonzero = lambda counts: {k: v for k, v in counts.items() if v}
    print(f"dp-{name}: 2 ranks sharing {card} over gloo, {len(a['losses'])} steps at global batch "
          f"{DP_TRAIN_BATCH[name]} ({DP_TRAIN_BATCH[name] // 2} a rank), against 1 NCCL rank: losses "
          f"{[round(x, 6) for x in a['losses']]} vs {[round(x, 6) for x in ref['losses']]} (max rel "
          f"{rel_loss:.3e}); the first step's summed gradient ||g_2ranks - g_1rank|| / ||g_1rank|| = "
          f"{rel_grad:.3e}; ||d(theta_final - theta_0)|| / ||theta_final - theta_0|| = {rel_upd:.3e}; ranks "
          f"bit-equal: {same}; the same start: {same_start}; s/step (median after the first) 2 ranks "
          f"{per_step(a):.4f} / {per_step(b):.4f}, 1 rank {per_step(ref):.4f} (steps "
          f"{[round(x, 4) for x in a['step_s']]} / {[round(x, 4) for x in ref['step_s']]}); launches rank 0 "
          f"{nonzero(a['launches'])}, rank 1 {nonzero(b['launches'])}, 1 rank {nonzero(ref['launches'])}")
    check(rel_loss <= DP_TOL, f"{name}: losses {a['losses']} vs one rank's {ref['losses']}")
    # Held: the gradient. AdamW's first steps move a parameter by ~lr x sign(g) whatever |g| is, so the update
    # over the run moves by 2 lr wherever bf16 rounding flips a near-zero gradient's sign (printed, not held),
    # and it cannot see a gradient scaled by a constant: the normalisation error a data-parallel sum can make.
    check(rel_grad <= DP_TOL, f"{name}: the first step's gradient differs from one rank's by {rel_grad}")
    check(same, f"{name}: the ranks' parameters differ")
    check(same_start, f"{name}: the runs start from different parameters")
    for r in (a, b):
        got = {k: r["launches"][k] for k in want_launches}
        check(got == want_launches, f"{name}: a rank launched {got}, expected {want_launches} (the one-rank run's)")
    check({k: ref["launches"][k] for k in want_launches} == want_launches,
          f"{name}: one rank launched {ref['launches']}, expected {want_launches}")
    return {k: a["launches"][k] + b["launches"][k] for k in want_launches}


def phase_dp(torch, seed, dev, card):
    """Phase 23: the data axis with two ranks sharing the card (gloo) and one
    NCCL rank alone. Returns each kernel's launches summed over the two
    ranks."""
    import numpy as np

    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.io.bitstream import write_bitstream
    from clip_codec_tpu_torch.utils.checkpoint import load_state_dict
    from clip_codec_tpu_torch.utils.config import ModelConfig


    t_phase = time.perf_counter()
    build = ROOT / "build" / "chip_smoke"
    dp = build / "dp"
    shutil.rmtree(dp, ignore_errors=True)
    dp.mkdir(parents=True)
    have_zstd = frame_engine("dp")
    _dp_px_store(seed, dp / "px", have_zstd)
    sd_store = build / "train"  # phase 11's images and latents; its frames, raw where no zstd engine exists
    codes = _train_store(seed, sd_store)
    if codes is not None:
        with raw_frames(have_zstd):
            for i, row in enumerate(codes):
                write_bitstream(row.tobytes(), 512, sd_store / f"img{i}.clp")
    rng = np.random.default_rng(seed + 24)
    z = rng.standard_normal((WIDE_BATCH, 512)).astype(np.float32)
    np.save(dp / "z.npy", z / np.linalg.norm(z, axis=1, keepdims=True))
    px = ["--store_dir", str(dp / "px"), "--epochs", "1", "--batch_size", str(DP_TRAIN_BATCH["train"]), "--seed",
          str(seed), "--data_workers", "2", "--log_every", "1"]
    sd = ["--store_dir", str(sd_store), "--epochs", "1", "--batch_size", str(DP_TRAIN_BATCH["train_sd"]),
          "--heads", "8", "--seed", str(seed), "--log_every", "1"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLIP_CODEC_")}
    env.update(CLIP_CODEC_SD_UNET_WEIGHTS=str(build / "sd" / "unet.pt"),
               CLIP_CODEC_SD_VAE_WEIGHTS=str(build / "sd" / "vae.pt"))
    search = {"name": "search", "n": RET_N, "d": 512, "k": RET_K, "queries": list(RET_Q), "seed": seed + 25,
              "tol": RET_NEAR, "cli": ["--store_dir", str(build / "compress" / "store"), "--query_clp",
                                       str(sorted((build / "compress" / "store").glob("*.clp"))[3])]}
    art = {"name": "artifact", "weights": str(build / "store" / "diffusion_unet_final.pt"),
           "path": str(dp / "sharded.torchprog"), "size": SIZE, "steps": STEPS, "batch": WIDE_BATCH,
           "z": str(dp / "z.npy"), "seeds": [seed, seed + 1]}
    two = _run_ranks(torch, {"out": str(dp / "two"), "tasks": [
        {"name": "train", "argv": px + ["--data_parallel", "--save_dir", str(dp / "px_two")]},
        {"name": "train_sd", "argv": sd + ["--data_parallel", "--save_dir", str(dp / "sd_two")]},
        search, art]}, 2, env, DP_TIMEOUT)
    one = _run_ranks(torch, {"out": str(dp / "one"), "tasks": [
        {"name": "train", "argv": px + ["--distributed", "--save_dir", str(dp / "px_one")]},
        {"name": "train_sd", "argv": sd + ["--distributed", "--save_dir", str(dp / "sd_one")]}]}, 1, env, DP_TIMEOUT)

    # Every sub-phase's checks run and print; the failures are raised together at the end.
    errors, launches = [], {}

    def part(fn):
        try:
            fn()
        except PhaseError as e:
            errors.append(str(e))

    def backends():  # 23e
        check(two[0]["backend"] == "cpu:gloo,cuda:gloo" and "[parallel] 2 rank(s), backend cpu:gloo,cuda:gloo "
              "(2 ranks share 1 card(s))" in two[0]["log"], f"two ranks sharing the card: backend {two[0]['backend']}")
        check(one[0]["backend"] == "cpu:gloo,cuda:nccl" and "[parallel] 1 rank(s), backend cpu:gloo,cuda:nccl "
              "(one card per rank)" in one[0]["log"], f"one rank: backend {one[0]['backend']}")
        print(f"dp-23e: one rank under a one-rank launcher environment (--distributed) chose {one[0]['backend']}; "
              f"two ranks sharing {card} chose {two[0]['backend']}")

    def pixel():  # 23a
        steps = -(-DP_PX_IMAGES // DP_TRAIN_BATCH["train"])
        launches.update(_dp_train_checks(torch, "train", two, one, dp, card,
                                         {"group_norm_silu": GN_PER_FORWARD * steps}))
        for r in two:  # each rank's K1 at its half of the batch, the one-rank run's shapes at the full batch
            want = {str([DP_TRAIN_BATCH["train"] // 2, H, W, C]): n * steps
                    for (H, W, C), n in zip(GN_SHAPES, (4, 8, 8, 8))}
            check(r["train"]["k1_by_shape"] == want, f"K1 by shape {r['train']['k1_by_shape']} != {want}")

    def sd():  # 23b
        sd_steps = TRAIN_IMAGES // DP_TRAIN_BATCH["train_sd"]
        launches.update(_dp_train_checks(torch, "train_sd", two, one, dp, card, {
            k: v * sd_steps for k, v in TRAIN_LAUNCHES.items() if k != "transformer_mlp"}))

    def retrieval():  # 23c: the sharded exact indexes and the CLI
        for r, rec in enumerate(two):
            for form, f in rec["search"]["forms"].items():
                print(f"dp-search: rank {r} {form}: rows {f['rows']} from {f['base']} of {RET_N} at D = 512, "
                      f"resident {f['resident_bytes']} bytes; by Q: " + "; ".join(
                          f"Q={q} device {m['local_device_ms']:.4f} ms (its scores and top-{RET_K}), a whole "
                          f"search {m['search_wall_ms']:.3f} ms wall (gather and host merge too), ids equal "
                          f"{m['ids_equal']}, max score err {m['max_score_err']:.2e}, near-tie places "
                          f"{m['near_tie_places']}, u8_ip_scores launches {m['launches_a_search']}"
                          for q, m in f["by_q"].items()) + f" on {card}")
                for q, m in f["by_q"].items():
                    check(m["ids_equal"] and m["max_score_err"] <= RET_NEAR,
                          f"rank {r} {form} Q={q}: sharded hits differ from the single index's: {m}")
                    check(m["launches_a_search"] == (1 if form == "u8" else 0), f"rank {r} {form} Q={q}: {m}")
        cli = two[0]["search"]["cli"]
        launches["u8_ip_scores"] = sum(rec["search"]["cli_u8_launches"] for rec in two)
        print(f"dp-search-cli: search_text on phase 16's store, rank 0: {cli}; rank 1: {two[1]['search']['cli']}; "
              f"u8_ip_scores launches of the --data_parallel --u8 run {launches['u8_ip_scores']} over the ranks")
        check(cli["sharded"] == cli["single"] and cli["sharded_u8"] == cli["single_u8"] and len(cli["sharded"]) == 10,
              "search_text --data_parallel printed other lines than the single index's")
        check(all(two[1]["search"]["cli"][k] == [] for k in ("sharded", "sharded_u8")), "rank 1 printed hits")

    def artifact():  # 23d: the data-sharded pixel artifact against the single-device one
        # Each rank's rows are held against the single-device artifact at the rank's batch, fed the same rows
        # of the same seed's global x_T; against the single-device artifact at B = 16 the images are printed
        # beside that artifact's own B = 16 against B = 8 on the same rows: bf16 GEMMs pick another
        # reduction at another batch, and the first DDIM step (t = 999, where sqrt(al_bar) is ~0) clips
        # x0 to +-1, so a rounding's difference flips whole pixels there.
        params = load_state_dict(art["weights"])
        mc = ModelConfig.find_for_checkpoint(art["weights"])
        half = WIDE_BATCH // 2
        single, single_half = (deploy.load_decompressor(deploy.export_decompressor(
            params, mc, dp / f"single{b}.torchprog", size=SIZE, steps=STEPS, batch_size=b, output="uint8"),
            device=dev) for b in (WIDE_BATCH, half))
        zz = np.load(dp / "z.npy")
        per_rank = {"affine_silu_conv3x3": (LAUNCHES_PER_FORWARD - 1) * STEPS, "affine_conv3x3": STEPS,
                    "group_norm_silu": 0}
        launches.update({k: sum(rec["artifact"]["launches"][k] for rec in two)
                         for k in ("affine_silu_conv3x3", "affine_conv3x3")})

        def agree(a, b):
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            return int(d.max()), float((d == 0).mean())

        for s in art["seeds"]:
            x_T = torch.randn((WIDE_BATCH, SIZE, SIZE, 3), generator=torch.Generator(device=dev).manual_seed(s),
                              device=dev, dtype=torch.float32)  # the artifacts' draw for the seed
            rows = [rec["artifact"]["rows"] for rec in two]
            want = np.concatenate([single_half(params, zz[lo:hi], x_T=x_T[lo:hi]).cpu().numpy() for lo, hi in rows])
            whole = single(params, zz, seed=s).cpu().numpy()
            got = np.load(dp / "two" / f"artifact_seed{s}.npy")
            rms = [rec["artifact"]["by_seed"][str(s)] for rec in two]
            (d_rows, eq_rows), (d_whole, eq_whole), (d_floor, eq_floor) = (
                agree(got, want), agree(got, whole), agree(want, whole))
            print(f"dp-artifact: seed {s}: the sharded artifact (mesh {two[0]['artifact']['meta']['mesh']}, rows "
                  f"{rows}, DDIM-{STEPS}) against the single-device artifact at B = {half} on each rank's rows: max "
                  f"|uint8 diff| {d_rows}, equal {eq_rows:.6f}; against the single-device one at B = {WIDE_BATCH}: "
                  f"max {d_whole}, equal {eq_whole:.6f} (that artifact at B = {WIDE_BATCH} against itself at B = "
                  f"{half} on the same rows: max {d_floor}, equal {eq_floor:.6f}); a replay "
                  f"{[round(m['replay_device_ms'], 3) for m in rms]} ms device a rank on {card}; launches a call "
                  f"{[m['launches'] for m in rms]}; first call (warm-up and capture) "
                  f"{[round(rec['artifact']['first_call_s'], 3) for rec in two]} s")
            check(got.shape == want.shape == (WIDE_BATCH, SIZE, SIZE, 3), f"artifact shapes {got.shape} {want.shape}")
            check(d_rows <= 1 and eq_rows >= 0.999, f"seed {s}: the ranks' rows: max diff {d_rows}, equal {eq_rows}")
            for m in rms:
                check(m["launches"] == per_rank, f"a call launched {m['launches']}, expected {per_rank}")
        check(two[0]["artifact"]["meta"]["sharded"] is True and two[0]["artifact"]["meta"]["mesh"] ==
              {"data": 2, "model": 1}, f"header {two[0]['artifact']['meta']}")
        del single, single_half, params
        torch.cuda.empty_cache()

    for fn in (backends, pixel, sd, retrieval, artifact):
        part(fn)
    check(not errors, "; ".join(errors))
    for name, n in launches.items():
        check(n > 0, f"{name}: no launch on phase 23's paths")
    print(f"dp: phase 23 in {time.perf_counter() - t_phase:.1f} s; launches summed over the two ranks {launches}; "
          f"two ranks sharing one card measure correctness and overhead, not scaling")
    return launches

# ------------------------------------------------- the model axis (phase 24)


def phase_k1_split(torch, gn, seed, dev):
    """24a: K1's split entries against their plain versions at the spatial
    U-Net's half-height shapes (bf16; phase 24's sampling at 256px and phase
    26's training at 512px), an fp32 case and a ragged one, with and without
    a shift, timed at the half-height shapes; returns a record per entry and
    shape. Shifted as the spatial U-Net calls them: the stats of x - (one
    element of each group), then apply about the mean with totals (0, M2)
    (``ops.groupnorm.group_norm_silu_spatial``)."""
    import torch.nn.functional as F

    from clip_codec_tpu_torch.parallel.mesh import merge_moments_model

    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    G, bf = GN_GROUPS, torch.bfloat16
    recs = {"group_norm_silu_stats": [], "group_norm_silu_apply": []}
    worst = {k: 0.0 for k in recs}
    timed = MP_GN_SHAPES + ST_GN_SHAPES  # phase 24's sampling shapes and phase 26's training shapes
    cases = [(shape, bf) for shape in timed] + [((WIDE_BATCH, 32, 64, 256), torch.float32), (GN_TAIL, bf)]
    for shape, dtype in cases:
        B, H, W, C = shape
        n = H * W * (C // G)
        x, scale, bias = _gn_inputs(torch, gen, shape, dev, dtype)
        with torch.no_grad():
            shift = x[:, 0, 0].reshape(B, G, C // G)[:, :, 0].float().contiguous()
            n0 = (gn.group_norm_silu_stats.launches, gn.group_norm_silu_apply.launches)
            part, part_s = gn.group_norm_silu_stats(x, G), gn.group_norm_silu_stats(x, G, shift=shift)
            mean, m2 = merge_moments_model(None, shift, part_s.sum(dim=1)[:, 0], part_s.sum(dim=1)[:, 1], n)
            tot = torch.stack([torch.zeros_like(m2), m2], dim=1)
            y = gn.group_norm_silu_apply(x, tot, n, (scale, bias), G, shift=mean)
            y_raw = gn.group_norm_silu_apply(x, part.sum(dim=1), n, (scale, bias), G)
        torch.cuda.synchronize()
        check((gn.group_norm_silu_stats.launches, gn.group_norm_silu_apply.launches) == (n0[0] + 2, n0[1] + 2),
              f"K1 split {shape}: not one launch per call")
        tag = f"group_norm_silu split {tuple(shape)} G={G} {str(dtype).split('.')[-1]}"
        # the partials' summation error scales with the sums of |terms|
        errs = {}
        for key, got, sh in (("stats", part, None), ("stats_shifted", part_s, shift)):
            want = gn.group_norm_silu_stats_plain(x, G, sh)
            mag = gn.group_norm_silu_stats_plain((x.float() if sh is None else x.float() - sh.repeat_interleave(
                C // G, dim=1)[:, None, None, :]).abs(), G)[:, :, 0].max()
            errs[key] = max((got[:, :, 0] - want[:, :, 0]).abs().max().item() / mag.item(),
                            ((got[:, :, 1] - want[:, :, 1]).abs().max() / want[:, :, 1].abs().max()).item())
            check(errs[key] <= 1e-5, f"{tag}: {key} partials off their plain version by {errs[key]} of their scale")
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for key, got, want in (
                ("apply", y, gn.group_norm_silu_norm_plain(x, tot, scale, bias, G, n=n, shift=mean)),
                ("apply_unshifted", y_raw, gn.group_norm_silu_norm_plain(x, part.sum(dim=1), scale, bias, G)),
                ("vs_group_norm_silu_plain", y, gn.group_norm_silu_plain(x, (scale, bias), G))):
            d = (got.float() - want.float()).abs()
            errs[key] = d.max().item()
            check(bool((d <= tol + tol * want.float().abs()).all().item()),
                  f"{tag}: {key} outside rtol=atol={tol} (max abs err {errs[key]})")
        worst["group_norm_silu_stats"] = max(worst["group_norm_silu_stats"], errs["stats"], errs["stats_shifted"])
        worst["group_norm_silu_apply"] = max(worst["group_norm_silu_apply"], errs["apply"])
        line = f"kernel-check: {tag} " + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
        if dtype == bf and shape in timed:
            with torch.no_grad():
                stats = lambda: gn.group_norm_silu_stats(x, G, shift=shift)
                apply = lambda: gn.group_norm_silu_apply(x, tot, n, (scale, bias), G, shift=mean)
                t = dict(stats_ms=graph_ms(torch, stats), stats_events_ms=cuda_ms(torch, stats),
                         apply_ms=graph_ms(torch, apply), apply_events_ms=cuda_ms(torch, apply),
                         stats_plain_ms=cuda_ms(torch, lambda: gn.group_norm_silu_stats_plain(x, G, shift), iters=5),
                         apply_plain_ms=cuda_ms(torch, lambda: gn.group_norm_silu_norm_plain(
                             x, tot, scale, bias, G, n=n, shift=mean), iters=5),
                         one_launch_k1_ms=graph_ms(torch, lambda: gn.group_norm_silu(x, (scale, bias), G)))
                xc, sb, bb = x.permute(0, 3, 1, 2), scale.to(bf), bias.to(bf)  # NCHW view, channels_last
                t["library_ms"] = graph_ms(torch, lambda: F.silu(F.group_norm(xc, G, sb, bb, 1e-5)))
            m = B * H * W * C
            sb_ms, sb_by, sb_unit = bound(m * 2 + B * 2 * G * 4, 3 * m, FP32_FLOPS_PER_S)  # x read once
            ab_ms, ab_by, ab_unit = bound(2 * m * 2, 11 * m, FP32_FLOPS_PER_S)  # x read once, y written once
            lib = "F.group_norm + F.silu (bf16, NCHW view): the whole GroupNorm+SiLU, for scale; never called"
            for name, ms, ev, pl, b in (("group_norm_silu_stats", t["stats_ms"], t["stats_events_ms"],
                                         t["stats_plain_ms"], (sb_ms, sb_by, sb_unit)),
                                        ("group_norm_silu_apply", t["apply_ms"], t["apply_events_ms"],
                                         t["apply_plain_ms"], (ab_ms, ab_by, ab_unit))):
                recs[name].append(dict(shape=list(shape), ms=ms, events_ms=ev, plain_ms=pl, bound_ms=b[0],
                                       bound_by=b[1], bound_unit=b[2], library_ms=t["library_ms"], library=lib,
                                       one_launch_k1_ms=t["one_launch_k1_ms"]))
            line += (f" stats_ms={t['stats_ms']:.4f} (graph; events {t['stats_events_ms']:.4f}, plain "
                     f"{t['stats_plain_ms']:.4f}, bound {sb_ms:.4f} {sb_unit}) apply_ms={t['apply_ms']:.4f} (graph; "
                     f"events {t['apply_events_ms']:.4f}, plain {t['apply_plain_ms']:.4f}, bound {ab_ms:.4f} "
                     f"{ab_unit}) spatial_gn_ms={t['stats_ms'] + t['apply_ms']:.4f} (stats + apply, the "
                     f"all-gather apart) one_launch_k1_ms={t['one_launch_k1_ms']:.4f} "
                     f"library_ms={t['library_ms']:.4f}")
        print(line)
        del x, part, part_s, y, y_raw
    for name, rs in recs.items():
        for r in rs:
            r["max_abs_err"] = worst[name]
    torch.cuda.empty_cache()
    return recs


def _shape_key(key: str):
    """``"<kernel> [a, b, c]"`` -> (kernel, (a, b, c))."""
    name, shape = key.split(" ", 1)
    return name, tuple(json.loads(shape))


def phase_mp(torch, attn, mlp, seed, dev, card):
    """Phase 24 (24b-24e): the model axis with two ranks sharing the card
    (gloo) and one NCCL rank alone. Returns the kernels' launches by
    (kernel, shape), summed over the two ranks, and K4's and K6's records
    at the tensor-parallel shapes."""
    import numpy as np

    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as sd_cli
    from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddim_sample
    from clip_codec_tpu_torch.models import CLIPCondUNet
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder
    from clip_codec_tpu_torch.ops import groupnorm as gn
    from clip_codec_tpu_torch.utils.checkpoint import load_state_dict
    from clip_codec_tpu_torch.utils.config import ModelConfig
    from clip_codec_tpu_torch.weights import sd_checkpoint as ckpt

    t_phase = time.perf_counter()
    build = ROOT / "build" / "chip_smoke"
    mp = build / "mp"
    shutil.rmtree(mp, ignore_errors=True)
    mp.mkdir(parents=True)
    sd_dir, weights = build / "sd", build / "store" / "diffusion_unet_final.pt"
    rng = np.random.default_rng(seed + 40)
    np.savez(mp / "tp_in.npz", lat=rng.standard_normal((MP_TP_BATCH, 64, 64, 4)).astype(np.float32),
             t=np.full(MP_TP_BATCH, 500, np.int32),
             ctx=rng.standard_normal((MP_TP_BATCH, MP_CTX, 768)).astype(np.float32))
    z_sd = rng.standard_normal((1, 512)).astype(np.float32)
    np.save(mp / "z_sd.npy", z_sd / np.linalg.norm(z_sd))
    z_px = rng.standard_normal((WIDE_BATCH, 512)).astype(np.float32)
    np.save(mp / "z_px.npy", z_px / np.linalg.norm(z_px, axis=1, keepdims=True))
    np.save(mp / "x_T.npy", rng.standard_normal((WIDE_BATCH, SIZE, SIZE, 3)).astype(np.float32))
    sd_files = dict(unet=str(sd_dir / "unet.pt"), vae=str(sd_dir / "vae.pt"), adapter=str(sd_dir / "adapter.pt"))
    tp_art = dict(name="tp_artifact", **sd_files, path=str(mp / "tp.torchprog"), size=SD_SIZE, steps=MP_SD_STEPS,
                  z=str(mp / "z_sd.npy"), seed=seed)
    px = dict(weights=str(weights), z=str(mp / "z_px.npy"), size=SIZE, steps=STEPS, seed=seed)
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLIP_CODEC_")}
    two = _run_ranks(torch, {"out": str(mp / "two"), "tasks": [
        dict(name="tp_forward", unet=sd_files["unet"], inputs=str(mp / "tp_in.npz"), reps=MP_REPS), tp_art,
        dict(name="spatial_sample", **px, x_T=str(mp / "x_T.npy"), check_steps=MP_CHECK_STEPS,
             check_timesteps=MP_CHECK_TIMESTEPS),
        dict(name="spatial_artifact", **px, path=str(mp / "spatial.torchprog"))]}, 2, env, MP_TIMEOUT, "mp_rank")
    one = _run_ranks(torch, {"out": str(mp / "one"), "tasks": [tp_art]}, 1, env, MP_TIMEOUT, "mp_rank")

    errors, launches = [], collections.Counter()

    def part(fn):
        try:
            fn()
        except PhaseError as e:
            errors.append(str(e))

    def tally(task):
        for rec in two:
            for key, n in rec[task]["by_shape"].items():
                launches[_shape_key(key)] += n

    def tp_forward():  # 24b
        unet, _ = sd_cli.load_frozen(sd_dir / "unet.pt", sd_dir / "vae.pt", dev, heads=8)
        inp = np.load(mp / "tp_in.npz")
        args = [torch.from_numpy(inp[k]).to(dev) for k in ("lat", "t", "ctx")]
        with torch.no_grad():
            want = unet(*args).float().cpu()
            unet.compute_dtype = torch.float32
            with plain_sd_kernels(attn, mlp):
                fp32 = unet(*args).float().cpu()
        del unet
        torch.cuda.empty_cache()
        eps = [torch.load(mp / "two" / f"rank{r}_tp_eps.pt", weights_only=True) for r in range(2)]
        rel = [((e - want).norm() / want.norm()).item() for e in eps]
        floor = ((want - fp32).norm() / fp32.norm()).item()
        tp32 = ((eps[0] - fp32).norm() / fp32.norm()).item()
        recs = [r["tp_forward"] for r in two]
        want_shapes = {f"flash_attention {list(s)}": 5 for s in MP_TP_FLASH}
        for stage in ("mlp_up", "mlp_down"):
            want_shapes.update({f"{stage} {list(s)}": c for s, c in zip(MP_TP_MLP, (5, 5, 5, 1))})
        print(f"mp-24b: the tensor-parallel SD-1.5 UNet, 2 ranks sharing {card} over gloo, one forward at UNet "
              f"batch {MP_TP_BATCH} (CFG batched), 64x64 latents, a {MP_CTX}-token context: heads a rank "
              f"{[r['heads'] for r in recs]}; ranks bit-equal: {torch.equal(eps[0], eps[1])}; ||eps_rank - "
              f"eps_one_rank|| / ||eps_one_rank|| = {[f'{x:.3e}' for x in rel]}; from the fp32 plain path: one "
              f"rank {floor:.3e}, TP {tp32:.3e} (ratio {tp32 / floor:.4f}); launches by shape a rank "
              f"{[r['by_shape'] for r in recs]}; device ms a forward (events over {MP_REPS}, each rank's own "
              f"and the other's work: a shared card, not scaling) {[round(r['device_ms'], 3) for r in recs]}")
        check(torch.equal(eps[0], eps[1]), "24b: the two ranks' eps differ")
        check(tp32 <= MP_TP_RATIO * floor, f"24b: TP eps {tp32} from the fp32 plain path, over {MP_TP_RATIO} x the "
              f"one-rank forward's distance ({floor})")
        check(max(rel) <= MP_TP_FLOOR * floor, f"24b: TP eps off the one-rank forward by {rel}, over "
              f"{MP_TP_FLOOR} x the one-rank path's distance from fp32 ({floor})")
        for r in recs:
            check(r["by_shape"] == want_shapes, f"24b: launches by shape {r['by_shape']} != {want_shapes}")
            check(r["launches"]["mlp_down"] == 16 and r["launches"]["flash_attention"] == 10,
                  f"24b: launches {r['launches']}")
        tally("tp_forward")

    def tp_artifact():  # 24c
        unet, vae, adapter = (ckpt.read_checkpoint(sd_dir / f"{n}.pt") for n in ("unet", "vae", "adapter"))
        unet, vae, adapter = ckpt.unet_state_dict(unet), ckpt.vae_state_dict(vae), ckpt.adapter_state_dict(adapter)
        single = deploy.load_sd_decompressor(deploy.export_sd_decompressor(
            unet, vae, adapter, mp / "single.torchprog", size=SD_SIZE, steps=MP_SD_STEPS, batch_size=1), device=dev)
        want = single(unet, vae, adapter, np.load(mp / "z_sd.npy"), seed=seed).cpu()
        # the same request through the plain versions in fp32 (eager, the artifact's x_T draw for the seed)
        meta = deploy.read_artifact_meta(deploy.export_sd_decompressor(
            unet, vae, adapter, mp / "fp32.torchprog", size=SD_SIZE, steps=MP_SD_STEPS, batch_size=1,
            dtype="float32"))
        mods = deploy._sd_modules(meta, dev)
        for m, st in zip(mods, (unet, vae, adapter)):
            m.load_state_dict(st, strict=True)
        dec = StableDiffusionDecoder(*(m.eval() for m in mods))
        z = torch.from_numpy(np.load(mp / "z_sd.npy")).to(dev)
        x_T = torch.randn(single.latent_shape(), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        with torch.no_grad(), plain_sd_kernels(attn, mlp):
            fp32 = deploy.make_sd_decompress_fn(SD_SIZE, MP_SD_STEPS, batch_size=1)(dec, z, x_T, 5.0).cpu()
        del single, dec, mods, unet, vae, adapter
        torch.cuda.empty_cache()
        got = torch.from_numpy(np.load(mp / "two" / "tp_artifact.npy"))
        rel = ((got - want).norm() / want.norm()).item()
        floor = ((want - fp32).norm() / fp32.norm()).item()
        tp32 = ((got - fp32).norm() / fp32.norm()).item()
        a, o = [r["tp_artifact"] for r in two], one[0]["tp_artifact"]
        print(f"mp-24c: the tensor-parallel SD artifact (512px, ddim-{MP_SD_STEPS}, batch 1, CFG batched) on a "
              f"(1, 2) mesh over gloo: replay {[r['replay'] for r in a]}, a request {[round(r['request_s'], 3) for r in a]}"
              f" s a rank (a shared card, not scaling; the first call {[round(r['first_call_s'], 3) for r in a]} s), "
              f"||img - single|| / ||single|| = {rel:.3e} (from the fp32 plain sampler: single {floor:.3e}, TP "
              f"{tp32:.3e}, ratio {tp32 / floor:.4f}), launches a request {a[0]['request_launches']}; on one "
              f"NCCL rank, mesh (1, 1): replay {o['replay']}, a request {o['request_s']:.3f} s (the single-device "
              f"artifact's replay {o['single_replay']}), bit-equal to the single-device artifact: "
              f"{o['bit_equal_to_single']} (max |diff| {o['max_abs_diff_to_single']:.3e}) on {card}")
        check(all(r["replay"] == "eager" for r in a), f"24c: gloo replay {[r['replay'] for r in a]}")
        check(a[0]["meta"]["mesh"] == {"data": 1, "model": 2} and a[0]["meta"]["sharded"] is True,
              f"24c: header {a[0]['meta']}")
        check(tp32 <= MP_TP_RATIO * floor, f"24c: TP images {tp32} from the fp32 plain sampler, over {MP_TP_RATIO} "
              f"x the single-device artifact's distance ({floor})")
        check(rel <= MP_TP_FLOOR * floor, f"24c: TP images off the single-device artifact's by {rel}, over "
              f"{MP_TP_FLOOR} x its distance from the fp32 plain sampler ({floor})")
        check(o["replay"] == "graph" and o["single_replay"] == "graph", f"24c: NCCL replay {o['replay']}")
        check(o["bit_equal_to_single"], "24c: the (1, 1) artifact's images differ from the single-device one's")
        want_req = {"flash_attention": MP_SD_STEPS * SD_FLASH_PER_FORWARD + 1,
                    "mlp_up": MP_SD_STEPS * SD_MLP_PER_FORWARD, "mlp_down": MP_SD_STEPS * SD_MLP_PER_FORWARD,
                    "transformer_mlp": MP_SD_STEPS * SD_MLP_PER_FORWARD}
        for r in a:
            check(r["request_launches"] == want_req, f"24c: a request launched {r['request_launches']} != {want_req}")
        tally("tp_artifact")  # the warm-up call and the request

    def spatial():  # 24d, 24e
        mc = ModelConfig.find_for_checkpoint(weights)
        with torch.device(dev):
            net = CLIPCondUNet(z_dim=mc.z_dim, base=mc.base, ch_mult=tuple(mc.ch_mult), time_dim=mc.time_dim,
                               img_ch=mc.img_ch, dtype=torch.float32, fused_pallas=False)
        net.load_state_dict(load_state_dict(weights), strict=True)
        net.eval().requires_grad_(False)
        z = torch.from_numpy(np.load(mp / "z_px.npy")).to(dev)
        x_T = torch.from_numpy(np.load(mp / "x_T.npy")).to(dev)
        sched = NoiseSchedule.create(MP_CHECK_TIMESTEPS, "linear")
        with torch.no_grad():
            want_k1 = ddim_sample(net, sched, z, tuple(x_T.shape), MP_CHECK_STEPS, x_T=x_T).cpu().numpy()
            with plain_k1(gn):
                want = ddim_sample(net, sched, z, tuple(x_T.shape), MP_CHECK_STEPS, x_T=x_T).cpu().numpy()
        del net
        torch.cuda.empty_cache()
        got = np.load(mp / "two" / "spatial_fp32.npy")
        d, d_k1, d_ref = (float(np.abs(a - b).max()) for a, b in ((got, want), (got, want_k1), (want_k1, want)))
        s = [r["spatial_sample"] for r in two]
        by_shape = [{k: v for k, v in r["by_shape"].items()} for r in s]
        want_shapes = {}
        for shape, calls in zip(MP_GN_SHAPES, MP_GN_CALLS):
            want_shapes[f"group_norm_silu_stats {list(shape)}"] = calls * STEPS
            want_shapes[f"group_norm_silu_apply {list(shape)}"] = calls * STEPS
        print(f"mp-24d: sample_spatial_sharded, the pixel U-Net (base {mc.base}, ch_mult {tuple(mc.ch_mult)}, "
              f"{SIZE}px, B = {WIDE_BATCH}), H split over 2 ranks sharing {card} over gloo: fp32, {MP_CHECK_STEPS} "
              f"DDIM steps on a linear schedule, max |x_spatial - x_unsharded| = {d:.3e} against the unsharded direct "
              f"form with the plain GroupNorm+SiLU, {d_k1:.3e} against it with the one-launch K1 (which itself sits "
              f"{d_ref:.3e} from the plain form); bf16 DDIM-{STEPS} {[round(r['bf16_s'], 3) for r in s]} s a rank "
              f"(a shared card and gloo halos, not scaling); K1 split launches a rank "
              f"{[(r['launches']['group_norm_silu_stats'], r['launches']['group_norm_silu_apply']) for r in s]}, "
              f"one-launch K1 {[r['launches']['group_norm_silu'] for r in s]}")
        check(np.isfinite(got).all() and got.shape == (WIDE_BATCH, SIZE, SIZE, 3), f"24d: output {got.shape}")
        check(d <= MP_FP32_TOL, f"24d: the fp32 spatial sample is {d} from the unsharded direct form (bound "
              f"{MP_FP32_TOL})")
        for b in by_shape:
            check(b == want_shapes, f"24d: K1 split launches by shape {b} != {want_shapes}")
        tally("spatial_sample")
        a = [r["spatial_artifact"] for r in two]
        path = mp / "spatial.torchprog"
        jax_header = {"kind": "pixel", "size": SIZE, "steps": STEPS, "sampler": "ddim", "eta": 0.0,
                      "batch_size": WIDE_BATCH, "z_dim": mc.z_dim, "img_ch": mc.img_ch, "sharded": True,
                      "spatial": True, "mesh": {"data": 1, "model": 2}}  # what JAX's export writes for these flags
        meta = a[0]["meta"]
        print(f"mp-24e: the spatial pixel artifact (DDIM-{STEPS}, B = {WIDE_BATCH}, {SIZE}px) on (1, 2) over gloo: "
              f"replay {[r['replay'] for r in a]}, a call {[round(r['call_s'], 3) for r in a]} s a rank (a shared "
              f"card, not scaling), max |img - 24d's clipped bf16 sample| = {a[0]['max_abs_diff_to_sample']:.3e}, "
              f"JAX's header keys and values: {({k: meta.get(k) for k in jax_header} == jax_header)}, the mesh "
              f"refusal: {a[0]['mesh_refusal']!r}")
        check({k: meta.get(k) for k in jax_header} == jax_header, f"24e: header {meta} != JAX's {jax_header}")
        check(all(r["replay"] == "eager" for r in a), f"24e: gloo replay {[r['replay'] for r in a]}")
        check(a[0]["mesh_refusal"] == f"{path}: exported for mesh {{'data': 1, 'model': 2}}, got "
              f"{{'data': 2, 'model': 1}}", f"24e: mesh refusal {a[0]['mesh_refusal']!r}")
        check(a[0]["max_abs_diff_to_sample"] <= MP_FP32_TOL, f"24e: the artifact's images are "
              f"{a[0]['max_abs_diff_to_sample']} from 24d's sample at the same seed")
        for r in a:
            check(r["by_shape"] == want_shapes, f"24e: K1 split launches by shape {r['by_shape']} != {want_shapes}")
        tally("spatial_artifact")

    for fn in (tp_forward, tp_artifact, spatial):
        part(fn)
    check(not errors, "; ".join(errors))
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    records = {"flash_attention": flash_cases(torch, attn, gen, dev, MP_TP_FLASH)}
    records.update(phase_mlp_kernels(torch, mlp, gen, dev, MP_TP_MLP, ragged=None))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"mp-24: mlp_down splits at the tensor-parallel shapes (R, C, F/2): "
          f"{ {str(s): mlp.down_splits(*s, sms) for s in MP_TP_MLP} } on {sms} SMs (the whole F: "
          f"{ {str((R, C, 2 * F)): mlp.down_splits(R, C, 2 * F, sms) for R, C, F in MP_TP_MLP} })")
    print(f"mp: phase 24 in {time.perf_counter() - t_phase:.1f} s; launches by shape summed over the two ranks "
          f"{dict(launches)}; two ranks sharing one card measure correctness and overhead, not scaling")
    return launches, records




# ------------------------------------------------ phase 25: the modules with no TPU kernel of their own

CODEC_ROWS, CODEC_DIM = 10_000, 512
DEC_BATCH, DEC_STEPS = 16, 5
DDPM_SHORT, DDPM_T, DDPM_BATCH = 50, 1000, 2
P25_FRAMES = 4  # frames a 25b decompress request carries (one batch of SERVE_BATCH)


@contextlib.contextmanager
def conv_tally(rc):
    """K2 and K3 launches by (kernel, (B, H, W, Cin, Cout)), counted at
    the wrappers' one launcher."""
    tally = collections.Counter()
    launch = rc._launch

    def counted(x, A, B, w9, bias, add, want_moments, linear):
        tally[("affine_conv3x3" if linear else "affine_silu_conv3x3", (*x.shape, w9.shape[2]))] += 1
        return launch(x, A, B, w9, bias, add, want_moments, linear)

    rc._launch = counted
    try:
        yield tally
    finally:
        rc._launch = launch


def check_conv_launches(rc, tally, batch, forwards, tag):
    """K2's and K3's counts, each read on its own since ``reset_launches``,
    against ``forwards`` forwards of the full-width U-Net, and the tally by
    shape against its conv shapes at ``batch``."""
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    got = {"affine_silu_conv3x3": rc.affine_silu_conv3x3.launches, "affine_conv3x3": rc.affine_conv3x3.launches}
    want = {"affine_silu_conv3x3": (LAUNCHES_PER_FORWARD - 1) * forwards, "affine_conv3x3": forwards}
    check(got == want, f"{tag}: launches {got} != {want}")
    shapes = path_conv_shapes(PX_BASE, PX_CH_MULT, SIZE, batch)
    want = {("affine_conv3x3" if shape == shapes[-1][0] else "affine_silu_conv3x3", shape): calls * forwards
            for shape, calls in shapes}
    check(dict(tally) == want, f"{tag}: launches by shape {dict(tally)} != {want}")
    return got


def _code_rows(seed, n, d):
    """Code-like rows: a quantized Gaussian around the middle of the range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.clip(np.rint(rng.standard_normal((n, d)) * 24 + 128), 0, 255).astype(np.uint8)


def phase_codec(torch, seed, card):
    """25a: the native store codec on the card machine."""
    import numpy as np

    from clip_codec_tpu_torch.io import bitstream, native
    from clip_codec_tpu_torch.io.store import Store, write_store

    t0 = time.perf_counter()
    nc = native.codec()
    check(nc is not None, f"25a: the native store codec did not build: {native.load_error()}")
    engine = bitstream.zstd_engine()
    check(engine == "native", f"25a: the zstd engine is {engine!r}, not native")
    print(f"25a: engine {engine}, libzstd {nc.zstd_version}, built and loaded in {time.perf_counter() - t0:.3f} s")
    codes = _code_rows(seed + 25, CODEC_ROWS, CODEC_DIM)
    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = (time.perf_counter() - t) / CODEC_ROWS * 1e6
        return out

    frames = timed("batch_compress", lambda: bitstream.compress_frames(codes))
    back = timed("batch_decompress", lambda: bitstream.decompress_frames(frames, CODEC_DIM))
    check(np.array_equal(back, codes), "25a: batch frames do not read back to the codes")
    single = timed("single_compress", lambda: [bitstream.compress_frame(r.tobytes()) for r in codes])
    check(single == frames, "25a: single frames differ from the batch's")
    back = timed("single_decompress", lambda: np.stack([bitstream.decompress_frame(f) for f in frames]))
    check(np.array_equal(back, codes), "25a: single frames do not read back to the codes")
    store = ROOT / "build" / "chip_smoke" / "codec"
    shutil.rmtree(store, ignore_errors=True)
    scale, zero = np.full(CODEC_DIM, 2 / 255, np.float32), np.full(CODEC_DIM, -1.0, np.float32)
    timed("write_store", lambda: write_store(store, codes.astype(np.float32), [f"img{i}.png" for i in range(CODEC_ROWS)],
                                             scale, zero, codes))
    back = timed("read_codes", lambda: Store.open(store).read_codes())
    check(np.array_equal(back, codes), "25a: the store does not read back to the codes")
    good = frames[0]
    bomb = nc.compress_frame(bytes(1 << 21))
    for name, bad, kw in (("bad magic", b"XXXX" + good[4:], {}), ("truncated header", b"CLPF\x01", {}),
                          ("corrupt payload", good[:8] + bytes(len(good) - 8), {}),
                          ("bomb", bomb, {"max_output": 1 << 20})):
        try:
            bitstream.decompress_frame(bad, **kw)
        except ValueError as e:
            print(f"25a: {name} refused: {e}")
        else:
            raise PhaseError(f"25a: a frame with a {name} was accepted")
    shutil.rmtree(store, ignore_errors=True)
    mean_bytes = sum(len(f) for f in frames) / len(frames)
    print(f"25a: {CODEC_ROWS} rows of D = {CODEC_DIM}, {mean_bytes:.1f} bytes a frame; us a frame: "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + f" (host CPU, {card})")
    return times


def phase_msgpack(torch, rc, seed, dev, card):
    """25b: JAX-layout .msgpack checkpoints written on the card machine and
    loaded by the port's entry points."""
    import warnings

    import numpy as np
    from PIL import Image

    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as sd_cli
    from clip_codec_tpu_torch.codec import ClipCodec
    from clip_codec_tpu_torch.io.store import write_store
    from clip_codec_tpu_torch.utils.checkpoint import save_params
    from clip_codec_tpu_torch.weights.convert import convert_sd_adapter, convert_unet

    root = ROOT / "build" / "chip_smoke" / "msgpack"
    shutil.rmtree(root, ignore_errors=True)
    net = full_unet(torch, seed + 25, dev)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    del net
    codes = _code_rows(seed + 26, P25_FRAMES, 512)
    scale, zero = np.full(512, 2 / 255, np.float32), np.full(512, -1.0, np.float32)
    out = {}
    launches = collections.Counter()  # K2 and K3 by (kernel, shape) over the two decompresses
    for name in ("msgpack", "pt"):
        store = root / name
        manifest = write_store(store, codes.astype(np.float32), [f"img{i}.png" for i in range(P25_FRAMES)],
                               scale, zero, codes)
        t0 = time.perf_counter()
        if name == "msgpack":
            save_params(store / "diffusion_unet_final.msgpack", convert_unet(sd, PX_CH_MULT))
        else:
            torch.save(sd, store / "diffusion_unet_final.pt")
        t1 = time.perf_counter()
        with warnings.catch_warnings():  # no model_config.json: the architecture is inferred
            warnings.simplefilter("ignore")
            codec = ClipCodec.load(store, device=dev)
        t2 = time.perf_counter()
        check(codec.net is not None and (codec.mc.base, codec.mc.ch_mult) == (PX_BASE, PX_CH_MULT),
              f"25b: ClipCodec.load of the {name} store: {codec.mc}")
        frames = [Path(r["bitstream"]).read_bytes() for r in manifest]
        reset_launches(rc)
        torch.cuda.synchronize()
        with conv_tally(rc) as tally:
            t3 = time.perf_counter()
            out[name] = codec.decompress(frames, size=SIZE, steps=STEPS, batch_size=SERVE_BATCH, seed=seed)
            t4 = time.perf_counter()
        got = check_conv_launches(rc, tally, SERVE_BATCH, STEPS, f"25b: {name}")
        launches.update(tally)
        print(f"25b: {name}: launches {got}; written in {t1 - t0:.3f} s ({(store / f'diffusion_unet_final.{name}').stat().st_size / 2**20:.1f} "
              f"MiB), ClipCodec.load {t2 - t1:.3f} s, DDIM-{STEPS} {SIZE}px decompress of {P25_FRAMES} frames "
              f"{t4 - t3:.3f} s on {card}")
        del codec
        torch.cuda.empty_cache()
    check(np.array_equal(out["msgpack"], out["pt"]), "25b: the .msgpack store's images differ from the .pt store's")
    check(bool(np.isfinite(out["pt"]).all()), "25b: non-finite images")
    print("25b: the .msgpack and .pt stores' images bit-equal")
    sd_dir = ROOT / "build" / "chip_smoke" / "sd"
    adapter = torch.load(sd_dir / "adapter.pt", map_location="cpu", weights_only=True)
    save_params(root / "sd_adapter_final.msgpack", convert_sd_adapter(adapter))
    pngs = {}
    env = {"CLIP_CODEC_SD_UNET_WEIGHTS": str(sd_dir / "unet.pt"), "CLIP_CODEC_SD_VAE_WEIGHTS": str(sd_dir / "vae.pt")}
    with mock.patch.dict(os.environ, env):
        for name, path in (("pt", sd_dir / "adapter.pt"), ("msgpack", root / "sd_adapter_final.msgpack")):
            png = root / f"sd_{name}.png"
            t0 = time.perf_counter()
            sd_cli.main(["--store_dir", str(sd_dir), "--bitstream", str(sd_dir / "img0.clp"), "--adapter", str(path),
                         "--out", str(png), "--steps", str(SD_STEPS), "--sampler", "dpmpp", "--inv_weight", "0"])
            print(f"25b: SD CLI --adapter {path.name}: {time.perf_counter() - t0:.3f} s on {card}")
            pngs[name] = np.asarray(Image.open(png))
    check(pngs["pt"].shape == (SD_SIZE, SD_SIZE, 3), f"25b: SD PNG {pngs['pt'].shape}")
    check(np.array_equal(pngs["pt"], pngs["msgpack"]), "25b: the SD CLI's PNG from the .msgpack adapter differs")
    print("25b: the SD CLI's PNGs from the .msgpack and .pt adapters bit-equal")
    return launches


def phase_direct_decoders(torch, seed, dev, card):
    """25c: the direct decoders on the card, bf16 against fp32, the
    inference helper on a real frame and the trainer's s/step."""
    import numpy as np

    from clip_codec_tpu_torch.models import CLIPCondDecoder, FeatureToImageDecoderLite, init_params
    from clip_codec_tpu_torch.train.train_decoder import reconstruct_image_from_bitstream, train_direct_decoder

    z = torch.randn((DEC_BATCH, 512), generator=torch.Generator().manual_seed(seed + 27))
    z = (z / z.norm(dim=1, keepdim=True)).to(dev)
    px_store = ROOT / "build" / "chip_smoke" / "train_px"  # phase 14's 16 images and their frames
    frame = Path(json.loads((px_store / "manifest.json").read_text())[0]["bitstream"])
    for name, make, size in (("CLIPCondDecoder", lambda dt: CLIPCondDecoder(512, 192, 512, dtype=dt), 512),
                             ("FeatureToImageDecoderLite", lambda dt: FeatureToImageDecoderLite(512, 256, 64, dtype=dt),
                              64)):
        m32 = init_params(make(torch.float32), torch.Generator().manual_seed(seed)).to(dev).eval()
        mbf = make(torch.bfloat16)
        mbf.load_state_dict(m32.state_dict())
        mbf = mbf.to(dev).eval()
        with torch.no_grad():
            y32, ybf = m32(z), mbf(z).float()
            rel = float((ybf - y32).norm() / y32.norm())
            ms = cuda_ms(torch, lambda: mbf(z))
        check(tuple(y32.shape) == (DEC_BATCH, size, size, 3), f"25c: {name} output {tuple(y32.shape)}")
        check(bool(torch.isfinite(ybf).all()), f"25c: {name}: non-finite bf16 output")
        check(rel < 2e-2, f"25c: {name}: bf16 {rel:.3e} from fp32")
        img = reconstruct_image_from_bitstream(frame, px_store, m32)
        check(img.size == (size, size), f"25c: {name}: reconstruct_image_from_bitstream gave {img.size}")
        train_direct_decoder(px_store, m32, out_size=size, epochs=1, batch_size=DEC_BATCH, device=dev)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, loss = train_direct_decoder(px_store, m32, out_size=size, epochs=DEC_STEPS, batch_size=DEC_BATCH,
                                       device=dev)
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / DEC_STEPS
        check(loss is not None and np.isfinite(loss), f"25c: {name}: training loss {loss}")
        print(f"25c: {name} {size}px B={DEC_BATCH}: bf16 {rel:.3e} from fp32 (relative norm), bf16 forward "
              f"{ms:.3f} ms; reconstruct_image_from_bitstream {img.size}; train_direct_decoder fp32 "
              f"{s_step:.3f} s/step over {DEC_STEPS} steps (loss {loss:.4f}), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
        del m32, mbf, y32, ybf
        torch.cuda.empty_cache()


def phase_ddpm(torch, rc, gn, seed, dev, card):
    """25d: ancestral DDPM through the full-width U-Net. Returns the net,
    K2's and K3's launches by (kernel, shape) over the two kernel-path runs
    and their records at the runs' B = 2 shapes."""
    from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddpm_sample
    from clip_codec_tpu_torch.utils.profiling import StepTimer

    records = phase_kernels(torch, rc, seed + 28, dev, batches=(DDPM_BATCH,), checked=())
    net = full_unet(torch, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    shape = (DDPM_BATCH, SIZE, SIZE, 3)
    z = torch.randn((DDPM_BATCH, 512), generator=gen, device=dev)
    z = z / z.norm(dim=1, keepdim=True)
    x_T = torch.randn(shape, generator=gen, device=dev)
    noise = [torch.randn(shape, generator=gen, device=dev) for _ in range(DDPM_SHORT - 1)]
    short = NoiseSchedule.create(DDPM_SHORT, device=dev)
    reset_launches(rc)
    with conv_tally(rc) as launches:
        xk = ddpm_sample(net, short, z, shape, x_T=x_T, noise=noise)
    n_short = check_conv_launches(rc, launches, DDPM_BATCH, DDPM_SHORT, f"25d: DDPM-{DDPM_SHORT}")
    with plain_convs(rc):
        xp = ddpm_sample(net, short, z, shape, x_T=x_T, noise=noise)
    rel = float((xk - xp).norm() / xp.norm())
    check(bool(torch.isfinite(xk).all()), "25d: non-finite DDPM-50 sample")
    check(rel < 2e-2, f"25d: DDPM-{DDPM_SHORT} kernel path {rel:.3e} from the plain path")
    print(f"25d: DDPM-{DDPM_SHORT} B={DDPM_BATCH} {SIZE}px: kernel path {rel:.3e} from the plain path (relative norm); "
          f"launches {n_short}")
    del noise, xk, xp
    counters = {"group_norm_silu": gn.group_norm_silu, "affine_silu_conv3x3": rc.affine_silu_conv3x3,
                "affine_conv3x3": rc.affine_conv3x3}
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        net(x_T, z, torch.full((DDPM_BATCH,), DDPM_T - 1, dtype=torch.int32, device=dev))
    tally = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    timer = StepTimer(skip_first=0, device=dev)
    with conv_tally(rc) as long_tally, timer:
        x = ddpm_sample(net, NoiseSchedule.create(DDPM_T, device=dev), z, shape, generator=gen)
    got = {k: c.launches for k, c in counters.items()}
    check(bool(torch.isfinite(x).all()), f"25d: non-finite DDPM-{DDPM_T} sample")
    for k in counters:
        check(got[k] == tally[k] * DDPM_T, f"25d: {k}: {got[k]} launches != {tally[k]} x {DDPM_T}")
    check_conv_launches(rc, long_tally, DDPM_BATCH, DDPM_T, f"25d: DDPM-{DDPM_T}")
    launches.update(long_tally)
    print(f"25d: DDPM-{DDPM_T} B={DDPM_BATCH} {SIZE}px through the kernels: {timer.mean_s:.3f} s "
          f"({timer.mean_s / DDPM_T * 1e3:.3f} ms a step) on {card}; launches {got} = per-forward {tally} x {DDPM_T}")
    return net, launches, records


def phase_utils(torch, rc, net, seed, dev, card):
    """25e: a Chrome trace around one forward, and nan_checked on the card."""
    from clip_codec_tpu_torch.utils.debug import nan_checked
    from clip_codec_tpu_torch.utils.profiling import TRACE_NAME, annotate, trace

    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    x = torch.randn((SERVE_BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
    z = torch.randn((SERVE_BATCH, 512), generator=gen, device=dev)
    t = torch.full((SERVE_BATCH,), 500, dtype=torch.int32, device=dev)
    out = ROOT / "build" / "chip_smoke" / "trace"
    shutil.rmtree(out, ignore_errors=True)
    with torch.no_grad():
        net(x, z, t)  # warm
        with trace(out):
            with annotate("chip_smoke_unet_forward"):
                n0 = rc.affine_silu_conv3x3.launches
                net(x, z, t)
                launched = rc.affine_silu_conv3x3.launches - n0
    events = json.loads((out / TRACE_NAME).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2 = [e for e in kernels if "conv_wgmma_kernel" in e.get("name", "")]
    check(any(e.get("name") == "chip_smoke_unet_forward" for e in events), "25e: no annotate region in the trace")
    # CUPTI may drop a kernel at the profiler's start: the trace must name K2, not hold every launch
    check(0 < len(k2) <= launched == LAUNCHES_PER_FORWARD - 1, f"25e: {len(k2)} K2 kernels in the trace, {launched} launched")
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    print(f"25e: trace {out / TRACE_NAME} ({(out / TRACE_NAME).stat().st_size / 2**10:.0f} KiB): the annotate region, "
          f"{len(kernels)} kernels ({len(k2)} K2 of the {launched} launched) summing to {busy:.3f} ms of device time "
          f"in one B={SERVE_BATCH} forward on {card}")
    checked = nan_checked(net)
    with torch.no_grad():
        checked(x, z, t)
        x[0, 7, 7, 0] = float("nan")
        try:
            checked(x, z, t)
        except FloatingPointError as e:
            print(f"25e: nan_checked raised on the card: {e}")
        else:
            raise PhaseError("25e: nan_checked did not raise on a NaN input")


def phase_25(torch, rc, gn, seed, dev, card, records):
    """25a-25e; returns the kernels line's phase 25 rows: K2 and K3 at each
    shape that 25b's two decompresses (B = 4, timed in phase 1) and 25d's
    two DDPM runs (B = 2, timed in 25d) launched them at, with the launches
    counted there."""
    t0 = time.perf_counter()
    phase_codec(torch, seed, card)
    launches = phase_msgpack(torch, rc, seed, dev, card)
    phase_direct_decoders(torch, seed, dev, card)
    net, ddpm_launches, ddpm_records = phase_ddpm(torch, rc, gn, seed, dev, card)
    phase_utils(torch, rc, net, seed, dev, card)
    del net
    torch.cuda.empty_cache()
    print(f"phase 25: {time.perf_counter() - t0:.1f} s on {card}")
    launches.update(ddpm_launches)
    rows = []
    for (name, shape), n in sorted(launches.items()):
        rec = next((r for r in records[name] + ddpm_records[name] if tuple(r["shape"]) == shape), None)
        check(rec is not None, f"phase 25: {name} launched at {shape}, where no record was timed")
        rows.append((name, {**rec, "launches": n, "phase": 25}))
    return rows


# ------------------------------------------------ phase 26: spatially sharded training


def phase_spatial_train(torch, seed, dev, card):
    """Phase 26: ``probes.mp_rank spatial_train`` on two ranks sharing the
    card over gloo on a (1, 2) mesh and on one NCCL rank unsharded. Returns
    K1's split launches by (kernel, shape) over the two ranks' CLI steps."""
    t_phase = time.perf_counter()
    st = ROOT / "build" / "chip_smoke" / "st"
    shutil.rmtree(st, ignore_errors=True)
    st.mkdir(parents=True)
    net = px_net(torch, seed, dev)
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, st / "unet.pt")
    del net
    batches = []
    for i, s in enumerate((seed, seed + 1)):
        x0, z, w, t, noise = px_batch(torch, s + 26, dev, ST_BATCH, ST_SIZE)
        torch.save({"x0": x0.cpu(), "z": z.cpu(), "w": w.cpu(), "t": t.cpu(), "noise": noise.cpu()}, st / f"batch{i}.pt")
        batches.append(str(st / f"batch{i}.pt"))
    _dp_px_store(seed + 26, st / "store", frame_engine("st"), n=ST_IMAGES)
    task = dict(name="spatial_train", weights=str(st / "unet.pt"), batches=batches, z_dim=512, **PX_MODEL,
                argv=["--store_dir", str(st / "store"), "--out_size", str(ST_SIZE), "--epochs", "1", "--batch_size",
                      str(ST_BATCH), "--seed", str(seed), "--log_every", "1"])
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLIP_CODEC_")}
    two = _run_ranks(torch, {"out": str(st / "two"), "tasks": [task]}, 2, env, ST_TIMEOUT, "mp_rank")
    one = _run_ranks(torch, {"out": str(st / "one"), "tasks": [task]}, 1, env, ST_TIMEOUT, "mp_rank")
    a, b = (r["spatial_train"] for r in two)
    o = one[0]["spatial_train"]
    grads = lambda side, tag: torch.load(st / side / f"rank0_grad_{tag}.pt", weights_only=True)
    flat = lambda g: torch.cat([g["grads"][k].flatten() for k in sorted(g["grads"])])
    rel = lambda x, y: ((x - y).norm() / y.norm()).item()

    # fp32: the spatial step against the unsharded one (the kernel paths)
    sp, un = grads("two", "fp32"), grads("one", "fp32")
    rel_loss = abs(sp["loss"] - un["loss"]) / abs(un["loss"])
    per_param = {k: ((sp["grads"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                 for k, v in un["grads"].items()}
    worst = max(per_param, key=per_param.get)
    # bf16: the discriminating fp32 ratio at two seeds
    ratios = []
    for i in range(len(batches)):
        g32 = flat(grads("one", f"fp32_plain{i}"))
        r_sp, r_un = rel(flat(grads("two", f"bf16_{i}")), g32), rel(flat(grads("one", f"bf16_{i}")), g32)
        ratios.append((r_sp, r_un))
    want_shapes = {}
    for shape, calls in zip(ST_GN_SHAPES, MP_GN_CALLS):
        for name in MP_K1:
            want_shapes[f"{name} {list(shape)}"] = calls
    per_step = lambda r: sorted(x["s"] for x in r["steps"][1:])[(len(r["steps"]) - 1) // 2]  # the median after the first
    gib = lambda n: n / 2 ** 30
    print(f"st-26: spatially sharded training, the pixel U-Net ({PX_MODEL}, z 512) at {ST_SIZE}px, global batch "
          f"{ST_BATCH}, H over 2 ranks sharing {card} over gloo on (1, 2), against one NCCL rank unsharded: fp32 loss "
          f"{sp['loss']:.6f} vs {un['loss']:.6f} (rel {rel_loss:.3e}), the worst parameter's gradient {worst} "
          f"{per_param[worst]:.3e} of its largest magnitude (whole gradient rel {rel(flat(sp), flat(un)):.3e}); bf16 "
          f"gradient from the fp32 plain unsharded step, spatial vs unsharded "
          f"{[(round(x, 6), round(y, 6), round(x / y, 4)) for x, y in ratios]} at seeds {seed}, {seed + 1}; K1 "
          f"launches a forward {a['grads']['bf16_0']['forward_launches']} (backward "
          f"{a['grads']['bf16_0']['backward_launches']}), unsharded {o['grads']['bf16_0']['forward_launches']} "
          f"(backward {o['grads']['bf16_0']['backward_launches']})")
    print(f"st-26: cli.train --spatial_shard 2, {len(a['steps'])} steps: losses {[round(x['loss'], 6) for x in a['steps']]} "
          f"vs one rank's {[round(x['loss'], 6) for x in o['steps']]}; s/step {[round(x['s'], 4) for x in a['steps']]} / "
          f"{[round(x['s'], 4) for x in b['steps']]} (median after the first {per_step(a):.4f} / {per_step(b):.4f}) "
          f"against one rank's {[round(x['s'], 4) for x in o['steps']]} ({per_step(o):.4f}); peak device memory a "
          f"rank {gib(a['peak_bytes']):.3f} / {gib(b['peak_bytes']):.3f} GiB against one rank's unsharded "
          f"{gib(o['peak_bytes']):.3f} GiB; collectives a step {a['steps'][-1]['collectives']} (one rank "
          f"{o['steps'][-1]['collectives']}); launches a step {a['steps'][-1]['launches']} (one rank "
          f"{o['steps'][-1]['launches']}); a shared card over gloo: overhead, not scaling")
    check(rel_loss <= ST_LOSS_TOL, f"26: fp32 spatial loss {sp['loss']} vs unsharded {un['loss']} (rel {rel_loss})")
    check(per_param[worst] <= ST_GRAD_TOL, f"26: fp32 gradient of {worst} off the unsharded one by {per_param[worst]} "
          f"of its largest magnitude")
    check(all(bool(torch.isfinite(v).all()) for v in sp["grads"].values()), "26: a non-finite spatial gradient")
    for r_sp, r_un in ratios:
        check(r_sp <= FP32_RATIO * r_un, f"26: the bf16 spatial gradient {r_sp} from fp32 > {FP32_RATIO} x the "
              f"unsharded bf16 step's {r_un}")
    for tag in a["grads"]:
        check(a["grads"][tag]["loss"] == b["grads"][tag]["loss"], f"26: the ranks' {tag} losses differ")
    for r in (a, b):
        for tag, g in r["grads"].items():
            check(g["forward_launches"] == {k: GN_PER_FORWARD for k in MP_K1} and g["backward_launches"] == {}
                  and g["by_shape"] == want_shapes, f"26: {tag}: K1 launches forward {g['forward_launches']} "
                  f"backward {g['backward_launches']} by shape {g['by_shape']}")
        check(len(r["steps"]) == ST_STEPS, f"26: {len(r['steps'])} CLI steps")
        for x in r["steps"]:
            check(x["launches"] == {k: GN_PER_FORWARD for k in MP_K1} and x["by_shape"] == want_shapes,
                  f"26: a CLI step launched {x['launches']} by shape {x['by_shape']}")
        check(r["peak_bytes"] < o["peak_bytes"], f"26: peak {r['peak_bytes']} B a spatial rank, not below the "
              f"unsharded {o['peak_bytes']}")
    check([x["loss"] for x in a["steps"]] == [x["loss"] for x in b["steps"]], "26: the ranks' CLI losses differ")
    dl = max(abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(a["steps"], o["steps"]))
    check(dl <= DP_TOL, f"26: CLI losses {a['steps']} vs one rank's {o['steps']} (max rel {dl})")
    for tag, g in o["grads"].items():
        want = {"group_norm_silu": GN_PER_FORWARD} if not tag.startswith("fp32_plain") else {}
        check(g["forward_launches"] == want and g["backward_launches"] == {},
              f"26: unsharded {tag}: K1 launches {g['forward_launches']} / {g['backward_launches']}")
    launches = collections.Counter()
    for r in (a, b):
        for x in r["steps"]:
            for key, n in x["by_shape"].items():
                launches[_shape_key(key)] += n
    print(f"st: phase 26 in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from clip_codec_tpu_torch.ops import attention as attn
    from clip_codec_tpu_torch.ops import attention_probe as ap
    from clip_codec_tpu_torch.ops import groupnorm as gn
    from clip_codec_tpu_torch.ops import int8 as q8
    from clip_codec_tpu_torch.ops import mlp
    from clip_codec_tpu_torch.ops import resblock_conv as rc

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"unit rates: {unit_rates()}")

    try:
        builds = start_builds()
        phase_build(builds)
        records = phase_kernels(torch, rc, args.seed, dev)
        net = full_unet(torch, args.seed, dev)
        phase_forward(torch, rc, net, args.seed, dev)
        launches = phase_serve(torch, rc, net, args.seed, dev, card)
        del net
        torch.cuda.empty_cache()

        phase_build(builds, ("flash_attention", "transformer_mlp"))
        records.update(phase_sd_kernels(torch, attn, mlp, args.seed, dev))
        unet, vae, adapter = sd_models(torch, args.seed, dev)
        phase_sd_forward(torch, attn, mlp, unet, vae, args.seed, dev)
        launches.update(phase_sd_serve(torch, attn, mlp, unet, vae, adapter, args.seed, dev, card))

        phase_build(builds, ("flash_attention_bwd",))
        records.update(phase_flash_bwd(torch, attn, args.seed, dev))
        phase_train_grad(torch, attn, mlp, unet, vae, adapter, args.seed, dev)
        train_launches, train_s_step = phase_train(torch, attn, mlp, unet, vae, adapter, args.seed, dev, card)
        launches.update({k: train_launches[k] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
        del unet, vae, adapter
        torch.cuda.empty_cache()

        phase_build(builds, ("groupnorm_silu",))
        records.update(phase_groupnorm(torch, gn, args.seed, dev))
        phase_px_grad(torch, gn, rc, args.seed, dev)
        launches.update(phase_px_train(torch, gn, rc, args.seed, dev, card))

        phase_build(builds, ("flash_attention_probe",))
        records.update(phase_probe_kernels(torch, ap, args.seed, dev))
        launches.update(phase_probe(torch, ap, args.seed, dev, records))

        phase_compress(torch, args.seed, dev, card)

        inv_records, inv_launches, inv_times = phase_inversion(torch, attn, mlp, args.seed, dev, card)
        launches.update(phase_eval(torch, rc, args.seed, dev, card))

        phase_build(builds, ("u8_ip_scan",))
        ret_records, ret_launches = phase_retrieval(torch, args.seed, dev, card)
        records.update(ret_records)
        launches.update(ret_launches)

        art = phase_artifacts(torch, attn, mlp, rc, args.seed, dev, card)
        torch.cuda.empty_cache()

        dino_w = phase_dino_encode(torch, args.seed, dev, card)
        dino_store, dino_adapter, dino_train = phase_dino_train(torch, attn, mlp, args.seed, dev, card, dino_w,
                                                                train_s_step)
        dino_inv = phase_dino_inversion(torch, attn, mlp, args.seed, dev, card, dino_w, dino_store, dino_adapter,
                                        inv_times)

        phase_build(builds, ("int8_conv",))
        q8_records = phase_int8_kernels(torch, q8, int8_path_shapes(torch, q8, gn, args.seed, dev), args.seed, dev,
                                        card)
        q8_records.update(phase_gn_int8(torch, gn, q8, args.seed, dev, card))
        q8_by_shape = phase_int8(torch, q8, gn, rc, attn, mlp, args.seed, dev, card, art, inv_times)
        for name in Q8_KERNELS:  # the codes' kernels and absmax launched on the main path, the act form never
            n = sum(v for (k, _), v in q8_by_shape.items() if k == name)
            if name in Q8_OFF_PATH:
                check(n == 0, f"{name}: {n} launches on the int8 paths (it is slower than the pair there)")
            else:
                check(n > 0, f"{name}: no launch on the int8 paths")
        for rec in q8_records["group_norm_silu_int8"]:
            shape = tuple(rec["shape"])
            check(q8_by_shape[("group_norm_silu_int8", shape)] > 0, f"group_norm_silu_int8 {list(shape)}: no launch "
                  f"on the int8 artifact's path")

        dp_launches = phase_dp(torch, args.seed, dev, card)

        records.update(phase_k1_split(torch, gn, args.seed, dev))
        mp_launches, mp_records = phase_mp(torch, attn, mlp, args.seed, dev, card)
        for name, rs in mp_records.items():  # K4 and K6 at the tensor-parallel shapes, K1's split entries
            for rec in rs["shapes"] if name == "flash_attention" else rs:
                check(mp_launches[(name, tuple(rec["shape"]))] > 0,
                      f"{name} {rec['shape']}: no launch on phase 24's paths")
        for name in MP_K1:
            for rec in records[name]:
                if tuple(rec["shape"]) in MP_GN_SHAPES:
                    check(mp_launches[(name, tuple(rec["shape"]))] > 0, f"{name} {rec['shape']}: no launch on phase 24")

        p25_rows = phase_25(torch, rc, gn, args.seed, dev, card, records)
        st_launches = phase_spatial_train(torch, args.seed, dev, card)
        for name in MP_K1:
            for shape in ST_GN_SHAPES:
                check(st_launches[(name, shape)] > 0, f"{name} {list(shape)}: no launch on phase 26")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (lib, replaces) in KERNELS.items():
        head = {"name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu", "replaces": replaces}
        if name in MP_K1:  # one record per phase 24a shape, its launches by shape over phase 24d-24e's two ranks,
            for rec in records[name]:  # or over phase 26's two ranks' CLI steps
                shape = tuple(rec["shape"])
                sampled = shape in MP_GN_SHAPES
                kernels.append({**head, "launches": (mp_launches if sampled else st_launches)[(name, shape)], **rec,
                                "phase": 24 if sampled else 26})
            continue
        if name in Q8_KERNELS:  # one record per phase 22a shape, launches by shape on the phase 22b-22c paths
            for rec in q8_records[name]:
                xs = rec["shape"]
                if name == "int8_conv_act":  # timed in bf16; the launches of both activation kinds at the shape
                    key = (tuple(xs[0]), tuple(xs[1]), xs[2], xs[3])
                    by_dtype = {dt: q8_by_shape.get((name, key + (dt,)), 0) for dt in ("bfloat16", "float32")}
                    kernels.append({**head, "launches": sum(by_dtype.values()), "launches_by_dtype": by_dtype, **rec,
                                    "phase": 22})
                    continue
                key = (tuple(xs[0]), tuple(xs[1]), xs[2], xs[3]) if name == "int8_conv_nhwc" else tuple(xs)
                kernels.append({**head, "launches": q8_by_shape.get((name, key), 0), **rec, "phase": 22})
            continue
        if isinstance(records[name], list):  # the convs, K6 and K1: one record per path shape
            for rec in records[name]:
                if name in ("mlp_up", "mlp_down"):
                    by_shape = launches["mlp_by_shape"].get(tuple(rec["shape"]), 0)
                elif name == "group_norm_silu":
                    by_shape = launches["gn_by_shape"][tuple(rec["shape"])]
                elif name in ("u8_ip_scores", "u8_ip_probe"):
                    by_shape = rec["launches"]  # counted by shape in phase 19b-19d
                elif rec["shape"][0] == WIDE_BATCH:  # phase 20's pixel artifact replays B = 16
                    by_shape = art["artifact_by_shape"][(name, tuple(rec["shape"][1:]))]
                    rec = {**rec, "phase": 20}
                else:  # phase 4 serves at B = 4, phase 18 evaluates at B = 8
                    tally = launches["by_shape" if rec["shape"][0] == SERVE_BATCH else "eval_by_shape"]
                    by_shape = tally[tuple(rec["shape"][1:])]
                kernels.append({**head, "launches": by_shape, **rec})
                if name in ("mlp_up", "mlp_down") and ("mlp_up", tuple(rec["shape"])) in art["artifact_by_shape"]:
                    # the same shape in phase 20's SD artifact (mlp_down runs once per mlp_up)
                    kernels.append({**head, **rec, "phase": 20,
                                    "launches": art["artifact_by_shape"][("mlp_up", tuple(rec["shape"]))]})
        else:
            kernels.append({**head, "launches": launches[name], **records[name]})
            if name == "flash_attention":  # phase 20's SD artifact, by shape beside the total
                kernels.append({**head, **records[name], "launches": art[name], "phase": 20, "launches_by_shape": {
                    str(list(shape)): c for (k, shape), c in art["artifact_by_shape"].items() if k == name}})
        if name in inv_records:  # K5 at the guided decode's shape, launches per default inversion request
            kernels.append({**head, "launches": inv_launches[name], **inv_records[name]})
        if name in dino_train:  # phase 21's path: the SD CLIs on the DINO store (21b training, 21c a request)
            timed = inv_records.get(name) or (records[name][0] if isinstance(records[name], list) else records[name])
            kernels.append({**head, **timed, "launches": dino_train[name] + dino_inv[name], "phase": 21,
                            "launches_by_step": {"21b": dino_train[name], "21c": dino_inv[name]}})
    for name, rs in mp_records.items():  # phase 24b-24c: K4 and K6 at each rank's shapes, summed over the ranks
        lib, replaces = KERNELS[name]
        for rec in (rs["shapes"] if name == "flash_attention" else rs):
            rec = {**rec, "max_abs_err": rs["max_abs_err"]} if name == "flash_attention" else rec
            kernels.append({"name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu", "replaces": replaces,
                            **rec, "phase": 24,
                            "launches": mp_launches[(name, tuple(rec["shape"]))]})
    for name, rec in p25_rows:  # phase 25's paths (25b, 25d): K2 and K3 by shape
        lib, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu", "replaces": replaces, **rec})
    for name, n in dp_launches.items():  # phase 23: each kernel's launches summed over the two ranks
        lib, replaces = KERNELS[name]
        timed = inv_records.get(name) or (records[name][0] if isinstance(records[name], list) else records[name])
        kernels.append({"name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu", "replaces": replaces, **timed,
                        "launches": n, "phase": 23})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
