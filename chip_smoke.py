#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full size: n = 1,000,000 vertices, ~10M edges
    python3 chip_smoke.py --n 20000  # a quick rehearsal at smaller graphs (the LM stays full)
    python3 chip_smoke.py --ab OTHER  # time OTHER's checkout against this one, in turns

Phases, one JSON line each:

1. build   — compile the six CUDA kernel libraries (``src/repro_torch/csrc``),
             one ``nvcc`` per source, started together on a thread of their own
             while the graph data are made on the host; count the tensor-core
             instructions (``HGMMA``) in each library's SASS
             (``cuobjdump --dump-sass``): ``flash_attention`` and
             ``flash_attention_bwd`` must have some, and ptxas must report no
             spills for either;
2. engine  — ``create_engine("device", …)`` for gcn and then gat (heads=2) on
             ``make_graph("uniform", n, avg_degree=10, weighted=True)`` with
             128-wide random features and dims [128, 128, 128], driven by a
             6-batch stream (1000 edge updates a batch, 30% deletions,
             feature updates): 2 batches through ``apply_batch``, 4 through
             ``apply_stream`` (traced with ``torch.profiler`` for the device's
             busy time); the final embeddings are held against the
             port's own ``full_forward`` over the post-stream graph at 2e-4.
             Kernel launch counts are zeroed before and read after these
             runs: each GNN kernel (``delta_agg``, ``segment_spmm``,
             ``row_linear``: every model product) must have launched on the
             main path;
2b. engine_skewed — ``create_engine("device", …)`` for gcn on a graph whose
             in-degrees are ``zipf_in_indptr(n, seed)`` (sources uniform,
             duplicates and self-loops removed; hub rows of 10^4 to 10^5
             in-edges, which the uniform graph lacks), widths as above, init
             and 2 batches of 1000 updates through ``apply_batch``, held
             against ``full_forward`` at 2e-4; counts zeroed before and read
             after: ``segment_spmm`` (init) and ``delta_agg`` must launch;
3. edge_softmax_op — the standalone op ``ops.edge_softmax`` (no main path
             calls it) on the base graph's ≈10M in-edges with H = 2 (gat's
             heads), counts zeroed before and read after; held against
             ``kref.edge_softmax_ref`` (normalized 1e-5, sums 1e-4);
4. lm_serve — the LM serving path, ``repro_torch.launch.serve.serve``, on
             llama3.2-1b at full width (16 × 2048, vocab 128,256; random
             weights from a seeded CUDA generator): batch 8, prompt 2048, 32
             greedy decode steps, counts zeroed before and read after
             (``flash_attention`` must launch, 16 times: once per layer of
             the prefill); then a profiled prefill and decode for the
             device-time split (attention kernel, matmuls, the rest);
5. lm_consistency — teacher-forced: prefill of 256 tokens into an fp32
             cache, 4 decode steps, and ``forward`` over the same 260 tokens
             (batch 2); logits within 2e-2 (the reference's own tolerance,
             tests/test_archs_smoke.py);
5b. lm_train — the LM training path, ``repro_torch.train.trainer.Trainer.train``,
             on llama3.2-1b at full width (fp32 params, bf16 compute, remat;
             random weights from a seeded CUDA generator; the serve phase's
             weights freed first): 4 AdamW steps of 4 × 2048 synthetic
             tokens, ``OptConfig(peak_lr=3e-3, warmup_steps=10,
             stable_steps=4, decay_steps=10)`` as ``launch/train.py`` sets
             them; counts zeroed before and read after: the forward
             ``flash_attention`` at least twice a layer a step (remat
             recomputes it) and each backward entry (dQ, dK/dV) once a layer
             a step; every loss finite; seconds a step, tokens/s, peak
             memory (which must come in below ``LM_TRAIN_PEAK_BEFORE_GB``,
             the peak before the AdamW update reused its temporaries), model
             FLOPs a step beside the fp32 peak; then one profiled step for
             the device-time split;
5c. lm_train_consistency — the same config at 2 layers (full width), batch 1
             × 512, weights made with numpy from the seed: ``loss_fn`` and
             every gradient leaf on the card (the kernels) against the CPU
             (the plain versions), loss within 1e-4 relative and each leaf's
             max |Δ| within 1e-3 of its largest entry (the embedding, whose
             gathered rows' gradient is rounded to bf16 on the way, within
             2^-7, one bf16 step; under compute_dtype fp32, where nothing
             rounds it, within 1e-3 too);
5d. lm_moe_serve — the serving path on the MoE family: qwen3-moe-30b-a3b at
             full width (d_model 2048, 32/4 heads of 128, QK norm, 128 experts,
             top-8, expert width 768, vocab 151,936; fp32 params, bf16
             compute and KV cache; random weights from a seeded CUDA
             generator), cut in depth from 48 to 12 layers (48 are 122 GB in
             fp32): batch 8, prompt 2048, 32 greedy steps through ``serve``,
             counts zeroed before and read after; then a prefill alone, counted
             the same way (``flash_attention`` and ``segment_spmm``, the MoE
             combine, must each launch at least once a layer), with the
             assignments each layer's capacity (161 tokens an expert and batch
             row) kept and dropped; a profiled prefill and decode (matmuls,
             attention, the combine, the rest);
5e. lm_moe_consistency — the same weights at dropless capacity
             (``capacity_factor = E / top_k``: which tokens overflow depends
             on the context): teacher-forced as in phase 5, within 2e-2;
5f. lm_hymba_serve — the serving path on hymba-1.5b at full width, cut in
             depth for the script's time (``SERVE_LAYERS``: 32 → 16 layers,
             global layers 0 and 15; d_model 1600, 25/5 heads of 64, 25 SSD heads of
             state 16, expand 2, window 1024 with global layers 0/15/31,
             vocab 32,001; 1.72B parameters; fp32 params, bf16 compute and
             cache; random weights from a seeded CUDA generator; the MoE
             weights freed first): batch 8, prompt 2048, 32 greedy steps
             through ``serve`` (s_max 2080 > 1024: the KV cache is a
             1024-slot ring), counts zeroed before and read after; then a
             prefill alone, counted the same way: ``flash_attention`` must
             launch once a layer, at window 1024 but on the global layers
             (unmasked); a profiled prefill and decode;
5g. lm_hymba_consistency — the same weights in fp32 compute, as the
             reference's own check runs (its reduced configs), teacher-forced
             as in phase 5 (s_max 260 < the window: no ring wrap), within
             2e-2; then in the config's bf16 compute, measured and not held:
             there decode rounds layer 0's conv carry to bf16 and the forward
             does not, by the reference's design;
5h. lm_hymba_ring — the same weights with every layer windowed
             (``full_attn_layers=()``), fp32 compute: a prompt of 1,100 and 8
             teacher-forced steps into an fp32 cache of 1,024 slots, so the
             ring wraps in the prefill and in decode; the ring decode's logits
             against the windowed kernel's forward, within 2e-2;
5i. lm_xlstm_serve — xlstm-1.3b at full width, cut in depth for the script's
             time (48 → 16 layers: 2 of its 6 groups of an sLSTM and 7 mLSTM
             blocks; d_model 2048, 4 heads of 512, vocab 50,304), as phase 5f; no TPU kernel on
             its path; the counted prefill also times the sLSTM step loops
             (synchronised) and gives their share of the prefill;
5j. lm_xlstm_consistency — its weights, teacher-forced as in phase 5 in fp32
             compute, then measured in bf16 compute, as phase 5g (there layer
             0's sLSTM output is rounded to bf16 and the layers above amplify a
             rounding step; each consistency row also gives the forward over
             the prompt alone against the forward over all of it);
5k. lm_encdec_serve — the serving path on the encoder-decoder,
             seamless-m4t-large-v2, at full width and depth (24 encoder and
             24 decoder layers, d_model 1024, 16 heads of 64, d_ff 8192,
             vocab 256,206, frame embeddings of 160, the stubbed audio
             frontend; 2.03B parameters; fp32 params, bf16 compute and
             cache; random weights from a seeded CUDA generator; the xlstm
             weights freed first): batch 8, 2048 source frames, prompt
             2048, 32 greedy steps through ``serve``, counts zeroed before
             and read after; then a prefill alone, counted the same way,
             each ``flash_attention`` call's ``causal``, Sq and Sk read: 72
             launches, 48 non-causal (the encoder's self attention and the
             cross attention) and 24 causal; a profiled prefill and decode;
5l. lm_encdec_consistency — the same weights, teacher-forced as in phase 5
             over a source of 300 frames (the cross attention Sq 256 over a
             ragged Sk, non-causal), within 2e-2 in fp32 compute and in the
             config's bf16 compute;
5m. lm_vlm_serve — the serving path on the vlm, pixtral-12b, at full width,
             cut in depth for the script's time (40 → 20 layers; d_model 5120,
             32/8 heads of 160, d_ff
             14,336, vocab 131,072, 256 patches of 1,024 before the prompt,
             the stubbed vision frontend; fp32 params, bf16 compute and
             cache): batch 8, prompt 2048, 32 greedy steps through ``serve``,
             counts zeroed before and read after; a counted prefill (one
             causal ``flash_attention`` a layer over 2,304 positions at dh
             160); a profiled prefill and decode;
5n. lm_vlm_consistency — the same weights, teacher-forced as in phase 5 over
             256 patches + 300 tokens, within 2e-2 in fp32 and bf16 compute;
5o. lm_vlm_train — the vlm's training path through the launch layer
             (``launch/steps.py``, ``dist/``): pixtral-12b at full width cut
             in depth to 4 of its 40 layers (2.44B parameters; the serve
             phase's weights freed first), ``torch.distributed`` at world
             size 1 (NCCL on an in-process ``HashStore``), the card's
             ``("data", "model")`` mesh of 1 × 1, ``shardings_for_cell``,
             params and AdamW state as DTensors, 3 steps of
             ``make_train_step`` inside ``activation_sharding`` on 2 × (256
             patches + 2,048 tokens) of the trainer's synthetic data; counts
             zeroed before and read after: the forward ``flash_attention`` at
             least twice a layer a step (remat) and each backward entry once
             a layer a step, every call at dh 160; every loss finite; seconds
             a step, tokens/s, peak memory (beside
             ``VLM_TRAIN_PEAK_BEFORE_GB``), model FLOPs a step beside the
             fp32 peak; one profiled step; then the same weights from the
             seed, the first batch's loss and gradients under the mesh and
             with no mesh (loss within 1e-6 relative, each gradient leaf
             within 1e-5 of its largest entry), and whether the loss, the
             gradients and one AdamW step's weights are bitwise equal;
5o′. lm_vlm_prod_prefill — pixtral-12b at the reference's production dtype
             (``launch/dryrun.py`` ``production_cfg``: bf16 params, bf16
             compute) at full width and depth (40 layers, 25.6 GB of bf16
             weights) through the launch layer on the 1 × 1 NCCL mesh:
             ``make_prefill_step`` on batch 2 of the prefill_32k cell's inputs
             (256 patches + 32,768 tokens: 33,024 positions, s_max 33,032 for
             the decode after it): a warm-up, two timed prefills (the first
             counted: 40 ``flash_attention`` launches, each bf16 at dh 160 over
             33,024 rows; its peak held by ``dryrun_check`` to the dry run's
             estimate of the cell), a profiled one (matmuls / attention / the
             rest), then 8 greedy steps of ``make_serve_step`` with finite
             logits;
5o″. lm_vlm_prod_train — the same dtype cut in depth to 4 layers (bf16 params
             and gradients, fp32 AdamW moments), 3 steps of ``make_train_step``
             on the 1 × 1 mesh on 2 × (256 patches + 4,096 tokens): exactly 2 ·
             L · steps bf16 dh-160 forwards (remat) and L · steps of each
             backward entry; finite losses, seconds a step, the peak (held by
             ``dryrun_check`` too);
5o‴. lm_prod_prefill, lm_moe_prod_prefill — the same for llama3.2-1b (16
             layers, 2 × 32,768 tokens: 16 bf16 dh-64 launches) and
             qwen3-moe-30b-a3b (48 layers, 61.09 GB of bf16 weights, at batch
             1: the dry run's estimate at batch 2 is over the card; 48 bf16
             dh-128 launches, Hq 32 over Hkv 4); lm_prod_train (llama, 16
             layers) and lm_moe_prod_train (qwen3-moe cut 48 → 3 layers) as
             lm_vlm_prod_train on 2 × 4,096 tokens (``PROD_PREFILLS``,
             ``PROD_TRAINS``).  On the one-rank mesh ``distribute_tree`` wraps
             the weights as they were made (``distribute_tensor`` copied each
             leaf, and the MoE's weights and a copy of their largest leaf did
             not fit);
5o⁗. lm_vlm_prod_consistency, lm_prod_consistency, lm_moe_prod_consistency,
             lm_hymba_prod_consistency, lm_encdec_prod_consistency
             (``PROD_CONSISTENCY``) — the same dtype cut to 2 layers (seamless
             2 + 2), batch 1 of 300 tokens (after pixtral's 256 patches;
             hymba's 1,100, past its window: layer 0 global, layer 1 windowed
             at 1024; seamless over 300 frames, so the cross attention runs Sq
             ≠ Sk over a ragged source; qwen3-moe dropless), the card against
             the CPU on the same bf16 weights: one training step's loss within
             2^-7 relative, and each gradient leaf and the prefill's last-token
             logits (bf16 here) within 2^-5 of their largest entry (a few bf16
             steps: ``TOL_PROD_REL``), run after the timed phases above (the
             CPU's products beside no timed run); exactly 3 passes of bf16
             forwards (prefill, loss, remat) and one of each backward entry, at
             dh 160, 64, 128, 64 and 64;
5p–5s. lm_moe_mesh, lm_encdec_mesh, lm_hymba_mesh, lm_xlstm_mesh — the other
             four families through the launch layer (``MESH_PHASES``), each
             at full width, cut in depth (qwen3-moe-30b-a3b 48 → 2 layers,
             1.87B elements, 30 GB of fp32 params, gradients and moments;
             seamless 24 + 24 → 2 + 2; hymba 32 → 2, layer 0 global and
             layer 1 windowed at 1024; xlstm 48 → 8, one group of an sLSTM
             and 7 mLSTM blocks), fp32 params, bf16 compute, remat, on the
             card's 1 × 1 NCCL mesh: 2 AdamW steps of ``make_train_step`` on
             2 × 2048 tokens of the trainer's data (seamless also 2048
             frames) with no mesh, the loss, every gradient leaf and the
             params after each step copied to the host and the device state
             freed (MoE: the first batch's gradients once more from the same
             state, which must be the step's bits); the same steps on the
             mesh, held bitwise to the host copies; a prefill of the 2048
             tokens and 4 decode steps (hymba's 1024-slot ring wraps) through
             ``make_prefill_step`` and ``make_serve_step``, plain and on the
             mesh, every logit bitwise.  Counts are zeroed before each run
             and read after; each ``flash_attention`` forward and backward
             call's kind is read (causal, windowed, non-causal, cross: the
             training runs must make exactly 2 forwards and 1 backward a
             layer a step of each), and each MoE combine's direction (the
             forward twice a layer a step, the dispatch gather's backward
             once); seconds a step (the host copies excluded), peak memory,
             prefill seconds and decode ms a step;
5q. dryrun_check — the dry run (``repro_torch.launch.dryrun``, fake process
             group, fake tensors) against the card: in a child process (a
             process holds one process group) it estimates the peak bytes of
             ``lm_vlm_train``'s step, each production prefill's counted prefill
             and each production training phase's steps (these six in its
             pool), and of a gcn ``full_forward`` at n over the base graph, which this phase
             runs meanwhile (peak reset
             around it); each estimate is held within ±15%
             (``TOL_DRYRUN_PEAK``) of ``max_memory_allocated()`` less what
             the process held that the call was not given.  Meanwhile, in
             ``DRYRUN_WORKERS`` processes of that child, a fixed set of
             cells (``dryrun_tasks``: each family's train, prefill and
             decode cell on both production meshes, cut in depth and
             sequence, and the GNN cells) on this machine's PyTorch: every
             one must run and give its figures; and, uncut on 16 × 16, the
             ``DRYRUN_UNCUT`` cells (llama3.2-1b ``train_4k``, pixtral-12b
             ``prefill_32k``), each of which must fit the card's 80 GB;
6. kernels — each kernel against its plain PyTorch version at the shapes its
             path gave it (segment_spmm/delta_agg max |Δ| ≤ 1e-5;
             flash_attention at the prefill shape, atol 2e-5 + rtol 2e-3 in
             fp32 and 3e-2 in bf16; edge_softmax_normalize exactly;
             ``flash_attention_lse``'s o bitwise ``flash_attention``'s and its
             lse against ``flash_attention_lse_ref`` at the forward's
             tolerance; ``flash_attention_bwd`` at the training shape (B 4,
             Hq 32, Hkv 8, S 2048, dh 64, causal) in fp32 against
             ``flash_attention_bwd_ref`` at atol 2e-5 + rtol 2e-3 and in bf16
             (a variant row) at 3e-2, each with a second launch bitwise the
             first, timed beside the backward of
             ``scaled_dot_product_attention`` in the same dtype, and so at
             pixtral's training shape (B 2, Hq 32, Hkv 8, S 2,304, dh 160) in
             fp32 and bf16 (variant rows); the bf16 forward also at
             ``lm_vlm_prod_prefill``'s shape (B 2, S 33,024), held on the last
             256 query rows of every head, and the bf16 forward and backward
             at ``lm_vlm_prod_train``'s (B 2, S 4,352), held whole; the bf16
             forward at ``lm_prod_prefill``'s shape (B 2, S 32,768, dh 64; its
             last 256 rows), at ``lm_prod_train``'s (B 2, S 4,096), at the MoE
             prefill's (dh 128, Hq 32 over Hkv 4), at hymba's band and the
             encoder's and the ragged cross attention's shapes, and the bf16
             backward at ``lm_prod_train``'s and ``lm_moe_prod_train``'s shapes
             (B 2, S 4,096; dh 64 and 128) and the mesh phases' hymba,
             encoder and cross shapes;
             row_linear ≤ 1e-5 at M = n, where the wrapper takes the tiled
             kernel, and bitwise the general kernel there, at gat's per-edge
             M = E and at the incremental step's row cap; rows of
             ``A[:m] @ W`` bitwise rows of ``A @ W`` for m from 1 to 20,000,
             across the wrapper's switch between the two kernels, at K = N =
             128 and K = 256), timed with CUDA events beside its plain
             version, a PyTorch yardstick where one call computes the same
             function (``index_add_``; ``scaled_dot_product_attention``;
             ``torch.matmul``) and its bound; ``segment_spmm`` and
             ``delta_agg`` also at a skewed shape (a Zipf in-degree sequence
             over n rows, ≈ 10M records, hub rows of 10^4 to 10^5 records;
             integer-valued messages, so every summation order is exact and
             each kernel must equal its plain version bit for bit; and
             Gaussian messages, where each kernel must equal
             ``row_sum_chunked_plain``, the kernels' documented order of
             additions, bit for bit).  The two row-sum kernels' rows carry
             their share of the bound and the longest chain a warp walks
             (``longest_chain_records``, at most ``ROW_SUM_CHUNK``) beside
             the most chunk sums a row adds (``most_chunks_a_row``), and
             the wrapper's host time a call (``host_us_per_call``: where it
             reaches ``ms``, the timed loop is host-bound).

The serving layer of the GNN engine runs on its own
``make_graph("uniform", 100_000, avg_degree=10, weighted=True)`` graph
(≈ 1M edges, features and dims 128, 2 layers; ``--n`` below 100,000 shrinks it too),
with launch counts zeroed before each phase and read after its drives,
before its checks against ``full_forward``:

7. policy — the three ``ADVERSARIAL_REGIMES`` at the reference's size (n =
             256, 6 batches, one layer; features 128): decision counts and
             ``policy_edges`` equal to ``BENCH_baseline.json``'s, and the
             forced replay of each mixed schedule bitwise equal; then on the
             100k graph, gcn, 6 batches of 1000 edge updates:
             ``policy="adaptive"``, the forced replay of its decisions
             (bitwise equal), and a forced incremental/chunked/full schedule
             (the chunked and full modes at full size, with the chunked
             mode's layer-to-host copy timed), each within 2e-4 of
             ``full_forward``.  Launches are counted per batch: every
             chunked or full batch must launch ``segment_spmm``, every
             incremental one on the 100k graph ``delta_agg``;
8. fusion_frontend — the reference's ring-lattice fusion cell at n =
             100,000: 12 single-edge batches 45 rows apart under
             ``FusionConfig(window=4)``: exactly 3 windows, 12 fused batches,
             3 dispatches; the same state as the serial loop, every h, a and
             nct bitwise (``row_linear``'s rows do not depend on how many
             rows a window puts into the update's product); then a
             ``ServingFrontend`` on the reference's 6-batch read schedule:
             10 reads, 8 batches of staleness, every read bitwise equal to
             the snapshot at its pinned version;
9. storage — ``store_h=False`` (paper §V-B) against ``store_h=True`` on the
             same stream: within 2e-4 of each other and of
             ``full_forward``; the ``state_bytes()`` ratio;
10. baselines_odec — gcn and gat over 3 batches of 100 edge updates:
             ``RTECFull`` and ``RTECUER`` within 2e-4 of ``full_forward``,
             ``RTECSample(fanout=10)`` finite, ``MTECPeriod(period=3)`` stale
             then fresh, edges processed Inc < UER ≤ Full, per-batch times
             beside the engine's; ``odec_query`` for 64 vertices within 1e-5
             of the committed engine with the engine's state unchanged;
             ``validate_registration`` over all 11 models;
11. offload — ``create_engine("offload")`` (host-resident state, pinned
             async staging) for gcn and gat (heads 2) on the 6-batch stream
             through ``apply_stream``, each within 2e-4 of ``full_forward``;
             gcn with ``StagingConfig(async_enabled=False)`` bitwise equal to
             async (``prefetch_hits`` 5 and 0); gcn on the device engine
             bitwise equal (the equal tensors printed); transfer
             rows, staged bytes, staging waits, exec seconds a batch, and the
             stream's peak device bytes beside the device engine's state
             bytes, with each batch's largest staged layer (rows, buffer
             bytes); gcn again on 3 batches of 10 updates, where the
             affected rows are a small share of V.  Every batch must launch
             ``delta_agg`` once per layer, and gat's ``segment_spmm`` too;
12. hot_cache — the reference's exact counters at its own sizes: the fig7
             smoke cell (2970 transfer rows, 145,560 staged bytes, 5 prefetch
             hits) and the hub_burst cell (580/504/0 hits/misses/evictions,
             61,648 staged bytes against 107,968 uncached, cached ≡
             uncached); then gcn at full width with
             ``CacheConfig(capacity_rows=8192, prewarm_rows=8192)`` bitwise
             equal to uncached, each run's stream peak device bytes printed;
13. chunked_backend — ``create_engine("chunked", chunk_size=8192)`` on the
             stream's first 3 batches within 2e-4 of ``full_forward``, every
             batch launching ``segment_spmm``; then the ring cell of phase 8
             through a fused window on the offload engine: 3/12/3, every
             tensor bitwise the serial offload loop's;
14. sharded — ``create_engine("sharded")`` with S logical shards on the
             card (the loopback exchange): the reference's fig7 sharded
             cell at its own size (powerlaw n = 300, dims [16, 16], S = 8):
             ``halo_rows_sent`` 157 under ppermute and 584 under psum
             (``benchmarks/check_regression.py`` ``COMMS_EXPECTED``), psum ≡
             ppermute ≡ the device engine bitwise; then the serving graph at
             full width, gcn and gat at S = 8 and S = 1: gcn bitwise the
             device engine, gat within 2e-4 of ``full_forward``; every
             batch launches ``delta_agg`` once per shard and layer, init
             ``segment_spmm``; exec seconds a batch, halo rows and bytes,
             state bytes;
15. sharded_offload — ``create_engine("sharded_offload")`` at S = 8: the
             fig7 cell's 731 transfer rows a shard, 470,016 staged bytes and
             5 prefetch hits; hub_burst cached 616/532/0 (``CACHE_EXPECTED``)
             and bitwise the uncached run; at full width gcn and gat bitwise
             the offload engine, psum ≡ ppermute; staged bytes, transfer rows
             a shard, ``sync_wait_s``, and the stream's peak device bytes
             beside the offload engine's.

The kernel checks include ``delta_agg`` at the offload path's largest
compact shape (a variant beside the engine's), ``segment_spmm`` at the MoE
combine's prefill shape on the records phase 5d's first layer gave it (16,384
rows, 164,864 records, D 2048; also bitwise ``row_sum_chunked_plain`` and
bitwise from launch to launch; timed beside ``index_add_``),
``flash_attention`` at the MoE prefill's shape (Hq 32, Hkv 4, dh 128), and
at hymba's prefill shape (Hq 25 over Hkv 5, dh 64, fp32, window 1024: its
bound counts the band's 1,573,376 key–query pairs a head, not causal's
2,098,176; SDPA with the band as a boolean mask beside it), and non-causal
at seamless's encoder shape (B 8, 16/16 heads, S 2048, dh 64: 4,194,304
pairs a head; SDPA with ``is_causal=False``), at a cross shape over a
ragged source (Sq 2048 over Sk 1,999), and causal at its decoder's shape
(the same heads, group 1), each with a second launch bitwise the first;
``flash_attention_bwd`` at the mesh phases' training shapes (B 2, S 2048,
fp32): hymba's windowed layer (Hq 25 over Hkv 5, window 1024), the encoder's
non-causal self attention (16/16 heads) and a cross attention over a ragged
source (Sk 1,999), each beside SDPA's backward (the band as a boolean
mask); and ``segment_spmm`` at the MoE dispatch backward's shape (the first
layer's records' gradients of ``lm_moe_mesh``, 4,096 token rows of 2048),
bitwise ``row_sum_chunked_plain``, beside ``index_add_``.  Then a ``{"kernels":
[...]}`` line (launches summed over every path that launched each kernel),
the ``nvidia-smi`` name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero.  It imports neither ``jax`` nor the
JAX package ``repro``.  Full ``nvcc`` logs go to ``build/repro_torch/logs/``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores (data sheet)
SPLIT_TF32 = 3  # TF32 products per fp32 product in flash_attention (hi·hi + hi·lo + lo·hi)
TOL_KERNEL = 1e-5  # kernel vs plain version: fp32, different summation order
TOL_ENGINE = 2e-4  # engine vs full recompute: the reference's tests/test_backends.py TOL
TOL_ATTN = (2e-5, 2e-3)  # flash vs plain (atol, rtol): the reference's tests/test_kernels.py
TOL_ATTN_BF16 = (3e-2, 3e-2)  # the same in bf16
#: bf16 flash vs plain, per block of 128 query rows: the kernel's max |Δ| over
#: SDPA's on the same inputs (a late row's |o| is far below TOL_ATTN_BF16's atol)
TOL_ATTN_BF16_VS_LIBRARY = 2.0
TOL_SUMS = 1e-4  # edge-softmax sums: the reference's tests/test_kernels.py
TOL_TEACHER = 2e-2  # teacher-forced logits: the reference's tests/test_archs_smoke.py
TOL_ODEC = 1e-5  # ODEC vs the committed engine: the reference's tests/test_baselines.py
TOL_STALE = 1e-6  # MTEC between refreshes vs its initial state: tests/test_baselines.py
#: per-regime adaptive decisions (incremental, chunked, full) and policy_edges,
#: the rows ``adversarial/<regime>/policy_*`` of BENCH_baseline.json
ADVERSARIAL_EXPECTED = {"hub_burst": (4, 0, 2, 3168), "delete_heavy": (3, 0, 3, 1608),
                        "feature_churn": (3, 3, 0, 4524)}
FORCED_SCHEDULE = ("incremental", "chunked", "full", "incremental", "chunked", "full")
SERVE_N = 100_000  # vertices of the serving phases' graph (at most --n)
WIDTH = 128  # the lane width both TPU kernels were tiled for (BD = 128)
GAT_HEADS = 2
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3.2-1b", 8, 2048, 32
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 2048  # lm_train: 8,192 tokens a step
CONSIST_LAYERS, CONSIST_SEQ = 2, 512  # lm_train_consistency: 2 layers, batch 1 × 512
#: lm_moe_serve: qwen3-moe-30b-a3b at full width, cut in depth 48 → 12 layers (all 48 are
#: 30.5B parameters, 122 GB in fp32, more than the card's 80 GB; 12 are 8.10B, 32.4 GB)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 12
#: the recurrent families at full width and depth (hymba 1.72B parameters, xlstm 1.39B)
HYMBA_ARCH, XLSTM_ARCH = "hymba-1.5b", "xlstm-1.3b"
#: the serve phases cut in depth for the script's time (full width): xlstm 48 → 16 layers
#: (two groups of an sLSTM and 7 mLSTM blocks), hymba 32 → 16 (global layers 0 and 15),
#: pixtral 40 → 20
SERVE_LAYERS = {"xlstm-1.3b": 16, "hymba-1.5b": 16, "pixtral-12b": 20}
#: lm_hymba_ring: a prompt past hymba's 1024-slot window, then teacher-forced steps
RING_PROMPT, RING_STEPS = 1100, 8
#: the encoder-decoder at full width and depth (24 + 24 layers, 2.03B parameters); its
#: consistency phase's source is 300 frames (a ragged Sk for the cross attention over a
#: 256-token prompt), and its kernel row's cross shape Sq 2048 over Sk 1,999
ENCDEC_ARCH, ENCDEC_CONSIST_FRAMES, ENCDEC_CROSS_SK = "seamless-m4t-large-v2", 300, 1999
#: the vlm at full width and depth (40 layers, 12.78B parameter elements, 51.1 GB in
#: fp32): its 256 patches stand before the prompt, so the prefill attends over 2,304
#: positions at head dim 160; its consistency phase's prompt is 300 tokens (256 + 300
#: positions: the last key tile at dh 160 is ragged)
VLM_ARCH, VLM_CONSIST_PROMPT = "pixtral-12b", 300
#: lm_vlm_train: the vlm at full width cut in depth 40 → 4 layers (2.44B parameters: 39 GB
#: of fp32 params, gradients and AdamW's two moments; all 40 would be 204 GB), 3 steps
#: of 2 × (256 patches + 2,048 tokens) through make_train_step on the card's 1 × 1 mesh
VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS, VLM_TRAIN_BATCH = 4, 3, 2
#: lm_vlm_prod_*: the vlm at the reference's production dtype (``launch/dryrun.py``
#: ``production_cfg``: bf16 params, bf16 compute), where every attention call is the bf16
#: instantiation at head dim 160.  The prefill at full width and depth (40 layers, 12.78B
#: elements, 25.6 GB in bf16) on batch PROD_BATCH of the prefill_32k cell's inputs (256
#: patches + 32,768 tokens), its cache PROD_DECODE positions longer than the cell's s_max
#: 33,024 for the greedy decode steps after it; training cut in depth to PROD_TRAIN_LAYERS
#: (2.44B elements: bf16 params and gradients, fp32 AdamW moments) on the train_4k cell's
#: sequence (256 patches + 4,096 tokens); the consistency phase cut to PROD_CONSIST_LAYERS
#: (batch 1 of 256 patches + VLM_CONSIST_PROMPT tokens), the card against the CPU
PROD_BATCH, PROD_PREFILL_SEQ, PROD_DECODE = 2, 32_768, 8
PROD_TRAIN_LAYERS, PROD_TRAIN_SEQ, PROD_TRAIN_STEPS, PROD_CONSIST_LAYERS = 4, 4096, 3, 2
#: lm_vlm_prod_consistency: the loss, relative, and each gradient leaf's and the prefill's
#: last-token logits' max |Δ| over their largest |entry|.  The gradients and the logits are
#: bf16 (the params' dtype: the head's product too): at the largest entry, in [2^k,
#: 2^(k+1)), one bf16 step is 2^(k−7), at most 2^-7 of it, and the two sides sum in other
#: orders through two layers whose every product rounds its output to bf16, so an entry
#: may land a few steps apart: 4 steps, 2^-5.  (TOL_TEACHER's 2e-2, which the
#: fp32-param phases hold their fp32 logits to, is below one bf16 step of a logit in
#: [4, 8).)  The loss is an fp32 mean over bf16 logits: two steps, 2^-7
TOL_PROD_LOSS, TOL_PROD_REL = 2.0 ** -7, 2.0 ** -5
#: a MoE consistency phase replays the card's expert choices on the CPU (``_expert_choice``);
#: in each routing at most this share of the tokens may choose otherwise on the CPU (11 and
#: 21 of 300 did on an H100, between experts whose router logits were near-tied), each
#: within one bf16 step of the router's input of a tie
MOE_FLIP_SHARE = 1 / 8
#: llama3.2-1b and qwen3-moe-30b-a3b at the production dtype too, where every attention call
#: is the bf16 instantiation at head dim 64 (llama; hymba and seamless in their consistency
#: phases) or 128 (qwen3-moe).  llama's prefill and training run uncut (16 layers, 2.47 GB
#: of bf16 weights); qwen3-moe's prefill at full depth (48 layers, 61.09 GB of weights) at
#: batch PROD_MOE_BATCH (the dry run's estimate of the prefill_32k inputs at batch 2 is
#: 80.55 GB, over the 76 GB the card leaves; at batch 1 70.82 GB) and its training cut in
#: depth to PROD_MOE_TRAIN_LAYERS (estimated 60.86 GB at 3 layers, 76.59 GB at 4)
PROD_MOE_BATCH, PROD_MOE_TRAIN_LAYERS, PROD_CONSIST_PROMPT = 1, 3, 300
#: the production dtype's phases: prefill → (arch, depth cut (0: none), batch); training →
#: (arch, depth cut); consistency → (arch, prompt tokens, source frames), each cut to
#: PROD_CONSIST_LAYERS at batch 1: the last key tile ragged at every head dim; hymba's prompt
#: past its window of 1,024 (layer 0 global, layer 1 windowed: the band cut), seamless's
#: cross attention over a ragged source; qwen3-moe dropless, as lm_moe_consistency
PROD_PREFILLS = {"lm_vlm_prod_prefill": (VLM_ARCH, 0, PROD_BATCH),
                 "lm_prod_prefill": (LM_ARCH, 0, PROD_BATCH),
                 "lm_moe_prod_prefill": (MOE_ARCH, 0, PROD_MOE_BATCH)}
PROD_TRAINS = {"lm_vlm_prod_train": (VLM_ARCH, PROD_TRAIN_LAYERS),
               "lm_prod_train": (LM_ARCH, 0),
               "lm_moe_prod_train": (MOE_ARCH, PROD_MOE_TRAIN_LAYERS)}
PROD_CONSISTENCY = {"lm_vlm_prod_consistency": (VLM_ARCH, VLM_CONSIST_PROMPT, 0),
                    "lm_prod_consistency": (LM_ARCH, PROD_CONSIST_PROMPT, 0),
                    "lm_moe_prod_consistency": (MOE_ARCH, PROD_CONSIST_PROMPT, 0),
                    "lm_hymba_prod_consistency": (HYMBA_ARCH, RING_PROMPT, 0),
                    "lm_encdec_prod_consistency": (ENCDEC_ARCH, PROD_CONSIST_PROMPT,
                                                   ENCDEC_CONSIST_FRAMES)}
#: lm_train's and lm_vlm_train's peaks on the H100 before the vocab-parallel loss and the
#: AdamW update's in-place temporaries (PERF.md §6: 37.92 and 74.71 GB), recorded beside
#: this run's; lm_train's must come in below its figure
LM_TRAIN_PEAK_BEFORE_GB, VLM_TRAIN_PEAK_BEFORE_GB = 37.92, 74.71
#: the mesh phases (10g′, and training at full width: 10c′, 10d″, 10e′): each family at its
#: full widths, cut in depth, fp32 params, the config's compute dtype, remat; MESH_STEPS AdamW
#: steps of MESH_BATCH × MESH_SEQ tokens of the trainer's data, plain and then on the card's
#: 1 × 1 NCCL mesh, held bitwise; then a prefill of MESH_SEQ tokens and MESH_DECODE decode
#: steps, plain and on the mesh, held bitwise.  phase → (arch, depth cut)
MESH_PHASES = {
    "lm_moe_mesh": ("qwen3-moe-30b-a3b", {"num_layers": 2}),  # 48 → 2: 1.87B elements
    "lm_encdec_mesh": ("seamless-m4t-large-v2", {"num_layers": 2, "enc_layers": 2}),  # 24 + 24
    # 32 → 2: layer 0 global, layer 1 windowed at 1024 over 2048 tokens; decode wraps the ring
    "lm_hymba_mesh": ("hymba-1.5b", {"num_layers": 2, "full_attn_layers": (0,)}),
    "lm_xlstm_mesh": ("xlstm-1.3b", {"num_layers": 8}),  # 48 → 8: one group, 1 sLSTM + 7 mLSTM
}
MESH_STEPS, MESH_BATCH, MESH_SEQ, MESH_DECODE = 2, 2, 2048, 4
TOL_MESH_LOSS = 1e-6  # lm_vlm_train: the mesh's loss against the plain path's, relative
TOL_MESH_GRAD = 1e-5  # lm_vlm_train: each gradient leaf's max |Δ| / its max |entry|
DIST_BACKEND = "nccl"  # lm_vlm_train's process group (world size 1)
#: dryrun_check: the dry run's peak estimate against the card's, relative
TOL_DRYRUN_PEAK = 0.15
#: dryrun_check's cells, on this machine's PyTorch: each family's train, prefill and decode
#: cell on both production meshes, cut in depth to DRYRUN_LAYERS (xlstm: one sLSTM-led
#: group; hymba: a global and a windowed layer) and in sequence to DRYRUN_SEQ tokens (train,
#: prefill), as ``python -m repro_torch.launch.dryrun --layers 2 --seq 256`` cuts them, and
#: the three GNN cells on both meshes at full size
DRYRUN_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2", "hymba-1.5b",
                "xlstm-1.3b", "pixtral-12b")
DRYRUN_LAYERS, DRYRUN_SEQ = 2, 256
#: dryrun_check's cells run uncut on 16 × 16, each of which must fit the card's 80 GB: the
#: training cell whose whole-vocab loss rows, and the prefill whose whole caches, did not
DRYRUN_UNCUT = (("llama3.2-1b", "train_4k"), ("pixtral-12b", "prefill_32k"))
DRYRUN_WORKERS = 6  # the cells' processes (this machine has 8 cores)
DRYRUN_TIMEOUT_S = 300  # the estimates' and the cells' child process
TOL_TRAIN_LOSS = 1e-4  # lm_train_consistency: loss, relative
TOL_TRAIN_GRAD = 1e-3  # lm_train_consistency: each leaf's max |Δ| / its max |entry|
#: the same for the embedding under compute_dtype bf16: the gradient of its gathered rows
#: is rounded to bf16 (the backward of the cast to compute_dtype), where one bf16 step is
#: 2^-8 to 2^-7 of a value; the card and the CPU round sums taken in other orders, so
#: an entry may land one step apart (measured: 2.4e-3 of the largest entry, PERF.md)
TOL_TRAIN_GRAD_BF16_CAST = 2.0 ** -7
KERNEL_INFO = {  # TPU kernel name → its library (csrc/<lib>.cu), source and TPU kernel
    "segment_spmm": {
        "lib": "segment_spmm",
        "source": "src/repro_torch/csrc/segment_spmm.cu",
        "replaces": "src/repro/kernels/segment_spmm.py:131",
    },
    "delta_agg": {
        "lib": "delta_agg",
        "source": "src/repro_torch/csrc/delta_agg.cu",
        "replaces": "src/repro/kernels/delta_agg.py:74",
    },
    "flash_attention": {
        "lib": "flash_attention",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
    },
    "edge_softmax_normalize": {
        "lib": "edge_softmax",
        "source": "src/repro_torch/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:60",
    },
    "flash_attention_bwd": {  # no TPU kernel: the Pallas flash kernel has no VJP
        "lib": "flash_attention_bwd",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none (the JAX package differentiates src/repro/kernels/ref.py "
                    "flash_attention_ref; the Pallas flash_attention at "
                    "src/repro/kernels/flash_attention.py:103 has no backward)",
    },
    "row_linear": {  # no TPU kernel: the models' fp32 products, left to XLA by the reference
        "lib": "row_linear",
        "source": "src/repro_torch/csrc/row_linear.cu",
        "replaces": "none (port-only: the dense products of src/repro/core/models.py)",
    },
}
#: row_linear's row-count probe: the wrapper switches from the general to the tiled
#: kernel at 16,896 rows (``kernels/row_linear.py`` ``TILED_MIN_ROWS``)
ROW_COUNTS = (1, 2, 15, 16, 17, 32, 33, 1000, 16_895, 16_896, 20_000)
ZIPF_EXPONENT, ZIPF_MAX_DEGREE = 1.97, 100_000  # the skewed kernel shape: zipf_in_indptr
SHARDS = 8  # logical shards of the sharded phases (the reference's CI mesh)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line (one write: the build's thread emits too); a phase's row
    also gets the seconds since the script began."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_per_call(fn, iters: int) -> float:
    """The host time of a call of ``fn`` (enqueue only, not synchronised).
    Where it reaches the time :func:`cuda_time_ms` reads for the same
    calls, back-to-back calls are host-bound and that time is the host's
    rate, not the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / iters * 1e6


def phase_build() -> None:
    from repro_torch.kernels._build import BUILD_DIR, _lib_path, build_all

    libs = [info["lib"] for info in KERNEL_INFO.values()]
    res = build_all(libs)
    logdir = BUILD_DIR / "logs"
    logdir.mkdir(parents=True, exist_ok=True)
    regs, spills = {}, {}
    for name, r in res.items():
        (logdir / f"nvcc_{name}.log").write_text(r["log"])
        lines = [ln.strip() for ln in r["log"].splitlines()]
        regs[name] = [ln for ln in lines if "registers" in ln]
        spills[name] = [ln for ln in lines if "spill" in ln and "0 bytes spill stores, 0 bytes "
                        "spill loads" not in ln]  # the kernels that spill, if any
    hgmma = {name: _sass_count(_lib_path(name), "HGMMA") for name in libs}
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in res.items()},
          "ptxas": regs, "ptxas_spills": spills, "sass_hgmma": hgmma})
    for name in ("flash_attention", "flash_attention_bwd"):
        if not hgmma[name]:
            raise AssertionError(f"{name}'s SASS has no HGMMA: it misses the tensor cores")
        if spills[name]:
            raise AssertionError(f"{name} spills: {spills[name]}")


def _sass_count(lib: Path, opcode: str) -> int:
    """Instructions of one opcode in a library's SASS (``cuobjdump``)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def final_features(x: np.ndarray, batches) -> np.ndarray:
    """The features after ``batches``' feature updates."""
    xc = np.array(x)
    for b in batches:
        if b.feat_vertices is not None:
            xc[b.feat_vertices] = b.feat_values
    return xc


def phase_engine(model_name: str, x, wl, seed: int, kernels: dict) -> dict:
    """One run of the main path.  Launch counts are set to 0 just before
    the engine is built and read just after its stream has finished
    (``row["launches"]``); the full_forward check afterwards is not counted."""
    import torch

    from repro_torch.core import full_forward, make_model
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model(model_name)
    for k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, dims=[WIDTH, WIDTH, WIDTH], seed=seed,
        device="cuda"))
    eng.synchronize()
    init_s = time.perf_counter() - t0
    per_batch = [eng.apply_batch(b) for b in wl.batches[:2]]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ss = eng.apply_stream(wl.batches[2:])
    launches = {name: k.launches for name, k in kernels.items()}
    busy_s = _device_busy_s(prof)
    emb = eng.embeddings
    if emb.shape != (wl.base.n, WIDTH) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"{model_name}: bad embeddings {tuple(emb.shape)}")
    t1 = time.perf_counter()
    xf = torch.from_numpy(final_features(x, wl.batches)).cuda()
    ref = full_forward(model, eng.params, xf, eng.graph)[-1].h
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    err = float((emb - ref).abs().max())
    row = {
        "phase": f"engine_{model_name}",
        "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
        "init_s": init_s, "full_forward_s": ref_s,
        "apply_batch": [{"plan_time_s": b.plan_time_s, "exec_time_s": b.exec_time_s,
                         "graph_time_s": b.graph_time_s, "inc_edges": b.inc_edges,
                         "full_edges": b.full_edges, "out_vertices": b.out_vertices}
                        for b in per_batch],
        "apply_stream_exec_s": [b.exec_time_s for b in ss.batches],
        "stream": ss.as_dict(),
        # the apply_stream above ran traced: device busy time (kernels and
        # copies) over its wall; None when the trace held no device time
        "stream_device_busy_s": busy_s,
        "stream_device_idle_share": None if busy_s is None else 1.0 - busy_s / ss.wall_s,
        "caps": _caps(eng._backend.hwm.snapshot()),
        "state_bytes": eng.state_bytes(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "max_abs_err_vs_full_forward": err,
        "launches": launches,
    }
    emit(row)
    if not err <= TOL_ENGINE:
        raise AssertionError(f"{model_name}: engine vs full_forward max|Δ| {err} > {TOL_ENGINE}")
    return row


def skewed_graph(n: int, seed: int):
    """A graph whose in-degrees are ``zipf_in_indptr(n, seed)``: each
    in-edge's source uniform over the vertices, duplicate edges and
    self-loops removed, weights uniform in [0.5, 1.5) (as ``make_graph``'s
    ``weighted``)."""
    from repro_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed + 2)
    indptr = zipf_in_indptr(n, seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    src = rng.integers(0, n, len(dst), dtype=np.int64)
    key = np.unique((dst * n + src)[src != dst])
    w = rng.uniform(0.5, 1.5, len(key)).astype(np.float32)
    return CSRGraph.from_edges(n, key % n, key // n, w)


def phase_engine_skewed(n: int, seed: int, kernels: dict, uniform: dict) -> dict:
    """gcn on the skewed graph: init and 2 batches through ``apply_batch``.
    Counts are set to 0 just before the engine is built and read just after
    its batches; the full_forward check afterwards is not counted.  The
    uniform graph's gcn run (``uniform``) is printed beside it."""
    import torch

    from repro_torch.core import full_forward, make_model
    from repro_torch.graph import make_stream, random_features
    from repro_torch.serve import EngineConfig, create_engine

    t0 = time.perf_counter()
    graph = skewed_graph(n, seed)
    x, _ = random_features(n, WIDTH, seed=seed)
    wl = make_stream(graph, num_batches=2, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=seed + 1)
    setup_s = time.perf_counter() - t0
    del graph
    model = make_model("gcn")
    _zero_counts(kernels)
    t0 = time.perf_counter()
    eng = create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, dims=[WIDTH, WIDTH, WIDTH], seed=seed,
        device="cuda"))
    eng.synchronize()
    init_s = time.perf_counter() - t0
    per_batch = [eng.apply_batch(b) for b in wl.batches]
    launches = _counts(kernels)
    emb = eng.embeddings
    if emb.shape != (n, WIDTH) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"engine_skewed: bad embeddings {tuple(emb.shape)}")
    xf = torch.from_numpy(final_features(x, wl.batches)).cuda()
    err = float((emb - full_forward(model, eng.params, xf, eng.graph)[-1].h).abs().max())
    in_deg = np.diff(wl.base.in_indptr)
    row = {
        "phase": "engine_skewed", "model": "gcn", "n": n, "edges": wl.base.num_edges,
        "max_in_degree": int(in_deg.max()), "rows_over_512": int((in_deg > 512).sum()),
        "width": WIDTH, "layers": 2, "setup_s": setup_s, "init_s": init_s,
        "apply_batch": [_batch_row(b) for b in per_batch],
        "uniform_gcn": {"init_s": uniform["init_s"],
                        "exec_time_s": [b["exec_time_s"] for b in uniform["apply_batch"]]},
        "max_abs_err_vs_full_forward": err, "launches": launches,
    }
    emit(row)
    _require_launched(row, ("segment_spmm", "delta_agg"))
    if not err <= TOL_ENGINE:
        raise AssertionError(f"engine_skewed: vs full_forward max|Δ| {err} > {TOL_ENGINE}")
    return row


def _device_busy_s(prof):
    """Seconds of device activity in a ``torch.profiler`` trace, or None."""
    from torch.autograd import DeviceType

    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e6 if us > 0 else None


def _caps(snapshot: dict) -> dict:
    """Largest packed-plan capacity per field kind over the layers."""
    names = ("e", "r", "f", "fe", "o")
    out = {}
    for key, cap in snapshot.items():
        if isinstance(key, tuple):
            out[names[key[1]]] = max(out.get(names[key[1]], 0), cap)
    return out


def _bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _messages(e: int, d: int, gen, integer: bool = False):
    """Gaussian messages, or with ``integer`` whole numbers in [-8, 8]: every
    partial sum of up to 10^6 of them is exact in fp32, so every summation
    order gives the same bits and a kernel is held to its plain version
    exactly, whatever the number of records a row (the skewed shape's hubs
    sum 10^5; with Gaussian messages two fp32 orders differ there by ~1e-2)."""
    import torch

    if integer:
        return torch.randint(-8, 9, (e, d), device="cuda", generator=gen).float()
    return torch.randn(e, d, device="cuda", generator=gen)


def _chains(max_records_a_row: int) -> dict:
    """The row-sum kernels' serial work at a shape: the longest chain one
    warp walks and the most chunk sums pass 2 adds for one row."""
    from repro_torch.kernels.segment_spmm import ROW_SUM_CHUNK

    return {"longest_chain_records": min(max_records_a_row, ROW_SUM_CHUNK),
            "most_chunks_a_row": -(-max_records_a_row // ROW_SUM_CHUNK)}


def kernel_segment_spmm(in_indptr: np.ndarray, d: int, gen, iters: int = 10,
                        integer: bool = False) -> dict:
    """full_forward's shape: dst-sorted edges, ``in_indptr`` offsets, no order
    (``integer``: see :func:`_messages`)."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    r, e = len(in_indptr) - 1, int(in_indptr[-1])
    row_ptr = torch.from_numpy(in_indptr.astype(np.int64)).cuda()
    dst = torch.repeat_interleave(torch.arange(r, device="cuda"), row_ptr.diff())
    msg = _messages(e, d, gen, integer)
    out = segment_spmm(msg, row_ptr, None, r)
    ref = segment_spmm_plain(msg, row_ptr, None, r)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    del out, ref
    ms = cuda_time_ms(lambda: segment_spmm(msg, row_ptr, None, r), iters)
    plain_ms = cuda_time_ms(lambda: segment_spmm_plain(msg, row_ptr, None, r), 3)
    lib_ms = cuda_time_ms(
        lambda: torch.zeros(r, d, device="cuda").index_add_(0, dst, msg), iters)
    host_us = host_us_per_call(lambda: segment_spmm(msg, row_ptr, None, r), iters)
    bound_ms, by = _bound(e * d * 4 + (r + 1) * 8 + r * d * 4, e * d)
    longest = int(np.diff(in_indptr).max())
    return {"name": "segment_spmm", "shape": {"E": e, "D": d, "R": r, "order": False,
                                              "max_records_a_row": longest, **_chains(longest)},
            "max_abs_err": err, **({"within_tol": err == 0.0, "values": "integers"}
                                   if integer else {}),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "host_us_per_call": host_us}


def _uniform_keys(e_cap: int, r_cap: int, live: int, rng) -> np.ndarray:
    """``live`` record keys uniform over ``[0, r_cap)`` and a -1 padded tail,
    as the packed plan ships them."""
    keys = np.full(e_cap, -1, np.int64)
    keys[:live] = rng.integers(0, r_cap, live)
    return keys


def zipf_in_indptr(n: int, seed: int) -> np.ndarray:
    """Row offsets of a skewed in-degree sequence over ``n`` rows: Zipf
    degrees (exponent ``ZIPF_EXPONENT``) clipped at ``ZIPF_MAX_DEGREE``, so at
    n = 1M about 10M records with hub rows of 10^4 to 10^5.  Built from the
    degrees directly: the preferential-attachment generator is quadratic in
    n on the host."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(ZIPF_EXPONENT, n), ZIPF_MAX_DEGREE)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr


def _scheduled_inputs(keys: np.ndarray, r_cap: int, d: int, gen, integer: bool = False):
    """Messages for records with row ``keys`` (-1: padding) and their row
    schedule — the layout the packed plan ships."""
    import torch

    from repro_torch.kernels.segment_spmm import prepare_row_schedule

    order, row_ptr = prepare_row_schedule(keys, r_cap)
    msg = _messages(len(keys), d, gen, integer)
    msg[torch.from_numpy(keys < 0).cuda()] = 0.0  # padded records are masked to 0 on the main path
    return msg, torch.from_numpy(order).cuda(), torch.from_numpy(row_ptr).cuda()


def kernel_segment_spmm_subset(fe_cap: int, f_cap: int, d: int, gen, rng) -> dict:
    """subset_layer's shape (gat's constrained path), with a row order."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    msg, order, row_ptr = _scheduled_inputs(
        _uniform_keys(fe_cap, f_cap, fe_cap * 3 // 4, rng), f_cap, d, gen)
    out = segment_spmm(msg, row_ptr, order, f_cap)
    ref = segment_spmm_plain(msg, row_ptr, order, f_cap)
    torch.cuda.synchronize()
    return {"name": "segment_spmm", "shape": {"E": fe_cap, "D": d, "R": f_cap, "order": True},
            "max_abs_err": float((out - ref).abs().max()),
            "ms": cuda_time_ms(lambda: segment_spmm(msg, row_ptr, order, f_cap), 100),
            "host_us_per_call": host_us_per_call(
                lambda: segment_spmm(msg, row_ptr, order, f_cap), 100)}


def kernel_delta_agg(keys: np.ndarray, r_cap: int, d: int, gen, iters: int = 200,
                     integer: bool = False) -> dict:
    """Step 1 of the incremental layer: the touched rows' state takes the
    scheduled record sums in place (records with key -1 are padding;
    ``integer``: see :func:`_messages`, the state too)."""
    import torch

    from repro_torch.kernels.delta_agg import delta_agg, delta_agg_plain

    msg, order, row_ptr = _scheduled_inputs(keys, r_cap, d, gen, integer)
    live_keys = keys[keys >= 0]
    live = len(live_keys)
    state0 = _messages(r_cap, d, gen, integer)
    out = delta_agg(state0.clone(), msg, row_ptr, order)
    ref = delta_agg_plain(state0.clone(), msg, row_ptr, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    del out, ref
    state = state0.clone()
    ms = cuda_time_ms(lambda: delta_agg(state, msg, row_ptr, order), iters)
    plain_ms = cuda_time_ms(lambda: delta_agg_plain(state, msg, row_ptr, order),
                            max(3, iters // 10))
    keys_live = torch.from_numpy(live_keys).cuda()
    msg_live = msg[torch.from_numpy(keys >= 0).cuda()]
    lib_ms = cuda_time_ms(lambda: state.index_add_(0, keys_live, msg_live), iters)
    host_us = host_us_per_call(lambda: delta_agg(state, msg, row_ptr, order), iters)
    counts = np.bincount(live_keys, minlength=r_cap)
    touched = int((counts > 0).sum())
    nbytes = live * d * 4 + (r_cap + 1) * 4 + live * 4 + 2 * touched * d * 4
    bound_ms, by = _bound(nbytes, live * d)
    longest = int(counts.max())
    return {"name": "delta_agg", "shape": {"E": len(keys), "live": live, "D": d, "R": r_cap,
                                           "touched": touched, "max_records_a_row": longest,
                                           **_chains(longest)},
            "max_abs_err": err, **({"within_tol": err == 0.0, "values": "integers"}
                                   if integer else {}),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "host_us_per_call": host_us}


def kernel_row_sum_chunked(in_indptr: np.ndarray, keys: np.ndarray, d: int, gen) -> list:
    """Both row-sum kernels at a skewed shape with Gaussian messages, where
    two summation orders of a hub row differ: each is held bit for bit to
    ``row_sum_chunked_plain``, the order ``csrc/row_sum.cuh`` documents
    (``segment_spmm`` on dst-sorted records, ``delta_agg`` on records with
    row ``keys`` in a random order and their row schedule)."""
    import torch

    from repro_torch.kernels.delta_agg import delta_agg
    from repro_torch.kernels.segment_spmm import (
        ROW_SUM_CHUNK,
        row_sum_chunked_plain,
        segment_spmm,
    )

    rows = []
    r, e = len(in_indptr) - 1, int(in_indptr[-1])
    row_ptr = torch.from_numpy(in_indptr.astype(np.int64)).cuda()
    msg = _messages(e, d, gen)
    out = segment_spmm(msg, row_ptr, None, r)
    ref = row_sum_chunked_plain(msg, row_ptr, None, ROW_SUM_CHUNK)
    rows.append(("segment_spmm", {"E": e, "D": d, "R": r, "order": False}, out, ref))
    del msg
    msg, order, row_ptr = _scheduled_inputs(keys, r, d, gen)
    state0 = _messages(r, d, gen)
    out = delta_agg(state0.clone(), msg, row_ptr, order)
    ref = state0
    touched = row_ptr[1:] != row_ptr[:-1]
    ref[touched] += row_sum_chunked_plain(msg, row_ptr, order, ROW_SUM_CHUNK)[touched]
    rows.append(("delta_agg", {"E": len(keys), "D": d, "R": r, "order": True}, out, ref))
    del msg
    torch.cuda.synchronize()
    return [{"name": name, "variant": "zipf_gaussian", "shape": shape,
             "max_abs_err": float((out - ref).abs().max()),
             "within_tol": bool(torch.equal(out, ref)), "values": "gaussian",
             "held_to": "row_sum_chunked_plain, bitwise"}
            for name, shape, out, ref in rows]


def _in_edges(graph):
    """The base graph's in-edges, dst-sorted: host ids, and on the card the
    ids and the ``in_indptr`` row offsets."""
    import torch

    dst_host = np.repeat(np.arange(graph.n), np.diff(graph.in_indptr))
    return dst_host, torch.from_numpy(dst_host).cuda(), torch.from_numpy(graph.in_indptr).cuda()


def phase_edge_softmax_op(graph, gen, kernels: dict) -> dict:
    """The standalone op ``ops.edge_softmax`` on the base graph's in-edges,
    H = gat's heads.  Counts are set to 0 just before the op and read just
    after; the reference check afterwards is not counted."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    dst_host, dst, _ = _in_edges(graph)
    scores = torch.rand(graph.num_edges, GAT_HEADS, device="cuda", generator=gen).exp_()
    for k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    normed, sums = ops.edge_softmax(scores, dst_host, graph.n)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n_ref, s_ref = kref.edge_softmax_ref(scores, dst, graph.n)
    row = {"phase": "edge_softmax_op", "E": graph.num_edges, "H": GAT_HEADS, "R": graph.n,
           # host seconds, synchronised: row schedule on the host + both kernels
           "op_s": op_s,
           "max_abs_err_normalized": float((normed - n_ref).abs().max()),
           "max_abs_err_sums": float((sums - s_ref).abs().max()), "launches": launches}
    emit(row)
    if not (row["max_abs_err_normalized"] <= TOL_KERNEL and row["max_abs_err_sums"] <= TOL_SUMS):
        raise AssertionError(f"edge_softmax vs edge_softmax_ref: {row}")
    return row


def _zero_counts(kernels: dict) -> None:
    import torch

    for k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()


def _counts(kernels: dict) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _require_launched(row: dict, names) -> None:
    for name in names:
        if row["launches"][name] <= 0:
            raise AssertionError(f"{row['phase']}: {name} was not launched")


def _layer_params(model, seed: int):
    """dims [128, 128, 128] from a seeded CPU generator, on the card."""
    import torch

    return model.init_layers(torch.Generator().manual_seed(seed), [WIDTH] * 3, device="cuda")


def _err_vs_full_forward(emb, model, params, x_final: np.ndarray, graph) -> float:
    import torch

    from repro_torch.core import full_forward

    ref = full_forward(model, params, torch.from_numpy(x_final).cuda(), graph)[-1].h
    return float((emb - ref).abs().max())


def _batch_row(b) -> dict:
    return {"mode": b.mode, "graph_time_s": b.graph_time_s, "plan_time_s": b.plan_time_s,
            "exec_time_s": b.exec_time_s, "inc_edges": b.inc_edges,
            "full_edges": b.full_edges, "out_vertices": b.out_vertices}


def _delta(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def _drive_batches(eng, batches, kernels: dict):
    """``apply_batch`` each batch (each exec time synchronised); per batch its
    stats row with the kernel launches it made."""
    stats, rows = [], []
    for b in batches:
        c0 = _counts(kernels)
        bs = eng.apply_batch(b)
        stats.append(bs)
        rows.append({**_batch_row(bs), "launches": _delta(_counts(kernels), c0)})
    return stats, rows


def _require_mode_launches(where: str, rows: list, incremental_delta_agg: bool) -> None:
    """Chunked and full batches must launch segment_spmm (subset_layer,
    full_forward); incremental ones delta_agg where asked."""
    for i, r in enumerate(rows):
        if r["mode"] in ("chunked", "full") and r["launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"{where} batch {i} ({r['mode']}): segment_spmm not launched")
        if (incremental_delta_agg and r["mode"] == "incremental"
                and r["launches"]["delta_agg"] <= 0):
            raise AssertionError(f"{where} batch {i} (incremental): delta_agg not launched")


def phase_policy(serve: dict, seed: int, kernels: dict) -> dict:
    """The execution policy: the adversarial regimes' decision counts and
    the forced replay of their mixed schedules, then adaptive, its forced
    replay and a forced mixed schedule on the serving graph (gcn,
    ``apply_batch``: each exec time synchronised).  Every run is driven and
    its launches read before the checks against ``full_forward``."""
    import torch

    from repro_torch.core import MODES, ExecutionPolicy, make_model
    from repro_torch.graph import ADVERSARIAL_REGIMES, make_adversarial_stream, random_features
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model("gcn")
    wl, x = serve["wl"], serve["x"]
    params = _layer_params(model, seed)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    regimes, regime_rows = {}, {}
    for regime in ADVERSARIAL_REGIMES:
        awl = make_adversarial_stream(regime, n=256, num_batches=6, feature_dim=WIDTH, seed=seed)
        ax, _ = random_features(awl.base.n, WIDTH, seed=seed)

        def run_regime(policy):
            # one layer, as the reference's adversarial cells (dims [8, 8]):
            # the pinned decisions are for that depth
            eng = create_engine("device", EngineConfig(
                model=model, graph=awl.base, x=ax, dims=[WIDTH] * 2, seed=seed, policy=policy,
                device="cuda"))
            return eng, *_drive_batches(eng, awl.batches, kernels)

        adaptive, a_stats, a_rows = run_regime("adaptive")
        modes = tuple(b.mode for b in a_stats)
        replay, _, r_rows = run_regime(ExecutionPolicy(force_mode=modes))
        regimes[regime] = {"decisions": [modes.count(m) for m in MODES],
                           "policy_edges": sum(b.est_edges for b in a_stats), "modes": modes,
                           "replay_bitwise": all(bool(torch.equal(u, v)) for u, v in zip(
                               _state_tensors(adaptive), _state_tensors(replay))),
                           "launches": [r["launches"] for r in a_rows],
                           "replay_launches": [r["launches"] for r in r_rows]}
        regime_rows[regime] = a_rows + r_rows

    def run(policy):
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   policy=policy, device="cuda"))
        return eng, *_drive_batches(eng, wl.batches, kernels)

    adaptive, a_stats, a_rows = run("adaptive")
    schedule = tuple(b.mode for b in a_stats)
    replay, _, r_rows = run(ExecutionPolicy(force_mode=schedule))
    forced, _, f_rows = run(ExecutionPolicy(force_mode=FORCED_SCHEDULE))
    launches = _counts(kernels)
    bitwise = all(bool(torch.equal(u, v))
                  for u, v in zip(_state_tensors(adaptive), _state_tensors(replay)))
    x_final = final_features(x, wl.batches)
    err_adaptive = _err_vs_full_forward(adaptive.embeddings, model, params, x_final,
                                        adaptive.graph)
    err_forced = _err_vs_full_forward(forced.embeddings, model, params, x_final, forced.graph)
    # the chunked mode's layer-to-host copy (layer_input_host) at this size
    copy_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = forced._backend.layer_input_host(1)
        copy_s.append(time.perf_counter() - t0)
    chunk = forced._orch._chunk_sched.stats
    row = {"phase": "policy", "seconds": time.perf_counter() - t_phase,
           "regimes": regimes, "n": wl.base.n, "edges": wl.base.num_edges,
           "adaptive": a_rows, "replay_bitwise": bitwise, "max_abs_err_adaptive": err_adaptive,
           "forced": f_rows, "max_abs_err_forced": err_forced,
           "layer_input_host": {"bytes": host.nbytes, "seconds": copy_s},
           "chunks": {"chunks": chunk.chunks, "rows_transferred": chunk.rows_transferred,
                      "rows_reused": chunk.rows_reused,
                      "edges_processed": chunk.edges_processed},
           "launches": launches}
    emit(row)
    for regime, got in regimes.items():
        want = ADVERSARIAL_EXPECTED[regime]
        if tuple(got["decisions"]) + (got["policy_edges"],) != want:
            raise AssertionError(f"policy {regime}: {got} != {want}")
        if len(set(got["modes"])) < 2 or not got["replay_bitwise"]:
            raise AssertionError(f"policy {regime}: mixed schedule not replayed bitwise: {got}")
        _require_mode_launches(f"policy {regime}", regime_rows[regime], False)
    if not bitwise:
        raise AssertionError("policy: adaptive != forced replay of its decisions")
    if not (err_adaptive <= TOL_ENGINE and err_forced <= TOL_ENGINE):
        raise AssertionError(f"policy vs full_forward: {err_adaptive}, {err_forced} > {TOL_ENGINE}")
    for where, rows in (("adaptive", a_rows), ("replay", r_rows), ("forced", f_rows)):
        _require_mode_launches(f"policy {where}", rows, True)
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _ring_stream(n: int, seed: int):
    """The reference's fusion cell (benchmarks/fig7_response_time.py
    ``smoke_fusion``) at n rows: a ring lattice (in-edges from i+1, i+2) and
    12 single-edge batches with one feature update, 45 rows apart."""
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.streaming import UpdateBatch

    idx = np.arange(n, dtype=np.int64)
    g = CSRGraph.from_edges(n, np.concatenate([(idx + 1) % n, (idx + 2) % n]),
                            np.concatenate([idx, idx]))
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(12):
        base = (i * 45) % n
        batches.append(UpdateBatch(
            ins_src=np.array([(base + 1) % n], np.int64),
            ins_dst=np.array([(base + 5) % n], np.int64),
            del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
            feat_vertices=np.array([(base + 7) % n], np.int64),
            feat_values=rng.standard_normal((1, WIDTH)).astype(np.float32)))
    return g, batches


def phase_fusion_frontend(serve: dict, seed: int, kernels: dict) -> dict:
    """Batch-window fusion on the ring cell (fused ≡ serial, bitwise), then
    the serving front-end's versioned reads on the serving stream."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import random_features
    from repro_torch.serve import EngineConfig, FusionConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    n = serve["n"]
    g, batches = _ring_stream(n, seed)
    rx, _ = random_features(n, WIDTH, seed=seed)
    runs = {}
    for fused in (False, True):
        eng = create_engine("device", EngineConfig(
            model=model, graph=g, x=rx, params=params, device="cuda",
            fusion=FusionConfig(window=4) if fused else None))
        runs[fused] = (eng, eng.apply_stream(batches))
    (serial, ss_s), (fused_eng, ss_f) = runs[False], runs[True]
    pairs = {f"{kind}{l}": (u, v) for kind in ("h", "a", "nct")
             for l, (u, v) in enumerate(zip(getattr(serial, kind), getattr(fused_eng, kind)))}
    equal = {k: bool(torch.equal(u, v)) for k, (u, v) in pairs.items()}
    bitwise = all(equal.values())
    max_diff = max(float((u - v).abs().max()) for u, v in pairs.values())
    dispatches = len(batches) - (ss_f.fused_batches - ss_f.fusion_windows)
    fusion = {"n": n, "batches": len(batches), "windows": ss_f.fusion_windows,
              "fused_batches": ss_f.fused_batches, "fallbacks": ss_f.fusion_fallbacks,
              "dispatches": dispatches, "bitwise_fused_vs_serial": bitwise,
              "equal_fused_vs_serial": equal, "max_abs_diff_fused_vs_serial": max_diff,
              "wall_s_fused": ss_f.wall_s, "wall_s_serial": ss_s.wall_s}
    del runs, serial, fused_eng, pairs

    wl, x = serve["wl"], serve["x"]
    eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                               device="cuda"))
    fr = eng.serving_frontend(max_pending_reads=16, max_versions=4)
    rows = np.arange(0, wl.base.n, 17)
    snaps = {0: eng.snapshot_rows(rows)}
    tickets = []
    for b in wl.batches:  # the reference's smoke_frontend schedule
        tickets.append(fr.submit_read(rows))
        if fr.version >= 2:
            tickets.append(fr.submit_read(rows, version=fr.version - 2))
        fr.apply_batch(b)
        snaps[fr.version] = eng.snapshot_rows(rows)
    fr.drain()
    st = fr.stats()
    reads_bitwise = all(np.array_equal(t.value(), snaps[t.version]) for t in tickets)
    row = {"phase": "fusion_frontend", "seconds": time.perf_counter() - t_phase,
           "fusion": fusion,
           "frontend": {"rows_per_read": int(rows.size), "reads_served": st.reads_served,
                        "staleness_batches": st.staleness_batches,
                        "reads_rejected": st.reads_rejected, "reads_bitwise": reads_bitwise,
                        "read_p50_s": st.read_p50_s, "read_p99_s": st.read_p99_s,
                        "wall_s": st.wall_s,
                        "exec_time_s": [b.exec_time_s for b in st.batches]},
           "launches": _counts(kernels)}
    emit(row)
    if (fusion["windows"], fusion["fused_batches"], dispatches, fusion["fallbacks"]) != (3, 12, 3, 0):
        raise AssertionError(f"fusion counters: {fusion}")
    if not bitwise:
        raise AssertionError(f"fused != serial: {equal}, max|Δ| {max_diff}")
    if (st.reads_served, st.staleness_batches) != (10, 8) or not reads_bitwise:
        raise AssertionError(f"frontend: {row['frontend']}")
    _require_launched(row, ("delta_agg",))
    return row


def phase_storage(serve: dict, seed: int, kernels: dict) -> dict:
    """§V-B recompute storage: ``store_h=False`` against ``store_h=True``."""
    from repro_torch.core import make_model
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    wl, x = serve["wl"], serve["x"]
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    out = {}
    for store_h in (True, False):
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   store_h=store_h, device="cuda"))
        ss = eng.apply_stream(wl.batches)
        out[store_h] = {"emb": eng.embeddings.clone(), "state_bytes": eng.state_bytes(),
                        "wall_s": ss.wall_s, "graph": eng.graph}
    launches = _counts(kernels)
    err = float((out[True]["emb"] - out[False]["emb"]).abs().max())
    x_final = final_features(x, wl.batches)
    err_full = max(_err_vs_full_forward(out[k]["emb"], model, params, x_final, out[k]["graph"])
                   for k in (True, False))
    row = {"phase": "storage", "seconds": time.perf_counter() - t_phase,
           "state_bytes": {"store_h": out[True]["state_bytes"],
                           "recompute_h": out[False]["state_bytes"]},
           "state_bytes_ratio": out[False]["state_bytes"] / out[True]["state_bytes"],
           "wall_s": {"store_h": out[True]["wall_s"], "recompute_h": out[False]["wall_s"]},
           "max_abs_diff_store_vs_recompute": err, "max_abs_err_vs_full_forward": err_full,
           "launches": launches}
    emit(row)
    if not (err <= TOL_ENGINE and err_full <= TOL_ENGINE):
        raise AssertionError(f"storage: {err}, {err_full} > {TOL_ENGINE}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _state_tensors(eng) -> list:
    return [v for v in (*eng.h, *eng.a, *eng.nct) if v is not None]


def phase_baselines_odec(serve: dict, seed: int, kernels: dict) -> dict:
    """The fig7 baselines beside the engine, ODEC, and the Theorem-1 gate."""
    import torch

    from repro_torch.core import (
        ALL_MODELS,
        RTECUER,
        MTECPeriod,
        RTECFull,
        RTECSample,
        make_model,
        odec_query,
        validate_registration,
    )
    from repro_torch.serve import EngineConfig, create_engine

    wl, x = serve["wl_small"], serve["x"]
    xt = torch.from_numpy(x).cuda()
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    launches = _counts(kernels)
    models = {}
    for name in ("gcn", "gat"):
        model = make_model(name)
        params = _layer_params(model, seed)
        c0 = _counts(kernels)
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   device="cuda"))
        systems = {"RTECFull": RTECFull(model, params, wl.base, xt),
                   "RTECUER": RTECUER(model, params, wl.base, xt),
                   "RTECSample": RTECSample(model, params, wl.base, xt, fanout=10, seed=seed),
                   "MTECPeriod": MTECPeriod(model, params, wl.base, xt, period=3)}
        mtec0 = systems["MTECPeriod"].embeddings.clone()
        per = {k: [] for k in ("engine", *systems)}
        stale = []
        for i, b in enumerate(wl.batches):
            if i == 0:
                q = np.unique(np.concatenate([b.ins_dst, b.del_dst]))[:64]
                before = [v.clone() for v in _state_tensors(eng)]
                emb_q, ost = odec_query(eng, b, q)
                unchanged = all(bool(torch.equal(u, v)) for u, v in zip(before, _state_tensors(eng)))
                del before
            per["engine"].append(eng.apply_batch(b))
            if i == 0:
                odec_err = float((emb_q - eng.embeddings[torch.from_numpy(q).cuda()]).abs().max())
            for k, sysm in systems.items():
                per[k].append(sysm.apply_batch(b))
            if i < 2:
                stale.append(float((systems["MTECPeriod"].embeddings - mtec0).abs().max()))
        # this model's drives, read before the checks against full_forward
        launches = {k: launches[k] + d for k, d in _delta(_counts(kernels), c0).items()}
        errs = {k: _err_vs_full_forward(systems[k].embeddings, model, params, x, eng.graph)
                for k in systems}
        edges = {k: sum(b.edges_processed for b in v) for k, v in per.items()}
        models[name] = {
            "exec_time_s": {k: [b.exec_time_s for b in v] for k, v in per.items()},
            "plan_time_s": {k: [b.plan_time_s for b in v] for k, v in per.items()},
            "edges_processed": edges, "max_abs_err_vs_full_forward": errs,
            "sample_finite": bool(torch.isfinite(systems["RTECSample"].embeddings).all()),
            "mtec_stale_max_abs_diff": stale,
            "odec": {"query": int(q.size), "max_abs_err_vs_engine": odec_err,
                     "engine_state_unchanged": unchanged, "exec_time_s": ost.exec_time_s,
                     "plan_time_s": ost.plan_time_s, "edges_processed": ost.edges_processed}}
        del eng, systems
    certified = {}
    for name in ALL_MODELS:
        rep = validate_registration(make_model(name))  # raises on a contradicted flag
        certified[name] = {"incrementalizable": rep.incrementalizable,
                           "dest_independent": rep.dest_independent,
                           "struct_independent": rep.struct_independent}
    row = {"phase": "baselines_odec", "seconds": time.perf_counter() - t_phase,
           "n": wl.base.n, "batches": len(wl.batches),
           "updates_per_batch": int(wl.batches[0].num_updates), "models": models,
           "certify": certified, "launches": launches}
    emit(row)
    for name, m in models.items():
        e = m["edges_processed"]
        errs = m["max_abs_err_vs_full_forward"]
        if not all(errs[k] <= TOL_ENGINE for k in ("RTECFull", "RTECUER", "MTECPeriod")):
            raise AssertionError(f"{name} baselines vs full_forward: {errs}")
        if not m["sample_finite"] or not all(d <= TOL_STALE for d in m["mtec_stale_max_abs_diff"]):
            raise AssertionError(f"{name}: RTECSample not finite or MTEC not stale: {m}")
        if not e["engine"] < e["RTECUER"] <= e["RTECFull"]:
            raise AssertionError(f"{name}: edges processed not Inc < UER <= Full: {e}")
        if not (m["odec"]["engine_state_unchanged"]
                and m["odec"]["max_abs_err_vs_engine"] <= TOL_ODEC):
            raise AssertionError(f"{name} ODEC: {m['odec']}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _host_state(eng) -> dict:
    """An engine's state by tensor name (h0.., a0.., nct0..) as host arrays."""
    return {f"{kind}{l}": v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
            for kind in ("h", "a", "nct") for l, v in enumerate(getattr(eng, kind))}


def _compare(u: dict, v: dict):
    """Per tensor: bitwise equal?  And the max |Δ| over all of them."""
    equal = {k: bool(np.array_equal(u[k], v[k])) for k in u}
    return equal, max(float(np.abs(u[k] - v[k]).max()) for k in u)


def _count_dispatches(eng, kernels: dict, rows: list, shapes: list = None) -> None:
    """Record the kernel launches of each ``dispatch`` of ``eng``'s backend
    (one per batch in ``apply_stream``) into ``rows``, with an offload
    batch's footprint (its largest layer's staged rows and staging-buffer
    bytes), and each layer's compact ``delta_agg`` shape (e_cap, r_cap, live
    records) into ``shapes``."""
    backend = eng._backend
    inner = backend.dispatch

    def dispatch(prep):
        c0 = _counts(kernels)
        inner(prep)
        rows.append(_delta(_counts(kernels), c0))
        if hasattr(prep, "transfers"):
            rows[-1]["staged_rows_max"] = max(tr.need_h.shape[0] for tr in prep.transfers)
            rows[-1]["layer_buffer_bytes_max"] = max(tr.layout.total for tr in prep.transfers)
        if shapes is not None:
            shapes.extend((lp.e_src.shape[0], lp.touch_rows.shape[0], int(lp.e_mask.sum()))
                          for lp in prep.plan.layers)

    backend.dispatch = dispatch


def _stream_row(ss, eng=None) -> dict:
    d = ss.as_dict()
    row = {k: d[k] for k in ("wall_s", "plan_s", "staged_bytes", "prefetch_hits", "sync_wait_s",
                             "compute_s", "cache_hit_rows", "cache_miss_rows", "cache_evictions")}
    row["exec_time_s"] = [b.exec_time_s for b in ss.batches]
    if eng is not None and hasattr(eng, "transfers"):
        row["transfer_rows"] = eng.transfers.total_rows
    return row


def phase_offload(serve: dict, seed: int, kernels: dict) -> dict:
    """The §V-B offload engine at full width: gcn and gat through
    ``apply_stream`` (pinned async staging), gcn again with inline staging
    (bitwise equal to async), on the device engine (bitwise equal), and
    on a stream of 10-update batches, whose affected rows are a small share
    of V (the device footprint then follows the affected set).  Every drive
    is counted before the checks against ``full_forward``."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import make_stream
    from repro_torch.serve import EngineConfig, StagingConfig, create_engine

    wl, x = serve["wl"], serve["x"]
    small = make_stream(wl.base, num_batches=3, batch_edges=10, delete_frac=0.3,
                        seed=seed + 3)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    runs, per_batch, shapes = {}, {}, []
    for key, name, backend, kw, w in (
            ("gcn", "gcn", "offload", {}, wl), ("gat", "gat", "offload", {}, wl),
            ("gcn_sync", "gcn", "offload", {"staging": StagingConfig(async_enabled=False)}, wl),
            ("gcn_device", "gcn", "device", {}, wl),
            ("gcn_small_batches", "gcn", "offload", {}, small)):
        model = make_model(name)
        params = _layer_params(model, seed)
        t0 = time.perf_counter()
        eng = create_engine(backend, EngineConfig(model=model, graph=w.base, x=x, params=params,
                                                  device="cuda", **kw))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        per_batch[key] = []
        _count_dispatches(eng, kernels, per_batch[key], shapes if key == "gcn" else None)
        ss = eng.apply_stream(w.batches)
        torch.cuda.synchronize()
        runs[key] = {"eng": eng, "model": model, "params": params, "ss": ss, "init_s": init_s,
                     "batches": w.batches,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "stream_mem_bytes": torch.cuda.max_memory_allocated() - base}
    launches = _counts(kernels)
    streams = {}
    for key, r in runs.items():
        eng = r["eng"]
        emb = eng.embeddings
        emb = torch.from_numpy(np.asarray(emb)).cuda() if not torch.is_tensor(emb) else emb
        if emb.shape != (wl.base.n, WIDTH) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"offload {key}: bad embeddings {tuple(emb.shape)}")
        streams[key] = {**_stream_row(r["ss"], eng), "init_s": r["init_s"],
                        "peak_mem_bytes": r["peak_mem_bytes"],
                        "stream_mem_bytes": r["stream_mem_bytes"],
                        "launches_per_batch": per_batch[key],
                        "max_abs_err_vs_full_forward": _err_vs_full_forward(
                            emb, r["model"], r["params"], final_features(x, r["batches"]),
                            eng.graph)}
    dev = runs["gcn_device"]["eng"]
    dev_state = _host_state(dev)
    sync_equal, sync_diff = _compare(_host_state(runs["gcn"]["eng"]),
                                     _host_state(runs["gcn_sync"]["eng"]))
    dev_equal, dev_diff = _compare(dev_state, _host_state(runs["gcn"]["eng"]))
    row = {"phase": "offload", "seconds": time.perf_counter() - t_phase, "n": wl.base.n,
           "edges": wl.base.num_edges, "width": WIDTH, "layers": 2, "streams": streams,
           "device_state_bytes": dev.state_bytes(),
           "bitwise_async_vs_sync": all(sync_equal.values()),
           "max_abs_diff_async_vs_sync": sync_diff,
           "equal_device_vs_offload": dev_equal, "max_abs_diff_device_vs_offload": dev_diff,
           "delta_agg_compact_shapes": shapes, "launches": launches}
    emit(row)
    for key in runs:
        if not streams[key]["max_abs_err_vs_full_forward"] <= TOL_ENGINE:
            raise AssertionError(f"offload {key} vs full_forward: {streams[key]}")
    if (streams["gcn"]["prefetch_hits"], streams["gcn_sync"]["prefetch_hits"]) != (
            len(wl.batches) - 1, 0):
        raise AssertionError(f"offload prefetch_hits: {streams['gcn']}, {streams['gcn_sync']}")
    if not row["bitwise_async_vs_sync"]:
        raise AssertionError(f"offload async != sync: {sync_equal}")
    if not all(dev_equal.values()):
        raise AssertionError(f"device vs offload: {dev_equal}, max|Δ| {dev_diff}")
    for key in ("gcn", "gat", "gcn_sync", "gcn_small_batches"):
        for i, c in enumerate(per_batch[key]):
            # step 1 once per layer (2 layers); gat's step 3 sums through segment_spmm
            if c["delta_agg"] != 2 or (key == "gat" and c["segment_spmm"] <= 0):
                raise AssertionError(f"offload {key} batch {i}: launches {c}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _hub_burst():
    """The reference's hub_burst cache cell (benchmarks/fig7_response_time.py
    ``smoke_cache``): the adversarial stream, 6 batches, features 8."""
    from repro_torch.graph import make_adversarial_stream, random_features

    wl = make_adversarial_stream("hub_burst", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    return x, wl


def _fig7_smoke():
    """The reference's fig7 smoke cell (benchmarks/fig7_response_time.py
    ``smoke`` and ``benchmarks/common.py`` ``setup``): powerlaw n = 300,
    average degree 4, features 16, 6 batches of 8 edge updates."""
    from repro_torch.graph import make_graph, make_stream, random_features

    g = make_graph("powerlaw", 300, avg_degree=4.0, seed=0, weighted=True)
    x, _ = random_features(300, 16, seed=0)
    return x, make_stream(g, num_batches=6, batch_edges=8, delete_frac=0.3, seed=1)


def phase_hot_cache(serve: dict, seed: int, kernels: dict) -> dict:
    """The reference's exact offload and cache counters at its own sizes,
    then the hot-row cache at full width against the uncached engine."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CacheConfig, EngineConfig, create_engine

    model = make_model("gcn")
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    fx, fwl = _fig7_smoke()
    fig7 = create_engine("offload", EngineConfig(model=model, graph=fwl.base, x=fx, dims=[16, 16],
                                                 seed=seed, device="cuda"))
    fig7_ss = fig7.apply_stream(fwl.batches)
    hx, hwl = _hub_burst()
    hub, hub_ss = {}, {}
    for cached in (False, True):
        hub[cached] = create_engine("offload", EngineConfig(
            model=model, graph=hwl.base, x=hx, dims=[8, 8], seed=seed, device="cuda",
            cache=CacheConfig(capacity_rows=256) if cached else None))
        hub_ss[cached] = hub[cached].apply_stream(hwl.batches)
    wl, x = serve["wl"], serve["x"]
    params = _layer_params(model, seed)
    full, full_ss, full_mem = {}, {}, {}
    for cached in (False, True):
        full[cached] = create_engine("offload", EngineConfig(
            model=model, graph=wl.base, x=x, params=params, device="cuda",
            cache=CacheConfig(capacity_rows=8192, prewarm_rows=8192) if cached else None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the cache's stores, when cached
        full_ss[cached] = full[cached].apply_stream(wl.batches)
        torch.cuda.synchronize()
        full_mem[cached] = torch.cuda.max_memory_allocated() - base
    launches = _counts(kernels)
    hub_equal, hub_diff = _compare(_host_state(hub[False]), _host_state(hub[True]))
    full_equal, full_diff = _compare(_host_state(full[False]), _host_state(full[True]))
    h_u, h_c = hub_ss[False].staged_bytes, hub_ss[True].staged_bytes
    f_u, f_c = full_ss[False].staged_bytes, full_ss[True].staged_bytes
    row = {"phase": "hot_cache", "seconds": time.perf_counter() - t_phase,
           "fig7_smoke": {"n": fwl.base.n, **_stream_row(fig7_ss, fig7)},
           "hub_burst": {"n": hwl.base.n, "uncached": _stream_row(hub_ss[False], hub[False]),
                         "cached": _stream_row(hub_ss[True], hub[True]),
                         "staged_bytes_ratio": h_u / max(h_c, 1),
                         "bitwise_cached_vs_uncached": all(hub_equal.values()),
                         "max_abs_diff": hub_diff},
           "full_width": {"n": wl.base.n, "capacity_rows": 8192, "prewarm_rows": 8192,
                          "uncached": {**_stream_row(full_ss[False], full[False]),
                                       "stream_mem_bytes": full_mem[False]},
                          "cached": {**_stream_row(full_ss[True], full[True]),
                                     "stream_mem_bytes": full_mem[True]},
                          "staged_bytes_ratio": f_u / max(f_c, 1),
                          "cache_store_bytes": full[True]._backend._cache.state_bytes(),
                          "bitwise_cached_vs_uncached": all(full_equal.values()),
                          "max_abs_diff": full_diff},
           "launches": launches}
    emit(row)
    got = (fig7.transfers.total_rows, fig7_ss.staged_bytes, fig7_ss.prefetch_hits)
    if got != (2970, 145_560, 5):
        raise AssertionError(f"fig7 smoke offload counters {got} != (2970, 145560, 5)")
    got = (hub_ss[True].cache_hit_rows, hub_ss[True].cache_miss_rows,
           hub_ss[True].cache_evictions, h_c, h_u)
    if got != (580, 504, 0, 61_648, 107_968):
        raise AssertionError(f"hub_burst cache counters {got} != (580, 504, 0, 61648, 107968)")
    if not (all(hub_equal.values()) and all(full_equal.values())):
        raise AssertionError(f"cached != uncached: {hub_equal}, {full_equal}")
    if not full_ss[True].cache_hit_rows > 0 or not f_c < f_u:
        raise AssertionError(f"full-width cache: {row['full_width']}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def phase_chunked_backend(serve: dict, seed: int, kernels: dict) -> dict:
    """The chunked-recompute backend on the serving stream's first 3
    batches, then one fused offload window (the ring cell of phase 8)."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import random_features
    from repro_torch.serve import EngineConfig, FusionConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    wl, x = serve["wl"], serve["x"]
    batches = wl.batches[:3]
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    eng = create_engine("chunked", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                chunk_size=8192, device="cuda"))
    _, rows = _drive_batches(eng, batches, kernels)
    g, ring_batches = _ring_stream(serve["n"], seed)
    rx, _ = random_features(serve["n"], WIDTH, seed=seed)
    ring = {}
    for fused in (False, True):
        e = create_engine("offload", EngineConfig(
            model=model, graph=g, x=rx, params=params, device="cuda",
            fusion=FusionConfig(window=4) if fused else None))
        ring[fused] = (e, e.apply_stream(ring_batches))
    launches = _counts(kernels)
    emb = torch.from_numpy(np.asarray(eng.embeddings)).cuda()
    err = _err_vs_full_forward(emb, model, params, final_features(x, batches), eng.graph)
    (serial, ss_s), (fused_eng, ss_f) = ring[False], ring[True]
    equal, max_diff = _compare(_host_state(serial), _host_state(fused_eng))
    dispatches = len(ring_batches) - (ss_f.fused_batches - ss_f.fusion_windows)
    st = eng.chunk_stats
    row = {"phase": "chunked_backend", "seconds": time.perf_counter() - t_phase,
           "n": wl.base.n, "chunk_size": 8192, "batches": rows,
           "chunk_stats": {"chunks": st.chunks, "rows_transferred": st.rows_transferred,
                           "rows_reused": st.rows_reused, "reuse_frac": st.reuse_frac,
                           "edges_processed": st.edges_processed},
           "max_abs_err_vs_full_forward": err,
           "offload_fusion": {"windows": ss_f.fusion_windows, "fused_batches": ss_f.fused_batches,
                              "fallbacks": ss_f.fusion_fallbacks, "dispatches": dispatches,
                              "equal_fused_vs_serial": equal,
                              "max_abs_diff_fused_vs_serial": max_diff,
                              "wall_s_fused": ss_f.wall_s, "wall_s_serial": ss_s.wall_s},
           "launches": launches}
    emit(row)
    if not err <= TOL_ENGINE:
        raise AssertionError(f"chunked backend vs full_forward: {err} > {TOL_ENGINE}")
    for i, r in enumerate(rows):
        if r["launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"chunked backend batch {i}: segment_spmm not launched")
    if (ss_f.fusion_windows, ss_f.fused_batches, dispatches, ss_f.fusion_fallbacks) != (3, 12, 3, 0):
        raise AssertionError(f"offload fusion counters: {row['offload_fusion']}")
    if not all(equal.values()):
        raise AssertionError(f"offload fused != serial: {equal}, max|Δ| {max_diff}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def phase_sharded(serve: dict, seed: int, kernels: dict) -> dict:
    """The row-sharded engine, S logical shards on the card: the
    reference's fig7 sharded cell at its own size, then the serving graph
    at full width against the device engine and ``full_forward``.  Every
    drive is counted before the checks."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CommsConfig, EngineConfig, create_engine

    t_phase = time.perf_counter()
    _zero_counts(kernels)
    gcn = make_model("gcn")
    fx, fwl = _fig7_smoke()
    fparams = gcn.init_layers(torch.Generator().manual_seed(seed), [16, 16], device="cuda")
    fig7 = {}
    for key, backend, kw in (("device", "device", {}),
                             ("psum", "sharded", {"comms": CommsConfig(halo="psum")}),
                             ("ppermute", "sharded", {"comms": CommsConfig(halo="ppermute")})):
        if backend == "sharded":
            kw["num_shards"] = SHARDS
        eng = create_engine(backend, EngineConfig(model=gcn, graph=fwl.base, x=fx, params=fparams,
                                                  device="cuda", **kw))
        fig7[key] = (eng, eng.apply_stream(fwl.batches))
    wl, x = serve["wl"], serve["x"]
    runs = {}
    for key, name, shards in (("gcn_device", "gcn", None), ("gcn_s8", "gcn", SHARDS),
                              ("gcn_s1", "gcn", 1), ("gat_s8", "gat", SHARDS),
                              ("gat_s1", "gat", 1)):
        model = make_model(name)
        params = _layer_params(model, seed)
        kw = {} if shards is None else {"num_shards": shards}
        c0 = _counts(kernels)
        t0 = time.perf_counter()
        eng = create_engine("device" if shards is None else "sharded", EngineConfig(
            model=model, graph=wl.base, x=x, params=params, device="cuda", **kw))
        torch.cuda.synchronize()
        run = {"eng": eng, "model": model, "params": params, "shards": shards,
               "init_s": time.perf_counter() - t0, "init_launches": _delta(_counts(kernels), c0)}
        _, run["batches"] = _drive_batches(eng, wl.batches, kernels)  # each exec synchronised
        runs[key] = run
    launches = _counts(kernels)

    fig7_state = {k: _host_state(e) for k, (e, _) in fig7.items()}
    fig7_eq = {k: _compare(fig7_state["device"], fig7_state[k])[0] for k in ("psum", "ppermute")}
    dev_state = _host_state(runs["gcn_device"]["eng"])
    x_final = final_features(x, wl.batches)
    full = {}
    for key, r in runs.items():
        eng = r["eng"]
        comms = eng._backend.comms_snapshot()
        row = {"shards": r["shards"], "init_s": r["init_s"], "init_launches": r["init_launches"],
               "batches": r["batches"], "state_bytes": eng.state_bytes(),
               "max_abs_err_vs_full_forward": _err_vs_full_forward(
                   eng.embeddings, r["model"], r["params"], x_final, eng.graph)}
        if comms is not None:
            row.update(halo_rows=eng.halo_rows_total, halo_rows_sent=comms.halo_rows_sent,
                       halo_bytes=comms.halo_bytes, halo_mode=eng.halo_mode)
        if key.startswith("gcn_s"):
            row["equal_vs_device"], row["max_abs_diff_vs_device"] = _compare(
                dev_state, _host_state(eng))
        full[key] = row
    row = {"phase": "sharded", "seconds": time.perf_counter() - t_phase,
           "fig7": {"n": fwl.base.n, "shards": SHARDS,
                    "halo_rows_sent": {k: fig7[k][1].comms_halo_rows_sent
                                       for k in ("psum", "ppermute")},
                    "halo_bytes": {k: fig7[k][1].comms_halo_bytes for k in ("psum", "ppermute")},
                    "wall_s": {k: fig7[k][1].wall_s for k in fig7},
                    "equal_vs_device": fig7_eq},
           "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
           "full_width": full, "launches": launches}
    emit(row)
    got = (fig7["ppermute"][1].comms_halo_rows_sent, fig7["psum"][1].comms_halo_rows_sent)
    if got != (157, 584):
        raise AssertionError(f"fig7 sharded halo rows {got} != (157, 584)")
    if not all(all(eq.values()) for eq in fig7_eq.values()):
        raise AssertionError(f"fig7 sharded != device engine: {fig7_eq}")
    for key in ("gcn_s8", "gcn_s1"):
        if not all(full[key]["equal_vs_device"].values()):
            raise AssertionError(f"sharded {key} != device engine: {full[key]['equal_vs_device']}")
    for key, r in full.items():
        if not r["max_abs_err_vs_full_forward"] <= TOL_ENGINE:
            raise AssertionError(f"sharded {key} vs full_forward: {r['max_abs_err_vs_full_forward']}")
        if r["init_launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"sharded {key}: init did not launch segment_spmm")
        per = runs[key]["shards"] or 1
        for i, b in enumerate(r["batches"]):
            if b["launches"]["delta_agg"] != per * 2:
                raise AssertionError(f"sharded {key} batch {i}: launches {b['launches']}")
    _require_launched(row, ("delta_agg", "segment_spmm", "row_linear"))
    return row


def phase_sharded_offload(serve: dict, seed: int, kernels: dict) -> dict:
    """The sharded-offload hybrid at S = 8: the reference's fig7 and
    hub_burst counters at their own sizes, then the serving graph at full
    width against the offload engine (bitwise) in both halo modes."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CacheConfig, CommsConfig, EngineConfig, create_engine

    t_phase = time.perf_counter()
    _zero_counts(kernels)
    gcn = make_model("gcn")
    fx, fwl = _fig7_smoke()
    fig7_kw = dict(model=gcn, graph=fwl.base, x=fx, dims=[16, 16], seed=seed, device="cuda",
                   num_shards=SHARDS)
    fig7 = create_engine("sharded_offload", EngineConfig(**fig7_kw))
    for b in fwl.batches:
        fig7.apply_batch(b)
    fig7_pipe = create_engine("sharded_offload", EngineConfig(**fig7_kw))
    fig7_ss = fig7_pipe.apply_stream(fwl.batches)
    hx, hwl = _hub_burst()
    hub, hub_ss = {}, {}
    for cached in (False, True):
        hub[cached] = create_engine("sharded_offload", EngineConfig(
            model=gcn, graph=hwl.base, x=hx, dims=[8, 8], seed=seed, device="cuda",
            num_shards=SHARDS, cache=CacheConfig(capacity_rows=256) if cached else None))
        hub_ss[cached] = hub[cached].apply_stream(hwl.batches)
    wl, x = serve["wl"], serve["x"]
    runs, per_batch = {}, {}
    for key, name, backend, halo in (
            ("gcn_offload", "gcn", "offload", None), ("gcn_hybrid", "gcn", "sharded_offload", "ppermute"),
            ("gcn_hybrid_psum", "gcn", "sharded_offload", "psum"),
            ("gat_offload", "gat", "offload", None), ("gat_hybrid", "gat", "sharded_offload", "ppermute"),
            ("gat_hybrid_psum", "gat", "sharded_offload", "psum")):
        model = make_model(name)
        params = _layer_params(model, seed)
        kw = {} if halo is None else {"num_shards": SHARDS, "comms": CommsConfig(halo=halo)}
        eng = create_engine(backend, EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                  device="cuda", **kw))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        per_batch[key] = []
        _count_dispatches(eng, kernels, per_batch[key])
        ss = eng.apply_stream(wl.batches)
        torch.cuda.synchronize()
        runs[key] = {"eng": eng, "ss": ss,
                     "stream_mem_bytes": torch.cuda.max_memory_allocated() - base}
    launches = _counts(kernels)

    hub_equal, hub_diff = _compare(_host_state(hub[False]), _host_state(hub[True]))
    states = {key: _host_state(r["eng"]) for key, r in runs.items()}
    full = {}
    for key, r in runs.items():
        eng = r["eng"]
        full[key] = {**_stream_row(r["ss"], eng), "stream_mem_bytes": r["stream_mem_bytes"],
                     "launches_per_batch": per_batch[key], "state_bytes": eng.state_bytes()}
        if "hybrid" in key:
            full[key].update(
                transfer_rows_per_shard=eng.per_shard_rows.tolist(),
                peak_device_bytes=eng.peak_device_bytes,
                halo_rows_sent=r["ss"].comms_halo_rows_sent,
                halo_bytes=r["ss"].comms_halo_bytes)
            ref = key.split("_")[0] + "_offload"
            full[key]["equal_vs_offload"], full[key]["max_abs_diff_vs_offload"] = _compare(
                states[ref], states[key])
    row = {"phase": "sharded_offload", "seconds": time.perf_counter() - t_phase,
           "fig7": {"n": fwl.base.n, "shards": SHARDS,
                    "transfer_rows_per_shard_max": int(fig7.per_shard_rows.max()),
                    **_stream_row(fig7_ss, fig7_pipe)},
           "hub_burst": {"n": hwl.base.n, "uncached": _stream_row(hub_ss[False], hub[False]),
                         "cached": _stream_row(hub_ss[True], hub[True]),
                         "bitwise_cached_vs_uncached": all(hub_equal.values()),
                         "max_abs_diff": hub_diff},
           "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
           "full_width": full, "launches": launches}
    emit(row)
    got = (row["fig7"]["transfer_rows_per_shard_max"], fig7_ss.staged_bytes,
           fig7_ss.prefetch_hits)
    if got != (731, 470_016, 5):
        raise AssertionError(f"fig7 hybrid counters {got} != (731, 470016, 5)")
    got = (hub_ss[True].cache_hit_rows, hub_ss[True].cache_miss_rows,
           hub_ss[True].cache_evictions)
    if got != (616, 532, 0) or not all(hub_equal.values()):
        raise AssertionError(f"hub_burst hybrid cache {got} != (616, 532, 0) or cached != "
                             f"uncached: {hub_equal}")
    for key in ("gcn_hybrid", "gcn_hybrid_psum", "gat_hybrid", "gat_hybrid_psum"):
        if not all(full[key]["equal_vs_offload"].values()):
            raise AssertionError(f"hybrid {key} != offload: {full[key]['equal_vs_offload']}")
        for i, c in enumerate(per_batch[key]):
            # step 1 once per shard and layer; gat's step 3 through segment_spmm
            if c["delta_agg"] != SHARDS * 2 or (key.startswith("gat") and c["segment_spmm"] <= 0):
                raise AssertionError(f"hybrid {key} batch {i}: launches {c}")
    _require_launched(row, ("delta_agg", "segment_spmm", "row_linear"))
    return row


def serving_data(n: int, seed: int) -> dict:
    """The serving phases' graph, features and streams."""
    from repro_torch.graph import make_graph, make_stream, random_features

    t0 = time.perf_counter()
    graph = make_graph("uniform", n, avg_degree=10, seed=seed, weighted=True)
    x, _ = random_features(n, WIDTH, seed=seed)
    wl = make_stream(graph, num_batches=6, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=seed + 1)
    wl_small = make_stream(graph, num_batches=3, batch_edges=100, delete_frac=0.3,
                           seed=seed + 2)
    emit({"phase": "serving_data", "n": n, "edges": graph.num_edges,
          "base_edges": wl.base.num_edges, "setup_s": time.perf_counter() - t0})
    return {"n": n, "x": x, "wl": wl, "wl_small": wl_small}


def _device_split_ms(events) -> dict:
    """Device milliseconds of a ``torch.profiler`` trace's ``key_averages()``
    by kernel kind."""
    from torch.autograd import DeviceType

    split = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "matmul": 0.0,
             "segment_spmm": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = e.key.lower()
        kind = ("flash_attention" if "flash_attention" in name else
                "flash_attention_bwd" if "bwd_dq_" in name or "bwd_dkdv_" in name
                else "segment_spmm" if "row_sum" in name  # the MoE combine on the LM path
                else "matmul" if any(w in name for w in ("gemm", "gemv", "splitk", "nvjet"))
                else "other")
        split[kind] += e.self_device_time_total / 1e3
    return split


def _profiled(fn, host: bool = True) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall, device time by
    kind, and the device's idle share of the wall.  ``host=False`` traces the
    device alone (no host operator events: a host loop of ~10^5 launches
    makes ~10^6 of them, whose averaging took minutes)."""
    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()  # one pass: a host-loop trace holds ~10^6 events
    split = _device_split_ms(events)
    busy = sum(split.values())
    top = sorted(((e.self_device_time_total / 1e3, e.key[:80]) for e in events
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)[:5]
    return {"wall_ms": wall_ms, "device_ms": split,
            "device_idle_share": 1.0 - busy / wall_ms if busy > 0 else None,
            "top_kernels_ms": [[name, ms] for ms, name in top]}


def phase_lm_serve(seed: int, kernels: dict):
    """One run of the LM serving path at full width.  Counts are set to 0
    just before ``serve`` and read just after it; a short warm-up serve
    before that takes the lazy CUDA/cuBLAS set-up out of the timed run."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill

    cfg = get_arch(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(cfg, params, tokens[:, :64], 2)  # warm-up
    for k in kernels.values():
        k.reset_counts()
    res = serve(cfg, params, tokens, LM_GEN)
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_serve: bad tokens {tuple(out.shape)}")

    tok_t = torch.from_numpy(tokens).cuda()
    pre = _profiled(lambda: prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN))
    _, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    row = {"phase": "lm_serve", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "init_s": init_s,
           "prefill_s": res.prefill_s, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "launches": launches,
           "profiled_prefill": pre, "profiled_decode": dec,
           "sample": out[0, :8].tolist()}
    emit(row)
    if launches["flash_attention"] < cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"on the prefill path, expected {cfg.num_layers}")
    return row, cfg, params


def phase_lm_consistency(cfg, params, seed: int, phase: str = "lm_consistency",
                         prompt: int = 256, steps: int = 4, ring_slots: int = 0,
                         check: bool = True, frames: int = 0) -> dict:
    """Teacher-forced: prefill into an fp32 cache + decode steps reproduce
    the full forward's logits at the same positions.  ``ring_slots``: the
    cache must be a ring of that many K/V slots (hymba past its window).
    ``check=False`` only measures (a difference the model has by design).
    ``frames``: an encoder-decoder's source length (normal draws after the
    tokens), the same source in every call.  A vlm gets its ``num_patches``
    patches the same way, and its cache holds them before the prompt."""
    import torch

    from repro_torch.models import decode_step, forward, prefill

    b, s = 2, prompt
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + steps))).cuda()
    src = {}
    if cfg.encdec:
        src["frames"] = torch.from_numpy(
            rng.normal(size=(b, frames, cfg.d_frontend)).astype(np.float32)).cuda()
    if cfg.num_patches:
        src["patches"] = torch.from_numpy(
            rng.normal(size=(b, cfg.num_patches, cfg.d_frontend)).astype(np.float32)).cuda()
    n_patch = cfg.num_patches
    full = forward(params, cfg, {"tokens": tokens, **src})
    # the same forward over the prompt alone: how far the model itself moves
    # when only the shapes of its products change (no cache, no decode)
    prefix_err = float((forward(params, cfg, {"tokens": tokens[:, :s], **src})
                        - full[:, :s]).abs().max())
    logits, cache = prefill(params, cfg, {"tokens": tokens[:, :s], **src},
                            s_max=n_patch + s + steps, cache_dtype=torch.float32)
    slots = cache.k.shape[3] if hasattr(cache, "k") else None
    errs = [float((logits[:, 0] - full[:, s - 1]).abs().max())]
    for i in range(steps):
        logits, cache = decode_step(params, cfg, tokens[:, s + i:s + i + 1], cache)
        errs.append(float((logits[:, 0] - full[:, s + i]).abs().max()))
    row = {"phase": phase, "compute_dtype": cfg.compute_dtype, "batch": b, "prompt": s,
           "steps": steps, "cache_slots": slots, "finite": bool(torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()), "max_abs_err": max(errs), "per_step": errs,
           "forward_prefix_max_abs_err": prefix_err, "checked": check}
    if cfg.encdec:
        row["frames"] = frames
    if n_patch:
        row.update(patches=n_patch, cache_index=cache.index)
    emit(row)
    if not check:
        return row
    if not (row["finite"] and row["max_abs_err"] <= TOL_TEACHER):
        raise AssertionError(f"{phase}: teacher-forced logits: max|Δ| {row['max_abs_err']} > "
                             f"{TOL_TEACHER}")
    if ring_slots and slots != ring_slots:
        raise AssertionError(f"{phase}: the cache has {slots} slots, not a ring of {ring_slots}")
    if n_patch and cache.index != n_patch + s + steps:
        raise AssertionError(f"{phase}: cache index {cache.index}, not {n_patch + s + steps}")
    return row


def _serve_depth(cfg):
    """``cfg`` cut in depth to its ``SERVE_LAYERS`` entry (global-attention layers
    below the cut kept), else as it is."""
    n = SERVE_LAYERS.get(cfg.name)
    if not n:
        return cfg
    return dataclasses.replace(cfg, num_layers=n,
                               full_attn_layers=tuple(i for i in cfg.full_attn_layers if i < n))


def phase_lm_recurrent_serve(arch: str, seed: int, kernels: dict):
    """The serving path on a recurrent family at full width and depth:
    ``serve`` with counts set to 0 just before it and read just after; then
    a prefill alone, counted the same way, with the window each
    ``flash_attention`` call was given (hymba) and the seconds spent in the
    sLSTM step loop (xlstm; synchronised around each loop); a profiled
    prefill and decode (xlstm's traced on the device alone: its host loop's
    events took minutes to average).  Returns the row, the config and the
    weights."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.models import lm as lm_mod
    from repro_torch.train.tree import tree_leaves

    cfg = _serve_depth(get_arch(arch))
    hymba = cfg.block_pattern == "hymba"
    phase = f"lm_{'hymba' if hymba else 'xlstm'}_serve"
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed + 7).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(cfg, params, tokens[:, :64], 2)  # warm-up
    _zero_counts(kernels)
    res = serve(cfg, params, tokens, LM_GEN)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase}: bad tokens {tuple(out.shape)}")

    tok_t = torch.from_numpy(tokens).cuda()
    windows, slstm_s = [], [0.0]
    orig_attn, orig_slstm = kops.flash_attention, lm_mod.slstm_seq

    def reading_attn(q, k, v, causal=True, window=None, q_offset=0):
        windows.append(window)
        return orig_attn(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def timed_slstm(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = orig_slstm(*args, **kw)
        torch.cuda.synchronize()
        slstm_s[0] += time.perf_counter() - t
        return y

    _zero_counts(kernels)
    kops.flash_attention, lm_mod.slstm_seq = reading_attn, timed_slstm
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    finally:
        kops.flash_attention, lm_mod.slstm_seq = orig_attn, orig_slstm
    prefill_launches = _counts(kernels)
    slots = cache.k.shape[3] if hymba else None
    finite = bool(torch.isfinite(logits).all())
    del cache
    # xlstm's sLSTM host loop (~170,000 launches a prefill): traced on the device alone
    host = cfg.block_pattern != "xlstm"
    pre = _profiled(lambda: prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN),
                    host)
    _, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            step_logits, cache = decode_step(params, cfg, tok, cache)
            tok = step_logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps, host)
    dec["steps"] = 8
    del cache
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "param_elements": sum(
               t.numel() for t in tree_leaves(params)), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "gen": LM_GEN, "init_s": init_s, "prefill_s": res.prefill_s,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "launches": launches, "prefill_launches": prefill_launches,
           "counted_prefill_s": counted_s, "prefill_logits_finite": finite,
           "profiled_prefill": pre, "profiled_decode": dec, "sample": out[0, :8].tolist()}
    if hymba:
        row.update(window=cfg.window, global_layers=list(cfg.full_attn_layers),
                   ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state, cache_slots=slots,
                   prefill_windows={str(w): windows.count(w) for w in sorted(
                       set(windows), key=lambda w: -1 if w is None else w)})
    else:
        row.update(groups=cfg.num_layers // cfg.slstm_every, slstm_every=cfg.slstm_every,
                   slstm_loop_s=slstm_s[0], slstm_share_of_prefill=slstm_s[0] / counted_s)
    emit(row)
    if not finite:
        raise AssertionError(f"{phase}: the prefill's logits are not finite")
    if hymba:
        windowed = len(cfg.full_attn_layers)
        if (prefill_launches["flash_attention"] != cfg.num_layers
                or launches["flash_attention"] != cfg.num_layers
                or windows.count(cfg.window) != cfg.num_layers - windowed
                or windows.count(None) != windowed):
            raise AssertionError(f"{phase}: flash_attention launched {prefill_launches} times "
                                 f"(serve: {launches}) with windows {windows}, expected "
                                 f"{cfg.num_layers}: one a layer of the prefill")
        if slots != cfg.window:
            raise AssertionError(f"{phase}: the cache has {slots} slots, not a "
                                 f"{cfg.window}-slot ring")
    return row, cfg, params


def phase_lm_encdec_serve(seed: int, kernels: dict):
    """The serving path on the encoder-decoder at full width and depth:
    ``serve`` on tokens and as many source frames (normal draws of the same
    generator after the tokens, as ``repro.launch.serve`` draws them),
    counts set to 0 just before it and read just after; then a prefill alone, counted the
    same way, with each ``flash_attention`` call's ``causal``, Sq and Sk read
    (24 encoder layers non-causal, 24 decoder layers causal, 24 cross
    attentions non-causal); a profiled prefill and decode.  Returns the
    row, the config and the weights."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.train.tree import tree_leaves

    phase = "lm_encdec_serve"
    cfg = get_arch(ENCDEC_ARCH)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    frames = rng.normal(size=(LM_BATCH, LM_PROMPT, cfg.d_frontend)).astype(np.float32)
    serve(cfg, params, tokens[:, :64], 2, frames[:, :64])  # warm-up
    _zero_counts(kernels)
    res = serve(cfg, params, tokens, LM_GEN, frames)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase}: bad tokens {tuple(out.shape)}")

    batch = {"tokens": torch.from_numpy(tokens).cuda(), "frames": torch.from_numpy(frames).cuda()}
    calls, orig_attn = [], kops.flash_attention

    def reading_attn(q, k, v, causal=True, window=None, q_offset=0):
        calls.append((bool(causal), q.shape[2], k.shape[2]))
        return orig_attn(q, k, v, causal=causal, window=window, q_offset=q_offset)

    _zero_counts(kernels)
    kops.flash_attention = reading_attn
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, batch, s_max=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    finally:
        kops.flash_attention = orig_attn
    prefill_launches = _counts(kernels)
    finite = bool(torch.isfinite(logits).all())
    cache_bytes = {name: getattr(cache, name).numel() * getattr(cache, name).element_size()
                   for name in ("k", "v", "mem_k", "mem_v")}
    del cache
    pre = _profiled(lambda: prefill(params, cfg, batch, s_max=LM_PROMPT + LM_GEN))
    _, cache = prefill(params, cfg, batch, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            step_logits, cache = decode_step(params, cfg, tok, cache)
            tok = step_logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    by_kind = {"non_causal": sum(not c for c, _, _ in calls),
               "causal": sum(c for c, _, _ in calls)}
    row = {"phase": phase, "arch": cfg.name, "enc_layers": cfg.enc_layers,
           "dec_layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "d_frontend": cfg.d_frontend, "params": cfg.param_count(),
           "param_elements": sum(t.numel() for t in tree_leaves(params)),
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "batch": LM_BATCH, "frames": LM_PROMPT, "prompt": LM_PROMPT, "gen": LM_GEN,
           "init_s": init_s, "prefill_s": res.prefill_s,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "cache_bytes": cache_bytes, "launches": launches,
           "prefill_launches": prefill_launches, "prefill_attention_calls": by_kind,
           "counted_prefill_s": counted_s, "prefill_logits_finite": finite,
           "profiled_prefill": pre, "profiled_decode": dec, "sample": out[0, :8].tolist()}
    emit(row)
    if not finite:
        raise AssertionError(f"{phase}: the prefill's logits are not finite")
    expected = cfg.enc_layers + 2 * cfg.num_layers
    if (prefill_launches["flash_attention"] != expected
            or launches["flash_attention"] != expected or len(calls) != expected
            or by_kind != {"non_causal": cfg.enc_layers + cfg.num_layers,
                           "causal": cfg.num_layers}
            or any((s_q, s_k) != (LM_PROMPT, LM_PROMPT) for _, s_q, s_k in calls)):
        raise AssertionError(f"{phase}: flash_attention launched {prefill_launches} times "
                             f"(serve: {launches}), calls {by_kind}, expected {expected}: "
                             "one an encoder layer, two a decoder layer")
    return row, cfg, params


def phase_lm_vlm_serve(seed: int, kernels: dict):
    """The serving path on the vlm at full width and depth: ``serve`` on
    tokens and the config's patches (normal draws of the same generator
    after the tokens, as ``repro.launch.serve`` draws them), counts set to
    0 just before it and read just after; then a prefill alone, counted
    the same way, with each ``flash_attention`` call's ``causal``, Sq, Sk
    and head dim read (one a layer, causal over patches + prompt); a
    profiled prefill and decode.  Returns the row, the config and the
    weights."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.train.tree import tree_leaves

    phase = "lm_vlm_serve"
    cfg = _serve_depth(get_arch(VLM_ARCH))
    n_pos = cfg.num_patches + LM_PROMPT  # the prefill's positions
    s_max = n_pos + LM_GEN
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    patches = rng.normal(size=(LM_BATCH, cfg.num_patches, cfg.d_frontend)).astype(np.float32)
    serve(cfg, params, tokens[:, :64], 2, patches=patches)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    res = serve(cfg, params, tokens, LM_GEN, patches=patches)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase}: bad tokens {tuple(out.shape)}")

    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "patches": torch.from_numpy(patches).cuda()}
    calls, orig_attn = [], kops.flash_attention

    def reading_attn(q, k, v, causal=True, window=None, q_offset=0):
        calls.append((bool(causal), q.shape[2], k.shape[2], q.shape[3]))
        return orig_attn(q, k, v, causal=causal, window=window, q_offset=q_offset)

    _zero_counts(kernels)
    kops.flash_attention = reading_attn
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, batch, s_max=s_max)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    finally:
        kops.flash_attention = orig_attn
    prefill_launches = _counts(kernels)
    finite = bool(torch.isfinite(logits).all())
    cache_index, cache_len = cache.index, cache.k.shape[3]
    cache_bytes = {name: getattr(cache, name).numel() * getattr(cache, name).element_size()
                   for name in ("k", "v")}
    del cache
    pre = _profiled(lambda: prefill(params, cfg, batch, s_max=s_max))
    _, cache = prefill(params, cfg, batch, s_max=s_max)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            step_logits, cache = decode_step(params, cfg, tok, cache)
            tok = step_logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "num_patches": cfg.num_patches, "d_frontend": cfg.d_frontend,
           "params": cfg.param_count(),
           "param_elements": sum(t.numel() for t in tree_leaves(params)),
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "prefill_positions": n_pos,
           "s_max": s_max, "init_s": init_s, "init_peak_mem_bytes": init_peak,
           "prefill_s": res.prefill_s,
           "prefill_tokens_per_s": LM_BATCH * n_pos / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "cache_bytes": cache_bytes, "cache_index": cache_index,
           "cache_len": cache_len, "launches": launches, "prefill_launches": prefill_launches,
           "prefill_attention_calls": sorted(set(calls)),
           "counted_prefill_s": counted_s, "prefill_logits_finite": finite,
           "profiled_prefill": pre, "profiled_decode": dec, "sample": out[0, :8].tolist()}
    emit(row)
    if not finite:
        raise AssertionError(f"{phase}: the prefill's logits are not finite")
    if (prefill_launches["flash_attention"] != cfg.num_layers
            or launches["flash_attention"] != cfg.num_layers or len(calls) != cfg.num_layers
            or set(calls) != {(True, n_pos, n_pos, cfg.resolved_head_dim)}):
        raise AssertionError(f"{phase}: flash_attention launched {prefill_launches} times "
                             f"(serve: {launches}), calls {sorted(set(calls))}, expected "
                             f"{cfg.num_layers}: one a layer, causal over {n_pos} positions "
                             f"at dh {cfg.resolved_head_dim}")
    if (cache_index, cache_len) != (n_pos, s_max):
        raise AssertionError(f"{phase}: cache index {cache_index} of {cache_len}, expected "
                             f"{n_pos} of {s_max}")
    return row, cfg, params


def phase_lm_moe_serve(seed: int, kernels: dict):
    """The serving path on the MoE family: qwen3-moe-30b-a3b at full width
    (the depth cut to ``MOE_LAYERS``), ``serve`` with counts set to 0 just
    before it and read just after.  Then a prefill alone, counted the same
    way, with the combine's inputs read at each layer (assignments kept and
    dropped by the capacity; the first layer's records, for the kernel row),
    a profiled prefill and a profiled decode.  Returns the row, the config,
    the weights and the first combine's ``(y, key, num_rows)``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.nn import moe as moe_mod

    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(cfg, params, tokens[:, :64], 2)  # warm-up
    _zero_counts(kernels)
    res = serve(cfg, params, tokens, LM_GEN)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_moe_serve: bad tokens {tuple(out.shape)}")

    # the prefill path alone: its launches, and what each layer's combine was given
    tok_t = torch.from_numpy(tokens).cuda()
    kept, first_layer = [], {}
    orig = moe_mod.combine

    def reading_combine(y, key, num_rows):
        kept.append((key < num_rows).sum())
        if not first_layer:  # with random weights, the layer that keeps the most records
            first_layer.update(y=y, key=key, num_rows=num_rows)
        return orig(y, key, num_rows)

    _zero_counts(kernels)
    moe_mod.combine = reading_combine
    try:
        logits, _ = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
    finally:
        moe_mod.combine = orig
    prefill_launches = _counts(kernels)
    assignments = LM_BATCH * LM_PROMPT * cfg.top_k
    kept = [int(k) for k in kept]
    pre = _profiled(lambda: prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN))
    _, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            step_logits, cache = decode_step(params, cfg, tok, cache)
            tok = step_logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    cap = moe_mod.capacity(cfg.capacity_factor, cfg.top_k, LM_PROMPT, cfg.num_experts)
    row = {"phase": "lm_moe_serve", "arch": cfg.name, "layers": cfg.num_layers,
           "layers_published": get_arch(MOE_ARCH).num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "experts": cfg.num_experts, "top_k": cfg.top_k,
           "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "capacity_factor": cfg.capacity_factor,
           "capacity_tokens": cap, "dispatch_shape": [cfg.num_experts, LM_BATCH, cap,
                                                      cfg.d_model],
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "init_s": init_s,
           "prefill_s": res.prefill_s, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "launches": launches, "prefill_launches": prefill_launches,
           "prefill_assignments_a_layer": assignments, "prefill_kept_by_layer": kept,
           "prefill_dropped_by_layer": [assignments - k for k in kept],
           "prefill_dropped_share": 1.0 - sum(kept) / (assignments * len(kept)),
           "prefill_logits_finite": bool(torch.isfinite(logits).all()),
           "profiled_prefill": pre, "profiled_decode": dec, "sample": out[0, :8].tolist()}
    emit(row)
    for name in ("flash_attention", "segment_spmm"):
        if prefill_launches[name] < cfg.num_layers:
            raise AssertionError(f"lm_moe_serve: {name} launched {prefill_launches[name]} "
                                 f"times on the prefill path, expected {cfg.num_layers}")
    if len(kept) != cfg.num_layers or not row["prefill_logits_finite"]:
        raise AssertionError(f"lm_moe_serve: {len(kept)} combines, finite logits "
                             f"{row['prefill_logits_finite']}")
    return row, cfg, params, (first_layer["y"], first_layer["key"], first_layer["num_rows"])


def kernel_moe_combine(y, key, num_rows: int) -> dict:
    """``segment_spmm`` at the MoE combine's prefill shape, on the records the
    first layer of ``lm_moe_serve``'s prefill gave it (the schedule built as
    ``nn/moe.py`` ``combine`` builds it): against its plain version, bitwise
    ``row_sum_chunked_plain`` (its documented order) and bitwise from one
    launch to the next; timed beside ``index_add_`` over the unsorted keys
    (dropped records into a spare row).  The bound counts the live records."""
    import torch

    from repro_torch.kernels.segment_spmm import (
        row_sum_chunked_plain,
        segment_spmm,
        segment_spmm_plain,
    )

    sorted_key, order = torch.sort(key, stable=True)
    row_ptr = torch.searchsorted(sorted_key, torch.arange(num_rows + 1, device="cuda"))
    out = segment_spmm(y, row_ptr, order, num_rows)
    again = segment_spmm(y, row_ptr, order, num_rows)
    ref = segment_spmm_plain(y, row_ptr, order, num_rows)
    chained = row_sum_chunked_plain(y, row_ptr, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    repeat_bitwise, chained_bitwise = bool(torch.equal(out, again)), bool(torch.equal(out, chained))
    del out, again, ref, chained
    d, live = y.shape[1], int(row_ptr[-1])
    most = int(row_ptr.diff().max())
    ms = cuda_time_ms(lambda: segment_spmm(y, row_ptr, order, num_rows), 20)
    plain_ms = cuda_time_ms(lambda: segment_spmm_plain(y, row_ptr, order, num_rows), 5)
    lib_ms = cuda_time_ms(
        lambda: torch.zeros(num_rows + 1, d, device="cuda").index_add_(0, key, y), 20)
    host_us = host_us_per_call(lambda: segment_spmm(y, row_ptr, order, num_rows), 20)
    bound_ms, by = _bound(live * d * 4 + live * 8 + (num_rows + 1) * 8 + num_rows * d * 4,
                          live * d)
    return {"name": "segment_spmm", "variant": "moe_combine",
            "shape": {"E": y.shape[0], "live": live, "D": d, "R": num_rows, "order": True,
                      "max_records_a_row": most, **_chains(most)},
            "max_abs_err": err, "repeat_bitwise": repeat_bitwise,
            "chunked_order_bitwise": chained_bitwise,
            "within_tol": err <= TOL_KERNEL and repeat_bitwise and chained_bitwise,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms, "host_us_per_call": host_us}


def _entries(kernel) -> dict:
    """A kernel library's launches by entry (dQ, dK/dV), summed over dtypes."""
    from repro_torch.kernels.flash_attention import BWD_ENTRIES

    return {e: sum(n for sym, n in kernel.entry_launches.items() if f"_{e}_" in sym)
            for e in BWD_ENTRIES}


def _free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm_train(seed: int, kernels: dict) -> dict:
    """The training path at full width through ``Trainer.train`` (counts set
    to 0 just before it and read just after), then one profiled step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer, synthetic_batch

    cfg = get_arch(LM_ARCH)
    tcfg = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed,
                       log_every=1)
    opt = OptConfig(peak_lr=3e-3, warmup_steps=10, stable_steps=TRAIN_STEPS, decay_steps=10)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, opt, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _zero_counts(kernels)
    out = trainer.train()
    launches, entries = _counts(kernels), _entries(kernels["flash_attention_bwd"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(h["loss"]) for h in trainer.history]
    step_s = [h["seconds"] for h in trainer.history]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady_s = sum(step_s[1:]) / len(step_s[1:])  # the first step pays the lazy set-up
    dh, L = cfg.resolved_head_dim, cfg.num_layers
    attn_fwd = 4 * dh * TRAIN_BATCH * cfg.num_heads * (TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * L
    model_flops = 6 * cfg.param_count() * tokens + 3 * attn_fwd  # forward + 2 × backward
    batch = synthetic_batch(cfg, tcfg, TRAIN_STEPS, device="cuda")
    prof = _profiled(lambda: trainer.step(trainer.state, batch))
    row = {"phase": "lm_train", "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "params": cfg.param_count(), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "steps": out["steps"], "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "tokens_per_step": tokens, "init_s": init_s, "losses": losses,
           "step_s": step_s, "wall_s": out["wall_s"], "steady_step_s": steady_s,
           "tokens_per_s": tokens / steady_s, "peak_mem_bytes": peak,
           "peak_gb": peak / 1e9, "peak_before_gb": LM_TRAIN_PEAK_BEFORE_GB,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_fp32_peak": model_flops / steady_s / FP32_FLOPS,
           "launches": launches, "bwd_launches_by_entry": entries,
           "profiled_step": prof}
    emit(row)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"lm_train: losses {losses}")
    if not peak / 1e9 < LM_TRAIN_PEAK_BEFORE_GB:
        raise AssertionError(f"lm_train: peak {peak / 1e9:.2f} GB, not below "
                             f"{LM_TRAIN_PEAK_BEFORE_GB} GB")
    if launches["flash_attention"] < 2 * L * TRAIN_STEPS:
        raise AssertionError(f"lm_train: flash_attention launched {launches['flash_attention']} "
                             f"times, expected at least {2 * L * TRAIN_STEPS}")
    if any(n != L * TRAIN_STEPS for n in entries.values()):
        raise AssertionError(f"lm_train: backward entries launched {entries}, expected "
                             f"{L * TRAIN_STEPS} each")
    del trainer, batch
    _free_cuda()
    return row


def _numpy_lm_tree(cfg, seed: int) -> dict:
    """Dense-LM weights made with numpy from ``seed`` at the init's scales
    (embedding 0.02, dense fan_in^-1/2, norms 1), tied embeddings, no biases."""
    if not cfg.tie_embeddings or cfg.qkv_bias or cfg.qk_norm:
        raise ValueError(f"{cfg.name}: the numpy weights cover tied, bias-free configs only")
    rng = np.random.default_rng(seed)
    d, L, f, hd = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return {"embed": normal((cfg.vocab_size, d), 0.02), "final_norm": np.ones(d, np.float32),
            "blocks": {"ln1": np.ones((L, d), np.float32), "ln2": np.ones((L, d), np.float32),
                       "attn": {"wq": normal((L, d, hq), d ** -0.5),
                                "wk": normal((L, d, hkv), d ** -0.5),
                                "wv": normal((L, d, hkv), d ** -0.5),
                                "wo": normal((L, hq, d), hq ** -0.5)},
                       "mlp": {"wg": normal((L, d, f), d ** -0.5),
                               "wi": normal((L, d, f), d ** -0.5),
                               "wo": normal((L, f, d), f ** -0.5)}}}


def phase_lm_train_consistency(seed: int, kernels: dict) -> dict:
    """``loss_fn`` and every gradient leaf of a 2-layer full-width llama3.2-1b on
    the card (the kernels) against the CPU (the plain versions), from the
    same numpy weights and tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_paths

    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=CONSIST_LAYERS)
    tree = _numpy_lm_tree(cfg, seed + 2)
    rng = np.random.default_rng(seed + 3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CONSIST_SEQ)))
             for k in ("tokens", "labels")}
    _zero_counts(kernels)
    loss, _, grads = value_and_grad(lm_params_from_numpy(tree, "cuda"), cfg,
                                    {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = _counts(kernels)
    t0 = time.perf_counter()
    loss_cpu, _, grads_cpu = value_and_grad(lm_params_from_numpy(tree, "cpu"), cfg, batch)
    cpu_s = time.perf_counter() - t0
    rel, limit = {}, {}
    for (key, a), (_, c) in zip(tree_paths(grads), tree_paths(grads_cpu)):
        rel[key] = _rel_err(a, c)
        limit[key] = (TOL_TRAIN_GRAD_BF16_CAST if key == "['embed']"
                      and cfg.compute_dtype == "bfloat16" else TOL_TRAIN_GRAD)
    loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    del grads, grads_cpu
    # the embedding again under compute_dtype fp32, where no cast rounds its
    # gradient: it must then hold the common limit
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    embed32 = _rel_err(
        value_and_grad(lm_params_from_numpy(tree, "cuda"), cfg32,
                       {k: v.cuda() for k, v in batch.items()})[2]["embed"],
        value_and_grad(lm_params_from_numpy(tree, "cpu"), cfg32, batch)[2]["embed"])
    row = {"phase": "lm_train_consistency", "layers": CONSIST_LAYERS, "batch": 1,
           "seq_len": CONSIST_SEQ, "loss": float(loss), "loss_cpu": float(loss_cpu),
           "loss_rel_err": loss_rel, "grad_rel_err": rel, "grad_rel_limit": limit,
           "embed_rel_err_fp32_compute": embed32, "cpu_s": cpu_s, "launches": launches}
    emit(row)
    if not (np.isfinite(float(loss)) and loss_rel <= TOL_TRAIN_LOSS
            and all(rel[k] <= limit[k] for k in rel) and embed32 <= TOL_TRAIN_GRAD):
        raise AssertionError(f"lm_train_consistency: loss {loss_rel}, grads {rel}, "
                             f"embedding under fp32 compute {embed32}")
    if launches["flash_attention_bwd"] != 2 * CONSIST_LAYERS:
        raise AssertionError(f"lm_train_consistency: backward launches {launches}")
    _free_cuda()
    return row


def phase_lm_vlm_train(seed: int, kernels: dict) -> dict:
    """The vlm's training path at full width through the launch layer:
    ``torch.distributed`` at world size 1 (NCCL, an in-process ``HashStore``:
    no port), the card's ``("data", "model")`` mesh of 1 × 1,
    ``shardings_for_cell`` for a train shape, params and AdamW state placed
    as DTensors, and ``VLM_TRAIN_STEPS`` steps of ``make_train_step`` inside
    ``activation_sharding``, counts set to 0 just before them and read just
    after (each ``flash_attention`` and backward call's head dim read too);
    then one profiled step.  Then the same weights, made again from the
    seed: the loss and every gradient of the first step's batch under the
    mesh and with no mesh (the mesh params' local tensors, no context),
    held at ``TOL_MESH_LOSS`` and ``TOL_MESH_GRAD``, and one AdamW step each
    way, whose updated weights are compared bit for bit (printed, not
    held)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.steps import make_train_step, shardings_for_cell
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, synthetic_batch, value_and_grad
    from repro_torch.train.tree import tree_leaves, tree_map, tree_paths

    phase = "lm_vlm_train"
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_TRAIN_LAYERS)
    L, B, S, n_pos = cfg.num_layers, VLM_TRAIN_BATCH, TRAIN_SEQ, cfg.num_patches + TRAIN_SEQ
    tcfg = TrainConfig(steps=VLM_TRAIN_STEPS, batch=B, seq_len=S, seed=seed)
    step = make_train_step(cfg, OptConfig(peak_lr=3e-3, warmup_steps=10,
                                          stable_steps=VLM_TRAIN_STEPS, decay_steps=10))
    _free_cuda()
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig(phase, S, B, "train"), mesh)

        def weights():  # from the seed, on the mesh
            return distribute_tree(init_model(torch.Generator(device="cuda").manual_seed(seed),
                                              cfg), sh["params_sharding"])

        def fresh_opt(params):
            return distribute_tree(adamw_init(params), sh["opt_sharding"])

        def batch_at(i):
            return synthetic_batch(cfg, tcfg, i, device="cuda")

        def placed(tree) -> bool:
            return all(isinstance(p, DTensor) and tuple(p.placements) == s.placements
                       for (_, p), (_, s) in zip(tree_paths(tree),
                                                 tree_paths(sh["params_sharding"])))

        t0 = time.perf_counter()
        params = weights()
        n_elems = sum(p.numel() for p in tree_leaves(params))
        opt_state = fresh_opt(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batches = [distribute_tree(batch_at(i), sh["batch_sharding"])
                   for i in range(VLM_TRAIN_STEPS)]
        placed_before = placed(params)
        fwd_dh, bwd_dh = [], []
        orig_fwd, orig_bwd = fmod._forward, fmod.flash_attention_bwd

        def reading_fwd(q, *a, **kw):
            fwd_dh.append(q.shape[3])
            return orig_fwd(q, *a, **kw)

        def reading_bwd(q, *a, **kw):
            bwd_dh.append(q.shape[3])
            return orig_bwd(q, *a, **kw)

        losses, step_s = [], []
        torch.cuda.reset_peak_memory_stats()
        # what the steps start from: the dry run's estimate counts the params, the
        # moments and the batch, and not what else the process holds on the card
        mem_at_reset = torch.cuda.memory_allocated()
        input_bytes = _storage_bytes(params, opt_state, *batches)
        _zero_counts(kernels)
        fmod._forward, fmod.flash_attention_bwd = reading_fwd, reading_bwd
        try:
            with activation_sharding(mesh, sh["shcfg"]):
                for i in range(VLM_TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, opt_state, metrics = step(params, opt_state, batches[i])
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    losses.append(float(metrics["loss"].full_tensor()))
        finally:
            fmod._forward, fmod.flash_attention_bwd = orig_fwd, orig_bwd
        launches, entries = _counts(kernels), _entries(kernels["flash_attention_bwd"])
        peak = torch.cuda.max_memory_allocated()
        placed_after = placed(params)
        with activation_sharding(mesh, sh["shcfg"]):
            prof = _profiled(lambda: step(params, opt_state, batches[0]))
        del params, opt_state
        _free_cuda()

        # mesh against plain: the same weights and the first step's batch
        params = weights()
        plain = tree_map(lambda p: p.to_local(), params)  # on 1 × 1 the whole tensors
        batch = batch_at(0)
        with activation_sharding(mesh, sh["shcfg"]):
            loss_m, _, grads_m = value_and_grad(params, cfg, batches[0])
        loss_p, _, grads_p = value_and_grad(plain, cfg, batch)
        loss_m = loss_m.full_tensor()
        grad_err, grads_bitwise = {}, True
        for (path, gm), (_, gp) in zip(tree_paths(grads_m), tree_paths(grads_p)):
            gm = gm.full_tensor()
            grad_err[path] = float((gm - gp).abs().max() / gp.abs().max().clamp_min(1e-30))
            grads_bitwise = grads_bitwise and bool(torch.equal(gm, gp))
        del grads_m, grads_p, gm, gp
        _free_cuda()
        with activation_sharding(mesh, sh["shcfg"]):
            new_m, _, _ = step(params, fresh_opt(params), batches[0])
        host = [p.to_local().cpu() for p in tree_leaves(new_m)]
        del new_m
        _free_cuda()
        new_p, _, _ = step(plain, adamw_init(plain), batch)
        updated_bitwise = all(bool(torch.equal(h.cuda(), p))
                              for h, p in zip(host, tree_leaves(new_p)))
        del new_p, host, params, plain, batches, batch
        _free_cuda()
    finally:
        dist.destroy_process_group()

    tokens = B * n_pos  # positions a step: the patches and the text
    steady_s = sum(step_s[1:]) / len(step_s[1:])  # the first step pays the lazy set-up
    dh = cfg.resolved_head_dim
    attn_fwd = 4 * dh * B * cfg.num_heads * (n_pos * (n_pos + 1) // 2) * L
    model_flops = 6 * cfg.param_count() * tokens + 3 * attn_fwd  # forward + 2 × backward
    loss_rel = float((loss_m - loss_p).abs() / loss_p.abs())
    worst = max(grad_err, key=grad_err.get)
    row = {"phase": phase, "arch": cfg.name, "layers": L, "layers_full": full.num_layers,
           "depth_cut": f"{full.num_layers} → {L} layers: {n_elems / 1e9:.2f}B parameters, "
                        f"{16 * n_elems / 1e9:.1f} GB of fp32 params, gradients and two AdamW "
                        f"moments; all {full.num_layers} would be "
                        f"{16 * full.param_count() / 1e9:.0f} GB",
           "param_elements": n_elems,
           "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": dh, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "num_patches": cfg.num_patches, "d_frontend": cfg.d_frontend,
           "params": cfg.param_count(), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "mesh": {"shape": [1, 1], "axes": ["data", "model"], "backend": DIST_BACKEND},
           "params_placed_before": placed_before, "params_placed_after": placed_after,
           "steps": VLM_TRAIN_STEPS, "batch": B, "seq_len": S, "positions": n_pos,
           "positions_per_step": tokens, "init_s": init_s, "losses": losses, "step_s": step_s,
           "steady_step_s": steady_s, "tokens_per_s": tokens / steady_s,
           "text_tokens_per_s": B * S / steady_s, "peak_mem_bytes": peak,
           "peak_gb": peak / 1e9, "peak_before_gb": VLM_TRAIN_PEAK_BEFORE_GB,
           "mem_at_reset_bytes": mem_at_reset, "input_bytes": input_bytes,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_fp32_peak": model_flops / steady_s / FP32_FLOPS,
           "launches": launches, "bwd_launches_by_entry": entries,
           "fwd_head_dims": sorted(set(fwd_dh)), "bwd_head_dims": sorted(set(bwd_dh)),
           "mesh_vs_plain": {"loss_mesh": float(loss_m), "loss_plain": float(loss_p),
                             "loss_rel_err": loss_rel, "max_grad_err": grad_err[worst],
                             "worst_leaf": worst, "loss_bitwise": bool(torch.equal(loss_m, loss_p)),
                             "grads_bitwise": grads_bitwise,
                             "updated_weights_bitwise": updated_bitwise},
           "profiled_step": prof}
    emit(row)
    if len(losses) != VLM_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    if not (placed_before and placed_after):
        raise AssertionError(f"{phase}: params not in their mesh placements")
    if launches["flash_attention"] < 2 * L * VLM_TRAIN_STEPS:
        raise AssertionError(f"{phase}: flash_attention launched {launches['flash_attention']} "
                             f"times, expected at least {2 * L * VLM_TRAIN_STEPS}")
    if any(n != L * VLM_TRAIN_STEPS for n in entries.values()):
        raise AssertionError(f"{phase}: backward entries launched {entries}, expected "
                             f"{L * VLM_TRAIN_STEPS} each")
    if set(fwd_dh) != {dh} or set(bwd_dh) != {dh} or len(bwd_dh) != L * VLM_TRAIN_STEPS:
        raise AssertionError(f"{phase}: head dims forward {sorted(set(fwd_dh))}, backward "
                             f"{sorted(set(bwd_dh))} ({len(bwd_dh)} calls), expected {dh}")
    if not loss_rel <= TOL_MESH_LOSS or not grad_err[worst] <= TOL_MESH_GRAD:
        raise AssertionError(f"{phase}: mesh vs plain: loss {loss_rel}, gradient "
                             f"{grad_err[worst]} at {worst}")
    return row


def _reading_attention(calls: list, bwd_calls: list):
    """Wrap ``flash_attention``'s forward and backward so that each call on
    the card appends its (dtype, head dim, Sq) to ``calls`` / ``bwd_calls``
    (the plain path's calls on the CPU are not read); returns the function
    that restores them."""
    from repro_torch.kernels import flash_attention as fmod

    orig_fwd, orig_bwd = fmod._forward, fmod.flash_attention_bwd

    def reading_fwd(q, *a, **kw):
        if q.device.type == "cuda":
            calls.append((str(q.dtype).removeprefix("torch."), q.shape[3], q.shape[2]))
        return orig_fwd(q, *a, **kw)

    def reading_bwd(q, *a, **kw):
        if q.device.type == "cuda":
            bwd_calls.append((str(q.dtype).removeprefix("torch."), q.shape[3], q.shape[2]))
        return orig_bwd(q, *a, **kw)

    fmod._forward, fmod.flash_attention_bwd = reading_fwd, reading_bwd

    def restore():
        fmod._forward, fmod.flash_attention_bwd = orig_fwd, orig_bwd

    return restore


def phase_prod_prefill(phase: str, seed: int, kernels: dict) -> dict:
    """A model of ``PROD_PREFILLS`` at the reference's production dtype
    (``production_cfg``: bf16 params and compute) at full width and depth,
    through the launch layer on the card's 1 × 1 NCCL mesh:
    ``shardings_for_cell`` for the prefill_32k cell at the phase's batch
    (32,768 tokens, after pixtral's 256 patches), params and inputs placed as
    DTensors, then ``make_prefill_step`` inside ``activation_sharding``: one
    warm-up, two timed prefills (the first counted: counts set to 0 just before
    it and read just after, each ``flash_attention`` call's dtype, head dim and
    Sq read, peak memory reset before it) and one profiled; then, from the
    second timed prefill's cache, ``PROD_DECODE`` greedy steps through
    ``make_serve_step``, whose logits must be finite.  The cache holds s_max =
    positions + ``PROD_DECODE``.  ``dryrun_check`` holds the counted prefill's
    peak to the dry run's estimate of the cell."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.dryrun import production_cfg
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, shardings_for_cell
    from repro_torch.models import init_model
    from repro_torch.train.tree import tree_leaves

    arch, layers, B = PROD_PREFILLS[phase]
    cfg = production_cfg(arch, layers)
    S, P = PROD_PREFILL_SEQ, cfg.num_patches or 0
    n_pos, s_max = P + S, P + S + PROD_DECODE
    _free_cuda()
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    calls, bwd_calls = [], []
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig(phase, S, B, "prefill"), mesh)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = distribute_tree(init_model(gen, cfg), sh["params_sharding"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_elems = sum(p.numel() for p in tree_leaves(params))
        rng = np.random.default_rng(seed)
        inputs = {"tokens": torch.from_numpy(  # the cell's inputs: int32 tokens, bf16 patches
            rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)).cuda()}
        if P:
            inputs["patches"] = torch.from_numpy(rng.normal(size=(B, P, cfg.d_frontend)).astype(
                np.float32)).cuda().to(torch.bfloat16)
        batch = distribute_tree(inputs, sh["batch_sharding"])
        step, serve_step = make_prefill_step(cfg, s_max), make_serve_step(cfg)
        prefill_s = []
        with activation_sharding(mesh, sh["shcfg"]):
            out = step(params, batch)  # warm-up
            del out
            _free_cuda()
            for i in range(2):
                torch.cuda.synchronize()
                if i == 0:
                    torch.cuda.reset_peak_memory_stats()
                    mem_at_reset = torch.cuda.memory_allocated()
                    input_bytes = _storage_bytes(params, batch)
                    _zero_counts(kernels)
                    restore = _reading_attention(calls, bwd_calls)
                t0 = time.perf_counter()
                try:
                    logits, cache = step(params, batch)
                    torch.cuda.synchronize()
                finally:
                    if i == 0:
                        restore()
                prefill_s.append(time.perf_counter() - t0)
                if i == 0:
                    launches, peak = _counts(kernels), torch.cuda.max_memory_allocated()
                    cache_index = cache.index
                    cache_shape = list(_local(cache.k).shape)
                    del logits, cache
            prof = _profiled(lambda: step(params, batch))
            # the decode steps go on from the second timed prefill's cache
            tok = _local(logits)[:, -1:].argmax(-1).to(torch.int32)
            decode_ms, finite = [], bool(torch.isfinite(_local(logits)).all())
            for _ in range(PROD_DECODE):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = serve_step(params, cache,
                                           distribute_tree(tok, sh["token_sharding"]))
                lg = _local(logits)
                finite = finite and bool(torch.isfinite(lg).all())
                decode_ms.append((time.perf_counter() - t0) * 1e3)
                tok = lg[:, -1:].argmax(-1).to(torch.int32)
            decode_index = cache.index
        del logits, cache, params, batch, lg, tok
        _free_cuda()
    finally:
        dist.destroy_process_group()
    dh = cfg.resolved_head_dim
    attn_flops = 4 * dh * B * cfg.num_heads * (n_pos * (n_pos + 1) // 2) * cfg.num_layers
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": dh,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "param_elements": n_elems, "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                                                "backend": DIST_BACKEND},
           "batch": B, "tokens": S, "patches": P, "positions": n_pos, "s_max": s_max,
           "init_s": init_s, "prefill_s": prefill_s,
           "prefill_positions_per_s": B * n_pos / min(prefill_s),
           "attention_flops": attn_flops, "peak_mem_bytes": peak, "peak_gb": peak / 1e9,
           "mem_at_reset_bytes": mem_at_reset, "input_bytes": input_bytes,
           "launches": launches, "attention_calls": sorted(set(calls)),
           "attention_call_count": len(calls), "cache_index": cache_index,
           "cache_k_shape": cache_shape, "profiled_prefill": prof,
           "decode_ms": decode_ms, "decode_index": decode_index, "decode_logits_finite": finite}
    emit(row)
    if (launches["flash_attention"] != cfg.num_layers or len(calls) != cfg.num_layers
            or set(calls) != {("bfloat16", dh, n_pos)} or bwd_calls):
        raise AssertionError(f"{phase}: flash_attention launched {launches['flash_attention']} "
                             f"times, calls {sorted(set(calls))} ({len(calls)}), expected "
                             f"{cfg.num_layers}: one a layer, bf16 at dh {dh} over {n_pos}")
    if cache_index != n_pos or decode_index != n_pos + PROD_DECODE or not finite:
        raise AssertionError(f"{phase}: cache index {cache_index} → {decode_index}, decode "
                             f"logits finite {finite}")
    return row


def phase_prod_train(phase: str, seed: int, kernels: dict) -> dict:
    """A model of ``PROD_TRAINS`` at ``production_cfg``, cut in depth where the
    table says (bf16 params and gradients, fp32 AdamW moments),
    ``PROD_TRAIN_STEPS`` AdamW steps of ``make_train_step`` on the card's 1 × 1
    NCCL mesh (as ``lm_vlm_train``) on ``PROD_BATCH`` × ``PROD_TRAIN_SEQ``
    tokens (after pixtral's 256 patches) of the trainer's synthetic data; counts
    set to 0 just before the steps and read just after, each attention call's
    dtype and head dim read: 2 · L · steps bf16 forwards at the model's head dim
    (remat) and L · steps of each backward entry; every loss finite; seconds a
    step and the peak; then one more step, profiled (device time by kind)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.dryrun import production_cfg
    from repro_torch.launch.steps import make_train_step, shardings_for_cell
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, synthetic_batch
    from repro_torch.train.tree import tree_leaves

    arch, layers = PROD_TRAINS[phase]
    cfg = production_cfg(arch, layers)
    L, B, S, steps = cfg.num_layers, PROD_BATCH, PROD_TRAIN_SEQ, PROD_TRAIN_STEPS
    n_pos = (cfg.num_patches or 0) + S
    tcfg = TrainConfig(steps=steps, batch=B, seq_len=S, seed=seed)
    step = make_train_step(cfg, OptConfig(peak_lr=3e-3, warmup_steps=10, stable_steps=steps,
                                          decay_steps=10))
    _free_cuda()
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    calls, bwd_calls = [], []
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig(phase, S, B, "train"), mesh)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = distribute_tree(init_model(gen, cfg), sh["params_sharding"])
        n_elems = sum(p.numel() for p in tree_leaves(params))
        opt_state = distribute_tree(adamw_init(params), sh["opt_sharding"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batches = [distribute_tree(synthetic_batch(cfg, tcfg, i, device="cuda"),
                                   sh["batch_sharding"]) for i in range(steps)]
        losses, step_s = [], []
        torch.cuda.reset_peak_memory_stats()
        mem_at_reset = torch.cuda.memory_allocated()
        input_bytes = _storage_bytes(params, opt_state, *batches)
        _zero_counts(kernels)
        restore = _reading_attention(calls, bwd_calls)
        try:
            with activation_sharding(mesh, sh["shcfg"]):
                for i in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, opt_state, metrics = step(params, opt_state, batches[i])
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    losses.append(float(metrics["loss"].full_tensor()))
        finally:
            restore()
        launches, entries = _counts(kernels), _entries(kernels["flash_attention_bwd"])
        peak = torch.cuda.max_memory_allocated()
        dtypes = sorted({str(p.dtype).removeprefix("torch.") for p in tree_leaves(params)})
        # one more step, profiled (matmuls / attention forward and backward / the rest);
        # the state lives in a list, so that no step's params stay referenced
        state = [params, opt_state]
        del params, opt_state, metrics

        def profiled_step():
            with activation_sharding(mesh, sh["shcfg"]):
                state[0], state[1], _ = step(state[0], state[1], batches[0])

        prof = _profiled(profiled_step)
        del state, batches
        _free_cuda()
    finally:
        dist.destroy_process_group()
    dh = cfg.resolved_head_dim
    tokens = B * n_pos
    steady_s = sum(step_s[1:]) / len(step_s[1:])  # the first step pays the lazy set-up
    attn_fwd = 4 * dh * B * cfg.num_heads * (n_pos * (n_pos + 1) // 2) * L
    model_flops = 6 * cfg.param_count() * tokens + 3 * attn_fwd
    row = {"phase": phase, "arch": cfg.name, "layers": L, "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "param_dtypes_after": dtypes,
           "remat": cfg.remat, "param_elements": n_elems, "steps": steps, "batch": B,
           "seq_len": S, "positions": n_pos, "init_s": init_s, "losses": losses,
           "step_s": step_s, "steady_step_s": steady_s, "tokens_per_s": tokens / steady_s,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_bf16_peak": model_flops / steady_s / BF16_FLOPS,
           "peak_mem_bytes": peak, "peak_gb": peak / 1e9, "mem_at_reset_bytes": mem_at_reset,
           "input_bytes": input_bytes, "launches": launches, "bwd_launches_by_entry": entries,
           "attention_calls": sorted(set(calls)), "attention_call_count": len(calls),
           "bwd_attention_calls": sorted(set(bwd_calls)), "profiled_step": prof}
    emit(row)
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    want = {("bfloat16", dh, n_pos)}
    if (len(calls) != 2 * L * steps or launches["flash_attention"] != 2 * L * steps
            or set(calls) != want or set(bwd_calls) != want or len(bwd_calls) != L * steps
            or any(n != L * steps for n in entries.values())):
        raise AssertionError(f"{phase}: forwards {len(calls)} {sorted(set(calls))}, backward "
                             f"entries {entries}, expected {2 * L * steps} and {L * steps} "
                             f"each, bf16 at dh {dh} over {n_pos}")
    return row


def _prod_consistency_inputs(phase: str, seed: int):
    """A ``PROD_CONSISTENCY`` phase's config, bf16 weights (made on the card from
    the seed: the same bits in every call) and CPU batch (tokens and labels,
    then pixtral's bf16 patches or seamless's frames)."""
    import torch

    from repro_torch.launch.dryrun import production_cfg
    from repro_torch.models import init_model

    arch, S, frames = PROD_CONSISTENCY[phase]
    cfg = production_cfg(arch, PROD_CONSIST_LAYERS)
    if cfg.is_moe:  # dropless: which tokens overflow would depend on the summation order
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    params = init_model(torch.Generator(device="cuda").manual_seed(seed + 5), cfg)
    rng = np.random.default_rng(seed + 6)
    tokens = rng.integers(0, cfg.vocab_size, (1, S + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :S]), "labels": torch.from_numpy(tokens[:, 1:])}
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(rng.normal(size=(1, cfg.num_patches, cfg.d_frontend))
                                            .astype(np.float32)).to(torch.bfloat16)
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(1, frames, cfg.d_frontend)).astype(np.float32))
    return cfg, params, batch


def _prod_consistency_side(cfg, params, batch) -> dict:
    """The prefill's last-token logits over the prompt, then one training step's
    loss and gradients, on the device ``params`` lie on."""
    from repro_torch.models import prefill
    from repro_torch.train.trainer import value_and_grad

    s_max = (cfg.num_patches or 0) + batch["tokens"].shape[1]
    logits = prefill(params, cfg, {k: v for k, v in batch.items() if k != "labels"}, s_max)[0]
    loss, _, grads = value_and_grad(params, cfg, batch)
    return {"logits": logits, "loss": loss, "grads": grads}


def _prod_attention_calls(cfg, batch) -> dict:
    """``flash_attention`` calls of one pass over ``batch`` (a prefill, or a
    training forward): (dtype, head dim, Sq) → count."""
    dh, S = cfg.resolved_head_dim, batch["tokens"].shape[1]
    calls = collections.Counter()
    if cfg.encdec:  # the encoder over the frames, the decoder's self and cross attention
        calls[("bfloat16", dh, batch["frames"].shape[1])] += cfg.enc_layers
        calls[("bfloat16", dh, S)] += 2 * cfg.num_layers
    else:
        calls[("bfloat16", dh, (cfg.num_patches or 0) + S)] += cfg.num_layers
    return dict(calls)


@contextlib.contextmanager
def _expert_choice(record: list = None, replay: list = None):
    """While open, each MoE routing's choice of a token's top-k experts (the
    first of the two ``nn/moe.py`` ``_top`` calls of a ``_route_rows``) is
    appended to ``record`` (on the card) or, with ``replay``, taken from it in
    call order (on the CPU): the gate values are then the call's own
    probabilities at the recorded experts, every other step the port's own.
    (A choice between two experts whose router logits lie closer than the
    card's and the CPU's router inputs differ is a coin toss between them; one
    flipped expert moves a token's MoE output by an eighth.)  Yields a list
    that gets, per replayed call, ``(flips, gap, over)``: the tokens whose own
    top-k set differs from the recorded one; over those, the largest gap in
    router logits between this side's k-th expert and the recorded expert it
    ranks lowest; and the largest ratio of such a gap to what one bf16 step of
    each element of the router's input (2^-7 |h_i|, every sign against) could
    move the two logits apart.  A ratio above 1 is no near-tie: the card chose
    an expert this side ranks well below its k-th."""
    import torch

    from repro_torch.nn import moe

    orig_top, orig_rows, calls, out, inputs = moe._top, moe._route_rows, [0], [], [None]
    replayed = iter(replay) if replay is not None else None

    def route_rows(router, x, top_k, cap):
        inputs[0] = (router, x)
        return orig_rows(router, x, top_k, cap)

    def top(x, k):
        gate = calls[0] % 2 == 0  # _route_rows: the gate's top-k, then the capacity's
        calls[0] += 1
        vals, idx = orig_top(x, k)
        if not gate:
            return vals, idx
        if replayed is None:
            record.append(idx.cpu())
            return vals, idx
        want = next(replayed).to(idx.device)
        flipped = (torch.sort(want, -1)[0] != torch.sort(idx, -1)[0]).any(-1)
        gap = over = 0.0
        if flipped.any():
            router, h = (t.detach() for t in inputs[0])
            hf = h.float()[flipped]                       # [n, D]: the flipped tokens' inputs
            logits = hf @ router                          # [n, E]
            kth = idx[flipped][:, -1]                     # this side's k-th expert
            at = logits.gather(-1, want[flipped])         # the recorded experts' logits
            low = want[flipped].gather(-1, at.argmin(-1, keepdim=True))[:, 0]
            gaps = logits.gather(-1, kth[:, None])[:, 0] - at.min(-1).values
            step = (hf.abs() * 2.0 ** -7 * (router[:, kth] - router[:, low]).abs().T).sum(-1)
            gap, over = float(gaps.max()), float((gaps / step.clamp_min(1e-30)).max())
        out.append((int(flipped.sum()), gap, over))
        return x.gather(-1, want), want

    moe._top, moe._route_rows = top, route_rows
    try:
        yield out
    finally:
        moe._top, moe._route_rows = orig_top, orig_rows


def phase_prod_consistency(phase: str, seed: int, kernels: dict) -> dict:
    """A model of ``PROD_CONSISTENCY`` at ``production_cfg`` cut to
    ``PROD_CONSIST_LAYERS`` at full width: the card (the kernels) against the
    port's plain path on the CPU, the same bf16 weights (made on the card,
    copied) and inputs, batch 1 of the table's tokens (after pixtral's 256
    patches; over seamless's frames): the prefill's last-token logits and every
    gradient leaf of one training step within ``TOL_PROD_REL`` of their largest
    |entry|, the loss within ``TOL_PROD_LOSS`` (see there); counts set to 0 just
    before the card's side and read just after, each attention call's dtype,
    head dim and Sq read: 3 passes of bf16 forwards (prefill, loss, remat) and
    one of each backward entry, every call at the model's head dim."""
    import torch

    from repro_torch.train.tree import tree_map, tree_paths

    _free_cuda()
    cfg, params, batch = _prod_consistency_inputs(phase, seed)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    calls, bwd_calls, choices = [], [], []
    _zero_counts(kernels)
    restore = _reading_attention(calls, bwd_calls)
    try:
        with _expert_choice(record=choices) if cfg.is_moe else contextlib.nullcontext():
            card = _prod_consistency_side(cfg, params, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
    finally:
        restore()
    launches, entries = _counts(kernels), _entries(kernels["flash_attention_bwd"])
    t0 = time.perf_counter()
    # a MoE's CPU side takes the card's expert choices (the gates its own): see
    # _expert_choice; the tokens whose own choice differs are counted
    with _expert_choice(replay=choices) if cfg.is_moe else contextlib.nullcontext() as flips:
        cpu = _prod_consistency_side(cfg, params_cpu, batch)
    cpu_s = time.perf_counter() - t0
    logit_err = _rel_err(card["logits"].float(), cpu["logits"].float())
    rel = {key: _rel_err(a.float(), c.float())
           for (key, a), (_, c) in zip(tree_paths(card["grads"]), tree_paths(cpu["grads"]))}
    dtypes = sorted({str(g.dtype).removeprefix("torch.") for _, g in tree_paths(card["grads"])})
    loss, loss_cpu = float(card["loss"]), float(cpu["loss"])
    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    worst = max(rel, key=rel.get)
    row = {"phase": phase, "arch": cfg.name, "layers": PROD_CONSIST_LAYERS,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype, "batch": 1,
           "patches": cfg.num_patches, "tokens": batch["tokens"].shape[1],
           "frames": batch["frames"].shape[1] if cfg.encdec else 0,
           "prefill_logit_rel_err": logit_err,
           "logit_tol": TOL_PROD_REL, "max_abs_logit": float(cpu["logits"].float().abs().max()),
           "loss": loss, "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
           "loss_tol": TOL_PROD_LOSS, "grad_rel_err": rel, "grad_tol": TOL_PROD_REL,
           "worst_leaf": worst, "grad_dtypes": dtypes, "cpu_s": cpu_s,
           "launches": launches, "bwd_launches_by_entry": entries,
           "attention_calls": sorted(set(calls)), "attention_call_count": len(calls),
           "bwd_attention_calls": sorted(set(bwd_calls))}
    if cfg.is_moe:  # routings replayed, and the tokens a side chose otherwise in each
        row.update(routings=len(choices), tokens_a_routing=int(batch["tokens"].numel()),
                   expert_choice_flips=[f for f, _, _ in flips],
                   expert_flip_max_logit_gap=max(g for _, g, _ in flips),
                   expert_flip_max_gap_over_bf16_step=max(o for _, _, o in flips),
                   expert_flip_share_tol=MOE_FLIP_SHARE)
    emit(row)
    del params, params_cpu, card, cpu
    _free_cuda()
    if cfg.is_moe and (len(flips) != len(choices)
                       or max(f for f, _, _ in flips) > MOE_FLIP_SHARE * row["tokens_a_routing"]
                       or row["expert_flip_max_gap_over_bf16_step"] > 1.0):
        raise AssertionError(f"{phase}: the card's expert choices are no near-ties: {flips} "
                             f"(flipped tokens, largest logit gap, gap over a bf16 step) of "
                             f"{len(choices)} routings")
    if not (np.isfinite(loss) and logit_err <= TOL_PROD_REL and loss_rel <= TOL_PROD_LOSS
            and rel[worst] <= TOL_PROD_REL):
        raise AssertionError(f"{phase}: logits {logit_err}, loss {loss_rel}, worst gradient "
                             f"{rel[worst]} at {worst}")
    per_pass = _prod_attention_calls(cfg, batch)
    n = sum(per_pass.values())
    want = {c: 3 * k for c, k in per_pass.items()}
    got, got_bwd = collections.Counter(calls), collections.Counter(bwd_calls)
    if (launches["flash_attention"] != 3 * n or dict(got) != want or dict(got_bwd) != per_pass
            or any(m != n for m in entries.values())):
        raise AssertionError(f"{phase}: forwards {dict(got)}, backward {dict(got_bwd)}, "
                             f"entries {entries}, expected {want} and {per_pass}, {n} each entry")
    return row


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a DTensor's local
    shard), each as the caching allocator rounds it (512 B)."""
    from repro_torch.train.tree import tree_leaves

    seen, total = set(), 0
    for tree in trees:
        for t in tree_leaves(tree):
            if not hasattr(t, "untyped_storage"):
                continue
            st = _local(t).untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += -(-st.nbytes() // 512) * 512
    return total


def _local(t):
    """A DTensor's local tensor (on the 1 × 1 mesh the whole one), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


@contextlib.contextmanager
def _attention_kinds():
    """While open, counts each ``flash_attention`` forward and each backward call
    by kind: ``causal``, ``windowed``, ``non_causal`` (the encoder's self
    attention) or ``cross`` (a call from the encoder-decoder's cross attention).
    A backward call is matched to its forward by the address of the output it
    differentiates (alive from the forward, or its recomputation, to the
    backward)."""
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import encdec

    kinds = {"forward": collections.Counter(), "backward": collections.Counter()}
    by_output, in_cross = {}, [0]
    orig_fwd, orig_bwd, orig_cross = (fmod._forward, fmod.flash_attention_bwd,
                                      encdec.cross_attention_apply)

    def reading_fwd(q, k, v, causal, window, q_offset, with_lse):
        o, lse = orig_fwd(q, k, v, causal, window, q_offset, with_lse)
        kind = ("cross" if in_cross[0] else "windowed" if window is not None
                else "causal" if causal else "non_causal")
        kinds["forward"][kind] += 1
        by_output[o.data_ptr()] = kind
        return o, lse

    def reading_bwd(q, k, v, o, *args, **kw):
        kinds["backward"][by_output.get(o.data_ptr(), "unmatched")] += 1
        return orig_bwd(q, k, v, o, *args, **kw)

    def reading_cross(*args, **kw):
        in_cross[0] += 1
        try:
            return orig_cross(*args, **kw)
        finally:
            in_cross[0] -= 1

    fmod._forward, fmod.flash_attention_bwd = reading_fwd, reading_bwd
    encdec.cross_attention_apply = reading_cross
    try:
        yield kinds
    finally:
        fmod._forward, fmod.flash_attention_bwd = orig_fwd, orig_bwd
        encdec.cross_attention_apply = orig_cross


def _expected_attention(cfg, steps: int) -> dict:
    """``flash_attention`` forward and backward calls by kind in ``steps``
    remat training steps of ``cfg`` (the forward twice a layer, the backward
    once)."""
    if cfg.encdec:
        per = {"non_causal": cfg.enc_layers, "causal": cfg.num_layers, "cross": cfg.num_layers}
    elif cfg.block_pattern == "xlstm":
        per = {}
    else:
        windows = [cfg.window and l not in cfg.full_attn_layers for l in range(cfg.num_layers)]
        per = {"windowed": sum(windows), "causal": cfg.num_layers - sum(windows)}
    per = {k: n for k, n in per.items() if n}
    return {"forward": {k: 2 * n * steps for k, n in per.items()},
            "backward": {k: n * steps for k, n in per.items()}}


def phase_lm_family_mesh(phase: str, seed: int, kernels: dict):
    """One family at full width through the launch layer on the card's
    ``("data", "model")`` mesh of 1 × 1 (``torch.distributed`` at world size 1,
    NCCL on an in-process ``HashStore``), against the same steps with no mesh
    (``MESH_PHASES``: the config, cut in depth, fp32 params, its compute
    dtype, remat).

    1. ``MESH_STEPS`` AdamW steps through ``make_train_step`` on plain tensors
       from the seed's weights and the trainer's synthetic batches: the loss,
       every gradient leaf AdamW was handed and the params after each step
       copied to the host (outside the step's time); the device state freed.
       For MoE, first the first batch's gradients once more from the same
       state (``value_and_grad``): they must be the step's bits.
    2. The same steps on the mesh (params and AdamW state placed by
       ``shardings_for_cell``, the batches by its batch shardings, inside
       ``activation_sharding``): loss, gradients and params after each step
       held bitwise to the host copies.
    3. A prefill of the first batch's ``MESH_SEQ`` tokens (an encoder-decoder
       also its frames) through ``make_prefill_step`` and ``MESH_DECODE``
       steps through ``make_serve_step``, the plain run's greedy tokens fed
       to both; plain, then on the mesh (TP-only params, the cache placed by
       ``cache_specs``): every logit bitwise.

    Counts are set to 0 before each of the four runs and read after; each
    ``flash_attention`` call's kind is read in the training runs, and each
    MoE combine's direction (the forward, or the dispatch gather's backward).
    Returns the row and, for MoE, the first dispatch backward's ``(records'
    gradient, key, rows)`` for the kernel row."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import init_model
    from repro_torch.nn import moe as moe_mod
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, synthetic_batch, value_and_grad
    from repro_torch.train.tree import tree_leaves

    arch, cut = MESH_PHASES[phase]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, remat=True, **cut)
    L, moe = cfg.num_layers, cfg.is_moe
    tcfg = TrainConfig(steps=MESH_STEPS, batch=MESH_BATCH, seq_len=MESH_SEQ, seed=seed)
    step = steps_mod.make_train_step(cfg, OptConfig(peak_lr=3e-3, warmup_steps=10,
                                                    stable_steps=MESH_STEPS, decay_steps=10))
    batches = [synthetic_batch(cfg, tcfg, i, device="cuda") for i in range(MESH_STEPS)]

    def weights():
        return init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)

    # the gradients make_train_step hands AdamW: copied to the host in the plain
    # run, held bitwise to those copies in the mesh run; their time is kept out of
    # the step's
    grads_host, grads_same, held_s, mode = [], [], [0.0], ["plain"]
    orig_update = steps_mod.adamw_update

    def reading_update(grads, state, params, opt_cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = [_local(g) for g in tree_leaves(grads)]
        if mode[0] == "plain":
            grads_host.append([g.cpu() for g in leaves])
        else:
            want = grads_host[len(grads_same)]
            grads_same.append(all(bool(torch.equal(g, w.cuda())) for g, w in zip(leaves, want)))
        torch.cuda.synchronize()
        held_s[0] += time.perf_counter() - t0
        return orig_update(grads, state, params, opt_cfg)

    # MoE: each combine's direction, and the first dispatch backward's inputs
    combines, dispatch_in = collections.Counter(), {}
    orig_combine = moe_mod.combine

    def reading_combine(y, key, num_rows):
        way = "forward" if torch.is_grad_enabled() else "dispatch_backward"
        combines[way] += 1
        if way == "dispatch_backward" and not dispatch_in:
            dispatch_in.update(y=y.clone(), key=key.clone(), num_rows=num_rows)
        return orig_combine(y, key, num_rows)

    def train(state, batch_list, after_step):
        """Steps from ``state`` = [params, opt] (emptied: no step's params stay
        alive past the next one; MoE's update holds both states at once)."""
        losses, step_s = [], []
        for i, batch in enumerate(batch_list):
            torch.cuda.synchronize()
            t0, h0 = time.perf_counter(), held_s[0]
            state[:] = step(*state, batch)
            metrics = state.pop()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0 - (held_s[0] - h0))
            losses.append(_local(metrics["loss"]).cpu())
            after_step(i, state[0])
        state.clear()
        return losses, step_s

    row = {"phase": phase, "arch": arch, "layers": L, "layers_full": full.num_layers,
           "enc_layers": cfg.enc_layers if cfg.encdec else None,
           "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "remat": cfg.remat, "steps": MESH_STEPS, "batch": MESH_BATCH, "seq_len": MESH_SEQ,
           "decode_steps": MESH_DECODE,
           "mesh": {"shape": [1, 1], "axes": ["data", "model"], "backend": DIST_BACKEND}}
    _free_cuda()
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    steps_mod.adamw_update = reading_update
    moe_mod.combine = reading_combine
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        sh = steps_mod.shardings_for_cell(
            cfg, ShapeConfig(phase, MESH_SEQ, MESH_BATCH, "train"), mesh)

        # 1. plain
        params_host = []
        params = weights()
        n_elems = sum(p.numel() for p in tree_leaves(params))
        row["param_elements"] = n_elems
        row["state_bytes_fp32"] = 16 * n_elems  # params, gradients, two AdamW moments
        if moe:  # the first step's gradients once more, from the same state
            rerun = [g.cpu() for g in tree_leaves(value_and_grad(params, cfg, batches[0])[2])]
            _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        combines.clear()
        state = [params, adamw_init(params)]
        del params
        with _attention_kinds() as kinds_plain:
            losses_p, step_s_p = train(
                state, batches, lambda i, p: params_host.append([t.cpu() for t in tree_leaves(p)]))
        row["plain"] = {"losses": [float(x) for x in losses_p], "step_s": step_s_p,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                        "launches": _counts(kernels),
                        "attention_calls": {k: dict(v) for k, v in kinds_plain.items()},
                        "combines": dict(combines), "host_copy_s": held_s[0]}
        if moe:
            row["moe_grads_repeat_bitwise"] = all(
                bool(torch.equal(a, b)) for a, b in zip(rerun, grads_host[0]))
            del rerun
        _free_cuda()

        # 2. the mesh
        mode[0] = "mesh"
        held_s[0] = 0.0
        params_same = []
        params = distribute_tree(weights(), sh["params_sharding"])
        state = [params, distribute_tree(adamw_init(params), sh["opt_sharding"])]
        del params
        dbatches = [distribute_tree(b, sh["batch_sharding"]) for b in batches]
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        combines.clear()
        with _attention_kinds() as kinds_mesh, activation_sharding(mesh, sh["shcfg"]):
            losses_m, step_s_m = train(state, dbatches, lambda i, p: params_same.append(
                all(bool(torch.equal(_local(t), h.cuda()))
                    for t, h in zip(tree_leaves(p), params_host[i]))))
        launches = _counts(kernels)
        entries = _entries(kernels["flash_attention_bwd"])
        row["mesh_run"] = {"losses": [float(x) for x in losses_m], "step_s": step_s_m,
                           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                           "launches": launches, "bwd_launches_by_entry": entries,
                           "attention_calls": {k: dict(v) for k, v in kinds_mesh.items()},
                           "combines": dict(combines), "compare_s": held_s[0]}
        row["train_bitwise"] = {
            "loss": all(bool(torch.equal(a, b)) for a, b in zip(losses_m, losses_p)),
            "grads": len(grads_same) == MESH_STEPS and all(grads_same),
            "params_after_each_step": len(params_same) == MESH_STEPS and all(params_same)}
        del dbatches, grads_host[:], params_host[:]
        _free_cuda()

        # 3. a prefill and decode steps, plain and on the mesh
        ssh = steps_mod.shardings_for_cell(
            cfg, ShapeConfig(phase, MESH_SEQ + MESH_DECODE, MESH_BATCH, "decode"), mesh)
        prefill = steps_mod.make_prefill_step(cfg, ssh["s_max"])
        serve_step = steps_mod.make_serve_step(cfg)
        prompt = {k: v for k, v in batches[0].items() if k != "labels"}
        fed = []

        def serve(params, place):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, place(prompt, {k: ssh["batch_sharding"][k]
                                                           for k in prompt}))
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            outs, decode_s = [_local(logits).cpu()], []
            for i in range(MESH_DECODE):
                if len(fed) == i:  # the plain run's greedy token
                    fed.append(outs[-1][:, -1:].argmax(-1).cuda())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = serve_step(params, cache, place(fed[i], ssh["token_sharding"]))
                torch.cuda.synchronize()
                decode_s.append(time.perf_counter() - t0)
                outs.append(_local(logits).cpu())
            return outs, {"prefill_s": prefill_s, "decode_ms": [1e3 * t for t in decode_s]}

        _zero_counts(kernels)
        plain_out, row["serve_plain"] = serve(weights(), lambda x, s: x)
        row["serve_plain"]["launches"] = _counts(kernels)
        _free_cuda()
        _zero_counts(kernels)
        with activation_sharding(mesh, ssh["shcfg"]):
            mesh_out, row["serve_mesh"] = serve(
                distribute_tree(weights(), ssh["params_sharding"]), distribute_tree)
        row["serve_mesh"]["launches"] = serve_launches = _counts(kernels)
        row["serve_bitwise"] = {
            "prefill_logits": bool(torch.equal(mesh_out[0], plain_out[0])),
            "decode_logits": all(bool(torch.equal(a, b))
                                 for a, b in zip(mesh_out[1:], plain_out[1:]))}
        del plain_out, mesh_out, batches, prompt, fed
        _free_cuda()
    finally:
        steps_mod.adamw_update = orig_update
        moe_mod.combine = orig_combine
        dist.destroy_process_group()

    row["launches"] = {name: row["plain"]["launches"][name] + launches[name]
                       + row["serve_plain"]["launches"][name] + serve_launches[name]
                       for name in kernels}
    row["flags"] = {**{f"train_{k}_bitwise": v for k, v in row["train_bitwise"].items()},
                    **{f"serve_{k}_bitwise": v for k, v in row["serve_bitwise"].items()}}
    if moe:
        row["flags"]["moe_grads_repeat_bitwise"] = row["moe_grads_repeat_bitwise"]
    row["ok"] = all(row["flags"].values())
    emit(row)
    losses = row["plain"]["losses"] + row["mesh_run"]["losses"]
    if len(losses) != 2 * MESH_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    if not row["ok"]:
        raise AssertionError(f"{phase}: mesh ≢ plain: {row['flags']}")
    want = _expected_attention(cfg, MESH_STEPS)
    for run in ("plain", "mesh_run"):
        got = row[run]["attention_calls"]
        if got["forward"] != want["forward"] or got["backward"] != want["backward"]:
            raise AssertionError(f"{phase}: {run} attention calls {got}, expected {want}")
    n_bwd = sum(want["backward"].values())
    if any(n != n_bwd for n in entries.values()):
        raise AssertionError(f"{phase}: backward entries launched {entries}, expected {n_bwd}")
    if moe:  # the combine twice a layer a step (remat), the dispatch backward once
        want_c = {"forward": 2 * L * MESH_STEPS, "dispatch_backward": L * MESH_STEPS}
        for run in ("plain", "mesh_run"):
            if row[run]["combines"] != want_c:
                raise AssertionError(f"{phase}: {run} combines {row[run]['combines']}, "
                                     f"expected {want_c}")
        if launches["segment_spmm"] < sum(want_c.values()):
            raise AssertionError(f"{phase}: segment_spmm launched {launches['segment_spmm']}")
    return row, (dispatch_in["y"], dispatch_in["key"], dispatch_in["num_rows"]) if moe else None


def dryrun_tasks(out_dir: str) -> list:
    """dryrun_check's cells as command lines (module, arguments): the slowest
    first, so that the pool's processes finish together."""
    cut = ["--layers", str(DRYRUN_LAYERS), "--seq", str(DRYRUN_SEQ)]
    lm = [(("--multi-pod",) if mp else ()) + ("--arch", arch, "--shape", shape)
          for shape in ("train_4k", "prefill_32k", "decode_32k") for mp in (True, False)
          for arch in DRYRUN_ARCHS]
    common = ["--mode", "opt", "--out-dir", out_dir, "--force"]
    return ([("repro_torch.launch.dryrun", [*cell, *cut, *common]) for cell in lm]
            + [("repro_torch.launch.gnn_dryrun", common)])


def dryrun_uncut_tasks(out_dir: str) -> list:
    """dryrun_check's ``DRYRUN_UNCUT`` cells on 16 × 16 as command lines."""
    return [("repro_torch.launch.dryrun", ["--arch", arch, "--shape", shape, "--mode", "opt",
                                           "--out-dir", out_dir, "--force"])
            for arch, shape in DRYRUN_UNCUT]


def dryrun_task(module: str, argv: list) -> dict:
    """One of :func:`dryrun_tasks` in this process: its sweep's counts."""
    import importlib

    with contextlib.redirect_stdout(sys.stderr):
        return importlib.import_module(module).main(argv)


def prod_estimate(name: str) -> dict:
    """(A task of :func:`dryrun_estimates`' pool.)  The dry run's estimate, on a
    fake 1 × 1 mesh, of a ``PROD_PREFILLS`` phase's counted prefill (the
    prefill_32k cell at the phase's batch; the card's cache holds
    ``PROD_DECODE`` positions more) or of a ``PROD_TRAINS`` phase's steps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import OptConfig

    if name in PROD_PREFILLS:
        arch, layers, batch = PROD_PREFILLS[name]
        cfg, opt = dryrun.production_cfg(arch, layers), None
        shape = ShapeConfig(name, PROD_PREFILL_SEQ, batch, "prefill")
    else:
        arch, layers = PROD_TRAINS[name]
        cfg = dryrun.production_cfg(arch, layers)
        shape = ShapeConfig(name, PROD_TRAIN_SEQ, PROD_BATCH, "train")
        opt = OptConfig(peak_lr=3e-3, warmup_steps=10, stable_steps=PROD_TRAIN_STEPS,
                        decay_steps=10)
    with contextlib.redirect_stdout(sys.stderr), dryrun.fake_world(1):
        res = dryrun.estimate(cfg, shape, dryrun.fake_mesh((1, 1), ("data", "model")), "opt",
                              opt)
    return {**dryrun.memory_analysis(res), "trace_s": res["trace_s"]}


def dryrun_estimates(n: int, e: int, out_path: str, cells_dir: str) -> None:
    """(Run in a child process: a fake process group is process-global, and
    this process's phases hold a real one.)  The dry run's estimates of the
    peak bytes of two calls this script measures on the card: ``lm_vlm_train``'s
    step (its config, batch and 1 × 1 mesh, placed as ``shardings_for_cell``
    places them) and the gcn ``full_forward`` of ``phase_dryrun_check`` (n
    vertices, e edges, dims [WIDTH] × 3).  Fake tensors: nothing allocated.
    Meanwhile :func:`dryrun_uncut_tasks`' cells (into ``cells_dir/uncut``) and
    :func:`dryrun_tasks`' run in ``DRYRUN_WORKERS`` processes, each writing its
    JSON to ``cells_dir``; their summed counts are kept."""
    import multiprocessing

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import make_model
    from repro_torch.core.full import full_forward_edges
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import OptConfig

    out = {}
    t0 = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    # the production dtype's estimates first, each in a worker of its own
    prod = {name: pool.apply_async(prod_estimate, (name,)) for name in (*PROD_PREFILLS,
                                                                         *PROD_TRAINS)}
    cells = pool.starmap_async(dryrun_task, dryrun_uncut_tasks(f"{cells_dir}/uncut")
                               + dryrun_tasks(cells_dir), chunksize=1)
    cfg = dataclasses.replace(get_arch(VLM_ARCH), num_layers=VLM_TRAIN_LAYERS)
    shape = ShapeConfig("lm_vlm_train", TRAIN_SEQ, VLM_TRAIN_BATCH, "train")
    with dryrun.fake_world(1):
        res = dryrun.estimate(cfg, shape, dryrun.fake_mesh((1, 1), ("data", "model")), "opt",
                              OptConfig(peak_lr=3e-3, warmup_steps=10,
                                        stable_steps=VLM_TRAIN_STEPS, decay_steps=10))
    out["lm_vlm_train"] = {**dryrun.memory_analysis(res), "trace_s": res["trace_s"]}
    model = make_model("gcn")
    with FakeTensorMode():
        x = torch.empty(n, WIDTH)
        params = [{k: torch.empty(v.shape, dtype=v.dtype) for k, v in
                   model.init_params(torch.Generator(), WIDTH, WIDTH).items()}
                  for _ in range(2)]

        def call(x, params):  # full_forward: the graph's arrays land on the card inside it
            src, dst = torch.empty(e, dtype=torch.int64), torch.empty(e, dtype=torch.int64)
            ew, et = torch.empty(e), torch.empty(e, dtype=torch.int32)
            deg, row_ptr = torch.empty(n), torch.empty(n + 1, dtype=torch.int64)
            return full_forward_edges(model, params, x, src, dst, ew, et, deg, row_ptr)

        res = dryrun.analyse(call, (x, params), {"inputs": x, "params": params})
    out["gcn_full_forward"] = {**dryrun.memory_analysis(res), "trace_s": res["trace_s"]}
    out.update({name: r.get() for name, r in prod.items()})
    out["estimates_s"] = time.perf_counter() - t0
    counts = cells.get()
    pool.close()
    pool.join()
    out["cells"] = {k: sum(c[k] for c in counts) for k in ("done", "skipped", "failed")}
    out["seconds"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out))


def phase_dryrun_check(graph, seed: int, vlm_train: dict, prod_rows: list) -> dict:
    """The dry run against the card: its peak estimates (``dryrun_estimates``,
    in a child process with a timeout) beside ``max_memory_allocated()`` of
    the same calls, less what the process held on the card that the call
    was not given: ``lm_vlm_train``'s steps, each ``PROD_PREFILLS`` phase's
    counted prefill and each ``PROD_TRAINS`` phase's steps (``prod_rows``, read
    by those phases) and a gcn ``full_forward`` over ``graph`` run here (peak
    reset around it).  Each
    estimate must lie within ``TOL_DRYRUN_PEAK`` of its measured peak, and
    every cell of :func:`dryrun_tasks` must have run, each with its figures."""
    import tempfile

    import torch

    from repro_torch.core import full_forward, make_model

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        est_path, cells_dir = f"{tmp}/estimates.json", f"{tmp}/cells"
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                f"chip_smoke.dryrun_estimates({graph.n}, {graph.num_edges}, {est_path!r}, "
                f"{cells_dir!r})")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        # a session of its own: a timeout kills the child and its pool together
        child = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 start_new_session=True)
        try:
            # the card's side meanwhile: full_forward from its inputs, peak reset around it
            model = make_model("gcn")
            gen = torch.Generator().manual_seed(seed)
            params = [{k: v.cuda() for k, v in model.init_params(gen, WIDTH, WIDTH).items()}
                      for _ in range(2)]
            x = torch.randn(graph.n, WIDTH, generator=gen).cuda()
            _free_cuda()
            before = torch.cuda.memory_allocated()
            inputs = _storage_bytes(x, *params)
            torch.cuda.reset_peak_memory_stats()
            states = full_forward(model, params, x, graph)
            torch.cuda.synchronize()
            ff_peak = torch.cuda.max_memory_allocated()
            if (states[-1].h.shape != (graph.n, WIDTH)
                    or not bool(torch.isfinite(states[-1].h).all())):
                raise AssertionError("dryrun_check: full_forward gave bad embeddings")
            del states, x, params
            _free_cuda()
            stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dryrun_check: the dry run took over {DRYRUN_TIMEOUT_S} s")
        finally:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
                child.communicate()
        if child.returncode != 0:
            raise AssertionError(f"dryrun_check: the dry run failed:\n{stderr[-4000:]}")
        est = json.loads(Path(est_path).read_text())
        results = {f.stem: json.loads(f.read_text()) for f in Path(cells_dir).glob("*.json")}
        uncut = {f.stem: json.loads(f.read_text())
                 for f in Path(cells_dir, "uncut").glob("*.json")}
        errors = {f.stem: f.read_text().strip().splitlines()[-1][:300]
                  for f in Path(cells_dir).glob("**/*.err")}
    measured = {
        "lm_vlm_train": (vlm_train["peak_mem_bytes"],
                         vlm_train["mem_at_reset_bytes"] - vlm_train["input_bytes"]),
        "gcn_full_forward": (ff_peak, before - inputs),
        **{row["phase"]: (row["peak_mem_bytes"], row["mem_at_reset_bytes"] - row["input_bytes"])
           for row in prod_rows},
    }
    checks = {}
    for name, (peak, other) in measured.items():
        e = est[name]
        call_peak = peak - other  # the card's peak less what the call was not given
        checks[name] = {"estimate_bytes": e["peak_bytes_per_device"],
                        "max_memory_allocated": peak, "held_before_not_inputs": other,
                        "measured_call_peak": call_peak,
                        "ratio": e["peak_bytes_per_device"] / call_peak,
                        "estimate_split": e["peak_split_bytes"],
                        "estimate_top": e["peak_top_storages"][:6],
                        "estimate_trace_s": e["trace_s"]}
    from repro_torch.launch import gnn_dryrun

    want = len(dryrun_tasks("")) - 1 + 2 * len(gnn_dryrun.CELLS)  # LM cells, GNN's × 2 meshes
    cells = {"expected": want + len(DRYRUN_UNCUT), **est["cells"], "failed_cells": errors,
             "workers": DRYRUN_WORKERS, "cut": {"num_layers": DRYRUN_LAYERS,
                                                "seq_len": DRYRUN_SEQ},
             "peak_gb": {k: r["memory_analysis"]["peak_est_gb"] for k, r in results.items()},
             "trace_s": {k: r["trace_s"] for k, r in results.items()},
             "uncut": {k: {"peak_gb": r["memory_analysis"]["peak_est_gb"],
                           "fits_hbm": r["fits_hbm"], "trace_s": r["trace_s"],
                           "peak_top": r["memory_analysis"]["peak_top_storages"][:4]}
                       for k, r in uncut.items()}}
    row = {"phase": "dryrun_check", **checks, "estimates_s": est["estimates_s"],
           "cells": cells, "child_s": est["seconds"], "phase_s": time.perf_counter() - t0}
    emit(row)
    for name, c in checks.items():
        if not abs(c["ratio"] - 1) <= TOL_DRYRUN_PEAK:
            raise AssertionError(f"dryrun_check: {name} estimate {c['estimate_bytes']} vs "
                                 f"measured {c['measured_call_peak']} (ratio {c['ratio']:.4f})")
    if (est["cells"]["failed"] or est["cells"]["done"] != want + len(DRYRUN_UNCUT)
            or len(results) != want or len(uncut) != len(DRYRUN_UNCUT)):
        raise AssertionError(f"dryrun_check: {est['cells']} of {want + len(DRYRUN_UNCUT)} "
                             f"cells ran: {errors}")
    unfit = {k: r["memory_analysis"]["peak_est_gb"] for k, r in uncut.items()
             if not r["fits_hbm"]}
    if unfit:
        raise AssertionError(f"dryrun_check: uncut cells over the card's 80 GB: {unfit}")
    for name, r in results.items():
        ops, mem = r["ops_per_device"], r["memory_analysis"]
        if not (mem["peak_bytes_per_device"] > 0 and ops["flops"] > 0
                and ops["hbm_bytes_raw"] > 0 and r["roofline"]["bound_s"] > 0
                and r["model_flops"]["useful_fraction"] > 0):
            raise AssertionError(f"dryrun_check: {name} lacks a figure")
    return row


def _rel_err(card, cpu) -> float:
    """max |card − cpu| over max |cpu|."""
    return float((card.cpu() - cpu).abs().max()) / max(float(cpu.abs().max()), 1e-30)


def _block_err(x, ref, rows: int = 128):
    """max |x − ref| of [B, H, S, dh] in each block of ``rows`` query rows."""
    import torch.nn.functional as F

    per_row = (x - ref).abs().amax(dim=(0, 1, 3))
    return F.pad(per_row, (0, -per_row.numel() % rows)).view(-1, rows).amax(1)


def kernel_flash_attention(cfg, gen, dtype: str = "float32", window=None, causal: bool = True,
                           sk: int = None, s: int = LM_PROMPT, b: int = LM_BATCH,
                           tail: int = 0) -> dict:
    """The prefill shape of ``cfg`` (GQA; causal, or not with ``causal=False``,
    as the encoder's self attention and the cross attention run; ``s`` query
    rows, the prompt's length unless given, and ``sk`` keys, ``s`` unless
    given) in fp32, the main path's dtype, or in
    bf16; with a sliding ``window``, the pairs of the band.  The bound is the
    design's over the visible key–query pairs (Sq·Sk a head when not causal):
    fp32 runs three TF32 products per product (split TF32), bf16 one bf16
    product.  The library call is ``scaled_dot_product_attention``, causal or
    not, or with the band as a boolean mask.  A second launch must give the
    first's bits.  In bf16 each block of 128 query rows must also be within
    ``TOL_ATTN_BF16_VS_LIBRARY`` times SDPA's max |Δ| in that block.  ``tail``:
    the outputs are held on the last ``tail`` query rows of every head only,
    against the plain version of those rows (``q_offset`` s − tail), which is
    also what ``plain_ms`` times (the plain version of every row of the
    production prefill would need ~280 GB of scores)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse

    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sk = s if sk is None else sk
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, hkv, sk, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, hkv, sk, dh, device="cuda", generator=gen).to(dt)
    mask = dict(causal=causal, window=window)
    out = flash_attention(q, k, v, **mask)
    repeat = bool(torch.equal(out, flash_attention(q, k, v, **mask)))
    o_lse, lse = flash_attention_lse(q, k, v, **mask)
    lse_same_o = bool(torch.equal(o_lse, out))  # the lse output leaves o's bits alone
    rows = slice(s - tail, s) if tail else slice(0, s)
    q_ref = q[:, :, rows].contiguous() if tail else q
    ref_mask = dict(mask, q_offset=s - tail) if tail else mask
    out, lse = out[:, :, rows].float(), lse[:, :, rows]
    ref, lse_ref = kref.flash_attention_lse_ref(q_ref, k, v, **ref_mask)
    ref = ref.float()
    if window is None:
        sdpa = dict(is_causal=causal)
    else:
        pos = torch.arange(s, device="cuda")
        rel = pos[:, None] - pos[None, :]
        sdpa = dict(attn_mask=(rel >= 0) & (rel < window))

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa)

    lib = library()[:, :, rows].float()
    atol, rtol = TOL_ATTN if dtype == "float32" else TOL_ATTN_BF16
    lse_err = float((lse - lse_ref).abs().max())
    lse_ok = bool(((lse - lse_ref).abs() <= TOL_ATTN[0] + TOL_ATTN[1] * lse_ref.abs()).all())
    within = (bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()) and lse_same_o
              and lse_ok and repeat)
    err, lib_err = float((out - ref).abs().max()), float((lib - ref).abs().max())
    scaled = {}
    if dtype != "float32":  # errors scaled per row and per block, where |o| is small
        blocks = _block_err(out, ref) / _block_err(lib, ref).clamp_min(1e-30)
        rms = ref.pow(2).mean(-1).sqrt().clamp_min(1e-30)
        scaled = {"block_err_over_library": float(blocks.max()),
                  "row_rel_err": float(((out - ref).abs().amax(-1) / rms).max()),
                  "library_row_rel_err": float(((lib - ref).abs().amax(-1) / rms).max())}
        within = within and scaled["block_err_over_library"] <= TOL_ATTN_BF16_VS_LIBRARY
    del out, ref, lib, o_lse, lse, lse_ref
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, **mask), 20)
    plain_ms = cuda_time_ms(lambda: kref.flash_attention_ref(q_ref, k, v, **ref_mask), 3,
                            warmup=1)
    lib_ms = cuda_time_ms(library, 10)
    if not causal:
        pairs = s * sk  # every key of every row
    else:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w  # visible key–query pairs a head
    flops = 4 * dh * b * hq * pairs  # q·k and p·v over the visible pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if dtype == "float32":
        bound_ms, by = _bound(nbytes, SPLIT_TF32 * flops, TF32_FLOPS)
    else:
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS)
    row = {"name": "flash_attention",
           "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "Sk": sk, "dh": dh, "causal": causal,
                     "window": window, "dtype": dtype, "visible_pairs_a_head": pairs},
           "max_abs_err": err, "within_tol": within, "library_max_abs_err": lib_err, **scaled,
           "lse_same_o_bits": lse_same_o, "lse_max_abs_err": lse_err, "repeat_bitwise": repeat,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "library_ms": lib_ms, "flops": flops,
           "fp32_simt_bound_ms": flops / FP32_FLOPS * 1e3}
    if tail:
        row["held_rows"] = row["plain_rows"] = tail
    if dtype != "float32":
        row["variant"] = dtype  # a check beside the main path's dtype, not a summary row
    return row


def kernel_flash_attention_bwd(cfg, gen, dtype: str = "float32", b: int = TRAIN_BATCH,
                               s: int = TRAIN_SEQ, causal: bool = True, window=None,
                               sk: int = None) -> dict:
    """The backward kernels at a training shape of ``cfg`` (GQA; ``b`` rows of
    ``s`` query positions over ``sk`` keys, ``s`` unless given; causal, with a
    sliding ``window``, or not causal, as the encoder's self attention and the
    cross attention) in fp32, the training step's dtype at fp32 params (they
    keep the residual stream fp32), or in bf16, that of the step at bf16
    params (``lm_vlm_prod_train``): against
    ``flash_attention_bwd_ref`` on the kernel's o and lse, a second launch
    bitwise the first, timed (both entries a call) beside the plain version
    and the backward of ``scaled_dot_product_attention`` in the same dtype
    (one forward kept, ``torch.autograd.grad`` timed; the band as a boolean
    mask).  The bound is that of the five products over the visible pairs,
    2.5 × the forward's operations: in fp32 at 3 TF32 products a product
    (split TF32, as the forward), in bf16 at one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_lse

    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sk = s if sk is None else sk
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, hkv, sk, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, hkv, sk, dh, device="cuda", generator=gen).to(dt)
    do = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    mask = dict(causal=causal, window=window)
    o, lse = flash_attention_lse(q, k, v, **mask)

    def run():
        return flash_attention_bwd(q, k, v, o, lse, do, **mask)

    grads = run()
    ref = kref.flash_attention_bwd_ref(q, k, v, o, lse, do, **mask)
    atol, rtol = TOL_ATTN if dtype == "float32" else TOL_ATTN_BF16
    within = all(bool(((g.float() - r.float()).abs() <= atol + rtol * r.float().abs()).all())
                 for g, r in zip(grads, ref))
    errs = {n: float((g.float() - r.float()).abs().max())
            for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    bitwise = all(bool(torch.equal(a, c)) for a, c in zip(grads, run()))
    del grads, ref
    ms = cuda_time_ms(run, 10)
    plain_ms = cuda_time_ms(lambda: kref.flash_attention_bwd_ref(q, k, v, o, lse, do, **mask),
                            2, warmup=1)
    if window is None:
        sdpa = dict(is_causal=causal)
    else:
        pos = torch.arange(s, device="cuda")
        rel = pos[:, None] - pos[None, :]
        sdpa = dict(attn_mask=(rel >= 0) & (rel < window))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **sdpa)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)
    del out, leaves
    if not causal:
        pairs = s * sk  # every key of every row
    else:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w  # visible key–query pairs a head
    flops = 10 * dh * b * hq * pairs  # S, dP, dV, dK, dQ over the visible pairs
    # q o dO dq, k v dk dv in the dtype; lse in fp32
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    if dtype == "float32":
        bound_ms, by = _bound(nbytes, SPLIT_TF32 * flops, TF32_FLOPS)
    else:
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS)
    library = ("backward of F.scaled_dot_product_attention(" +
               ("attn_mask=band" if window is not None else f"is_causal={causal}") +
               ", enable_gqa)")
    row = {"name": "flash_attention_bwd",
           "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "Sk": sk, "dh": dh, "causal": causal,
                     "window": window, "dtype": dtype, "visible_pairs_a_head": pairs},
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "within_tol": within and bitwise, "bitwise_repeat": bitwise,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "bound_share": bound_ms / ms, "library_ms": lib_ms, "library": library,
           "flops": flops, "fp32_simt_bound_ms": flops / FP32_FLOPS * 1e3}
    if dtype != "float32":
        row["variant"] = dtype  # a check beside the fp32 row, not a summary row
    return row


def kernel_edge_softmax(graph, gen) -> dict:
    """``edge_softmax_normalize`` at the op's shape on the base graph: H =
    gat's heads, sums from ``segment_spmm`` (phase 1).  No single PyTorch
    call computes this function, so there is no library yardstick."""
    import torch

    from repro_torch.kernels.edge_softmax import (
        edge_softmax_normalize,
        edge_softmax_normalize_plain,
    )
    from repro_torch.kernels.segment_spmm import segment_spmm

    _, dst, row_ptr = _in_edges(graph)
    e, r, h = graph.num_edges, graph.n, GAT_HEADS
    scores = torch.rand(e, h, device="cuda", generator=gen).exp_()
    sums = segment_spmm(scores, row_ptr, None, r)
    out = edge_softmax_normalize(scores, dst, sums)
    ref = edge_softmax_normalize_plain(scores, dst, sums)
    err, exact = float((out - ref).abs().max()), bool(torch.equal(out, ref))
    del out, ref
    ms = cuda_time_ms(lambda: edge_softmax_normalize(scores, dst, sums), 50)
    plain_ms = cuda_time_ms(lambda: edge_softmax_normalize_plain(scores, dst, sums), 10)
    nbytes = 2 * e * h * 4 + e * dst.element_size() + r * h * 4
    bound_ms, by = _bound(nbytes, e * h)
    return {"name": "edge_softmax_normalize", "shape": {"E": e, "H": h, "R": r},
            "max_abs_err": err, "within_tol": exact,  # the same IEEE division: bit for bit
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes the gather-and-divide"}


def _row_linear_inputs(m: int, k: int, n: int, gen):
    """Embedding-like rows and a glorot weight, as the models' products get."""
    import torch

    a = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(k, n, device="cuda", generator=gen) * (2.0 / (k + n)) ** 0.5
    return a, w


def _bitwise(x, y) -> bool:
    import torch

    return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def _row_linear_bound(m: int, k: int, n: int):
    return _bound((m * k + k * n + m * n) * 4, 2 * m * k * n)


def kernel_row_linear(m: int, e: int, r_cap: int, gen) -> list:
    """``row_linear`` at the update's shape on the main path (``a @ W`` over
    all n rows in ``full_forward``, K = N = 128), where the wrapper takes the
    tiled kernel: bitwise the general kernel, within 1e-5 of the plain
    version, the row-count probe at K = N = 128 and K = 256 across the
    wrapper's switch between the kernels, both kernels timed beside
    ``torch.matmul`` (TF32 off) and the bound, and both kernels at a few M
    around the switch.  Variant rows: gat's per-edge product (M = E, no plain
    version: seconds for nothing) and the incremental step's update (M =
    the largest row cap), each bitwise the general kernel."""
    import torch

    from repro_torch.kernels.row_linear import (
        ENTRIES,
        TILED_MIN_ROWS,
        kernel_entry,
        row_linear,
        row_linear_plain,
    )

    general = ENTRIES[0]
    probe = {}
    for k, n in ((WIDTH, WIDTH), (2 * WIDTH, WIDTH)):
        a, w = _row_linear_inputs(ROW_COUNTS[-1], k, n, gen)
        full = row_linear(a, w)
        probe[f"K{k}_N{n}"] = {
            "entry_at_full": kernel_entry(ROW_COUNTS[-1], k, n),
            "rows_independent": all(bool(torch.equal(row_linear(a[:r], w), full[:r]))
                                    for r in ROW_COUNTS),
            "matmul_max_row_diff": max(float(((a[:r] @ w) - (a @ w)[:r]).abs().max())
                                       for r in ROW_COUNTS)}
    del a, w, full

    a, w = _row_linear_inputs(m, WIDTH, WIDTH, gen)
    out = row_linear(a, w)
    same = _bitwise(out, row_linear(a, w, entry=general))
    err = float((out - row_linear_plain(a, w)).abs().max())
    del out
    ms = cuda_time_ms(lambda: row_linear(a, w), 20)
    general_ms = cuda_time_ms(lambda: row_linear(a, w, entry=general), 20)
    plain_ms = cuda_time_ms(lambda: row_linear_plain(a, w), 3, warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.matmul(a, w), 20)
    bound_ms, by = _row_linear_bound(m, WIDTH, WIDTH)
    del a
    switch = {}  # both kernels on each side of the wrapper's switch between them
    for k in (WIDTH, 2 * WIDTH):
        a, wk = _row_linear_inputs(4 * TILED_MIN_ROWS, k, WIDTH, gen)
        for rows in (TILED_MIN_ROWS // 16, TILED_MIN_ROWS // 4, TILED_MIN_ROWS,
                     4 * TILED_MIN_ROWS):
            switch[f"K{k}_M{rows}"] = {
                entry: cuda_time_ms(lambda: row_linear(a[:rows], wk, entry=entry), 50)
                for entry in ENTRIES}
        del a
    main = {"name": "row_linear", "shape": {"M": m, "K": WIDTH, "N": WIDTH},
            "entry": kernel_entry(m, WIDTH, WIDTH), "max_abs_err": err,
            "bitwise_general": same,
            "within_tol": err <= TOL_KERNEL and same and all(
                p["rows_independent"] for p in probe.values()),
            "row_count_probe": probe, "ms": ms, "general_ms": general_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "torch.matmul (TF32 off)", "entries_at_switch_ms": switch}

    rows = [main]
    for variant, rows_m, iters in (("gat_per_edge", e, 5), ("incremental_update", r_cap, 50)):
        a = torch.randn(rows_m, WIDTH, device="cuda", generator=gen)
        out = row_linear(a, w)
        same = _bitwise(out, row_linear(a, w, entry=general))
        err = float((out - row_linear_plain(a, w)).abs().max()) if rows_m <= m else None
        del out
        bound_ms, by = _row_linear_bound(rows_m, WIDTH, WIDTH)
        rows.append({
            "name": "row_linear", "variant": variant,
            "shape": {"M": rows_m, "K": WIDTH, "N": WIDTH},
            "entry": kernel_entry(rows_m, WIDTH, WIDTH),
            # the plain version is skipped at M = E: its K steps take seconds there
            "max_abs_err": err, "bitwise_general": same,
            "within_tol": same and (err is None or err <= TOL_KERNEL),
            "ms": cuda_time_ms(lambda: row_linear(a, w), iters),
            "general_ms": cuda_time_ms(lambda: row_linear(a, w, entry=general), iters),
            "plain_ms": None, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": cuda_time_ms(lambda: torch.matmul(a, w), iters)})
        del a
    return rows


#: --ab: the kernel rows and LM phases timed in each turn (``ab_child``)
AB_N, AB_GAT_EDGES, AB_ROW_CAP = 1_000_000, 9_995_744, 131_072  # the engine's (PERF.md §4)


def ab_child(cs) -> dict:
    """(In a child of :func:`ab`: ``cs`` is the ``chip_smoke`` module of the
    checkout under test, and its ``repro_torch`` the one imported.)  Times a
    subset of the kernel rows through that checkout's own functions:
    ``segment_spmm`` and ``delta_agg`` at the Zipf shape (integer messages,
    bitwise), ``row_linear`` at the engine's shapes, the ``flash_attention``
    forward and backward at llama3.2-1b's; then the LM phases' prefill
    seconds, decode ms a token, training seconds a step and peak memory."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import set_fp32_precision
    from repro_torch.kernels import delta_agg as dmod
    from repro_torch.kernels import edge_softmax as emod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import row_linear as rmod
    from repro_torch.kernels import segment_spmm as smod

    set_fp32_precision()
    with contextlib.redirect_stdout(sys.stderr):  # the phases' own lines
        cs.phase_build()
        kernels = {"segment_spmm": smod.KERNEL, "delta_agg": dmod.KERNEL,
                   "flash_attention": fmod.KERNEL, "flash_attention_bwd": fmod.BWD_KERNEL,
                   "edge_softmax_normalize": emod.KERNEL, "row_linear": rmod.KERNEL}
        gen = torch.Generator(device="cuda").manual_seed(0)
        rng = np.random.default_rng(0)
        zipf = cs.zipf_in_indptr(AB_N, 0)
        keys = np.repeat(np.arange(AB_N), np.diff(zipf))[rng.permutation(int(zipf[-1]))]
        cfg = get_arch(cs.LM_ARCH)
        rows = [{**cs.kernel_segment_spmm(zipf, cs.WIDTH + 1, gen, integer=True),
                 "variant": "zipf"},
                {**cs.kernel_delta_agg(keys, AB_N, cs.WIDTH + 1, gen, iters=20, integer=True),
                 "variant": "zipf"},
                *cs.kernel_row_linear(AB_N, AB_GAT_EDGES, AB_ROW_CAP, gen),
                cs.kernel_flash_attention(cfg, gen), cs.kernel_flash_attention_bwd(cfg, gen)]
        keep = ("name", "variant", "ms", "max_abs_err", "bitwise_repeat", "repeat_bitwise",
                "chunked_order_bitwise")
        rows = [{k: r[k] for k in keep if k in r} for r in rows]
        phases = {}
        for name, run in (
                ("lm_serve", lambda: cs.phase_lm_serve(0, kernels)[0]),
                ("lm_train", lambda: cs.phase_lm_train(0, kernels)),
                ("lm_moe_serve", lambda: cs.phase_lm_moe_serve(0, kernels)[0]),
                ("lm_hymba_serve", lambda: cs.phase_lm_recurrent_serve(cs.HYMBA_ARCH, 0,
                                                                       kernels)[0]),
                ("lm_xlstm_serve", lambda: cs.phase_lm_recurrent_serve(cs.XLSTM_ARCH, 0,
                                                                       kernels)[0]),
                ("lm_encdec_serve", lambda: cs.phase_lm_encdec_serve(0, kernels)[0]),
                ("lm_vlm_serve", lambda: cs.phase_lm_vlm_serve(0, kernels)[0]),
                ("lm_vlm_train", lambda: cs.phase_lm_vlm_train(0, kernels))):
            row = run()
            phases[name] = {k: row[k] for k in ("prefill_s", "decode_ms_per_token",
                                                "steady_step_s", "peak_mem_bytes") if k in row}
            cs._free_cuda()
    return {"rows": rows, "phases": phases}


def ab(other: Path) -> int:
    """Time ``other``'s checkout (its own ``chip_smoke.py`` and ``src``) and this
    one on this card in turns (other, this, this, other), each in a process of
    its own that builds its kernels; one JSON line a turn: the checkout's
    directory, the card and its power limit, :func:`ab_child`'s figures."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    for tree in (other.resolve(), ROOT, ROOT, other.resolve()):
        # the checkout's chip_smoke and repro_torch first; then this file as a module of
        # its own (it puts its own src first on the path: the checkout's is imported)
        code = (f"import importlib.util, json, sys; sys.path.insert(0, {str(tree)!r}); "
                f"import chip_smoke as cs; import repro_torch; "
                f"spec = importlib.util.spec_from_file_location('chip_smoke_ab', "
                f"{str(Path(__file__).resolve())!r}); "
                f"ab = importlib.util.module_from_spec(spec); spec.loader.exec_module(ab); "
                f"print(json.dumps(ab.ab_child(cs)))")
        run = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(run.stderr[-6000:], file=sys.stderr)
            return run.returncode
        print(json.dumps({"tree": tree.name, "card": smi,
                          **json.loads(run.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="vertices (default 1,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=Path, default=None, metavar="OTHER",
                    help="time the checkout at OTHER against this one, in turns (ab)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import set_fp32_precision
        from repro_torch.kernels import delta_agg as dmod
        from repro_torch.kernels import edge_softmax as emod
        from repro_torch.kernels import flash_attention as fmod
        from repro_torch.kernels import row_linear as rmod
        from repro_torch.kernels import segment_spmm as smod
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2
    if args.ab is not None:
        return ab(args.ab)
    set_fp32_precision()
    kernels = {"segment_spmm": smod.KERNEL, "delta_agg": dmod.KERNEL,
               "flash_attention": fmod.KERNEL, "flash_attention_bwd": fmod.BWD_KERNEL,
               "edge_softmax_normalize": emod.KERNEL, "row_linear": rmod.KERNEL}

    build = _InThread(phase_build)  # nvcc's processes run beside the graph's host work
    return _phases(args, kernels, build)


class _InThread:
    """``fn()`` on a thread of its own; ``result()`` waits for it and raises
    what it raised."""

    def __init__(self, fn):
        import threading

        self.exc = None

        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised by result()
                self.exc = exc

        self.thread = threading.Thread(target=run)
        self.thread.start()

    def result(self) -> None:
        self.thread.join()
        if self.exc is not None:
            raise self.exc


def _phases(args, kernels: dict, build: _InThread) -> int:
    """Every phase after the build (which ``build`` runs meanwhile: the data
    are made on the host beside it), then the kernel rows and the last lines."""
    import torch

    from repro_torch.core.full import next_bucket
    from repro_torch.graph import make_graph, make_stream, random_features

    t0 = time.perf_counter()
    graph = make_graph("uniform", args.n, avg_degree=10, seed=args.seed, weighted=True)
    x, _ = random_features(args.n, WIDTH, seed=args.seed)
    wl = make_stream(graph, num_batches=6, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=args.seed + 1)
    emit({"phase": "data", "n": args.n, "edges": graph.num_edges,
          "base_edges": wl.base.num_edges, "setup_s": time.perf_counter() - t0})
    build.result()

    # each path: counts set to 0 just before it is driven, read just after
    engine_rows = [phase_engine(m, x, wl, args.seed, kernels) for m in ("gcn", "gat")]
    gnn = {name: sum(row["launches"][name] for row in engine_rows)
           for name in ("segment_spmm", "delta_agg", "row_linear")}
    emit({"phase": "main_path_launches", **gnn})
    for name, cnt in gnn.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    skewed_row = phase_engine_skewed(args.n, args.seed, kernels, engine_rows[0])
    del graph
    serve = serving_data(min(args.n, SERVE_N), args.seed)
    serving_rows = [phase(serve, args.seed, kernels) for phase in (
        phase_policy, phase_fusion_frontend, phase_storage, phase_baselines_odec,
        phase_offload, phase_hot_cache, phase_chunked_backend, phase_sharded,
        phase_sharded_offload)]
    del serve
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    es = phase_edge_softmax_op(wl.base, gen, kernels)
    lm, cfg, params = phase_lm_serve(args.seed, kernels)
    phase_lm_consistency(cfg, params, args.seed)
    del params
    train = phase_lm_train(args.seed, kernels)
    train_check = phase_lm_train_consistency(args.seed, kernels)
    moe, moe_cfg, moe_params, combine_in = phase_lm_moe_serve(args.seed, kernels)
    phase_lm_consistency(dataclasses.replace(  # dropless: what overflows depends on context
        moe_cfg, capacity_factor=moe_cfg.num_experts / moe_cfg.top_k), moe_params, args.seed,
        phase="lm_moe_consistency")
    del moe_params
    hymba, hymba_cfg, rec_params = phase_lm_recurrent_serve(HYMBA_ARCH, args.seed, kernels)
    # held in fp32 compute, as the reference's own check (its reduced configs): under
    # bf16 compute hymba's decode rounds layer 0's conv carry to bf16, which the
    # forward does not (the reference's _ssd_branch); that run is measured, not held
    hymba32 = dataclasses.replace(hymba_cfg, compute_dtype="float32")
    phase_lm_consistency(hymba32, rec_params, args.seed, phase="lm_hymba_consistency")
    phase_lm_consistency(hymba_cfg, rec_params, args.seed, phase="lm_hymba_consistency_bf16",
                         check=False)
    phase_lm_consistency(dataclasses.replace(hymba32, full_attn_layers=()), rec_params,
                         args.seed, phase="lm_hymba_ring", prompt=RING_PROMPT, steps=RING_STEPS,
                         ring_slots=hymba_cfg.window)
    del rec_params
    xlstm, xlstm_cfg, rec_params = phase_lm_recurrent_serve(XLSTM_ARCH, args.seed, kernels)
    # fp32 compute, as hymba's: under bf16 compute layer 0's sLSTM output is rounded to
    # bf16, and where two orders of its fp32 sum straddle a rounding boundary the 47
    # layers above amplify the step (the forward over the prompt alone moves as much)
    phase_lm_consistency(dataclasses.replace(xlstm_cfg, compute_dtype="float32"), rec_params,
                         args.seed, phase="lm_xlstm_consistency")
    phase_lm_consistency(xlstm_cfg, rec_params, args.seed, phase="lm_xlstm_consistency_bf16",
                         check=False)
    del rec_params
    encdec, encdec_cfg, encdec_params = phase_lm_encdec_serve(args.seed, kernels)
    # 300 frames: the cross attention runs Sq 256 over a ragged Sk, non-causal
    for compute, phase in (("float32", "lm_encdec_consistency"),
                           ("bfloat16", "lm_encdec_consistency_bf16")):
        phase_lm_consistency(dataclasses.replace(encdec_cfg, compute_dtype=compute),
                             encdec_params, args.seed, phase=phase, frames=ENCDEC_CONSIST_FRAMES)
    del encdec_params
    vlm, vlm_cfg, vlm_params = phase_lm_vlm_serve(args.seed, kernels)
    # 256 patches + 300 tokens: the last key tile at dh 160 is ragged; bf16 compute is
    # held at the same tolerance (its forward over the prompt alone is measured too)
    for compute, phase in (("float32", "lm_vlm_consistency"),
                           ("bfloat16", "lm_vlm_consistency_bf16")):
        phase_lm_consistency(dataclasses.replace(vlm_cfg, compute_dtype=compute), vlm_params,
                             args.seed, phase=phase, prompt=VLM_CONSIST_PROMPT)
    del vlm_params
    vlm_train = phase_lm_vlm_train(args.seed, kernels)
    _free_cuda()
    # the reference's production dtype (bf16 params): pixtral, llama3.2-1b and qwen3-moe,
    # each a full-depth prefill of the prefill_32k cell's inputs and training (cut in depth
    # where the state needs it); then five families at 2 layers, the card against the CPU
    # (the CPU sides after the timed phases)
    prod = {phase: phase_prod_prefill(phase, args.seed, kernels) for phase in PROD_PREFILLS}
    prod.update({phase: phase_prod_train(phase, args.seed, kernels) for phase in PROD_TRAINS})
    prod_checks = {phase: phase_prod_consistency(phase, args.seed, kernels)
                   for phase in PROD_CONSISTENCY}
    # the MoE, encoder-decoder, hymba and xLSTM families through the launch layer on the
    # 1 × 1 mesh, each trained at full width against the plain path (MoE's dispatch
    # backward inputs kept for its kernel row)
    mesh_rows, dispatch_in = {}, None
    for phase in MESH_PHASES:
        mesh_rows[phase], extra = phase_lm_family_mesh(phase, args.seed, kernels)
        if extra is not None:
            dispatch_in = extra
    _free_cuda()
    # every path's launches: the engine phases, the serving phases, the op, the LM
    path_rows = engine_rows + [skewed_row] + serving_rows + [es, lm, train, train_check, moe,
                                                             hymba, xlstm, encdec, vlm,
                                                             vlm_train, *prod.values(),
                                                             *prod_checks.values(),
                                                             *mesh_rows.values()]
    launches = {name: sum(row["launches"][name] for row in path_rows) for name in kernels}
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    phase_dryrun_check(wl.base, args.seed, vlm_train, list(prod.values()))

    # kernels at the shapes their paths used (GNN: largest layer caps over both runs)
    caps = {k: max(row["caps"][k] for row in engine_rows) for k in ("e", "r", "f", "fe")}
    rng = np.random.default_rng(args.seed)
    serving = {row["phase"]: row for row in serving_rows}
    chunk = serving["policy"]["chunks"]  # the policy's chunked mode: a mean chunk's shape
    # the offload path's largest compact delta_agg call (gcn, phase offload)
    off_e, off_r, off_live = max(serving["offload"]["delta_agg_compact_shapes"])
    off_check = kernel_delta_agg(_uniform_keys(off_e, off_r, off_live, rng), off_r,
                                 WIDTH + 1, gen)
    off_check["variant"] = "offload_compact"
    results = [
        kernel_segment_spmm(wl.base.in_indptr, WIDTH + 1, gen),  # gcn: [ctx (1) | raw (128)]
        kernel_segment_spmm_subset(caps["fe"], caps["f"], WIDTH + 2, gen, rng),  # gat
        kernel_segment_spmm_subset(next_bucket(chunk["edges_processed"] // chunk["chunks"]),
                                   8192, WIDTH + 1, gen, rng),  # chunked scheduler, gcn
        kernel_delta_agg(_uniform_keys(caps["e"], caps["r"], caps["e"] * 3 // 4, rng),
                         caps["r"], WIDTH + 1, gen),
        off_check,
    ]
    # the skewed shape: a Zipf in-degree sequence over the engine's n rows
    zipf = zipf_in_indptr(args.n, args.seed)
    skew_spmm = kernel_segment_spmm(zipf, WIDTH + 1, gen, integer=True)
    zipf_keys = np.repeat(np.arange(args.n), np.diff(zipf))[rng.permutation(int(zipf[-1]))]
    skew_delta = kernel_delta_agg(zipf_keys, args.n, WIDTH + 1, gen, iters=20, integer=True)
    for row in (skew_spmm, skew_delta):
        row["variant"] = "zipf"
    results += [
        skew_spmm,
        skew_delta,
        kernel_moe_combine(*combine_in),
        kernel_flash_attention(cfg, gen),
        kernel_flash_attention(cfg, gen, "bfloat16"),
        {**kernel_flash_attention(moe_cfg, gen), "variant": "moe_prefill"},  # dh 128
        {**kernel_flash_attention(hymba_cfg, gen, window=hymba_cfg.window),
         "variant": "hymba_prefill"},  # Hq 25 over Hkv 5, the 1024 band
        # the encoder-decoder: the encoder's self attention (non-causal, Sq = Sk; the serve
        # cell's cross attention has this shape too), a cross attention over a source no
        # multiple of the key tile, and the decoder's causal self attention (group 1)
        {**kernel_flash_attention(encdec_cfg, gen, causal=False), "variant": "encdec_encoder"},
        {**kernel_flash_attention(encdec_cfg, gen, causal=False, sk=ENCDEC_CROSS_SK),
         "variant": "encdec_cross"},
        {**kernel_flash_attention(encdec_cfg, gen), "variant": "encdec_decoder"},
        # the vlm: pixtral's prefill over 256 patches + 2,048 tokens at head dim 160, in
        # the path's fp32 and in bf16
        {**kernel_flash_attention(vlm_cfg, gen, s=vlm_cfg.num_patches + LM_PROMPT),
         "variant": "vlm_prefill"},
        {**kernel_flash_attention(vlm_cfg, gen, "bfloat16", s=vlm_cfg.num_patches + LM_PROMPT),
         "variant": "vlm_prefill_bf16"},
        # the production dtype's prefill (lm_vlm_prod_prefill's shape: B 2, 33,024
        # positions), held on the last 256 query rows of every head
        {**kernel_flash_attention(vlm_cfg, gen, "bfloat16", b=PROD_BATCH,
                                  s=vlm_cfg.num_patches + PROD_PREFILL_SEQ, tail=256),
         "variant": "vlm_prod_prefill_bf16"},
        # and lm_vlm_prod_train's (B 2, 256 patches + 4,096 tokens), held whole
        {**kernel_flash_attention(vlm_cfg, gen, "bfloat16", b=PROD_BATCH,
                                  s=vlm_cfg.num_patches + PROD_TRAIN_SEQ),
         "variant": "vlm_prod_train_bf16"},
        # the production dtype's dh-64 and dh-128 kernels: lm_prod_prefill's shape (B 2,
        # 32,768 positions) held on the last 256 query rows of every head, lm_prod_train's
        # (B 2, 4,096), qwen3-moe's prefill (Hq 32 over Hkv 4, dh 128), hymba's band, the
        # encoder's self attention and a cross attention over a ragged source
        {**kernel_flash_attention(cfg, gen, "bfloat16", b=PROD_BATCH, s=PROD_PREFILL_SEQ,
                                  tail=256), "variant": "lm_prod_prefill_bf16"},
        {**kernel_flash_attention(cfg, gen, "bfloat16", b=PROD_BATCH, s=PROD_TRAIN_SEQ),
         "variant": "lm_prod_train_bf16"},
        {**kernel_flash_attention(moe_cfg, gen, "bfloat16"), "variant": "moe_prefill_bf16"},
        {**kernel_flash_attention(hymba_cfg, gen, "bfloat16", window=hymba_cfg.window),
         "variant": "hymba_prefill_bf16"},
        {**kernel_flash_attention(encdec_cfg, gen, "bfloat16", causal=False),
         "variant": "encdec_encoder_bf16"},
        {**kernel_flash_attention(encdec_cfg, gen, "bfloat16", causal=False, sk=ENCDEC_CROSS_SK),
         "variant": "encdec_cross_bf16"},
        kernel_flash_attention_bwd(cfg, gen),
        kernel_flash_attention_bwd(cfg, gen, "bfloat16"),
        # the vlm's training shape: 256 patches + 2,048 tokens at head dim 160
        *({**kernel_flash_attention_bwd(vlm_cfg, gen, dt, b=VLM_TRAIN_BATCH,
                                         s=vlm_cfg.num_patches + TRAIN_SEQ),
           "variant": "vlm_train" + ("" if dt == "float32" else "_bf16")}
          for dt in ("float32", "bfloat16")),
        # lm_vlm_prod_train's shape at the production dtype (B 2, S 4,352)
        {**kernel_flash_attention_bwd(vlm_cfg, gen, "bfloat16", b=PROD_BATCH,
                                      s=vlm_cfg.num_patches + PROD_TRAIN_SEQ),
         "variant": "vlm_prod_train_bf16"},
        # the mesh phases' training shapes (B 2, S 2048): hymba's windowed layer (Hq 25 over
        # Hkv 5, window 1024), the encoder's self attention and the cross attention, here
        # over a ragged source (Sk 1,999)
        {**kernel_flash_attention_bwd(hymba_cfg, gen, b=MESH_BATCH, s=MESH_SEQ,
                                      window=hymba_cfg.window), "variant": "hymba_train"},
        {**kernel_flash_attention_bwd(encdec_cfg, gen, b=MESH_BATCH, s=MESH_SEQ, causal=False),
         "variant": "encdec_encoder_train"},
        {**kernel_flash_attention_bwd(encdec_cfg, gen, b=MESH_BATCH, s=MESH_SEQ, causal=False,
                                      sk=ENCDEC_CROSS_SK), "variant": "encdec_cross_train"},
        # the production dtype's training: lm_prod_train's shape (B 2, S 4,096, dh 64),
        # lm_moe_prod_train's (Hq 32 over Hkv 4, dh 128), and hymba's band, the encoder's
        # self attention and the ragged cross attention at the mesh phases' shapes, in bf16
        {**kernel_flash_attention_bwd(cfg, gen, "bfloat16", b=PROD_BATCH, s=PROD_TRAIN_SEQ),
         "variant": "lm_prod_train_bf16"},
        {**kernel_flash_attention_bwd(moe_cfg, gen, "bfloat16", b=PROD_BATCH, s=PROD_TRAIN_SEQ),
         "variant": "moe_prod_train_bf16"},
        {**kernel_flash_attention_bwd(hymba_cfg, gen, "bfloat16", b=MESH_BATCH, s=MESH_SEQ,
                                      window=hymba_cfg.window), "variant": "hymba_train_bf16"},
        {**kernel_flash_attention_bwd(encdec_cfg, gen, "bfloat16", b=MESH_BATCH, s=MESH_SEQ,
                                      causal=False), "variant": "encdec_encoder_train_bf16"},
        {**kernel_flash_attention_bwd(encdec_cfg, gen, "bfloat16", b=MESH_BATCH, s=MESH_SEQ,
                                      causal=False, sk=ENCDEC_CROSS_SK),
         "variant": "encdec_cross_train_bf16"},
        # the MoE dispatch gather's backward: its records' gradients summed per token
        {**kernel_moe_combine(*dispatch_in), "variant": "moe_dispatch_backward"},
        kernel_edge_softmax(wl.base, gen),
        *kernel_row_linear(wl.base.n, wl.base.num_edges, caps["r"], gen),
        *kernel_row_sum_chunked(zipf, zipf_keys, WIDTH + 1, gen),
    ]
    del zipf_keys
    for res in results:
        emit({"phase": "kernel", **res})
        ok = res["within_tol"] if "within_tol" in res else res["max_abs_err"] <= TOL_KERNEL
        if not ok:
            raise AssertionError(f"{res['name']}: kernel vs plain max|Δ| {res['max_abs_err']}")

    summary = []
    for res in results:
        if "plain_ms" not in res or "variant" in res:
            continue
        name = res["name"]
        info = {k: KERNEL_INFO[name][k] for k in ("source", "replaces")}
        entry = {"name": name, "route": "cuda", **info,
                 "launches": launches[name], "max_abs_err": res["max_abs_err"],
                 "ms": res["ms"], "plain_ms": res["plain_ms"],
                 "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                 "library_ms": res["library_ms"]}
        for extra in ("bound_share", "host_us_per_call", "fp32_simt_bound_ms", "general_ms"):
            if extra in res:
                entry[extra] = res[extra]
        if name in ("segment_spmm", "flash_attention"):  # of which the MoE serve path's
            entry["launches_lm_moe_serve"] = moe["launches"][name]
        if name == "flash_attention":  # and hymba's, the encoder-decoder's and the vlm's
            entry["launches_lm_hymba_serve"] = hymba["launches"][name]
            entry["launches_lm_encdec_serve"] = encdec["launches"][name]
            entry["launches_lm_vlm_serve"] = vlm["launches"][name]
            entry["launches_lm_vlm_train"] = vlm_train["launches"][name]
            for phase, row in {**prod, **prod_checks}.items():
                entry[f"launches_{phase}"] = row["launches"][name]
            entry["launches_lm_encdec_serve_non_causal"] = encdec[
                "prefill_attention_calls"]["non_causal"]
        if name == "flash_attention_bwd":  # two entries a backward, and the paths that ran it
            entry["launches_by_entry"] = train["bwd_launches_by_entry"]
            entry["launches_by_path"] = {row["phase"]: row["launches"][name]
                                         for row in (train, train_check, vlm_train,
                                                     *(prod[p] for p in PROD_TRAINS),
                                                     *prod_checks.values(),
                                                     *mesh_rows.values())}
            entry["launches_by_entry_lm_vlm_train"] = vlm_train["bwd_launches_by_entry"]
            for phase in PROD_TRAINS:
                entry[f"launches_by_entry_{phase}"] = prod[phase]["bwd_launches_by_entry"]
        if name in ("segment_spmm", "flash_attention", "flash_attention_bwd"):
            for phase, row in mesh_rows.items():  # the mesh phases' four runs, and by kind
                entry[f"launches_{phase}"] = row["launches"][name]
                if name == "segment_spmm" and row["mesh_run"]["combines"]:
                    entry[f"calls_{phase}_mesh_train"] = row["mesh_run"]["combines"]
                if name != "segment_spmm" and row["mesh_run"]["attention_calls"]["forward"]:
                    way = "forward" if name == "flash_attention" else "backward"
                    entry[f"calls_{phase}_mesh_train"] = row["mesh_run"]["attention_calls"][way]
        others = [{k: r[k] for k in ("variant", "shape", "max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "bound_share", "library_ms",
                                     "general_ms", "within_tol", "host_us_per_call",
                                     "held_rows", "library_max_abs_err",
                                     "repeat_bitwise", "bitwise_repeat",
                                     "chunked_order_bitwise")
                   if k in r}
                  for r in results if r["name"] == name and "variant" in r]
        if others:
            entry["variants"] = others
        summary.append(entry)
    emit({"kernels": summary})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
