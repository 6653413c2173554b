#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (pdf_table_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the two kernel sources in ops/kernels/csrc
     (deform_conv, resize_norm), one nvcc each, started together; prints
     ptxas's registers and spills per kernel function;
  3. kernels: the deform-conv kernel's tap mode (K1) against its plain
     PyTorch version at every LORE DCN shape (768^2 crops and the 384/512
     buckets, B=2), bf16 and one f32 shape; then at the main paths' own
     shapes (one sub-batch of 8 crops at 768^2 and at 1024^2), timed
     beside each call's bound and torch.matmul of the bf16 tap columns;
     its flat-kc mode (K2) against the plain chunked version at the wtw
     slice's stride-4 shape (8 x 256^2 x 64 -> 64) and two small ones (one
     ragged in pixels with Cout = 72), timed at the slice's shape beside
     its bound and torch.matmul of the corner-rounded rows; both modes
     also against the plain version on the inputs cast to f32, and at a
     strided and a dilated geometry against their plain versions; the
     resize+normalize kernel (K3) against its plain version at the three
     page buckets' detector sizes (N = 1 and 8), two upscales and both
     norm styles, through both of its bodies where the vector body takes
     the shape (and the default route must be the shape rule's); both
     bodies timed at the three buckets, the plain version and
     F.interpolate + normalize at the detection slice's shape, beside the
     bound; K1's f32 body (bench.py's default dtype; 3xTF32 on the
     tensor cores) at every wireless DCN of a sub-batch of 8 at 768^2,
     512^2 and 384^2 and every DCN of one at 1024^2: against the plain
     version, against deform_conv2d_3xtf32_plain (its own rounding points)
     and against an f64 evaluation of the same columns (at most twice the
     plain f32 version's error there), timed beside its bounds (3xTF32 and
     the CUDA cores' f32 peak) and torch.matmul of the built f32 columns;
  4. LORE wireless slice: OcrTableStructureTask(model="Lore",
     task_type="wireless", dtype="bfloat16") at full LORE width over 4
     synthetic 1224x950 pages with 2 table regions each, on numpy-seeded
     weights (offset convs perturbed), down to per-table HTML; the launch
     count shows the path went through K1; a yardstick
     LoreModel(plain_dcn=True) on the same weights and crops holds its
     outputs;
  5. LORE wtw slice: the same with task_type="wtw" (1024^2, corner
     decode, dense vertex refine): the 8 crops run as one 1024^2
     sub-batch, whose forward launches K2 5 times (the five stride-4 DCNs,
     all 9 taps each) and K1 11 times, and runs no row gather; snapped
     vertices and valid cells are counted, the yardstick holds its
     outputs, the refine on the card equals the CPU's on the task's own
     decode, crops/s, peak memory and the device's idle share (from a
     device-only trace of one run) are printed;
  6. detection slice: OcrDetectionTask(model="PP-OCRv4_det") at full
     width, f32, over 8 synthetic 1224x950 pages (one chunk: bucket
     1280x960, detector input 960x720) down to page quads, with the
     bench's detection overrides; the launch count shows the chunk went
     through K3; a yardstick run (the same model on
     resize_normalize_plain's input) holds the input, the prob maps and
     the uint8 maps, and the device boxes match the CPU's; stage times and
     the device's idle share; the trace must show K3's vector body;
  7. recognition slice: OcrRecognitionTask(model="PP-OCRv4_rec") with the
     0/180 textline classifier, both at full width, f32, over the same 8
     pages' canvases resident on the card and 31 text quads a page (the
     bench's line grid of up to 30 axis-aligned quads, 120-360 px wide and
     22 px tall, plus one tilted quad, so that the homography sampler runs
     once), down to texts. Seeded weights with BatchNorm statistics
     calibrated on strips of the pages, and the classifier's bias shifted
     so that half of the crops flip. The lane launches none of K1-K3 (the
     JAX lane reaches no Pallas kernel). The packed decode of the card is
     held against the same port on the CPU, texts against the charset;
     crops/s, stage times, peak memory and the device's idle share;
  8. layout: OcrLayoutTask(model="picodet") at full width
     (picodet_lcnet_x1_0, 800x608, f32) with bench.py's table arguments
     (task_type="table", score_threshold=0.05, keep_top_k=2) on the
     detection phase's 8 canvases, resident on the card: the antialiased
     resize as two matmuls, PicoDet, the GFL decode + top-k and the
     fixed-point NMS on the card. Seeded weights, BatchNorm scale 0.2 and
     statistics calibrated on the canvases. The lane launches none of
     K1-K3. Pages/s, stage times (with the NMS's rounds), peak memory and
     idle share; the card's survivors against the same port on the CPU
     (boxes within 0.5 px, the same labels, scores within 1e-4) at the
     bench's arguments, and the share matched in any order at
     keep_top_k 50;
 8b. surface: the device ops of the JAX package's public surface, each on
     the card and held to the same call with its inputs on the CPU:
     batch_resize_pad_normalize (4 pages cut to 4 sizes, packed, to
     736x576; 1e-4 grey levels), warp_perspective_batch (31 quads of a
     page, 48x320 crops; 1e-4 grey levels), connected_components (a
     page's ink at 1/4 scale; labels equal), nms_mask (the components'
     boxes grown by 12 px, their mean ink as scores; masks equal),
     decode_centernet_bbox (a blurred ink heatmap of the 4 pages, k 100;
     within 1e-5, indices equal) and device_decode_nms (the layout phase's
     PicoDet heads on its 8 canvases; survivors equal, rows within 1e-5 of
     their values). None launches K1-K3. Every export of every package of
     the port resolves; the counts are printed;
  9. pipeline: the port's BatchPipeline.run with bench.py's configuration
     (det thresholds, the table layout head, rec en, LORE wireless f32 with
     res_buckets="auto", use_orientation_cls=False, the 0/180 classifier
     on, bench.py's line grid copied here and injected through
     _boxes_finish) on 16 pages of make_page (two chunks of 8): a warm-up,
     one counted run (K3 once a chunk, K1 16 times a LORE sub-batch, no
     page with an error, every page with page_html, tables through LORE),
     then the median of the timed runs: pages/s, per-lane ms, peak memory,
     idle share, K1's device ms (its trace must show the f32 body,
     dcn_tf32_kernel, as CenterNet's, DocXLayout's and the training
     step's must). On 2 of the pages the card is held against the same
     pipeline on the CPU: quads to 1 px, layout survivors equal, texts
     equal on at least 98 % of crops, page_html byte-equal where its
     inputs are equal;
 9b. pipeline_digital: 8 PDF pages written with the port's PdfWriter
     (three wired tables, two tables on a page, a text-only page, a merged
     header, an A3 landscape page that is scaled to fit 2048x1536, a page
     authored rotated by 90 degrees) and read with the port's reader,
     built here with make and g++, interleaved with 8 raster pages of the
     same canvas size, through the pipeline phase's BatchPipeline.run
     (mixed chunks; the runner renders the digital pages where PIL
     imports, else they carry render_page_vector's image): a warm-up, one
     counted run (K3 once a chunk, K1 16 times a LORE sub-batch of the
     raster pages' tables and the rotated page's, K2 never; no page
     errors: the rotated page runs the serial per-page system; the A3 page
     scaled), timed runs (pages/s, lanes with pdf_text and
     digital_serial, reader and render ms a page, peak memory), idle
     share; every digital page but the rotated one (held in
     system_per_page) against the same pipeline on the CPU: vector text
     cells equal, table_html equal wherever the layout's table regions
     are (the count printed);
 9s. pipeline_scanned: the 16 pages of the pipeline phase written by PIL
     as one PDF of JPEG scans at 144 dpi (page 3 a grey JPEG, page 7 a
     CMYK one), and a seventeenth scan with an invisible OCR text layer
     (render mode 3, the port's PdfWriter), read with the port's reader
     and rendered by the runner (the JPEGs decoded through PIL as
     cv2.imdecode decodes them, placed 1:1) through the pipeline phase's
     BatchPipeline.run: a warm-up, one counted run (K3 once a chunk, K1 16
     times a LORE sub-batch, K2 never; no error page, a table; the 16
     scans take the raster lane and come back is_pdf False, the OCR'd one
     the digital lane and is_pdf True, as in the JAX runner), timed runs
     (pages/s, the rasterize lane against the same run on the decoded
     images); the scans' outputs equal to that run's page for page (quads,
     texts, layout cells, table_html, page_html), 2 scans against the same
     pipeline on the CPU; fails where PIL cannot decode JPEG; renders 2
     pages through render_pdf(backend="ghostscript") where a gs binary is
     on PATH;
 9d. decode: the host image decode (utils/image_io.py) on the card's host,
     which has PIL and no cv2: the fixtures of tests/data/image_decode/
     (a clean JPEG; a corrupt one that libjpeg stops on after its last
     scanline, which decodes; one it stops on before its first, a
     truncated one, an ICO and a TGA, which give None; since the
     twenty-first slice one file per decode F10-F15 of ROADMAP.md Queue 3:
     a 16-bit colour JP2, a corrupt GIF, HDR, PAM, colour and grey PFM, a
     colour-mapped 1-bit Sun raster, PNMs of maxval 100 and 1000, 16-bit
     colour PPM and TIFF, YCbCr and CIELAB TIFF, PNGs with a wrong tEXt and
     IEND CRC) held to the SHA-256 of cv2's decode committed beside them,
     with the paths of the libopenjp2 and libtiff that PIL links (the
     port's JPEG 2000 and TIFF readers call them) printed, the phase
     failing where either is missing; a GIF whose screen is over PIL's
     178,956,970-pixel check, decoded to its background and frame; a
     13,400 x 13,400 flat grey
     JPEG made here, which Image.open refuses as a decompression bomb,
     decoded to its shape and value; a JPEG header of 40,000 x 30,000
     raising ImageDecodeError without a pixel loaded; a 2480 x 3508 ASCII
     P3 and a 16,400^2 grey TIFF in one deflate strip (made by
     make_fixtures.py there; libtiff's scanline route), each decoded to
     its samples and timed; PIL's MAX_IMAGE_PIXELS and
     LOAD_TRUNCATED_IMAGES left as they were; since the twenty-second
     slice the host geometry of F16-F19 (minAreaRect, uint8 and f32
     warpAffine, fillPoly off the image, the f32 resize) on the seeded
     inputs of tests/data/image_decode/host_geometry.py, each output held
     to the SHA-256 of cv2 5.0.0's committed beside it, and timed. No
     kernel runs;
 9e. html: the port's table-HTML parser (utils/html_tree.py) on the
     card's host, which has no lxml: every input of
     tests/data/html_tree/cases.json (the rows of F20, edge cases and
     seeded table soup) parsed, its canonical tree (tests/html_soup.py)
     held to the SHA-256 of lxml 6.1.1 / libxml2 2.14.6's committed
     beside it, and the parse timed. No kernel runs;
 9c. bf16_models: every model that runs bf16 since the twelfth slice, f32
     and bf16 at full width on the trees and inputs of its f32 phase (the
     four DBNets on a chunk of 8 at 960x720, PicoDet on the chunk, the
     four recognizers and the 0/180 PP-LCNet on the 248 crops, the SLANet
     and TableMaster encoders on a sub-batch of 8 crops, LGPMA on one
     crop): forward ms of both dtypes (CUDA events, two rounds), speed-up,
     peak memory, the bf16-vs-f32 gap (printed), the card's bf16 heads
     finite and within BF16_CPU_RMS of the same bf16 model on the CPU on
     the first two inputs;
 9d. pipeline_bf16: the pipeline phase's configuration and 16 pages with
     no dtype passed, so that the port's policy gives bf16 to detection,
     PicoDet, recognition and LORE as JAX's registry does on its
     accelerator: a counted run (K3 once a chunk, K1's bf16 body and K2
     over 16 DCNs a LORE sub-batch, dcn_wgmma_kernel in the trace, no page
     error, every page with HTML), pages/s, lanes, idle share, peak
     memory, and the share of pages whose quad counts, texts and table
     cell counts equal the f32 run's (reported);
 9e. tsr_host_crop: LORE wireless (f32) through the per-crop surface:
     batch_infer on the 8 TSR crops and __call__ on one, crops/s beside
     batch_infer_from_pages on the same regions, 2 crops against the same
     task on the CPU slot by slot on their uint8 warps (valid slots,
     dets, logical coordinates), the cells and table HTML of the crops
     and the call compared and printed. Every phase before 9c pins dtype="float32" where it
     means f32 (F32);
 9f. system_per_page: OcrSystemTask, the per-page system, on the card at
     full width under the default dtype policy (PP-OCRv4 det and rec,
     PicoDet, LORE wireless in bf16; both PULC classifiers on; the
     pipeline phase's trees, the detector's threshold at the 77th
     percentile of the first page's prob map, bench.py's line grid added
     to its quads): ocr() over 6 raster pages
     of 1224x950 (a wired table, the same page skewed by 3 degrees and
     turned by 180, a page turned by 90, two text pages) and 2 digital
     pages (text, a wired table) of digital_pdf: a warm-up, one counted
     run (K1 on LORE's forwards, K3 never: the per-image path resizes on
     the host; the host geometry's ms a page: contours, minAreaRect,
     crops), timed runs (pages/s, timing_summary's stage ms; every border
     of the counted run's maps through the C++ library and through
     tools/contours_py.py, the same algorithm in Python, equal and timed),
     idle share and peak memory; then
     BatchPipeline.run on the rotated digital page (the serial route) and
     the raster pages through the default runner and its
     device_boxes=False and device_crops=False lanes, K1 and K3 counted
     on each; then the same system in f32 on the card against the port on
     the CPU on a raster page and the digital table page: quads to 1 px,
     texts equal on at least 95 % of the cells, layout labels and the
     digital page's HTML equal (page_html equality counted);
 9g. serve: the port's ExtractionService on the card behind make_server on
     127.0.0.1 (an ephemeral port), its runner the pipeline phase's
     configuration and trees under the default dtype policy (bf16 det,
     PicoDet, rec, LORE wireless), warm() before the first request (every
     task built, every kernel's library loaded), its batcher grouping a
     round's 5 requests (default max_wait_ms, so a batch closes on its
     size): a warm-up round, then 16 rounds of 4 raster PNG pages
     (make_page) and one 2-page digital PDF (the port's PdfWriter) posted
     at once: every answer 200, the counters adding up (fewer batches
     than requests), every answer its batch's output, and every page of
     every batch equal (page HTML,
     table HTML) to BatchPipeline.run on the same pages run again;
     /healthz reads "gpu"; the xlsx answer decodes to a worksheet with the
     table's cells; K1 16 a LORE sub-batch and K3 once a chunk of the
     counted rounds; requests/s, pages/s, p50/p95 latency over the 80
     requests, each batch's batcher wait, payload decode and run apart
     (median and sum) and the runner's lanes (median), the idle share of
     a traced round and of its run;
 9h. cli: the port's cli.main.main (the `pdftable` command) on the card,
     its system the per-page phase's (the smoke's trees, the line grid)
     under the CLI's config, on one full-width raster PNG with --debug,
     on the 2-page PDF with --batch_pages 1 and 8 and on a one-page PDF
     holding the PNG's page as a JPEG scan: a warm-up and one counted run
     each; the merged HTML equal to OcrSystemTask's / BatchPipeline.run's
     on the same pages, the debug PNG equal to the rendered overlay, K1 16
     a LORE forward on the image and scan routes, K3 once on the batched
     route;
 10. tsr_slanet and tsr_master: OcrTableStructureTask(model="SLANet")
     (488^2, LCNet 1.0, neck 96, hidden 256) and (model="TableMaster")
     (480^2, D 512, 8 heads, ff 2024, N = 3), f32, T = 500 steps each, on
     8 table regions of 4 synthetic pages resident on the card, through
     batch_infer_from_pages: seeded trees calibrated on the card on the
     task's own crops (SLANet: BatchNorm scale 0.2; TableMaster: its
     variances x 4; the structure logits spread, TableMaster's <UKN>,
     <SOS>, <PAD> out of reach), as the CPU tests' trees. The counted run
     launches none of K1-K3 (the JAX lane reaches no Pallas kernel); crops/s
     (median of runs), stage ms (crop + pre, encoder, decode, download,
     host post), the decode's device launches, peak memory, idle share
     (TableMaster's from the device-only trace alone, no top ops);
     the card against the same port on the CPU on the first two crops
     (one of each size): the inputs bit for bit, teacher-forced
     probabilities and locs within 1e-4 (the CPU's greedy ids as the
     teacher), greedy ids equal up to the CPU's first near-tie. Then
     MtlTabNet: TableMaster's tree plus the
     cell branch's parameters loads into the MtlTabNet task, whose
     structure tokens must equal TableMaster's;
 11. pipeline arms: the pipeline phase's pages through BatchPipeline.run
     with table_structure_model="SLANet" (16 pages) and then
     "TableMaster" (8 pages, one chunk: its decodes are host-bound, some
     2 s a sub-batch of 8) at full width, T = 500, on the trees of phase
     10, built by the system from OcrSystemConfig.table_structure_kwargs:
     a warm-up, one counted run (K3 once a chunk, K1 and K2 never, every
     table a token result, every page with page_html), the median of the
     timed runs (pages/s, lanes, peak memory), idle share; 2 pages (1 for
     TableMaster) against the same pipeline on the CPU as in phase 9;
 12. tsr_centernet: OcrTableStructureTask(model="CenterNet") at full
     width (1024^2, head_conv 256, K 300, MK 600, f32) on the 8 regions of
     phase 10, resident on the card: a seeded tree (offset convs
     perturbed, BatchNorm statistics calibrated on the crops and doubled,
     head biases shaped so that cells pass the 0.3 threshold and vertices
     snap); the counted run launches K1 at each of the trunk's 16 DCNs a
     sub-batch (K2 and K3 never); one bf16 forward of the sub-batch of 8
     prints K1's and K2's launches as the flat-kc route picks them; a
     plain_dcn=True yardstick on the same tree and crops holds the heads;
     the card against the same port on the CPU on 2 crops (inputs, heads,
     the decode's cell and vertex slots up to the first near-tie of their
     scores; the cells reported); crops/s, stage ms (pre, forward,
     decode, download, host post), snapped vertices, peak memory, idle
     share and K1's share of the forward's device time;
 13. tsr_lgpma: OcrTableStructureTask(model="Lgpma") at full width
     (ResNet-50, FPN 256, max side 800, 512 proposals, fc 1024, mask_top
     256, f32), one crop a forward, on the same regions: no K1-K3 launch
     (JAX's lane reaches no Pallas kernel); crops/s, stage ms of one crop,
     peak memory, idle share; the card against the CPU on 2 crops (inputs,
     FPN levels, proposals up to the first near-tie, the bbox, LPMA and
     GPMA heads on the CPU's RoIs, cells where the proposals are equal);
 14. pipeline_centernet: the pipeline arm of phase 11 with
     table_structure_model="CenterNet" (16 pages; K3 once a chunk, K1 16
     times a CenterNet sub-batch; one page against the CPU), then a
     LoreAndLineCell run on the same pages (every table with merged
     cells);
 15. layout_docx: OcrLayoutTask(model="DocXLayout") at full width
     (768^2, head_conv 256, top_k 100, f32) on the detection phase's 8
     canvases, resident on the card: each canvas warped to 768^2 as the
     JAX pre-processor's cv2.warpAffine does, one forward of the 8, the
     4-point decode on the card, the polygon NMS on the host. A seeded
     tree (offset convs perturbed, BatchNorm statistics calibrated on the
     warped canvases and doubled, heatmap biases at 0 with the "table"
     class lifted, the wh bias a +-20 px quad). The counted run launches K1
     16 times a forward (the f32 body) and K2 and K3 never; pages/s, stage
     ms (warp + normalize, forward, decode, download, host pnms), peak
     memory, idle share and K1's share of the forward's device time; one
     bf16 forward prints K1's and K2's launches as the flat-kc route
     picks them; a plain_dcn=True yardstick holds the heads; 2 canvases
     against the same port on the CPU (the warped input, the heads, the
     cells up to the first near-tie of their scores);
 16. pipeline_docx: the pipeline phase's 16 pages through
     BatchPipeline.run with layout_model="DocXLayout" on that tree and
     LORE wireless f32: a warm-up, one counted run (K3 once a chunk, K1 16
     times for each DocXLayout forward and each LORE sub-batch, K2 never,
     tables through LORE), a timed run, idle share; one page against the
     same pipeline on the CPU (layout cells up to the first near-tie);
 17. det_backbones: OcrDetectionTask with db_resnet18, db_resnet50 and
     db_proxylessnas at full width, f32, on the detection phase's 8 pages
     (one chunk, 960x720, the modelscope normalization on K3): seeded
     trees calibrated on the card (variances doubled), the threshold at
     the 80th percentile of the first page's map; per model the counted
     run (K3 once a chunk, K1 and K2 never), pages/s, forward ms,
     peak memory, idle share, the prob maps on K3's input against a
     yardstick on resize_normalize_plain's, and 2 pages' quads against
     the same port on the CPU (equal where the uint8 maps are);
 18. rec_backbones: OcrRecognitionTask with CRNN, ConvNextViT (every crop
     warped to 804 px, three 300 px chunks, their logits joined before
     the decode) and LightweightEdge at full width, f32, with the
     recognition phase's 0/180 classifier, canvases and quads: per model
     the counted run (no K1-K3 launch; the JAX lane reaches no Pallas
     kernel), crops/s, forward ms, peak memory, idle share, and the
     packed decode of 2 pages' crops against the same port on the CPU;
 19. train: LORE training at full width (LoreConfig.wtw(), f32, B = 4,
     1024^2), K1 made differentiable by DeformConv2dFunction. (a) At the
     7 DCN shapes of a wtw step (16 calls), the Function's forward and its
     gradients (dx, doffset, dmask, dW, dbias) against autograd of the
     plain version on the card, plus one bf16 shape each through K1 and
     K2, also held on dyadic inputs against f64 autograd of
     deform_conv2d_rounded (the backward's bf16 rounding points, to f32
     round-off); forward and backward ms per DCN and per step beside
     their bounds. (b) LoreTrainer on 4 synthetic wired tables, constant
     schedule: the first step against the same step of a plain_dcn model
     from the same tree (loss terms, the gradient norm, the unreached
     leaves, the largest parameter difference after the step), every
     params leaf with a finite gradient, K1 launched 16 times a counted
     step (32 under remat, whose stage-by-stage checkpoints must lower
     the step's memory), the loss falling over 8 steps on the one
     batch, median step ms, images/s, peak memory, idle share of a traced
     step. (c) save_train_state, restore into a fresh trainer: its next
     step equals the live one bit for bit (deterministic algorithms on).
  train_det: train_quick_detector on the card with the bench's detector
     config (PP-OCRv4 det, f32, 320 px, batch 4, lr 1e-3, bench.py's 250
     steps of its bar pages): the loss must fall, the first three steps'
     losses are held to the same steps on the CPU (1e-4, then 1e-3: Adam's
     round-off amplification), median step ms, images/s, peak memory,
     idle share of a traced step (all read through the trainer's on_step
     hook), no K1-K3 launch; the trained tree in the detection task with
     the bench's trained thresholds (0.3 / 0.55) on 8 bench pages must
     find a box on each, boxes a page printed; one ctc_loss step of
     PP-OCRv4 rec
     (32 crops, 48x160) against the CPU's (loss 1e-4, gradients 1e-3 of
     each leaf's largest magnitude).
  convert: PP-OCRv4 det converted through the converter's ONNX route and a
     seeded LORE-wireless tree saved with its writer into a temporary
     model cache; the detection and LORE tasks built without
     ``variables`` on the card give outputs bit-equal to the same tasks
     given the trees, K1 and K3 launched.
  det_polygon: DBNet's polygon mode (approxPolyDP, the 0.7 score filter,
     the vertex offset) with train_det's tree on 4 bench pages, the card
     against the CPU: prob maps within 1e-4, a pixel that changes sides
     of the threshold within that of it, polygons equal where none does.
  flops: model FLOPs (utils/flops.py) of each bench-configuration model's
     forward at its largest call in one BatchPipeline.run of the 16 pages,
     and of the run, over device ms and wall time: TFLOP/s and MFU against
     the card's dense peak for the dtype, in bf16 and f32; a LORE
     sub-batch's count equal with K1 and with the plain DCN.
  parallel: a one-rank NCCL group: BatchPipeline(mesh) on the 16 pages
     against the meshless run (the pipeline phase's rules), K1 and K3
     launched; GPipe at one stage and the dp LORE step at world size 1
     bit-equal to their meshless counterparts; then two spawned gloo
     ranks on cuda:0 run the pages 8 and 8, and rank 0's gathered outputs
     hold the same rules against the meshless run.
  train_mesh: LoreTrainer(LoreConfig.wtw()) at full width on a (dp 1, tp
     2, sp 2) mesh of four spawned gloo ranks on cuda:0, 2 steps of a
     global batch of 2 at 1024^2, against the meshless step: losses,
     params after step 1, replicated leaves bit-equal across the ranks,
     K1 launched at each DCN's columns (the two tp-split ones at 128).
(After geometry, windows: K1's two bodies and K2 over output row windows
bit-equal to the whole call's rows.)
Prints each phase's wall seconds ({"phase_s": {...}}), the card line,
one {"kernels": [...]} line, and as the last line {"ok": true, "device":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM, dense; "float32" on the CUDA cores, "3xtf32" the f32 body's
# three tf32 products on the tensor cores (494.7 TFLOP/s tf32 / 3)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 494.7e12 / 3}
PEAK_BYTES = 3.35e12
REPLACES = "pdf_table_tpu/ops/pallas/deform_blend.py:190"
SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/deform_conv.cu"
FK_REPLACES = "pdf_table_tpu/ops/pallas/deform_blend.py:83"
RN_REPLACES = "pdf_table_tpu/ops/pallas/resize_norm.py:61"
RN_SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/resize_norm.cu"
# every LORE DCN at a 768^2 crop: (side, Cin, Cout, calls per forward)
DCN_SHAPES_768 = [(192, 64, 64, 5), (96, 128, 64, 4), (96, 128, 128, 2),
                  (48, 256, 128, 2), (48, 256, 256, 1), (48, 256, 64, 1),
                  (24, 512, 256, 1)]
# every LORE DCN at a 1024^2 crop (the wtw slice); the first level takes
# the flat-kc route at B=8
DCN_SHAPES_1024 = [(256, 64, 64, 5), (128, 128, 64, 4), (128, 128, 128, 2),
                   (64, 256, 128, 2), (64, 256, 256, 1), (64, 256, 64, 1),
                   (32, 512, 256, 1)]
MAIN_BATCH = 8   # both LORE slices run their 8 crops as one sub-batch
# K2 cases (B, H, W, Cin, Cout): the wtw slice's stride-4 DCN, then two
# small ones (one ragged in pixels, with Cout = 72)
FK_CASES = [(MAIN_BATCH, 256, 256, 64, 64), (1, 25, 40, 64, 72),
            (2, 32, 32, 128, 64)]
FK_CALLS = 5     # stride-4 DCNs per wtw forward, one launch each
# max |err| / max |plain out|. K1 against the plain version: the same bf16
# column (the same f32 blend, one rounding) and f32 sums in another order;
# a column that rounds the other way at a tie shows as ~1e-5. K2 against
# the plain chunked version: the same bf16 products, f32 sums in another
# order. f32: the same operands, f32 sums in another order.
TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# K1's f32 body against deform_conv2d_3xtf32_plain (the same tf32 split
# of the same columns and W; f32 sums in another order: tensor-core groups
# of 8 per K step against torch's matmul, each some 3e-7 of max |out| from
# exact at the LORE depths), max |err| / max |plain out|; and against an
# f64 evaluation of the same f32 columns, at most F64_RATIO times the plain
# f32 version's error there
TF32_TOL = 2e-6
F64_RATIO = 2.0
FK_TOL = 1e-4
# either mode against the plain version on the same inputs cast to f32:
# the bf16 roundings of the column (K1) or of w4 and each corner's
# product (K2), 2^-9 relative each
F32_TOL = 1e-2
# yardstick run (bf16 model, deform conv kernel vs plain): both sum the DCN
# in f32 in another order, so bf16 roundings of activations flip and spread
# through ~40 layers
HEADS_TOL = 5e-2        # max |diff| / max |head| per head
MATCH_MIN = 0.9         # share of valid slots found in both runs
DETS_TOL = 0.25         # feature-map px, on slots valid in both runs
LOGI_TOL = 5e-2         # max |diff| / max |logi|, same slots
# random weights put the cell heatmap near sigmoid(-2.19) = 0.10, so the
# smoke lowers the threshold for valid cells to exist
VIS_THRESH = 0.1
# wtw: the corner heatmap sits at the same level, so corners count from
# 0.1; cells the refine penalizes (x 0.4, <= 2 snap events) fall to ~0.04,
# so valid cells count from there
WTW_VIS_THRESH = 0.04
WTW_VIS_CORNER = 0.1
# resize+normalize: (N, canvas H, W) -> detector (Ho, Wo); the three page
# buckets at their PP-OCRv4 sizes, N = 1 and the slice's chunk of 8, and
# two upscales (360-px rows are off 16 bytes and take the scalar body,
# 368-px rows the vector body). The first 8-canvas case is the slice's
# shape.
RN_BUCKETS = (((1280, 960), (960, 720)), ((1600, 1280), (960, 768)),
              ((2048, 1536), (960, 720)))
RN_CASES = [(n, hw, det) for hw, det in RN_BUCKETS for n in (8, 1)] \
    + [(2, (480, 360), (960, 720)), (2, (480, 368), (960, 720))]
# both sides compute in f32 and differ only in summation order
RN_TOL = 1e-5
# every phase that means f32 names it: on the card the dtype policy
# (engine/device.py::default_dtype) gives the registry models bf16
F32 = dict(dtype="float32")
# F.interpolate computes the source coordinate in f32 (the tap tables in
# f64), so its weights differ by ~1e-4 near the canvas' far edge
RN_LIBRARY_TOL = 1e-2
# detection yardstick (f32 model on the kernel's vs the plain version's
# input, which differ by <= RN_TOL): prob maps and the share of uint8 map
# pixels that may differ (rounding boundaries)
DET_PROB_TOL = 1e-4
DET_U8_SHARE = 1e-4
# device boxes on the card vs the CPU: the mean-prob column is an f32 sum
# taken in another order
CC_MEAN_RTOL = 1e-6
# the bench's detection overrides (bench.py:76-78): random weights find no
# text at the PP-OCRv4 defaults
DET_KW = dict(thresh=0.45, box_thresh=0.0, max_candidates=48, **F32)
DET_PAGES = 8
# recognition slice: the card against the port on the CPU, same weights and
# inputs, both f32. Share of crops whose ids and keep masks are all equal
# (seeded logits can sit near a tie, and a crop near the flip threshold can
# go the other way), and the confidence difference on those crops (a mean
# of softmax maxima over f32 forwards that sum in another order)
REC_EQUAL_MIN = 0.95
REC_CONF_TOL = 1e-3
REC_LINES = 30          # the bench's line grid per page
# layout phase: bench.py's table arguments (bench.py:79-81); the seeded
# tree's BatchNorm scale and head gain (see layout_tree); the card against
# the CPU: boxes in canvas px (800x608 input from 1280x960 canvases, 1.6
# canvas px a model px), scores (f32 sums in another order)
LAYOUT_KW = dict(task_type="table", score_threshold=0.05, keep_top_k=2,
                 **F32)
LAYOUT_BN_SCALE = 0.2
LAYOUT_HEAD_GAIN = 4.0
LAYOUT_BOX_TOL = 0.5
LAYOUT_SCORE_TOL = 1e-4
# pipeline phase: 16 pages = two chunks of 8, LORE in bench.py's f32;
# timed runs after one warm-up; the card against the CPU on 2 pages
# (quads to 1 px, texts equal on at least 98 % of crops)
PIPE_PAGES = 16
PIPE_RUNS = 3
PIPE_CPU_PAGES = 2
PIPE_LORE_KW = dict(vis_thresh=VIS_THRESH, **F32)
PIPE_QUAD_TOL = 1.0
PIPE_TEXT_MIN = 0.98
# pipeline_digital: 8 raster pages of the digital pages' canvas bucket
# beside the 8 digital pages; timed runs after the warm-up and the counted
# run
DIGITAL_RASTER = 8
DIGITAL_RUNS = 1
# pipeline_scanned: the pages written as a grey and a CMYK JPEG, timed runs
# after the counted one, scans held against the CPU, and the largest mean
# grey-level difference of a decoded scan from its page (JPEG's loss)
SCAN_GREY, SCAN_CMYK = 3, 7
# decode: a JPEG side just over twice PIL's MAX_IMAGE_PIXELS
DECODE_BIG_SIDE = 13400
SCAN_RUNS = 2
SCAN_CPU_PAGES = 2
SCAN_JPEG_MEAN = 4.0
# train phase: the wtw step at full width, f32, B = 4 (LoreTrainArgs'
# default); the first step through the kernel against the plain-DCN model
# (f32 on both sides, sums in another order): each loss term, the global
# gradient norm; the Function's gradients against autograd of the plain
# version per DCN shape (relative to each gradient's max), f32 and bf16
# (autograd of the bf16 plain versions accumulates dx in bf16, and the
# flat-kc dW sums corners rounded one by one)
TRAIN_BATCH = 4
TRAIN_STEPS = 8
TRAIN_LR = 1e-4
TRAIN_LOSS_TOL = 1e-5
TRAIN_NORM_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
TRAIN_BF16_GRAD_TOL = 3e-2
# the bf16 backward on dyadic inputs against f64 autograd of
# deform_conv2d_rounded (the rounding points written out as casts): the
# rounded values agree exactly, the f32 gradients to round-off; the bf16
# ones (dx, and dW through the Function) within bf16's unit roundoff, as a
# correct rounding is
TRAIN_ROUNDED_TOL = 1e-6
BF16_ROUNDOFF = 2.0 ** -8
TRAIN_BF16_SHAPE = (2, 64, 64, 64, 64)       # (B, H, W, Cin, Cout)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def make_page(seed: int, h: int = 1224, w: int = 950):
    """Synthetic text-like page: dark line bars on white (bench.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    y = 60
    while y < h - 60:
        n_words = rng.integers(3, 8)
        x = 70
        for _ in range(n_words):
            ww = int(rng.integers(60, 160))
            if x + ww > w - 70:
                break
            img[y:y + 16, x:x + ww] = rng.integers(20, 60)
            x += ww + 18
        y += int(rng.integers(26, 40))
    return img


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 100, replays: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of a CUDA
    graph that holds ``launches`` calls, the least of ``replays``. For a
    kernel that runs tens of microseconds: between eager launches the
    host's own cost per call can exceed that, and the events then time
    the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


def host_ms(fn, iters: int = 5) -> float:
    """Host clock around ``iters`` calls that end in a synchronize, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def dcn_bound(b, h, w, cin, cout, dtype: str, corners: int = 1,
              peak: str = ""):
    """Least time for one DCN call: max(ops / peak, compulsory bytes /
    rate). Bytes: x, offset, mask, W and bias read once, the f32 output
    written once; operations: the contraction, ``corners`` times as deep
    where each corner is contracted on its own (flat-kc mode), at the
    ``peak`` rate of PEAK_FLOPS (default: bf16's for bf16, the 3xTF32
    rate for f32, as the f32 body computes)."""
    esize = 2 if dtype == "bfloat16" else 4
    px = b * h * w
    flops = 2 * px * 9 * corners * cin * cout
    nbytes = (px * cin * esize + px * 18 * 4 + px * 9 * 4
              + 9 * cin * cout * esize + cout * 4 + px * cout * 4)
    rate = PEAK_FLOPS[peak or ("bfloat16" if dtype == "bfloat16"
                               else "3xtf32")]
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def dcn_inputs(gen, b, h, w, cin, cout, dt, out_hw=None):
    """x, offset (3 px spread), mask, W (He scale) and bias on the card;
    offset and mask at ``out_hw`` (default: the input's size)."""
    import torch

    ho, wo = out_hw or (h, w)
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dt)
    off = torch.randn(b, ho, wo, 18, device="cuda", generator=gen) * 3.0
    mask = torch.rand(b, ho, wo, 9, device="cuda", generator=gen)
    wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
          * (2.0 / (9 * cin)) ** 0.5).to(dt)
    bias = torch.randn(cout, device="cuda", generator=gen)
    return x, off, mask, wt, bias


def errors(got, want) -> tuple:
    """(max |got - want|, that over max |want|)."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max())


def f32_rel_err(got, args) -> float:
    """``got`` against the plain version on the same inputs cast to f32."""
    from pdf_table_tpu_torch.ops.deform_conv import deform_conv2d_plain

    x, off, mask, wt, bias = args
    return errors(got, deform_conv2d_plain(x.float(), off, mask, wt.float(),
                                           bias))[1]


def tiling(b, h, w, cin, cout, flat_kc, dtype="bfloat16") -> dict:
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (kernel_tiling,
                                                     kernel_tiling_f32)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if dtype == "float32":
        n, wgs, splits, tg = kernel_tiling_f32(b * h * w, cout, cin, 9, sms)
        return {"n_tile": n, "pixels_per_block": 64 * wgs,
                "cout_splits": splits, "taps_per_group": tg}
    n, wgs, splits = kernel_tiling(b * h * w, cout, flat_kc, sms)
    return {"n_tile": n, "pixels_per_block": 64 * wgs, "cout_splits": splits}


def f32_body_errors(got, plain, args) -> dict:
    """K1's f32 body against its plain twin at its own rounding points
    (deform_conv2d_3xtf32_plain), and the body and the plain f32 version
    against an f64 evaluation of the same f32 columns (max |err| over max
    |f64 out|)."""
    from pdf_table_tpu_torch.ops.deform_conv import (
        deform_conv2d_3xtf32_plain, tap_columns)

    x, off, mask, wt, bias = args
    cin, cout = wt.shape[2:]
    wd = wt.reshape(9, cin, cout).double()
    ref = None
    for t, col in enumerate(tap_columns(x, off, mask, (3, 3))):
        part = col.double() @ wd[t]
        ref = part if ref is None else ref.add_(part)
    ref = ref.add_(bias.double()).reshape(got.shape)
    scale = float(ref.abs().max())
    out = {"f64_err": float((got.double() - ref).abs().max()) / scale,
           "plain_f64_err": float((plain.double() - ref).abs().max())
           / scale}
    del ref
    out["f64_ratio"] = out["f64_err"] / out["plain_f64_err"]
    out["tf32_plain_rel_err"] = errors(got, deform_conv2d_3xtf32_plain(
        *args))[1]
    return out


def timed(row, fn, plain, library, bound) -> None:
    """Kernel, plain and library ms (CUDA events) and the bound into
    ``row``."""
    t_min, t_ops, t_bytes = bound
    row.update(ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 3, 1),
               library_ms=cuda_ms(library, 20), bound_ms=t_min,
               ops_ms=t_ops, bytes_ms=t_bytes,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    row["x_bound"] = row["ms"] / t_min


def phase_kernels(gen):
    """K1 (the tap mode) against its plain version at every LORE DCN
    shape; timed at the slices' sub-batch shapes beside its bound and the
    library yardstick: torch.matmul of the already-built tap columns,
    (B*HW, 9*Cin) @ (9*Cin, Cout), the contraction alone on cuBLAS."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (deform_conv2d_plain,
                                                     deform_conv2d_tap,
                                                     flat_kc_route,
                                                     tap_columns)
    from pdf_table_tpu_torch.ops.kernels import launch_counts

    # (crop side, fmap side, Cin, Cout, calls per forward, dtype, batch)
    cases = [(768, hw, ci, co, n, "bfloat16", 2)
             for hw, ci, co, n in DCN_SHAPES_768]
    for side in (384, 512):
        cases += [(side, hw * side // 768, ci, co, n, "bfloat16", 2)
                  for hw, ci, co, n in DCN_SHAPES_768]
    cases.append((768, 48, 256, 128, 2, "float32", 2))
    # the f32 body (bench.py's default dtype, the pipeline phase's LORE,
    # DocXLayout) at every wireless DCN of a sub-batch of 8, at 768^2 and
    # the 384/512 buckets, and at every DCN of a 1024^2 sub-batch of 8
    # (Cycle-CenterNet's and wtw's f32 path)
    for side in (768, 384, 512):
        cases += [(side, hw * side // 768, ci, co, n, "float32", MAIN_BATCH)
                  for hw, ci, co, n in DCN_SHAPES_768]
    cases += [(1024, hw, ci, co, n, "float32", MAIN_BATCH)
              for hw, ci, co, n in DCN_SHAPES_1024]
    cases += [(768, hw, ci, co, n, "bfloat16", MAIN_BATCH)
              for hw, ci, co, n in DCN_SHAPES_768]
    cases += [(1024, hw, ci, co, n, "bfloat16", MAIN_BATCH)
              for hw, ci, co, n in DCN_SHAPES_1024]
    rows = []
    for crop, hw, cin, cout, calls, dname, B in cases:
        dt = getattr(torch, dname)
        args = dcn_inputs(gen, B, hw, hw, cin, cout, dt)
        flat_kc = flat_kc_route(B, hw, hw, cin, 9, cout, dt)
        # K1 itself at every shape, the flat-kc route's included
        n0 = launch_counts["deform_conv2d"]
        got = deform_conv2d_tap(*args)
        torch.cuda.synchronize()
        check(launch_counts["deform_conv2d"] == n0 + 1,
              "deform_conv2d did not count its launch")
        plain = deform_conv2d_plain(*args)
        abs_err, rel = errors(got, plain)
        tag = f"deform_conv2d {crop} {hw}^2 {cin}->{cout} {dname} B={B}"
        check(rel < TOL[dname], f"{tag}: rel err {rel:.3g} >= {TOL[dname]}")
        row = {"crop": crop, "hw": hw, "cin": cin, "cout": cout, "batch": B,
               "dtype": dname, "calls_per_forward": calls,
               "route": "flat_kc" if flat_kc else "tap",
               "tiling": tiling(B, hw, hw, cin, cout, False, dname),
               "max_abs_err": abs_err, "rel_err": rel}
        if dname == "bfloat16":
            row["f32_rel_err"] = f32_rel_err(got, args)
            check(row["f32_rel_err"] < F32_TOL, f"{tag}: against f32 "
                  f"{row['f32_rel_err']:.3g} >= {F32_TOL}")
        else:
            row.update(f32_body_errors(got, plain, args))
            check(row["tf32_plain_rel_err"] < TF32_TOL, f"{tag}: against "
                  f"deform_conv2d_3xtf32_plain {row['tf32_plain_rel_err']:.3g}"
                  f" >= {TF32_TOL}")
            check(row["f64_ratio"] <= F64_RATIO, f"{tag}: against f64 "
                  f"{row['f64_err']:.3g}, {row['f64_ratio']:.3g} times the "
                  f"plain f32 version's {row['plain_f64_err']:.3g}")
        del got, plain
        if B == MAIN_BATCH or dname == "float32":
            x, off, mask, wt, _ = args
            cols = torch.cat(list(tap_columns(x, off, mask, (3, 3))),
                             dim=1).to(dt)
            wl = wt.reshape(9 * cin, cout)
            timed(row, lambda: deform_conv2d_tap(*args),
                  lambda: deform_conv2d_plain(*args),
                  lambda: torch.matmul(cols, wl),
                  dcn_bound(B, hw, hw, cin, cout, dname))
            if dname == "float32":
                row["bound_3xtf32_ms"] = row["bound_ms"]
                row["bound_cuda_core_ms"] = dcn_bound(
                    B, hw, hw, cin, cout, dname, peak="float32")[0]
            del cols
        rows.append(row)
        del args
    torch.cuda.empty_cache()
    return rows


def phase_geometry(gen):
    """Both modes off LORE's geometry (stride, padding, dilation 1): a
    strided and a dilated 3x3 DCN, ragged in pixels, Cout 72, against
    their plain versions. Rows for the K1 and the K2 entries."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (
        _out_hw, deform_conv2d_chunked, deform_conv2d_chunked_plain,
        deform_conv2d_plain, deform_conv2d_tap)

    k1_rows, k2_rows = [], []
    for geo in (((2, 2), (1, 1), (1, 1)), ((1, 1), (2, 2), (2, 2))):
        ho, wo = _out_hw(23, 19, 3, 3, *geo)
        args = dcn_inputs(gen, 2, 23, 19, 64, 72, torch.bfloat16, (ho, wo))
        for fn, plain, tol, rows in (
                (deform_conv2d_tap, deform_conv2d_plain, TOL["bfloat16"],
                 k1_rows),
                (deform_conv2d_chunked, deform_conv2d_chunked_plain, FK_TOL,
                 k2_rows)):
            abs_err, rel = errors(fn(*args, *geo), plain(*args, *geo))
            check(rel < tol, f"{fn.__name__} stride/padding/dilation {geo}: "
                  f"rel err {rel:.3g} >= {tol}")
            rows.append({"crop": None, "batch": 2, "h": 23, "w": 19,
                         "cin": 64, "cout": 72, "dtype": "bfloat16",
                         "stride_padding_dilation": geo,
                         "max_abs_err": abs_err, "rel_err": rel})
    return k1_rows, k2_rows


# row windows (the sp axis of the train step): K1's f32 and bf16 bodies
# and K2 over output rows [o0, o1) against the whole call's rows, bit for
# bit, at three LORE levels' shapes of a wtw batch of 2 at 1024^2 (B, H,
# W, Cin, Cout): two halves (sp = 2) and a window across them
WINDOW_SHAPES = ((2, 64, 64, 256, 256), (2, 128, 128, 128, 128),
                 (2, 256, 256, 64, 64))


def phase_windows(gen):
    """K1 and K2 over row windows (see above): one row per shape and
    mode."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (deform_conv2d_chunked,
                                                     deform_conv2d_tap)

    rows = []
    for shape in WINDOW_SHAPES:
        h = shape[1]
        windows = ((0, h // 2), (h // 2, h), (h // 3, h // 2 + 5))
        for name, fn, dt in (("K1 f32", deform_conv2d_tap, torch.float32),
                             ("K1 bf16", deform_conv2d_tap, torch.bfloat16),
                             ("K2", deform_conv2d_chunked, torch.bfloat16)):
            x, off, mask, wt, bias = dcn_inputs(gen, *shape, dt)
            with torch.no_grad():
                whole = fn(x, off, mask, wt, bias)
                equal = [torch.equal(fn(x, off[:, o0:o1].contiguous(),
                                        mask[:, o0:o1].contiguous(), wt,
                                        bias, h0=o0, ho=o1 - o0),
                                     whole[:, o0:o1])
                         for o0, o1 in windows]
            rows.append({"kernel": name, "shape": list(shape),
                         "windows": [list(w) for w in windows],
                         "bit_equal": equal})
            check(all(equal), f"windows: {name} at {shape}: a row window "
                  f"differs from the whole call's rows: {equal}")
    print(json.dumps({"row_windows": rows}))
    return rows


def phase_flat_kc(gen):
    """K2 (the flat-kc mode) against the plain chunked version on the same
    tensors; timed at the wtw slice's stride-4 shape beside its bound and
    the library yardstick: torch.matmul of the corner-rounded rows,
    (B*HW, 36*Cin) @ (36*Cin, Cout), the contraction alone on cuBLAS."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (
        deform_conv2d_chunked, deform_conv2d_chunked_plain, flat_kc_chunks,
        flat_kc_route)
    from pdf_table_tpu_torch.ops.kernels import launch_counts

    rows = []
    for i, (B, H, W, cin, cout) in enumerate(FK_CASES):
        args = dcn_inputs(gen, B, H, W, cin, cout, torch.bfloat16)
        n0 = launch_counts["deform_conv2d_flat_kc"]
        got = deform_conv2d_chunked(*args)
        torch.cuda.synchronize()
        check(launch_counts["deform_conv2d_flat_kc"] == n0 + 1,
              "deform_conv2d_flat_kc did not count its launch")
        abs_err, rel = errors(got, deform_conv2d_chunked_plain(*args))
        tag = f"deform_conv2d_flat_kc {B}x{H}x{W} {cin}->{cout}"
        check(rel < FK_TOL, f"{tag}: rel err {rel:.3g} >= {FK_TOL}")
        row = {"batch": B, "h": H, "w": W, "cin": cin, "cout": cout,
               "flat_kc_route": flat_kc_route(B, H, W, cin, 9, cout,
                                              torch.bfloat16),
               "tiling": tiling(B, H, W, cin, cout, True),
               "max_abs_err": abs_err, "rel_err": rel,
               "f32_rel_err": f32_rel_err(got, args)}
        check(row["f32_rel_err"] < F32_TOL, f"{tag}: against f32 "
              f"{row['f32_rel_err']:.3g} >= {F32_TOL}")
        del got
        if i == 0:   # the wtw slice's stride-4 DCN
            check(row["flat_kc_route"], f"{tag} is not on the flat-kc route")
            (g2, w4, wrep), = flat_kc_chunks(*args[:4], tap_chunk=9)
            gm = g2 * torch.repeat_interleave(w4, cin, dim=1)
            del g2
            row["calls_per_forward"] = FK_CALLS
            timed(row, lambda: deform_conv2d_chunked(*args),
                  lambda: deform_conv2d_chunked_plain(*args),
                  lambda: torch.matmul(gm, wrep),
                  dcn_bound(B, H, W, cin, cout, "bfloat16", corners=4))
            del gm
        rows.append(row)
        del args
    torch.cuda.empty_cache()
    return rows


def rn_bound(n, hw, det):
    """Least time for one resize_normalize call: max(ops / f32 peak,
    compulsory bytes / rate). Bytes: the uint8 canvases read once, the f32
    output written once, the two tap tables; operations: a 2x2 blend (4
    multiply-adds) and the normalize (2) per output value."""
    (H, W), (Ho, Wo) = hw, det
    nbytes = n * H * W * 3 + n * Ho * Wo * 3 * 4 + (Ho + Wo) * 12
    flops = n * Ho * Wo * 3 * 10
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def rn_library(norm):
    """The PyTorch calls for the same function: F.interpolate (bilinear,
    half-pixel, clamped) + normalize, as fn(u8, det). Timed beside the
    kernel only."""
    import torch
    import torch.nn.functional as F

    mean = torch.tensor(norm["mean"], device="cuda")[:, None, None]
    std = torch.tensor(norm["std"], device="cuda")[:, None, None]

    def fn(u8, det):
        x = u8.permute(0, 3, 1, 2)
        if norm["reverse_channels"]:
            x = x.flip(1)
        y = F.interpolate(x.float() * norm["scale"], size=det,
                          mode="bilinear", align_corners=False,
                          antialias=False)
        return ((y - mean) / std).permute(0, 2, 3, 1)
    return fn


def phase_resize(gen):
    """K3 against its plain version at RN_CASES, through every body that
    takes the shape; the 8-canvas bucket shapes are timed through both
    bodies (graph_ms, the bodies in turns; ``eager_ms`` is the same call
    launched eagerly, host cost included), the slice's shape also through
    the plain version and the library call."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import launch_counts
    from pdf_table_tpu_torch.ops.resize_norm import (kernel_route,
                                                     resize_normalize,
                                                     resize_normalize_plain)
    from pdf_table_tpu_torch.tasks.detection import NORM

    rows = []
    for i, (n, hw, det) in enumerate(RN_CASES):
        u8 = torch.randint(0, 256, (n, *hw, 3), device="cuda",
                           generator=gen, dtype=torch.uint8)
        route = kernel_route(*hw, *det)
        routes = ["scalar"] + (["vector"] if route == "vector" else [])
        for style, norm in NORM.items():
            want = resize_normalize_plain(u8, det, **norm)
            row = {"batch": n, "canvas": list(hw), "det": list(det),
                   "style": style, "route": route, "max_abs_err": 0.0}
            for r in [None] + routes:
                n0 = launch_counts["resize_normalize"]
                got = resize_normalize(u8, det, route=r, **norm)
                torch.cuda.synchronize()
                check(launch_counts["resize_normalize"] == n0 + 1,
                      "resize_normalize did not count its launch")
                err = float((got - want).abs().max())
                check(err <= RN_TOL, f"resize_normalize {n}x{hw}->{det} "
                      f"{style} {r}: max abs err {err:.3g} > {RN_TOL}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row[f"{r or 'default'}_max_abs_err"] = err
            if n == 8 and style == "imagenet":
                times = {r: [] for r in routes}
                for r in routes + routes[::-1]:
                    times[r].append(graph_ms(
                        lambda: resize_normalize(u8, det, route=r, **norm)))
                bound, t_ops, t_bytes = rn_bound(n, hw, det)
                row.update(ms=min(times[route]),
                           scalar_ms=min(times["scalar"]),
                           eager_ms=cuda_ms(
                               lambda: resize_normalize(u8, det, **norm),
                               100, 10), bound_ms=bound,
                           ops_ms=t_ops, bytes_ms=t_bytes,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes")
                row["x_bound"] = row["ms"] / bound
            if i == 0 and style == "imagenet":   # the slice's shape
                library = rn_library(norm)
                lib = library(u8, det)
                row.update(
                    plain_ms=cuda_ms(
                        lambda: resize_normalize_plain(u8, det, **norm), 10),
                    library_ms=cuda_ms(lambda: library(u8, det), 20),
                    library_max_abs_err=float((lib - want).abs().max()))
                check(row["library_max_abs_err"] <= RN_LIBRARY_TOL,
                      "F.interpolate + normalize computes another function")
            rows.append(row)
    check(all(r["route"] == "vector" for r in rows if "ms" in r),
          "a page bucket's detector shape is off the vector body")
    return rows


def kernels_line(rows, launches: dict, fk_rows, fk_launches: dict,
                 rn_rows, rn_launches: dict, train_rows, windows) -> dict:
    """One entry per TPU kernel. deform_conv2d (K1, the tap mode): times
    summed over the 16 DCN calls of one forward of the wireless slice's
    sub-batch (B=8 at 768^2, bf16), ``wtw_forward`` over the 11 tap-mode
    calls of one wtw forward (B=8 at 1024^2), ``f32_forward`` and
    ``f32_buckets`` over the 16 calls of one f32 forward of 8 crops at
    768^2, 512^2 and 384^2 (wireless) and 1024^2 (wtw, Cycle-CenterNet):
    the f32 body, which the pipeline phase runs, its ``bound_ms`` at the
    3xTF32 rate and ``bound_cuda_core_ms`` at the CUDA cores' f32 peak;
    launches over the counted runs of the paths that run it
    (``launches_by_path``, here and for the other two). deform_conv2d_flat_kc
    (K2, the flat-kc mode): times over its 5 calls in one wtw forward (the
    stride-4 DCNs). resize_normalize (K3): one call at the detection
    slice's chunk (8 canvases 1280x960 -> 960x720) through the body the
    shape rule picks (the vector body; ``scalar_ms`` is the other body at
    the same shape, ``buckets`` both at the three page buckets).
    ``shapes`` lists every checked shape with its errors and, where timed,
    its times. ``launches_by_path`` names every counted path, the ones that
    launch a kernel 0 times too (the token-model phases and arms launch K3
    once a chunk of the detection lane and never K1 or K2). K1's ``train`` is the training step's (B = 4 at 1024^2,
    f32, 16 calls): the Function's forward and the plain backward summed
    over the step beside their bounds, and its checked shapes, the bf16
    gradient check's included (K2's ``train_shapes``: its bf16 gradient
    check). ``row_windows`` (K1 and K2): the row-window launches against
    the whole call's rows (phase_windows)."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")

    def total(rs, extra=()):
        sums = {k: sum(r[k] * r["calls_per_forward"] for r in rs)
                for k in keys + extra + ("ops_ms", "bytes_ms")}
        sums["bound_by"] = "operations" \
            if sums.pop("ops_ms") >= sums.pop("bytes_ms") else "bytes"
        return sums

    bf16 = [r for r in rows if r["batch"] == MAIN_BATCH
            and r["dtype"] == "bfloat16"]
    main = total([r for r in bf16 if r["crop"] == 768])
    wtw = total([r for r in bf16 if r["crop"] == 1024
                 and r["route"] == "tap"])
    f32 = {crop: total([r for r in rows if r["batch"] == MAIN_BATCH
                        and r["dtype"] == "float32" and r["crop"] == crop],
                       ("bound_cuda_core_ms",))
           for crop in (768, 512, 384, 1024)}
    fk = total([r for r in fk_rows if "ms" in r])
    rn = next(r for r in rn_rows if "plain_ms" in r)
    rn_buckets = [{k: r[k] for k in ("canvas", "det", "ms", "scalar_ms",
                                     "eager_ms", "bound_ms", "x_bound")}
                  for r in rn_rows if "ms" in r]
    t32 = [r for r in train_rows if r["dtype"] == "float32"]

    def step_sum(get):
        return sum(get(r) * r["calls_per_step"] for r in t32)

    bwd = {k: step_sum(lambda r: r["backward"][k])
           for k in ("ops_ms", "bytes_ms", "columns_bytes_ms")}
    train = {
        "launches_per_step": sum(r["calls_per_step"] for r in t32),
        "forward_ms": step_sum(lambda r: r["forward_ms"]),
        "forward_bound_ms": step_sum(lambda r: r["forward_bound_ms"]),
        "backward_ms": step_sum(lambda r: r["backward_ms"]),
        "backward_bound_ms": max(bwd["ops_ms"], bwd["bytes_ms"]),
        "backward_bound_by": "operations"
        if bwd["ops_ms"] >= bwd["bytes_ms"] else "bytes", **{
            f"backward_{k}": v for k, v in bwd.items()},
        "shapes": [r for r in train_rows if r["mode"] == "tap"]}
    return {"kernels": [{
        "name": "deform_conv2d", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + t32), **main,
        "wtw_forward": wtw, "f32_forward": f32[768],
        "f32_buckets": {str(c): f32[c] for c in (512, 384, 1024)},
        "train": train,
        "row_windows": [w for w in windows if w["kernel"] != "K2"],
        "shapes": rows}, {
        "name": "deform_conv2d_flat_kc", "route": "cuda", "source": SOURCE,
        "replaces": FK_REPLACES, "launches": sum(fk_launches.values()),
        "launches_by_path": fk_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fk_rows), **fk,
        "train_shapes": [r for r in train_rows if r["mode"] == "flat_kc"],
        "row_windows": [w for w in windows if w["kernel"] == "K2"],
        "shapes": fk_rows}, {
        "name": "resize_normalize", "route": "cuda", "source": RN_SOURCE,
        "replaces": RN_REPLACES, "launches": sum(rn_launches.values()),
        "launches_by_path": rn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rn_rows),
        "ms": rn["ms"], "scalar_ms": rn["scalar_ms"],
        "eager_ms": rn["eager_ms"], "plain_ms": rn["plain_ms"], "bound_ms": rn["bound_ms"],
        "bound_by": rn["bound_by"], "library_ms": rn["library_ms"],
        "buckets": rn_buckets, "shapes": rn_rows}]}


def _match(a, b, j):
    """Valid slots of crop ``j`` in both runs, matched by feature-map
    index: (slots in a, slots in b, valid in a, valid in b)."""
    import torch

    ia = {i: s for s, i in enumerate(a["inds"][j].tolist())
          if bool(a["valid"][j, s])}
    ib = {i: s for s, i in enumerate(b["inds"][j].tolist())
          if bool(b["valid"][j, s])}
    common = sorted(set(ia) & set(ib))
    return (torch.tensor([ia[i] for i in common], dtype=torch.long),
            torch.tensor([ib[i] for i in common], dtype=torch.long),
            len(ia), len(ib))


def compare_runs(task, plain, pages, regions):
    """The task's model against the plain-deform-conv yardstick ``plain``
    on the same crops: heads, then valid slots matched by feature-map
    index (dets, and the regressor's logical coordinates). ``dets_px`` and
    ``logi`` are the worst slot.

    Under wiz_rev the slots are the decoded cells before the vertex
    refine, and both regressors run on the task model's refined slots:
    snapping a vertex is a choice among corner detections, so a near-tie
    that the kernels' bf16 roundings tip moves a vertex by up to a cell
    side. The refine itself is held exactly: ``refine_sort`` on the card
    against the same function on the CPU, on the task's own decode
    (``refine_exact``). ``refined`` then gives, for information, the share
    of common slots within DETS_TOL and LOGI_TOL when each run refines its
    own decode."""
    import torch

    from pdf_table_tpu_torch.models.lore.corner_refine import refine_sort

    cfg = task.model_config
    k = cfg.max_objs
    worst = {"heads": 0.0, "dets_px": 0.0, "logi": 0.0, "match": 1.0,
             "valid_slots": 0, "common_slots": 0}
    refined = {"common_slots": 0, "dets_share": 0.0, "logi_share": 0.0}

    def decoded(dd):
        cells = dd["dc_packed"][:, :k]
        return {"dets": cells[..., :8], "inds": cells[..., 9].long(),
                "valid": cells[..., 8] >= cfg.vis_thresh}

    def chain(model, dd, rs=None):
        """refine_sort (unless given) + gather_logical: the slots (dets,
        inds, valid) and the packed output."""
        if rs is None:
            rs = refine_sort(dd["dc_packed"], k, cfg.vis_thresh,
                             cfg.vis_thresh_corner)
        packed = model.gather_logical(dd["ax_flat"], dd["cr_map"], *rs)
        return {"dets": rs[0], "inds": rs[1],
                "valid": rs[2] >= cfg.vis_thresh}, packed

    if cfg.wiz_rev:
        worst["refine_exact"] = True
    with torch.inference_mode():
        for sub, _metas, x in task.sub_batches(pages, regions):
            ha, hb = task.model.heads(x), plain.heads(x)
            for name in ha:
                rel = float((ha[name] - hb[name]).abs().max()
                            / hb[name].abs().max().clamp_min(1e-6))
                worst["heads"] = max(worst["heads"], rel)
            if cfg.wiz_rev:
                da, db = task.model.detect_decode(x), plain.detect_decode(x)
                dc = da["dc_packed"]
                rs = refine_sort(dc, k, cfg.vis_thresh,
                                 cfg.vis_thresh_corner)
                rs_cpu = refine_sort(dc.cpu(), k, cfg.vis_thresh,
                                     cfg.vis_thresh_corner)
                worst["refine_exact"] &= all(
                    torch.equal(a.cpu(), b) for a, b in zip(rs, rs_cpu))
                fa, pa = chain(task.model, da, rs)
                _, gb = chain(plain, db, rs)
                keep = pa[..., 9] > 0.5
                la, lb = pa[..., 16:20][keep], gb[..., 16:20][keep]
                worst["logi"] = max(worst["logi"], float(
                    (la - lb).abs().max() / lb.abs().max().clamp_min(1e-6)))
                fb, pb = chain(plain, db)
                sa_, sb_ = decoded(da), decoded(db)
            else:
                fa, fb = task.model.features(x), plain.features(x)
                pa, pb = task.model.proc_pack(fa), plain.proc_pack(fb)
                sa_, sb_ = fa, fb
            for j in range(len(sub)):
                sa, sb, na, nb = _match(sa_, sb_, j)
                worst["valid_slots"] += na
                if na or nb:
                    worst["match"] = min(worst["match"],
                                         len(sa) / max(na, nb))
                if not len(sa):
                    continue
                worst["common_slots"] += len(sa)
                dd = (sa_["dets"][j, sa] - sb_["dets"][j, sb]).abs().max()
                worst["dets_px"] = max(worst["dets_px"], float(dd))
                if not cfg.wiz_rev:
                    la, lb = pa[j, sa, 16:20], pb[j, sb, 16:20]
                    rel = float((la - lb).abs().max()
                                / lb.abs().max().clamp_min(1e-6))
                    worst["logi"] = max(worst["logi"], rel)
                    continue
                # each run refining its own decode: information only
                sa, sb, _, _ = _match(fa, fb, j)
                if not len(sa):
                    continue
                ddr = (fa["dets"][j, sa] - fb["dets"][j, sb]).abs().amax(-1)
                la, lb = pa[j, sa, 16:20], pb[j, sb, 16:20]
                lr = (la - lb).abs().amax(-1) / lb.abs().max().clamp_min(1e-6)
                refined["common_slots"] += len(sa)
                refined["dets_share"] += int((ddr < DETS_TOL).sum())
                refined["logi_share"] += int((lr < LOGI_TOL).sum())
    if cfg.wiz_rev:
        n = max(refined["common_slots"], 1)
        refined["dets_share"] /= n
        refined["logi_share"] /= n
        worst["refined"] = refined
    return worst


SLICE_KW = dict(dtype="bfloat16", vis_thresh=VIS_THRESH)
WTW_KW = dict(dtype="bfloat16", vis_thresh=WTW_VIS_THRESH,
              vis_thresh_corner=WTW_VIS_CORNER)


def lore_variables(cfg):
    """Seeded LORE tree for ``cfg`` with its offset convs perturbed. On
    top: random heads put every cell corner on its center, and the post
    filter drops cells under 1 px, so the corners get a fixed 6
    feature-map px offset and the logical regressor's output is widened
    10x, so that tables carry cells and a grid (the tests shape their
    weights the same way); wtw corner group boxes get +-3 px, so that cell
    quads hold them and vertices snap."""
    import numpy as np

    from pdf_table_tpu_torch.engine.params import (init_lore,
                                                   perturb_conv_offset_mask)

    variables = perturb_conv_offset_mask(init_lore(cfg, seed=0), seed=1)
    prm = variables["params"]
    heads = prm["detector"]["heads"]
    heads["wh_out"]["bias"] = np.array(
        [6, 6, -6, 6, -6, -6, 6, -6], np.float32)
    if cfg.task_type == "wtw":
        heads["st_out"]["bias"] = np.array(
            [3, 3, -3, 3, -3, -3, 3, -3], np.float32)
    prm["processor"]["stacker"]["tsfm"]["decoder"]["linear_2"]["kernel"] *= 10
    return variables


def slice_setup(device="cuda", task_type="wireless"):
    """The smoke's LORE slices: the bf16 ``task_type`` task at full width on
    seeded weights, 4 synthetic pages, 2 table regions each (all larger
    than 512 px, so one sub-batch of 8 at the config's resolution).
    Returns (task, variables, pages, regions)."""
    import numpy as np

    from pdf_table_tpu_torch.tasks.table_structure import (
        OcrTableStructureTask, lore_config)

    kw = WTW_KW if task_type == "wtw" else SLICE_KW
    variables = lore_variables(lore_config(task_type, **kw))
    task = OcrTableStructureTask(model="Lore", task_type=task_type,
                                 device=device, variables=variables,
                                 res_buckets="auto", **kw)
    pages = np.stack([make_page(i) for i in range(4)])
    regions = [(pi, box) for pi in range(4)
               for box in ((70, 100, 880, 560), (70, 620, 880, 1150))]
    return task, variables, pages, regions


def _trace(fn, activities):
    """torch.profiler over one ``fn()`` that ends in a synchronize: wall
    ms of that run and its device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own event carries its kernels'
    # time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    return wall_ms, events


def profile_run(fn, full: bool = True) -> dict:
    """Two traces of one ``fn()`` each. The light one records device
    activity only, so its wall time carries little of the profiler's host
    cost: device busy time, wall time and the idle share of that one run.
    The full one (host ops too; not with ``full=False``, which returns the
    light one's numbers alone) gives the top ops by device time, and its
    own busy, wall and idle share; K1's device ms come from the light
    one."""
    from torch.profiler import ProfilerActivity

    wall, events = _trace(fn, [ProfilerActivity.CUDA])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not full:
        return {"wall_ms": wall, "device_busy_ms": busy,
                "idle_share": max(0.0, 1.0 - busy / wall) if busy else None}
    names = sorted({e.key for e in events})
    full_wall, full = _trace(fn, [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    full_busy = sum(e.self_device_time_total for e in full) / 1e3
    top = sorted(full, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    k1 = sum(e.self_device_time_total for e in events
             if any(k in e.key for k in K1_KERNELS)) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
            "k1_device_ms": k1,
            "full_trace": {"wall_ms": full_wall, "device_busy_ms": full_busy,
                           "idle_share": max(0.0, 1.0 - full_busy
                                             / full_wall)},
            "top_ops": [{"name": e.key[:80],
                         "device_ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top],
            "kernel_names": names}


def f32_body_traced(prof: dict, tag: str) -> dict:
    """``prof`` without its kernel names, after checking that the f32 DCNs
    of the traced run went through K1's 3xTF32 body."""
    names = prof.pop("kernel_names")
    check(any("dcn_tf32_kernel" in n for n in names),
          f"{tag}: the trace shows no dcn_tf32_kernel")
    return prof


# kernel launches per sub-batch of 8 full-resolution crops: the wireless
# forward runs its 16 DCNs on K1; the wtw forward (1024^2) its five
# stride-4 DCNs on the flat-kc route (one K2 launch each, all 9 taps) and
# the other 11 on K1
SLICE_LAUNCHES = {"wireless": {"deform_conv2d": 16,
                               "deform_conv2d_flat_kc": 0},
                  "wtw": {"deform_conv2d": 11, "deform_conv2d_flat_kc": 5}}
# device kernels of the TPU route's row gather, which no slice runs now
GATHER_KERNELS = ("indexSelect", "index_select", "blend_matmul")


def count_snaps(task, pages, regions) -> int:
    """Vertices of cells above threshold that the corner refine moved, over
    the slice's sub-batches."""
    import torch

    from pdf_table_tpu_torch.models.lore.corner_refine import \
        refine_vertices_by_corners

    cfg = task.model_config
    k = cfg.max_objs
    snapped = 0
    with torch.inference_mode():
        for _sub, _metas, x in task.sub_batches(pages, regions):
            dc = task.model.detect_decode(x)["dc_packed"]
            dets = dc[:, :k, :8]
            refined, _ = refine_vertices_by_corners(
                dets, dc[:, :k, 8], dc[:, k:, :8], dc[:, k:, 8:10],
                dc[:, k:, 10], cfg.vis_thresh, cfg.vis_thresh_corner)
            moved = (refined != dets).reshape(*dets.shape[:2], 4, 2).any(-1)
            snapped += int(moved[dc[:, :k, 8] >= cfg.vis_thresh].sum())
    return snapped


def phase_slice(card, task_type="wireless"):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.lore.model import LoreModel
    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

    t0 = time.perf_counter()
    task, variables, pages, regions = slice_setup(task_type=task_type)
    build_s = time.perf_counter() - t0
    res = task.model_config.resolution
    plan = [x.shape for _s, _m, x in task.sub_batches(pages, regions)]
    n_sub = len(plan)
    check(all(tuple(p[1:3]) == tuple(res) for p in plan),
          f"{task_type}: sub-batches {plan} are not at {res}")

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in SLICE_LAUNCHES[task_type]}
    for k, n in SLICE_LAUNCHES[task_type].items():
        check(launches[k] == n * n_sub, f"{task_type}: {k} launched "
              f"{launches[k]} times, expected {n * n_sub}")
    htmls = [OcrTableToHtmlTask()(r, []) for r in results]
    check(len(results) == len(regions), "one result per region")
    check(all(isinstance(r.get("cells"), list) for r in results),
          "every result carries a cell list")
    check(all(h.startswith("<table") for h in htmls), "table HTML")
    for r in results:
        for c in r["cells"]:
            check(all(np.isfinite(c["bbox"])) and len(c["logic"]) == 4,
                  "cells are finite with 4 logical coords")

    # steady state: each run ends in the packed output's download
    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages, regions)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: task.batch_infer_from_pages(pages, regions))
    gathers = [n for n in prof.pop("kernel_names")
               if any(g in n for g in GATHER_KERNELS)]

    plain = LoreModel(task.model_config, plain_dcn=True).eval()
    load_flax_variables(plain, variables)
    plain.to("cuda")
    before = dict(launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _sub, _metas, x in task.sub_batches(pages, regions):
            plain.forward_packed(x).cpu()
    plain_run = time.perf_counter() - t0
    check(dict(launch_counts) == before,
          "the plain yardstick launched a kernel")
    cmp = compare_runs(task, plain, pages, regions)
    cells = [len(r["cells"]) for r in results]
    summary = {
        "card": card, "task_type": task_type, "resolution": list(res),
        "crops": len(regions), "sub_batches": n_sub,
        "launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "ms_per_crop": per_run * 1e3 / len(regions),
        "peak_mem_gib": peak / 2 ** 30,
        "plain_dcn_run_s": plain_run,
        "cells_per_table": cells, "valid_cells": sum(cells),
        "html_bytes": [len(h) for h in htmls], "yardstick": cmp,
        "profile": prof, "row_gather_kernels": gathers,
    }
    if task_type == "wtw":
        summary["snapped_vertices"] = count_snaps(task, pages, regions)
    print(json.dumps({"slice" if task_type == "wireless"
                      else f"{task_type}_slice": summary}))
    check(cmp["valid_slots"] > 0, "no valid slots to compare")
    check(cmp["heads"] < HEADS_TOL, f"heads differ: {cmp['heads']:.3g}")
    check(cmp["match"] >= MATCH_MIN, f"valid slots differ: {cmp['match']}")
    check(cmp["dets_px"] < DETS_TOL, f"dets differ: {cmp['dets_px']:.3g}")
    check(cmp["logi"] < LOGI_TOL, f"logi differ: {cmp['logi']:.3g}")
    check(not gathers, f"{task_type}: the run gathered corner rows outside "
          f"the kernel: {gathers}")
    if task_type == "wtw":
        check(cmp["refine_exact"], "wtw: the refine on the card differs "
              "from the CPU's on the same decode")
        check(summary["valid_cells"] > 0, "wtw: no valid cells")
        check(summary["snapped_vertices"] > 0, "wtw: no vertex snapped")
    return launches


def det_setup(device="cuda"):
    """The smoke's detection slice: PP-OCRv4 at full width, f32, seeded
    weights, the bench's overrides, 8 synthetic pages (one chunk).
    Returns (task, pages)."""
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

    task = OcrDetectionTask(model="PP-OCRv4_det", device=device, **DET_KW)
    return task, [make_page(i) for i in range(DET_PAGES)]


def det_stages(task, pages) -> dict:
    """The chunk's stages, each timed alone (host_ms), and torch.profiler
    over one batch_infer_from_pages: device busy time, wall time, idle
    share and the top ops by device time."""
    import torch

    (_idx, shapes, bucket, canv), = list(task.chunks(pages))
    det_hw = task.det_size(bucket)
    prob_hw = task.prob_size(det_hw)
    dev = task.device
    with torch.inference_mode():
        canvas = torch.from_numpy(canv).to(dev)
        valid = torch.from_numpy(
            task._valid_extents(shapes, bucket, prob_hw)).to(dev)
        x = task.normalize(canvas, det_hw)
        prob = task.model(x)["prob"]
        packed = task.boxes(task.quantize(prob), valid)
        packed_np = packed.cpu().numpy()
        stages = {
            "canvas_upload": host_ms(lambda: torch.from_numpy(canv).to(dev)),
            "resize_normalize": host_ms(
                lambda: task.normalize(canvas, det_hw)),
            "dbnet": host_ms(lambda: task.model(x)),
            "pool_quantize_cc": host_ms(
                lambda: task.boxes(task.quantize(prob), valid)),
            "download": host_ms(lambda: packed.cpu()),
            "host_finish": host_ms(lambda: task._boxes_finish(
                packed_np, shapes, bucket, prob_hw)),
        }
    prof = profile_run(lambda: task.batch_infer_from_pages(pages))
    names = prof.pop("kernel_names")
    return {"stage_ms": stages, "profile": prof,
            "resize_kernels": [n[:60] for n in names
                               if "resize_normalize" in n]}


def det_yardstick(task, pages) -> dict:
    """The task's model on the kernel's input against the same model on
    resize_normalize_plain's input, per chunk: worst input and prob
    difference, share of uint8 map pixels that differ. Then the device
    boxes on the card against the same function on the CPU, on the
    chunk's uint8 maps, at the task's threshold and at the maps' 80th
    percentile (many components on random weights): boxes and areas
    equal, means within CC_MEAN_RTOL."""
    import torch

    from pdf_table_tpu_torch.ops.connected_components import \
        batch_component_boxes_u8
    from pdf_table_tpu_torch.ops.resize_norm import resize_normalize_plain
    from pdf_table_tpu_torch.tasks.detection import CC_ITERS, MAX_COMPONENTS

    worst = {"input": 0.0, "prob": 0.0, "u8_share": 0.0, "cc_equal": True,
             "cc_mean_rel": 0.0, "cc_components": []}
    with torch.inference_mode():
        for _idx, shapes, bucket, canv in task.chunks(pages):
            canvas = torch.from_numpy(canv).to(task.device)
            det_hw = task.det_size(bucket)
            xk = task.normalize(canvas, det_hw)
            xp = resize_normalize_plain(canvas, det_hw, **task.norm)
            pk, pp = task.model(xk)["prob"], task.model(xp)["prob"]
            uk, up = task.quantize(pk), task.quantize(pp)
            worst["input"] = max(worst["input"],
                                 float((xk - xp).abs().max()))
            worst["prob"] = max(worst["prob"], float((pk - pp).abs().max()))
            worst["u8_share"] = max(worst["u8_share"],
                                    float((uk != up).float().mean()))
            valid = torch.from_numpy(task._valid_extents(
                shapes, bucket, task.prob_size(det_hw)))
            for thr in (int(round(task.model_config.thresh * 255)),
                        int(uk.float().quantile(0.8))):
                a = batch_component_boxes_u8(
                    uk, thr, valid.to(task.device), MAX_COMPONENTS,
                    CC_ITERS).cpu()
                b = batch_component_boxes_u8(uk.cpu(), thr, valid,
                                             MAX_COMPONENTS, CC_ITERS)
                cols = [0, 1, 2, 3, 5]
                worst["cc_equal"] &= torch.equal(a[..., cols], b[..., cols])
                rel = ((a[..., 4] - b[..., 4]).abs()
                       / b[..., 4].abs().clamp_min(1e-12)).max()
                worst["cc_mean_rel"] = max(worst["cc_mean_rel"], float(rel))
                worst["cc_components"].append(int((b[..., 5] > 0).sum()))
    return worst


def phase_detection(card):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)

    t0 = time.perf_counter()
    task, pages = det_setup()
    build_s = time.perf_counter() - t0
    n_chunks = sum(1 for _ in task.chunks(pages))

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    quads = task.batch_infer_from_pages(pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts["resize_normalize"]
    check(launches == n_chunks, f"resize_normalize launched {launches} "
          f"times, expected {n_chunks}")
    check(len(quads) == len(pages), "one quad array per page")
    check(sum(len(q) for q in quads) > 0, "no text boxes on any page")
    for q, page in zip(quads, pages):
        h, w = page.shape[:2]
        check(q.dtype == np.float32 and q.shape[1:] == (4, 2),
              "quads are (n, 4, 2) f32")
        check(bool(np.isfinite(q).all()), "quads are finite")
        check(bool((q[..., 0] >= 0).all() and (q[..., 0] <= w).all()
                   and (q[..., 1] >= 0).all() and (q[..., 1] <= h).all()),
              "quads lie inside their page")

    # steady state: each run ends in the packed boxes' download
    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()

    stages = det_stages(task, pages)
    cmp = det_yardstick(task, pages)
    summary = {
        "card": card, "pages": len(pages), "chunks": n_chunks,
        "resize_launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": len(pages) / per_run,
        "ms_per_page": per_run * 1e3 / len(pages),
        "peak_mem_gib": peak / 2 ** 30,
        "quads_per_page": [len(q) for q in quads], "yardstick": cmp,
        **stages,
    }
    print(json.dumps({"detection": summary}))
    check(len(stages["resize_kernels"]) == 1
          and "resize_normalize_vec_kernel" in stages["resize_kernels"][0],
          f"the chunk did not go through K3's vector body: "
          f"{stages['resize_kernels']}")
    check(cmp["input"] <= RN_TOL, f"det input differs: {cmp['input']:.3g}")
    check(cmp["prob"] <= DET_PROB_TOL, f"prob differs: {cmp['prob']:.3g}")
    check(cmp["u8_share"] <= DET_U8_SHARE,
          f"u8 maps differ in {cmp['u8_share']:.3g} of pixels")
    check(cmp["cc_equal"], "device boxes differ from the CPU's")
    check(cmp["cc_mean_rel"] <= CC_MEAN_RTOL,
          f"device box means differ: {cmp['cc_mean_rel']:.3g}")
    return launches


def rec_quads(shapes):
    """Text quads per page: the bench's injected line grid (bench.py: up
    to REC_LINES axis-aligned quads a page, 120-360 px wide, 22 px tall,
    36 px apart) plus one tilted quad under it, so that the homography
    sampler runs too."""
    import numpy as np

    out = []
    for i, (h, w) in enumerate(shapes):
        rng = np.random.default_rng(int(h) * 7 + int(w))
        lines = []
        y = 60
        while y < h - 80 and len(lines) < REC_LINES:
            ww = int(rng.integers(120, 360))
            lines.append([[70, y], [70 + ww, y], [70 + ww, y + 22],
                          [70, y + 22]])
            y += 36
        quad = np.asarray([[70, y], [370, y], [370, y + 22], [70, y + 22]],
                          np.float32)
        a = 0.02 * (i + 1)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                       np.float32)
        ctr = quad.mean(0, keepdims=True)
        lines.append(((quad - ctr) @ rot.T + ctr).tolist())
        out.append(np.asarray(lines, np.float32))
    return out


def rec_cls_trees(canvases):
    """PP-OCRv4 rec and 0/180 classifier trees, seeded, with BatchNorm
    statistics calibrated on the card on 16 strips of the first two
    canvases (so that texts and orientation probabilities depend on the
    crop)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_cls, init_rec)
    from pdf_table_tpu_torch.models.cls.config import ClsPulcConfig
    from pdf_table_tpu_torch.models.cls.model import PPLCNetClassifier
    from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
    from pdf_table_tpu_torch.tasks.cls_pulc import CLS_MEAN, CLS_STD
    from pdf_table_tpu_torch.tasks.recognition import rec_config

    strips = torch.from_numpy(np.stack(
        [canvases[p, y:y + 48, 70:390] for p in range(2)
         for y in range(54, 54 + 36 * 8, 36)])).float().cuda()
    cfg = rec_config()
    rec_v = calibrate_batch_stats(CTCRecModel(cfg).cuda(), init_rec(cfg, 0),
                                  strips / 127.5 - 1.0)
    ccfg = ClsPulcConfig.for_task("textline_orientation")
    mean = torch.tensor(CLS_MEAN, device="cuda")
    std = torch.tensor(CLS_STD, device="cuda")
    cls_v = calibrate_batch_stats(
        PPLCNetClassifier(ccfg).cuda(), init_cls(ccfg, 0),
        (strips[:, :, :192] / 255.0 - mean) / std)
    return rec_v, cls_v


def rec_setup():
    """The smoke's recognition slice: PP-OCRv4 rec and the 0/180 textline
    classifier at full width, f32, on the trees of :func:`rec_cls_trees`,
    the classifier's bias shifted so that half of the crops flip. Returns
    (task on the card, the same task on the CPU, canvases (8, 1280, 960,
    3) uint8, quads per page)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
    from pdf_table_tpu_torch.tasks.recognition import (FLIP_THRESH,
                                                       OcrRecognitionTask)

    pages = [make_page(i) for i in range(DET_PAGES)]
    (bucket, g), = pack_pages(pages).items()
    check(bucket == (1280, 960), f"pages fell into bucket {bucket}")
    canvases = g["images"]
    quads = rec_quads(g["shapes"])
    rec_v, cls_v = rec_cls_trees(canvases)
    cls = ClsImagePulcTask("textline_orientation", device="cuda",
                           variables=cls_v)
    task = OcrRecognitionTask(device="cuda", variables=rec_v, cls_task=cls,
                              **F32)
    # put the flip threshold between the two middle crops' margins
    dev_pages = torch.from_numpy(canvases).cuda()
    margins = []
    with torch.inference_mode():
        for grp in task.plan(quads):
            _, _, cls_in = task.cut(dev_pages, grp, task.upload(grp))
            p = cls.probs(cls_in)[:grp["n"], 1].double()
            margins += torch.log(p / (1 - p)).tolist()
    m = np.sort(np.asarray(margins))
    mid = (m[len(m) // 2 - 1] + m[len(m) // 2]) / 2
    cls_v["params"]["fc"]["bias"] = cls_v["params"]["fc"]["bias"] + np.array(
        [0.0, np.log(FLIP_THRESH / (1 - FLIP_THRESH)) - mid], np.float32)
    cls.load_variables(cls_v)
    cpu = OcrRecognitionTask(
        device="cpu", variables=rec_v, cls_task=ClsImagePulcTask(
            "textline_orientation", device="cpu", variables=cls_v), **F32)
    return task, cpu, canvases, quads


def rec_stages(task, dev_pages, quads) -> dict:
    """The lane's stages, each timed alone over all groups (host_ms)."""
    import torch

    groups = task.plan(quads)
    with torch.inference_mode():
        up = [task.upload(g) for g in groups]
        cuts = [task.cut(dev_pages, g, t) for g, t in zip(groups, up)]
        crops = [task.orient(*c) for c in cuts]
        logits = [task.logits(c) for c in crops]
        packed = [task.pack(lg) for lg in logits]
        packed_np = [p.cpu().numpy() for p in packed]
        return {
            "geometry": host_ms(lambda: task.plan(quads)),
            "geometry_upload": host_ms(
                lambda: [task.upload(g) for g in groups]),
            "crop_resample": host_ms(
                lambda: [task.cut(dev_pages, g, t)
                         for g, t in zip(groups, up)]),
            "cls": host_ms(lambda: [task.orient(*c) for c in cuts]),
            "rec_forward": host_ms(lambda: [task.logits(c) for c in crops]),
            "decode": host_ms(lambda: [task.pack(lg) for lg in logits]),
            "download": host_ms(lambda: [p.cpu() for p in packed]),
            "host_post": host_ms(
                lambda: task.finish(quads, groups, packed_np)),
        }


def phase_recognition(card):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.recognition import unpack_rec

    t0 = time.perf_counter()
    task, cpu, canvases, quads = rec_setup()
    build_s = time.perf_counter() - t0
    n_crops = sum(len(q) for q in quads)
    dev_pages = torch.from_numpy(canvases).cuda()

    # the main path, counted: the lane launches none of the kernels
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    texts, scores = task.batch_infer_from_pages(dev_pages, quads)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(sum(launch_counts.values()) == 0,
          f"the recognition lane launched {dict(launch_counts)}")
    groups = task.plan(quads)
    shape = [(g["bucket"], g["aa"], g["n"], len(g["pidx"])) for g in groups]
    check(sorted(g["aa"] for g in groups) == [False, True],
          f"expected one axis-aligned and one homography group: {shape}")
    chars = set(task.charset.id_to_char[1:])
    check([len(t) for t in texts] == [len(q) for q in quads]
          and [len(s) for s in scores] == [len(q) for q in quads],
          "one text and one score per quad")
    check(all(isinstance(t, str) and set(t) <= chars
              for page in texts for t in page),
          "texts are strings of the charset")
    check(all(np.isfinite(s) and 0.0 <= s <= 1.0
              for page in scores for s in page), "scores lie in [0, 1]")
    check(len({t for page in texts for t in page}) > n_crops // 2,
          "the texts do not depend on the crops")

    # steady state: each run ends in the packed decodes' download
    torch.cuda.reset_peak_memory_stats()
    runs = {"resident": [], "numpy": []}
    for _ in range(10):
        for key, src in (("resident", dev_pages), ("numpy", canvases)):
            t0 = time.perf_counter()
            task.batch_infer_from_pages(src, quads)
            runs[key].append(time.perf_counter() - t0)
    per_run = statistics.median(runs["resident"])
    peak = torch.cuda.max_memory_allocated()
    stages = rec_stages(task, dev_pages, quads)
    prof = profile_run(lambda: task.batch_infer_from_pages(dev_pages, quads))
    prof.pop("kernel_names")

    # the card against the same port on the CPU
    with torch.inference_mode():
        got = [task.enqueue(dev_pages, g).cpu().numpy() for g in groups]
        flips = 0
        for g in groups:
            crops, rot, cls_in = task.cut(dev_pages, g, task.upload(g))
            out = task.orient(crops, rot, cls_in)[:g["n"]]
            flips += int((out != crops[:g["n"]]).flatten(1).any(1).sum())
    t0 = time.perf_counter()
    cpu_pages = torch.from_numpy(canvases)
    want = [cpu.enqueue(cpu_pages, g).numpy() for g in cpu.plan(quads)]
    cpu_s = time.perf_counter() - t0
    equal = conf_err = 0
    for g, a, b in zip(groups, got, want):
        (ia, ka, ca), (ib, kb, cb) = (unpack_rec(a, g["n"]),
                                      unpack_rec(b, g["n"]))
        same = (ia == ib).all(1) & (ka == kb).all(1)
        equal += int(same.sum())
        if same.any():
            conf_err = max(conf_err, float(np.abs(ca - cb)[same].max()))
    summary = {
        "card": card, "pages": len(quads), "crops": n_crops,
        "groups": shape, "launches": dict(launch_counts),
        "model_build_s": build_s, "first_run_s": first_s,
        "run_s_median": per_run, "run_s_min": min(runs["resident"]),
        "run_s_max": max(runs["resident"]), "runs": len(runs["resident"]),
        "crops_per_s": n_crops / per_run,
        "ms_per_crop": per_run * 1e3 / n_crops,
        "numpy_canvases": {
            "run_s_median": statistics.median(runs["numpy"]),
            "crops_per_s": n_crops / statistics.median(runs["numpy"])},
        "peak_mem_gib": peak / 2 ** 30, "stage_ms": stages, "profile": prof,
        "flipped_crops": flips,
        "text_lengths": [min(len(t) for p in texts for t in p),
                         max(len(t) for p in texts for t in p)],
        "sample_texts": texts[0][:2],
        "cpu": {"run_s": cpu_s, "equal_crops": equal,
                "equal_share": equal / n_crops, "conf_max_abs": conf_err},
    }
    print(json.dumps({"recognition": summary}))
    check(0 < flips < n_crops, f"{flips} of {n_crops} crops flipped")
    check(equal / n_crops >= REC_EQUAL_MIN, f"only {equal} of {n_crops} "
          f"crops decode as on the CPU")
    check(conf_err <= REC_CONF_TOL,
          f"confidences differ from the CPU's: {conf_err:.3g}")


def layout_tree(dev_canvases):
    """The full-width PicoDet tree (picodet_lcnet_x1_0, bench.py's table
    head): seeded, BatchNorm scales LAYOUT_BN_SCALE, statistics calibrated
    on the card on the canvases at the model's input, ``head_cls`` kernels
    x LAYOUT_HEAD_GAIN so that scores and box bins spread. At BatchNorm
    scale 1 the 60-odd random layers are chaotic: two f32 runs that sum in
    another order then differ by 1e-3 of the heads."""
    import torch

    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_picodet,
                                                   set_batch_norm_scale)
    from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
    from pdf_table_tpu_torch.models.picodet.model import PicoDet
    from pdf_table_tpu_torch.tasks.layout import resize_bilinear_aa

    cfg = PicoDetConfig(**LAYOUT_KW)
    v = set_batch_norm_scale(init_picodet(cfg, 0), LAYOUT_BN_SCALE)
    mean = torch.tensor(cfg.norm_mean, device="cuda")
    std = torch.tensor(cfg.norm_std, device="cuda")
    with torch.no_grad():
        x = resize_bilinear_aa(dev_canvases, (cfg.img_height, cfg.img_width))
        x = ((x / 255.0 - mean) / std).contiguous()
    v = calibrate_batch_stats(PicoDet(cfg).cuda(), v, x)
    for name, mod in v["params"]["head"].items():
        if name.startswith("head_cls"):
            mod["kernel"] = mod["kernel"] * LAYOUT_HEAD_GAIN
    return v


def layout_cells_diff(got, want) -> dict:
    """Per-page layout cells of two runs: equal counts, labels and types,
    worst box (px) and score difference."""
    import numpy as np

    out = {"same_count": True, "same_labels": True, "box_px": 0.0,
           "score": 0.0, "cells": 0}
    for g, w in zip(got, want):
        out["same_count"] &= len(g) == len(w)
        out["same_labels"] &= [(c.label, c.cell_type.name) for c in g] == \
            [(c.label, c.cell_type.name) for c in w]
        out["cells"] += len(w)
        if g and len(g) == len(w):
            out["box_px"] = max(out["box_px"], float(np.abs(
                np.asarray([c.bbox for c in g])
                - np.asarray([c.bbox for c in w])).max()))
            out["score"] = max(out["score"], float(np.abs(
                np.asarray([c.score for c in g])
                - np.asarray([c.score for c in w])).max()))
    return out


def layout_cells_matched(got, want) -> float:
    """Share of ``want``'s cells that a cell of ``got`` on the same page
    matches (same label, box within LAYOUT_BOX_TOL px, score within
    LAYOUT_SCORE_TOL), in any order."""
    import numpy as np

    matched = total = 0
    for g, w in zip(got, want):
        free = list(g)
        total += len(w)
        for c in w:
            for i, d in enumerate(free):
                if d.label == c.label and abs(d.score - c.score) \
                        <= LAYOUT_SCORE_TOL and np.abs(
                            np.subtract(d.bbox, c.bbox)).max() \
                        <= LAYOUT_BOX_TOL:
                    matched += 1
                    del free[i]
                    break
    return matched / max(total, 1)


def layout_stages(task, dev_pages) -> dict:
    """The chunk's stages, each timed alone (host_ms), and the NMS's
    fixed-point rounds."""
    import torch

    from pdf_table_tpu_torch.models.picodet.processor import (
        nms_dominance, nms_fixed_point)

    cfg = task.model_config
    with torch.inference_mode():
        x = task.preprocess(dev_pages)
        raw = task.model(x)
        cand = task.decode(raw)
        handle, metas = task.enqueue(dev_pages)
        packed = handle.cpu().numpy()
        alive, dom, _ = nms_dominance(cand[..., :4], cand[..., 4:], cfg)
        _, rounds = nms_fixed_point(alive, dom)
        stages = {
            "resize_normalize": host_ms(lambda: task.preprocess(dev_pages)),
            "forward": host_ms(lambda: task.model(x)),
            "decode_topk": host_ms(lambda: task.decode(raw)),
            "nms": host_ms(lambda: task.nms(cand)),
            "download": host_ms(lambda: handle.cpu()),
            "host_finish": host_ms(lambda: [
                task.post.to_layout_cells(task.post.from_device_nms(
                    packed[i], m["org_shape"])) for i, m in enumerate(metas)]),
        }
    return {"stage_ms": stages, "nms_rounds": rounds,
            "candidates": int(cand.shape[1])}


def phase_layout(card):
    """PicoDet at full width with bench.py's table arguments on the
    detection phase's 8 canvases, resident on the card; the card's
    survivors against the same port on the CPU."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.layout import (DOCX_SUB_BATCH,
                                                  OcrLayoutTask)

    (bucket, g), = pack_pages([make_page(i)
                               for i in range(DET_PAGES)]).items()
    canvases = g["images"]
    dev_pages = torch.from_numpy(canvases).cuda()
    t0 = time.perf_counter()
    tree = layout_tree(dev_pages)
    task = OcrLayoutTask(device="cuda", variables=tree, **LAYOUT_KW)
    build_s = time.perf_counter() - t0

    # the main path, counted: the lane reaches no Pallas kernel in JAX
    # and launches none of K1-K3
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cells = task.batch_infer_from_pages(dev_pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(launch_counts)
    check(sum(launches.values()) == 0,
          f"the layout lane launched {launches}")
    check(len(cells) == len(canvases), "one cell list per page")
    check(all(len(c) <= LAYOUT_KW["keep_top_k"] for c in cells),
          "more survivors than keep_top_k")
    check(sum(len(c) for c in cells) > 0, "no layout cell on any page")
    H, W = bucket
    for page in cells:
        for c in page:
            x1, y1, x2, y2 = c.bbox
            check(c.label == "table" and c.cell_type.name == "TABLE",
                  "the table head gives table cells")
            check(0 <= x1 <= x2 <= W and 0 <= y1 <= y2 <= H
                  and 0.05 < c.score <= 1.0, f"bad layout cell {c}")

    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(dev_pages)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    stages = layout_stages(task, dev_pages)
    prof = profile_run(lambda: task.batch_infer_from_pages(dev_pages))
    prof.pop("kernel_names")

    # the card against the same port on the CPU at bench.py's arguments;
    # then, for information, at a deeper keep list, cells matched in any
    # order: among 50 survivors a page, candidates whose scores lie within
    # the two runs' f32 difference can swap places or suppress each other
    # the other way
    cpu = OcrLayoutTask(device="cpu", variables=tree, **LAYOUT_KW)
    t0 = time.perf_counter()
    cmp = {"bench": layout_cells_diff(cells,
                                      cpu.batch_infer_from_pages(canvases))}
    cpu_s = time.perf_counter() - t0
    for t in (task, cpu):
        t.model_config.score_threshold = 0.3
        t.model_config.keep_top_k = 50
    deep = cpu.batch_infer_from_pages(canvases)
    cmp["keep50"] = {"cells": sum(len(c) for c in deep),
                     "matched_share": layout_cells_matched(
                         task.batch_infer_from_pages(dev_pages), deep)}
    summary = {
        "card": card, "pages": len(canvases), "canvas": list(bucket),
        "input": [task.model_config.img_height, task.model_config.img_width],
        "launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": len(canvases) / per_run,
        "ms_per_page": per_run * 1e3 / len(canvases),
        "peak_mem_gib": peak / 2 ** 30, "cells_per_page": [len(c)
                                                            for c in cells],
        **stages, "profile": prof, "cpu": {"run_s": cpu_s, **cmp},
    }
    print(json.dumps({"layout": summary}))
    c = cmp["bench"]
    check(c["same_count"] and c["same_labels"],
          "layout: the card's survivors differ from the CPU's")
    check(c["box_px"] <= LAYOUT_BOX_TOL,
          f"layout: boxes differ by {c['box_px']:.3g} px")
    check(c["score"] <= LAYOUT_SCORE_TOL,
          f"layout: scores differ by {c['score']:.3g}")
    return tree


SURFACE_GREY = 1e-4      # grey levels, warps and resizes
SURFACE_DECODE = 1e-5    # the decodes, of each value
SURFACE_SIZES = ((1224, 950), (1000, 800), (700, 950), (1224, 600))
SURFACE_OUT = (736, 576)
SURFACE_QUADS = 31
SURFACE_CROP = (48, 320)
SURFACE_K = 100


def port_exports() -> dict:
    """Every package of the port -> the names of its ``__all__``, each
    resolved with ``getattr`` (lazy exports import their module here)."""
    import importlib
    from pathlib import Path

    import pdf_table_tpu_torch

    root = Path(pdf_table_tpu_torch.__file__).parent
    out = {}
    for init in sorted(root.rglob("__init__.py")):
        rel = init.parent.relative_to(root).parts
        mod = importlib.import_module(".".join(("pdf_table_tpu_torch",)
                                               + rel))
        names = list(getattr(mod, "__all__", ()))
        for n in names:
            getattr(mod, n)
        if names:
            out[mod.__name__] = len(names)
    return out


def surface_inputs():
    """The surface phase's host inputs, from make_page and a seed."""
    import numpy as np

    from pdf_table_tpu_torch.ops import order_points_clockwise
    from pdf_table_tpu_torch.ops.image import pack_images

    rng = np.random.default_rng(0)
    pages = [make_page(i) for i in range(len(SURFACE_SIZES))]
    buf, hw = pack_images([p[:h, :w] for p, (h, w) in zip(pages,
                                                          SURFACE_SIZES)])
    quads = []
    for i in range(SURFACE_QUADS):
        cx, cy = rng.uniform(100, 850), rng.uniform(80, 1140)
        w, h = rng.uniform(60, 300), rng.uniform(16, 40)
        a = np.deg2rad(rng.uniform(-30, 30) if i % 3 == 0 else 0.0)
        d = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        quads.append(order_points_clockwise(d @ rot.T + (cx, cy)))
    ink = np.stack([255 - p[:, :, 0] for p in pages]).astype(np.float32)
    small = ink[:, ::4, ::4] / 255.0
    k = np.ones(5, np.float32) / 5
    blur = np.apply_along_axis(np.convolve, 1, small, k, "same")
    blur = np.apply_along_axis(np.convolve, 2, blur, k, "same")
    heat = (blur + rng.uniform(0, 1e-3, blur.shape)).astype(np.float32)
    B, H, W = heat.shape
    return {"buf": buf, "hw": hw, "page": pages[0], "quads": np.stack(quads),
            "mask": small[0] > 0.5, "ink": small[0].astype(np.float32),
            "heat": heat[..., None],
            "wh": rng.uniform(4, 60, (B, H, W, 2)).astype(np.float32),
            "reg": rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)}


def phase_surface(card, layout_v):
    """The public surface's device ops on the card, each held to the same
    call with its inputs on the CPU, and the port's package exports."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch import ops
    from pdf_table_tpu_torch.models.picodet.processor import \
        device_decode_nms
    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask

    exports = port_exports()
    x = surface_inputs()
    (_, g), = pack_pages([make_page(i) for i in range(DET_PAGES)]).items()
    layout = OcrLayoutTask(device=DEVICE, variables=layout_v, **LAYOUT_KW)
    with torch.inference_mode():
        raw = layout.forward(layout.preprocess(
            torch.from_numpy(g["images"]).to(DEVICE)))
    cfg = layout.model_config
    mats = ops.perspective_matrices(x["quads"], SURFACE_CROP)
    # NMS over the page's components, grown so that neighbours overlap,
    # their mean ink as scores: one set of boxes for both devices
    boxes, means, _, valid = ops.component_boxes(
        ops.connected_components(torch.from_numpy(x["mask"])),
        torch.from_numpy(x["ink"]), 512)
    grown = boxes[valid] + torch.tensor([-12., -12., 12., 12.])
    means = means[valid]

    def calls(dev):
        """Every op on ``dev``: name -> (output tensors, seconds)."""
        t = lambda a: torch.as_tensor(a).to(dev)
        out = {}

        def timed_call(name, fn, *args):
            """``fn(*args)`` twice, the second call timed (the first
            loads the device's kernels)."""
            fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            out[name] = (res if isinstance(res, tuple) else (res,),
                         time.perf_counter() - t0)
            return res

        with torch.inference_mode():
            timed_call("batch_resize_pad_normalize",
                       ops.batch_resize_pad_normalize, t(x["buf"]),
                       t(x["hw"]), SURFACE_OUT)
            timed_call("warp_perspective_batch", ops.warp_perspective_batch,
                       t(x["page"]), t(mats), SURFACE_CROP)
            timed_call("connected_components", ops.connected_components,
                       t(x["mask"]))
            timed_call("nms_mask", ops.nms_mask, t(grown), t(means), 0.3)
            timed_call("decode_centernet_bbox", ops.decode_centernet_bbox,
                       t(x["heat"]), t(x["wh"]), t(x["reg"]), SURFACE_K)
            timed_call("device_decode_nms", device_decode_nms,
                       {k: [a.to(dev) for a in v] for k, v in raw.items()},
                       cfg)
        return out

    torch.cuda.synchronize()
    reset_launch_counts()
    card_out = calls(DEVICE)
    launches = dict(launch_counts)
    cpu_out = calls("cpu")
    norm = 255 * min(cfg.norm_std)
    tol = {"batch_resize_pad_normalize": SURFACE_GREY / norm,
           "warp_perspective_batch": SURFACE_GREY}
    rows = {}
    for name, (got, card_s) in card_out.items():
        want, cpu_s = cpu_out[name]
        row = {"card_ms": card_s * 1e3, "cpu_ms": cpu_s * 1e3,
               "shape": [list(a.shape) for a in got]}
        for g_, w_ in zip(got, want):
            g_, w_ = g_.cpu(), w_.cpu()
            check(g_.shape == w_.shape and g_.dtype == w_.dtype,
                  f"surface: {name} gives {g_.shape} {g_.dtype} on the "
                  f"card, {w_.shape} {w_.dtype} on the CPU")
            if g_.dtype.is_floating_point:
                err = (g_ - w_).abs().max().item() if g_.numel() else 0.0
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
                if name in tol:
                    check(err <= tol[name], f"surface: {name} differs from "
                          f"the CPU by {err:.3g} (limit {tol[name]:.3g})")
                else:
                    lim = SURFACE_DECODE * (1 + w_.abs())
                    check(bool(((g_ - w_).abs() <= lim).all()),
                          f"surface: {name} differs from the CPU by {err:.3g}"
                          f" beyond {SURFACE_DECODE:g} of the value")
            else:
                check(torch.equal(g_, w_),
                      f"surface: {name}'s {g_.dtype} output differs from "
                      f"the CPU's")
        rows[name] = row
    surv = card_out["device_decode_nms"][0][0][..., 4].cpu()
    check(torch.equal(surv > 0, cpu_out["device_decode_nms"][0][0][..., 4]
                      > 0), "surface: device_decode_nms keeps other rows")
    labels = card_out["connected_components"][0][0]
    n_comp = int(torch.unique(labels[labels > 0]).numel())
    kept = int(card_out["nms_mask"][0][0].sum())
    summary = {"card": card, "launches": launches, "packages": len(exports),
               "exports": sum(exports.values()), "components": n_comp,
               "nms_boxes": int(card_out["nms_mask"][0][0].numel()),
               "nms_kept": kept, "survivors": int((surv > 0).sum()),
               "ops": rows}
    print(json.dumps({"surface": summary}))
    check(sum(launches.values()) == 0,
          f"surface: the ops launched {launches}")
    check(n_comp > 10 and 0 < kept < summary["nms_boxes"],
          "surface: the components or the NMS did no real work")
    check(summary["survivors"] > 0, "surface: no PicoDet survivor")
    return summary


# the token-model TSR phases (SLANet, TableMaster/MtlTabNet at full width,
# 500 decode steps) on the LORE slice's 8 table regions of 4 pages
TSR_PAGES = 4
TSR_BOXES = ((70, 100, 880, 560), (70, 620, 880, 1150))
TSR_RUNS = 1
TSR_TEACHER_TOL = 1e-4  # card vs CPU: cuDNN and oneDNN sum in other orders
TSR_TIE_GAP = 1e-4      # greedy ids compared up to the CPU's first near-tie
TSR_CPU_CROPS = 2       # crops held against the CPU (one of each size)
SLANET_BN_SCALE = 0.2   # LCNet: PicoDet's treatment (LAYOUT_BN_SCALE)
SLANET_GAIN = 30.0      # structure logits spread (the CPU tests' trees)
MASTER_VAR_GAIN = 4.0   # the residual encoder's variances, as the tests
MASTER_GAIN = 10.0
MASTER_SPECIAL_BIAS = -100.0   # <UKN>, <SOS>, <PAD>
PIPE_TSR_RUNS = 1
# the TableMaster arm decodes 16 crops a chunk at some 2 s a sub-batch of
# 8 on the host's launches: one chunk of 8 pages, one page on the CPU
PIPE_ARM_PAGES = {"SLANet": (PIPE_PAGES, PIPE_CPU_PAGES),
                  "TableMaster": (8, 1), "CenterNet": (PIPE_PAGES, 1)}
PHASE_NAMES = {"SLANet": "tsr_slanet", "TableMaster": "tsr_master",
               "CenterNet": "tsr_centernet"}
ARM_KINDS = {"SLANet": "slanet", "TableMaster": "master",
             "CenterNet": "center_net"}


def tsr_inputs():
    import numpy as np

    pages = np.stack([make_page(i) for i in range(TSR_PAGES)])
    regions = [(pi, box) for pi in range(TSR_PAGES) for box in TSR_BOXES]
    return pages, regions


def token_tree(model: str, dev_pages, regions, base=None):
    """A seeded full-width tree for ``model`` calibrated on the card on the
    task's own crops of ``regions``: SLANet with BatchNorm scale 0.2 and
    its structure logits x SLANET_GAIN; TableMaster with its variances x
    MASTER_VAR_GAIN, its class logits x MASTER_GAIN and <UKN>, <SOS>,
    <PAD> out of reach (random weights emit <SOS> at every step
    otherwise). MtlTabNet: ``base``, TableMaster's tree, plus the cell
    branch's seeded parameters, so that its structure outputs must equal
    TableMaster's."""
    import torch

    from pdf_table_tpu_torch.engine.params import (
        calibrate_batch_stats, init_slanet, init_table_master,
        scale_batch_variances, set_batch_norm_scale)
    from pdf_table_tpu_torch.models.table_master.config import \
        TableMasterConfig
    from pdf_table_tpu_torch.models.table_master.vocab import (
        MasterStructureVocab, load_pubtabnet_textline_alphabet)
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    if model == "MtlTabNet":
        cfg = TableMasterConfig(variant="mtl_tabnet", cell_vocab_size=len(
            load_pubtabnet_textline_alphabet()) + 4)
        cell = init_table_master(cfg, 0)["params"]
        params = dict(base["params"])
        params.update({k: v for k, v in cell.items()
                       if k.startswith(("cell", "fc_cell"))})
        return {"params": params, "batch_stats": base["batch_stats"]}
    task = OcrTableStructureTask(model=model, device="cuda", **F32)
    cfg = task.model_config
    (_sub, _metas, x), = task.sub_batches(dev_pages, regions)
    net = task.model
    if model == "SLANet":
        net.forward = net.encode
        tree = calibrate_batch_stats(
            net, set_batch_norm_scale(init_slanet(cfg, 0), SLANET_BN_SCALE),
            x)
        tree["params"]["head"]["fc_struct1"] *= SLANET_GAIN
    else:
        net.forward = net.memory
        tree = scale_batch_variances(calibrate_batch_stats(
            net, init_table_master(cfg, 0), x), MASTER_VAR_GAIN)
        tree["params"]["fc_cls"] *= MASTER_GAIN
        v = MasterStructureVocab()
        tree["params"]["fc_cls_b"][[v.unknown_id, v.sos_id, v.pad_id]] = \
            MASTER_SPECIAL_BIAS
    del net.forward
    torch.cuda.synchronize()
    return tree


def near_tie(probs) -> int:
    """First step whose top-1/top-2 gap is under TSR_TIE_GAP (the length
    when none is)."""
    import numpy as np

    top2 = np.sort(probs, axis=-1)[..., -2:]
    close = np.nonzero(top2[:, 1] - top2[:, 0] < TSR_TIE_GAP)[0]
    return int(close[0]) if len(close) else len(probs)


def split_decode(task):
    """(encode, decode) of the task's model: SLANet's trunk + neck and
    head, TableMaster's memory and decode."""
    m = task.model
    if task.model_name == "SLANet":
        return m.encode, lambda f, teacher=None: m.head(f, teacher)
    return m.memory, lambda f, teacher=None: m.decode(f, teacher)


def device_launches(fn) -> int:
    """Kernels launched on the card by one ``fn()``, from a device-only
    trace."""
    from torch.profiler import ProfilerActivity

    _wall, events = _trace(fn, [ProfilerActivity.CUDA])
    return sum(e.count for e in events)


def tsr_stages(task, dev_pages, regions) -> dict:
    """One sub-batch's stages, each timed alone (host_ms), and the
    decode's launches."""
    import torch

    encode, decode = split_decode(task)
    with torch.inference_mode():
        (sub, metas, x), = task.sub_batches(dev_pages, regions)
        feat = encode(x)
        out = decode(feat)
        packed = torch.cat([out["structure_probs"], out["loc_preds"]], -1)
        packed_np = packed.cpu().numpy()
        stages = {
            "crop_pre": host_ms(lambda: list(task.sub_batches(dev_pages,
                                                              regions))),
            "encoder": host_ms(lambda: encode(x)),
            "decode": host_ms(lambda: decode(feat), iters=1),
            "download": host_ms(lambda: packed.cpu()),
            "host_post": host_ms(lambda: [
                task._post_one(packed_np[j:j + 1], m)
                for j, m in enumerate(metas)]),
        }
        launches = device_launches(lambda: decode(feat))
    steps = task.model_config.max_structure_len
    return {"stage_ms": stages, "decode_launches": launches,
            "decode_launches_per_step": launches / steps,
            "crops": len(sub)}


def tsr_agreement(task, cpu, dev_pages, pages, regions) -> dict:
    """The card against the same port on the CPU on the first
    TSR_CPU_CROPS crops (a full-width TableMaster encoder takes some 10 s
    a crop on the card machine's CPU): the inputs bit for bit,
    teacher-forced probabilities and locs (teacher: the CPU's greedy
    ids), greedy ids up to the CPU's first near-tie. Each side encodes
    once and decodes twice."""
    import numpy as np
    import torch

    regions = regions[:TSR_CPU_CROPS]

    def run(t, src, teacher=None):
        encode, decode = split_decode(t)
        (_s, _m, x), = t.sub_batches(src, regions)
        feat = encode(x)
        greedy = {k: v.cpu().numpy() for k, v in decode(feat).items()}
        ids = torch.from_numpy(greedy["structure_probs"].argmax(-1))
        forced = decode(feat, (ids if teacher is None else teacher)
                        .to(x.device))
        return (x.cpu(), greedy, {k: v.cpu().numpy()
                                  for k, v in forced.items()}, ids)

    with torch.inference_mode():
        t0 = time.perf_counter()
        xc, want, want_t, ids = run(cpu, pages)
        cpu_s = time.perf_counter() - t0
        x, got, got_t, _ = run(task, dev_pages, teacher=ids)
    prefixes, equal = [], 0
    for b in range(len(ids)):
        t = near_tie(want["structure_probs"][b])
        prefixes.append(t)
        equal += bool((got["structure_probs"][b, :t].argmax(-1)
                       == ids[b, :t].numpy()).all())
    return {"inputs_equal": bool(torch.equal(x, xc)),
            "teacher_probs_max_abs": float(np.abs(
                got_t["structure_probs"] - want_t["structure_probs"]).max()),
            "teacher_locs_max_abs": float(np.abs(
                got_t["loc_preds"] - want_t["loc_preds"]).max()),
            "greedy_prefixes": prefixes, "greedy_equal_crops": equal,
            "crops": len(ids), "cpu_s": cpu_s,
            "tokens_per_crop": [len(task.post.vocab.decode(r.tolist()))
                                for r in ids]}


def phase_tsr(card, model: str, pages, regions, base=None):
    """``OcrTableStructureTask(model)`` at full width (T = 500) on 8 table
    regions cut from the resident canvases, through
    ``batch_infer_from_pages``: the counted run (no K1-K3 launch: the
    lane reaches no Pallas kernel in JAX), crops/s (median of runs), stage
    ms, the decode's launches, peak memory, idle share and agreement with
    the same port on the CPU. Returns the tree and the launch counts."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    t0 = time.perf_counter()
    dev_pages = torch.from_numpy(pages).cuda()
    tree = token_tree(model, dev_pages, regions, base)
    task = OcrTableStructureTask(model=model, device="cuda", variables=tree,
                                 **F32)
    build_s = time.perf_counter() - t0
    cfg = task.model_config

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(dev_pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    check(sum(launches.values()) == 0,
          f"the {model} lane launched {launches}")
    kind = "slanet" if model == "SLANet" else "master"
    vocab = set(task.post.vocab.tokens)
    check(len(results) == len(regions)
          and all(r["type"] == kind for r in results),
          f"{model}: one {kind} result per region")
    check(all(set(r["structure_tokens"]) <= vocab for r in results),
          f"{model}: tokens outside the vocabulary")
    check(all(np.isfinite(c["bbox"]).all() for r in results
              for c in r["cells"]), f"{model}: cells are not finite")
    check(sum(len(r["structure_tokens"]) for r in results) > 0,
          f"{model}: no structure token")

    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(TSR_RUNS):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(dev_pages, regions)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    stages = tsr_stages(task, dev_pages, regions)
    # TableMaster's full trace (host ops of some 80,000 launches) is the
    # light one alone: the phase was the smoke's longest
    prof = profile_run(lambda: task.batch_infer_from_pages(dev_pages,
                                                           regions),
                       full=model != "TableMaster")
    prof.pop("kernel_names", None)
    cpu = OcrTableStructureTask(model=model, device="cpu", variables=tree,
                                **F32)
    agree = tsr_agreement(task, cpu, dev_pages, pages, regions)
    summary = {
        "card": card, "model": model, "variant": getattr(
            cfg, "variant", "slanet"), "crops": len(regions),
        "input": list(task.input_hw), "steps": cfg.max_structure_len,
        "launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "peak_mem_gib": peak / 2 ** 30, **stages, "profile": prof,
        "tokens": [len(r["structure_tokens"]) for r in results],
        "cells": [len(r["cells"]) for r in results],
        "cpu": agree}
    print(json.dumps({PHASE_NAMES[model]: summary}))
    check(agree["inputs_equal"], f"{model}: the card's crops differ from "
          f"the CPU's")
    check(agree["teacher_probs_max_abs"] <= TSR_TEACHER_TOL
          and agree["teacher_locs_max_abs"] <= TSR_TEACHER_TOL,
          f"{model}: teacher-forced outputs differ from the CPU's: "
          f"{agree['teacher_probs_max_abs']:.3g}, "
          f"{agree['teacher_locs_max_abs']:.3g}")
    check(agree["greedy_equal_crops"] == agree["crops"],
          f"{model}: greedy ids differ from the CPU's before the first "
          f"near-tie (prefixes {agree['greedy_prefixes']})")
    return tree, results, launches


def phase_mtl_tabnet(card, pages, regions, master_tree, master_results):
    """MtlTabNet: TableMaster's tree plus the cell branch's parameters
    loads into the MtlTabNet task, whose structure path must give
    TableMaster's results (the cell branch is not decoded, as in JAX)."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    dev_pages = torch.from_numpy(pages).cuda()
    tree = token_tree("MtlTabNet", dev_pages, regions, master_tree)
    task = OcrTableStructureTask(model="MtlTabNet", device="cuda",
                                 variables=tree)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(dev_pages, regions)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    same = [a["structure_tokens"] == b["structure_tokens"]
            for a, b in zip(results, master_results)]
    print(json.dumps({"tsr_mtl_tabnet": {
        "card": card, "variant": task.model_config.variant,
        "cell_vocab_size": task.model_config.cell_vocab_size,
        "launches": launches, "run_s": run_s,
        "same_tokens_as_table_master": sum(same), "crops": len(same)}}))
    check(sum(launches.values()) == 0, f"MtlTabNet launched {launches}")
    check(all(same), "MtlTabNet's structure tokens differ from "
          "TableMaster's on the same structure weights")
    return launches


def add_lines(quads, shapes):
    """bench.py's line grid (bench.py:90-121), copied: up to 30
    axis-aligned quads a page, after the detected ones."""
    import numpy as np

    out = []
    for (h, w), q in zip(shapes, quads):
        rng = np.random.default_rng(int(h) * 7 + int(w))
        lines = []
        y = 60
        while y < h - 80 and len(lines) < REC_LINES:
            x = 70
            ww = int(rng.integers(120, 360))
            lines.append([[x, y], [x + ww, y],
                          [x + ww, y + 22], [x, y + 22]])
            y += 36
        out.append(np.concatenate(
            [np.asarray(q).reshape(-1, 4, 2),
             np.asarray(lines, np.float32)], axis=0))
    return out


def build_pipeline(device, trees, tsr="Lore", policy=False, mesh=None):
    """The port's BatchPipeline with bench.py's configuration
    (bench.py:73-88): det thresholds, the table layout head, rec en, LORE
    wireless f32 with res_buckets="auto", no page orientation check, the
    0/180 textline classifier on; the line grid injected through
    ``_boxes_finish``. With ``tsr`` "SLANet", "TableMaster" or
    "CenterNet" the system builds that TSR task itself (full width, T =
    500) on ``trees["tsr"]`` through
    ``OcrSystemConfig.table_structure_kwargs``; with "LoreAndLineCell" the
    LORE task of the pipeline phase plus the line cells, on
    ``trees["lore"]``. Every model is f32, unless ``policy``: then the
    registry models (detection, PicoDet, recognition, LORE) get no dtype,
    and the port's policy gives them bf16 on the card, as JAX's registry
    gives them bf16 on its accelerator. With a dp ``mesh`` every task is
    built on it (a collective: the same order on every rank)."""
    from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
    from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
    from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    def pin(kw):
        return {k: v for k, v in kw.items() if k != "dtype"} if policy \
            else dict(kw, **F32)

    cfg = OcrSystemConfig(use_layout=True, use_table=True,
                          use_orientation_cls=False,
                          table_structure_model=tsr)
    if tsr == "LoreAndLineCell":
        cfg.table_structure_kwargs = dict(
            task_type="wireless", variables=trees["lore"],
            res_buckets="auto", **pin(PIPE_LORE_KW))
    elif tsr != "Lore":
        cfg.table_structure_kwargs = {"variables": trees["tsr"], **F32}
    bp = BatchPipeline(cfg, mesh=mesh, batch_pages=8, device=device)
    s = bp.system
    s._det = OcrDetectionTask(model="PP-OCRv4_det", device=device,
                              mesh=mesh, **pin(DET_KW))
    s._layout = OcrLayoutTask(model="picodet", device=device, mesh=mesh,
                              variables=trees["layout"], **pin(LAYOUT_KW))
    s._rec = OcrRecognitionTask(model=cfg.recognizer_model, lang=cfg.lang,
                                device=device, variables=trees["rec"],
                                mesh=mesh, **pin({}))
    s._line_cls = ClsImagePulcTask("textline_orientation", device=device,
                                   variables=trees["cls"], mesh=mesh)
    if tsr == "Lore":
        s._tsr = OcrTableStructureTask(model="Lore", task_type="wireless",
                                       device=device, variables=trees["lore"],
                                       res_buckets="auto", mesh=mesh,
                                       **pin(PIPE_LORE_KW))
    orig = bp._boxes_finish
    bp._boxes_finish = lambda packed, shapes, bucket_hw, prob_hw: add_lines(
        orig(packed, shapes, bucket_hw, prob_hw), shapes)
    return bp


def pipeline_diff(got, want) -> dict:
    """Page outputs of the card and the CPU on the same pages."""
    import numpy as np

    out = {"quads_same_count": True, "quad_px": 0.0, "crops": 0,
           "equal_texts": 0, "layout": layout_cells_diff(
               [o.layout_cells for o in got], [o.layout_cells for o in want]),
           "table_html_equal": 0, "tables": 0, "page_html_checked": 0,
           "page_html_equal": 0}
    for g, w in zip(got, want):
        gq = np.asarray([c.poly for c in g.text_cells])
        wq = np.asarray([c.poly for c in w.text_cells])
        out["quads_same_count"] &= gq.shape == wq.shape
        if gq.shape == wq.shape and len(gq):
            out["quad_px"] = max(out["quad_px"], float(np.abs(gq - wq).max()))
        texts_equal = [a.text == b.text
                       for a, b in zip(g.text_cells, w.text_cells)]
        out["crops"] += len(w.text_cells)
        out["equal_texts"] += sum(texts_equal)
        out["tables"] += len(w.table_html)
        out["table_html_equal"] += sum(a == b for a, b in
                                       zip(g.table_html, w.table_html))
        if gq.shape == wq.shape and all(texts_equal) \
                and g.table_html == w.table_html:
            out["page_html_checked"] += 1
            out["page_html_equal"] += g.page_html == w.page_html
    out["text_share"] = out["equal_texts"] / max(out["crops"], 1)
    return out


def phase_pipeline(card, layout_v):
    """The port's BatchPipeline.run end to end on 16 pages (two chunks of
    8) at full width: warm-up, one counted run, timed runs; then 2 pages
    against the same pipeline on the CPU."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.table_structure import lore_config

    imgs = [make_page(i) for i in range(PIPE_PAGES)]
    pages = [{"image": im, "page": i} for i, im in enumerate(imgs)]
    t0 = time.perf_counter()
    (bucket, g), = pack_pages(imgs[:DET_PAGES]).items()
    rec_v, cls_v = rec_cls_trees(g["images"])
    trees = {"layout": layout_v, "rec": rec_v, "cls": cls_v,
             "lore": lore_variables(lore_config("wireless", **PIPE_LORE_KW))}
    bp = build_pipeline("cuda", trees)
    build_s = time.perf_counter() - t0
    n_chunks = -(-PIPE_PAGES // bp.batch_pages)

    t0 = time.perf_counter()
    bp.run(pages)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # the main path, counted; LORE forwards counted beside K1's launches
    tsr_model = bp.system.tsr_task.model
    forwards = []
    real_forward = tsr_model.forward_packed
    tsr_model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                          real_forward(x))[1]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    del tsr_model.forward_packed
    check(len(out) == PIPE_PAGES, "one output per page")
    errors = [o.metric.get("error") for o in out if o.metric.get("error")]
    check(not errors, f"pages carry errors: {errors[:3]}")
    check(all(o.page_html for o in out), "a page has no page_html")
    n_tables = sum(len(o.table_structures) for o in out)
    check(n_tables > 0 and forwards, "no table reached LORE")
    check(launches["resize_normalize"] == n_chunks,
          f"K3 launched {launches['resize_normalize']} times for "
          f"{n_chunks} chunks")
    check(launches["deform_conv2d"] == 16 * len(forwards),
          f"K1 launched {launches['deform_conv2d']} times for "
          f"{len(forwards)} LORE sub-batches (16 DCNs each)")
    check(launches["deform_conv2d_flat_kc"] == 0, "K2 ran on the f32 path")

    torch.cuda.reset_peak_memory_stats()
    run_s, lanes = [], []
    for _ in range(PIPE_RUNS):
        t0 = time.perf_counter()
        bp.run(pages)
        run_s.append(time.perf_counter() - t0)
        lanes.append(bp.last_stats)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    lane_ms = {k: statistics.median(st[k] for st in lanes) * 1e3
               for k in lanes[0] if k != "n_pages"}
    prof = f32_body_traced(profile_run(lambda: bp.run(pages)), "pipeline")

    # 2 pages on the card against the same pipeline on the CPU
    few = pages[:PIPE_CPU_PAGES]
    got = bp.run(few)
    cpu = build_pipeline("cpu", trees)
    t0 = time.perf_counter()
    want = cpu.run(few)
    cpu_s = time.perf_counter() - t0
    cmp = pipeline_diff(got, want)
    summary = {
        "card": card, "pages": PIPE_PAGES, "chunks": n_chunks,
        "canvas": list(bucket), "launches": launches,
        "lore_sub_batches": forwards, "model_build_s": build_s,
        "warm_up_s": warm_s, "counted_run_s": counted_s,
        "run_s_median": per_run, "run_s_min": min(run_s),
        "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": PIPE_PAGES / per_run,
        "ms_per_page": per_run * 1e3 / PIPE_PAGES, "lane_ms": lane_ms,
        "peak_mem_gib": peak / 2 ** 30, "tables": n_tables,
        "text_cells": sum(len(o.text_cells) for o in out),
        "layout_cells": sum(len(o.layout_cells) for o in out),
        "page_html_bytes": [len(o.page_html) for o in out[:4]],
        "profile": prof, "cpu": {"run_s": cpu_s, **cmp},
    }
    print(json.dumps({"pipeline": summary}))
    check(not [o for o in want if o.metric.get("error")],
          "the CPU pipeline gave errors")
    check(cmp["quads_same_count"] and cmp["quad_px"] <= PIPE_QUAD_TOL,
          f"quads differ from the CPU's: {cmp['quad_px']:.3g} px")
    lay = cmp["layout"]
    check(lay["same_count"] and lay["same_labels"]
          and lay["box_px"] <= LAYOUT_BOX_TOL
          and lay["score"] <= LAYOUT_SCORE_TOL,
          f"layout survivors differ from the CPU's: {lay}")
    check(cmp["text_share"] >= PIPE_TEXT_MIN,
          f"texts equal on {cmp['text_share']:.3f} of crops")
    check(cmp["page_html_equal"] == cmp["page_html_checked"],
          "page_html differs where its inputs are equal")
    return launches, trees, out

# bf16_models: timed forwards per model and dtype, in two rounds (f32,
# bf16, then bf16, f32), and the bf16-vs-f32 gap of the heads on the card
# (printed: random trees calibrated on mostly white pages keep channels of
# near-zero variance, whose BatchNorm multiplies bf16's round-off by up to
# 1 / sqrt(eps), so the gap says how the tree amplifies round-off, not
# whether bf16 is right). The checks, on the first BF16_CPU_ITEMS inputs
# (RMS relative to the largest magnitude): the card's bf16 heads finite and
# within BF16_CPU_RMS of the same bf16 model on the CPU, which the CPU
# tests hold to JAX's bf16 models (cuDNN and oneDNN sum in other orders:
# the largest reading 4.9e-3, LightweightEdge); and bf16 on the card: its
# heads at least BF16_OWN_MIN as far from the card's f32 heads as the CPU's
# bf16 heads are. The smallest bf16-vs-f32 gap (4.5e-4, ProxylessNAS) lies
# under the largest card-vs-CPU reading, so closeness alone cannot tell a
# card path that lost bf16; the second check does, and the card's f32
# heads, put in place of its bf16 ones, must fail the two (the control)
BF16_RUNS = 3
BF16_CPU_ITEMS = 2
BF16_CPU_RMS = 1e-2
BF16_OWN_MIN = 0.5
# PP-LCNet's two-class probabilities saturate on most crops (the card's
# bf16 equalled the CPU's on the first 2): more crops, for a gap to f32
BF16_CLS_ITEMS = 32
# tsr_host_crop: the card against the CPU on the first TSR_CPU_CROPS crops'
# warp_u8 inputs and on __call__'s float-warp input (f32 on both sides,
# cuDNN and oneDNN sum in other orders), slot by slot on every compared
# input, with the slice's tolerances: the share of valid slots (by their
# centre) valid in both runs at least MATCH_MIN (a slot at the visibility
# threshold goes either way), the dets of the common slots within
# HOST_CROP_DETS_PX feature-map px (the heads do not see the other slots),
# their logical coordinates within LOGI_TOL of the largest (the regressor
# attends over all valid slots, so one slot more moves them all). The cells
# and table HTML, which the random wireless tree's some 240 cells a crop
# make chaotic (one slot at the visibility threshold or one logical
# coordinate at .5 regroups a row), are compared and printed
HOST_CROP_DETS_PX = 1e-3


def head_gap(got, want) -> dict:
    """Heads ``got`` against ``want`` (lists of tensors, on any device):
    RMS and max of the difference, relative to ``want``'s largest
    magnitude, and whether ``got`` is finite."""
    import torch

    got = torch.cat([t.float().reshape(-1).cpu() for t in got])
    want = torch.cat([t.float().reshape(-1).cpu() for t in want])
    scale = max(float(want.abs().max()), 1e-6)
    d = (got - want).double()
    return {"rms": float(d.pow(2).mean().sqrt()) / scale,
            "max": float(d.abs().max()) / scale,
            "finite": bool(torch.isfinite(got).all())}


def bf16_pair(card, name, build, forward, x, first, extra=None) -> dict:
    """``build(dtype, device)`` in f32 and in bf16 on the card, on the
    same tree: each model's ``forward(model, x)`` timed with CUDA events
    in two rounds, its peak memory, the bf16 heads against the f32 ones;
    then, on ``first(device)`` (the first BF16_CPU_ITEMS inputs on that
    device), the card's bf16 heads against the bf16 model's on the CPU and
    against the card's f32 heads, with the card's f32 heads in their place
    as the control that must fail."""
    import torch

    runs, heads, peak = {}, {}, {}
    models = {d: build(d, "cuda") for d in ("float32", "bfloat16")}
    with torch.inference_mode():
        for d in ("float32", "bfloat16", "bfloat16", "float32"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs.setdefault(d, []).append(cuda_ms(
                lambda: forward(models[d], x), BF16_RUNS))
            peak[d] = torch.cuda.max_memory_allocated() / 2 ** 30
            heads[d] = forward(models[d], x)
        gap = head_gap(heads["bfloat16"], heads["float32"])
        few = {d: forward(m, first(torch.device("cuda")))
               for d, m in models.items()}
        cpu_few = forward(build("bfloat16", "cpu"),
                          first(torch.device("cpu")))
    ref = head_gap(cpu_few, few["float32"])["rms"]

    def bf16_held(card_few):
        """The card's heads against the CPU's bf16 heads and, for their
        own bf16-ness, against the card's f32 heads."""
        cpu = head_gap(card_few, cpu_few)
        own = head_gap(card_few, few["float32"])["rms"]
        return cpu, own, (cpu["rms"] < BF16_CPU_RMS
                          and own >= BF16_OWN_MIN * ref and ref > 0)

    cpu, own, held = bf16_held(few["bfloat16"])
    _, own32, control_held = bf16_held(few["float32"])
    ms = {d: statistics.mean(r) for d, r in runs.items()}
    row = {"card": card, "f32_ms": ms["float32"], "bf16_ms": ms["bfloat16"],
           "f32_ms_rounds": runs["float32"],
           "bf16_ms_rounds": runs["bfloat16"],
           "speedup": ms["float32"] / ms["bfloat16"],
           "peak_gib_f32": peak["float32"], "peak_gib_bf16": peak["bfloat16"],
           "gap_f32_rms": gap["rms"], "gap_f32_max": gap["max"],
           "cpu_bf16_rms": cpu["rms"], "cpu_bf16_max": cpu["max"],
           "card_bf16_to_f32_rms": own, "cpu_bf16_to_card_f32_rms": ref,
           "control_f32_passes": control_held, **(extra or {})}
    print(json.dumps({f"bf16_models_{name}": row}))
    check(gap["finite"] and cpu["finite"],
          f"bf16 {name}: outputs are not finite")
    check(held, f"bf16 {name}: the card's bf16 heads are {cpu['rms']:.3g} "
          f"(RMS) from the CPU's, {own:.3g} from its f32 heads (the CPU's "
          f"bf16 {ref:.3g})")
    check(not control_held, f"bf16 {name}: the card's f32 heads pass as "
          f"bf16 ({own32:.3g} from themselves)")
    del models
    torch.cuda.empty_cache()
    return row


def head_items(x, n=BF16_CPU_ITEMS):
    """``first`` of :func:`bf16_pair` for a batched tensor or a list of
    batched tensors: a function of the device giving the first ``n``
    items there."""
    if isinstance(x, list):
        return lambda dev: [t[:n].to(dev) for t in x[:1]]
    return lambda dev: x[:n].to(dev)


def phase_bf16_models(card):
    """Every model that gained bf16 in the twelfth slice, f32 and bf16 at
    full width on the card, on the trees and inputs of its f32 phase: the
    four DBNets on a chunk of 8 at 960x720, PicoDet on the chunk, the four
    recognizers and the 0/180 PP-LCNet on the recognition phase's crops
    (248), the SLANet and TableMaster encoders on a sub-batch of 8 crops
    (their decodes are f32 and unchanged) and LGPMA on one crop. Per
    model the forward ms of both dtypes (CUDA events), the speed-up, peak
    memory, the bf16-vs-f32 gap, and the card's bf16 against the CPU's.
    Returns the rows by name."""
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.dbnet.model import DBNet
    from pdf_table_tpu_torch.models.lgpma.model import LGPMA
    from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
    from pdf_table_tpu_torch.models.picodet.model import PicoDet
    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
    from pdf_table_tpu_torch.tasks.detection import (OcrDetectionTask,
                                                     det_config)
    from pdf_table_tpu_torch.tasks.layout import resize_bilinear_aa
    from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    def loaded(net, tree, device):
        load_flax_variables(net, tree)
        return net.eval().to(device)

    rows = {}
    pages = [make_page(i) for i in range(DET_PAGES)]
    (bucket, g), = pack_pages(pages).items()
    canvases = g["images"]
    dev_canvases = torch.from_numpy(canvases).cuda()
    for model in ("PP-OCRv4_det",) + DET_MODELS:
        probe = OcrDetectionTask(model=model, device="cuda", **DET_KW)
        tree = det_backbone_tree(probe, pages)
        with torch.inference_mode():
            x = probe.normalize(dev_canvases, probe.det_size(bucket))
        del probe
        rows[model] = bf16_pair(
            card, model, lambda d, dev: loaded(DBNet(det_config(
                model, **dict(DET_KW, dtype=d))), tree, dev),
            lambda m, x: [m(x)["prob"]], x, head_items(x),
            {"input": list(x.shape)})

    layout_v = layout_tree(dev_canvases)
    cfg = PicoDetConfig(**LAYOUT_KW)
    mean = torch.tensor(cfg.norm_mean, device="cuda")
    std = torch.tensor(cfg.norm_std, device="cuda")
    with torch.inference_mode():
        x = resize_bilinear_aa(dev_canvases, (cfg.img_height, cfg.img_width))
        x = ((x / 255.0 - mean) / std).contiguous()
    rows["picodet"] = bf16_pair(
        card, "picodet", lambda d, dev: loaded(
            PicoDet(PicoDetConfig(**dict(LAYOUT_KW, dtype=d))), layout_v,
            dev),
        lambda m, x: [t for v in m(x).values() for t in v], x,
        head_items(x), {"input": list(x.shape)})

    quads = rec_quads(g["shapes"])
    rec_v, cls_v = rec_cls_trees(canvases)
    cls = ClsImagePulcTask("textline_orientation", device="cuda",
                           variables=cls_v)
    n_crops = sum(len(q) for q in quads)
    for model in ("PP-OCRv4_rec",) + REC_MODELS:
        tree = rec_v if model == "PP-OCRv4_rec" \
            else rec_backbone_tree(model, canvases)
        # the crops at this recognizer's own geometry, cut once
        probe = OcrRecognitionTask(model=model, device="cuda",
                                   variables=tree, cls_task=cls, **F32)
        with torch.inference_mode():
            cut = [probe.cut(dev_canvases, grp, probe.upload(grp))
                   for grp in probe.plan(quads)]
            crops = [probe.orient(*c) for c in cut]
        if model == "PP-OCRv4_rec":
            cls_in = torch.cat([c[2] for c in cut])
            rows["PP-LCNet"] = bf16_pair(
                card, "PP-LCNet", lambda d, dev: ClsImagePulcTask(
                    "textline_orientation", device=dev, variables=cls_v,
                    dtype=d), lambda t, x: [t.probs(x)], cls_in,
                head_items(cls_in, BF16_CLS_ITEMS),
                {"input": list(cls_in.shape)})
        del probe, cut
        rows[model] = bf16_pair(
            card, model, lambda d, dev: OcrRecognitionTask(
                model=model, device=dev, variables=tree, dtype=d),
            lambda t, cs: [t.logits(c) for c in cs], crops,
            head_items(crops), {"crops": n_crops})
        del crops

    tsr_pages, regions = tsr_inputs()
    dev_pages = torch.from_numpy(tsr_pages).cuda()
    for model, encode in (("SLANet", lambda m, x: [m.encode(x)]),
                          ("TableMaster", lambda m, x: [m.memory(x)])):
        tree = token_tree(model, dev_pages, regions)
        probe = OcrTableStructureTask(model=model, device="cuda",
                                      variables=tree, **F32)
        (_sub, _metas, x), = probe.sub_batches(dev_pages, regions)
        del probe
        rows[model] = bf16_pair(
            card, model, lambda d, dev: OcrTableStructureTask(
                model=model, device=dev, variables=tree,
                dtype=d).model, encode, x, head_items(x),
            {"input": list(x.shape)})
    probe = OcrTableStructureTask(model="Lgpma", device="cuda", **F32)
    tree = lgpma_tree(probe, dev_pages, regions)
    (_s, _m, x), *_ = probe.sub_batches(dev_pages, regions)
    lg_cfg = probe.model_config
    del probe
    rows["Lgpma"] = bf16_pair(
        card, "Lgpma", lambda d, dev: loaded(LGPMA(type(lg_cfg)(
            **dict(vars(lg_cfg), dtype=d))), tree, dev),
        lambda m, x: [m(x)[k] for k in ("gpma_seg", "gpma_reg")], x,
        head_items(x), {"input": list(x.shape)})
    return rows


def phase_pipeline_bf16(card, trees, f32_out):
    """bench.py's configuration as ``build_pipeline`` copies it with no
    dtype passed: the port's policy gives bf16 on the card to detection,
    PicoDet, recognition and LORE, as JAX's registry does on its
    accelerator. The pipeline phase's 16 pages: warm-up, one counted run
    (K3 once a chunk, K1's bf16 body and K2 over LORE's 16 DCNs a
    sub-batch), timed runs; pages/s, lanes, idle share, peak memory, and
    the agreement with the f32 pipeline phase's run on the same pages
    (reported, not checked). Returns the launch counts."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)

    imgs = [make_page(i) for i in range(PIPE_PAGES)]
    pages = [{"image": im, "page": i} for i, im in enumerate(imgs)]
    t0 = time.perf_counter()
    bp = build_pipeline("cuda", trees, policy=True)
    s = bp.system
    dtypes = {"det": s.det_task.model_config.dtype,
              "layout": s.layout_task.model_config.dtype,
              "rec": s.rec_task.model_config.dtype,
              "tsr": s.tsr_task.model_config.dtype}
    check(set(dtypes.values()) == {"bfloat16"},
          f"the policy gave {dtypes} on the card")
    build_s = time.perf_counter() - t0
    n_chunks = -(-PIPE_PAGES // bp.batch_pages)
    bp.run(pages)                       # warm-up
    tsr_model = s.tsr_task.model
    forwards = []
    real_forward = tsr_model.forward_packed
    tsr_model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                          real_forward(x))[1]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    del tsr_model.forward_packed
    check(len(out) == PIPE_PAGES, "one output per page")
    errors = [o.metric.get("error") for o in out if o.metric.get("error")]
    check(not errors, f"bf16 pages carry errors: {errors[:3]}")
    check(all(o.page_html for o in out), "a bf16 page has no page_html")
    check(launches["resize_normalize"] == n_chunks,
          f"K3 launched {launches['resize_normalize']} times for "
          f"{n_chunks} chunks")
    check(forwards and launches["deform_conv2d"] > 0
          and launches["deform_conv2d"]
          + launches["deform_conv2d_flat_kc"] == 16 * len(forwards),
          f"K1 {launches['deform_conv2d']} and K2 "
          f"{launches['deform_conv2d_flat_kc']} launches for "
          f"{len(forwards)} LORE sub-batches (16 DCNs each)")
    torch.cuda.reset_peak_memory_stats()
    run_s, lanes = [], []
    for _ in range(PIPE_RUNS):
        t0 = time.perf_counter()
        bp.run(pages)
        run_s.append(time.perf_counter() - t0)
        lanes.append(bp.last_stats)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    lane_ms = {k: statistics.median(st[k] for st in lanes) * 1e3
               for k in lanes[0] if k != "n_pages"}
    prof = profile_run(lambda: bp.run(pages))
    names = prof.pop("kernel_names")
    check(any("dcn_wgmma_kernel" in n for n in names),
          "pipeline_bf16: the trace shows no dcn_wgmma_kernel (K1's bf16 "
          "body)")

    def cells(o):
        return [len(t.get("cells", [])) for t in o.table_structures]

    agree = {
        "quad_counts": float(np.mean([len(a.text_cells) == len(b.text_cells)
                                      for a, b in zip(out, f32_out)])),
        "texts": float(np.mean([[c.text for c in a.text_cells]
                                == [c.text for c in b.text_cells]
                                for a, b in zip(out, f32_out)])),
        "table_cell_counts": float(np.mean([cells(a) == cells(b)
                                            for a, b in zip(out, f32_out)]))}
    summary = {
        "card": card, "dtypes": dtypes, "pages": PIPE_PAGES,
        "chunks": n_chunks, "launches": launches,
        "lore_sub_batches": forwards, "model_build_s": build_s,
        "counted_run_s": counted_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s),
        "runs": len(run_s), "pages_per_s": PIPE_PAGES / per_run,
        "lane_ms": lane_ms, "peak_mem_gib": peak / 2 ** 30,
        "profile": prof, "agreement_with_f32": agree,
        "tables": sum(len(o.table_structures) for o in out)}
    print(json.dumps({"pipeline_bf16": summary}))
    return launches


SYS_RASTER = 6
SYS_RUNS = 1
SYS_CPU_RASTER = 1
SYS_THRESH_QUANTILE = 0.77
SYS_QUAD_PX = 1.0
SYS_TEXT_MIN = 0.95


def system_pages():
    """The per-page phase's raster pages (1224x950 class) and its digital
    pages (from ``digital_pdf``: a wired table, the text-only page, and
    the page authored rotated by 90 degrees)."""
    import numpy as np

    from pdf_table_tpu_torch.pdfio import PdfDocument
    from pdf_table_tpu_torch.tasks.preprocess import rotate_image

    table = make_page(200)
    table[400:400 + 6 * 40:40, 80:880] = 30
    table[400:640, 80:881:160] = 30
    skewed = rotate_image(table, 3.0)
    raster = [table, skewed, np.ascontiguousarray(np.rot90(table, 2)),
              np.ascontiguousarray(np.rot90(make_page(201), 1)),
              make_page(202), make_page(203)]
    data, _a3, rot = digital_pdf()
    doc = PdfDocument.open(data)
    digital = [{"pdf_page": doc.load_page(i), "pdf_doc": doc}
               for i in (0, 4)]
    rotated = {"pdf_page": doc.load_page(rot), "pdf_doc": doc}
    return raster, digital, rotated


class LineGridPost:
    """A detection post-processor that appends bench.py's line grid
    (``add_lines``, from the image's shape) to the quads of the one it
    wraps: random weights trace speckle at full width, and the line grid
    gives recognition the crops of a text page, as the pipeline phases'
    ``_boxes_finish`` does."""

    def __init__(self, post):
        self.post = post
        self.config = post.config

    def __call__(self, prob, org_shape, net_shape=None):
        import numpy as np

        r = self.post(prob, org_shape, net_shape)
        quads = add_lines([r["det_polygons"]], [org_shape])[0]
        extra = len(quads) - len(r["det_polygons"])
        return {"det_polygons": quads.reshape(-1, 8).astype(np.float32),
                "det_scores": np.concatenate(
                    [r["det_scores"], np.ones(extra, np.float32)])}

    def __getattr__(self, name):
        return getattr(self.post, name)


def build_system(device, trees, thresh, policy=True):
    """The per-page system on ``device``: the pipeline phase's trees, the
    detector's threshold ``thresh`` and the line grid (``LineGridPost``);
    the registry models without a dtype (the policy: bf16 on the card)
    unless ``policy`` is off (f32)."""
    from pdf_table_tpu_torch.pipeline.system import (OcrSystemConfig,
                                                     OcrSystemTask)
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
    from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    dt = {} if policy else dict(F32)

    def pin(kw):
        return dict({k: v for k, v in kw.items() if k != "dtype"}, **dt)

    system = OcrSystemTask(OcrSystemConfig(), device=device)
    system._det = OcrDetectionTask(device=device, thresh=thresh,
                                   box_thresh=0.0, **dt)
    system._det.post = LineGridPost(system._det.post)
    system._layout = OcrLayoutTask(device=device, variables=trees["layout"],
                                   **pin(LAYOUT_KW))
    system._rec = OcrRecognitionTask(device=device, variables=trees["rec"],
                                     **dt)
    system._line_cls = ClsImagePulcTask("textline_orientation",
                                        device=device,
                                        variables=trees["cls"])
    system._tsr = OcrTableStructureTask(
        model="Lore", task_type="wireless", device=device,
        variables=trees["lore"], **pin(PIPE_LORE_KW))
    return system


def counted(fn, model):
    """Run ``fn()`` with the launch counts reset first and LORE's forwards
    counted: (result, launches, LORE forwards)."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)

    forwards = []
    real = model.forward_packed
    model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                      real(x))[1]
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        del model.forward_packed
    return out, {k: launch_counts[k] for k in KERNELS}, forwards


def host_geometry_ms(run, n_pages):
    """One ``run()`` with the host geometry timed: ms a page of the
    contours (the first ``max_candidates`` built), the min-area rectangles
    and the natural-size crops; and the contour maps it traced."""
    import pdf_table_tpu_torch.ops.cv_host as cv_host
    import pdf_table_tpu_torch.pipeline.system as system_mod

    spent = {"contours": 0.0, "min_area_rect": 0.0, "crops": 0.0}
    maps = []
    real = {"find_contours": cv_host.find_contours,
            "min_area_rect": cv_host.min_area_rect,
            "crops": system_mod.crop_rotated_boxes}

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    def contours(bitmap, limit=None):
        maps.append(bitmap)
        return real["find_contours"](bitmap, limit)

    cv_host.find_contours = timed("contours", contours)
    cv_host.min_area_rect = timed("min_area_rect", real["min_area_rect"])
    system_mod.crop_rotated_boxes = timed("crops", real["crops"])
    try:
        run()
    finally:
        cv_host.find_contours = real["find_contours"]
        cv_host.min_area_rect = real["min_area_rect"]
        system_mod.crop_rotated_boxes = real["crops"]
    return {k: v * 1e3 / n_pages for k, v in spent.items()}, maps


def system_diff(got, want) -> dict:
    """The card's and the CPU's outputs of the same pages."""
    import numpy as np

    quads = texts = cells = layout = html = 0
    quad_px = 0.0
    for g, w in zip(got, want):
        gq = np.asarray([c.bbox for c in g.text_cells]).reshape(-1, 4)
        wq = np.asarray([c.bbox for c in w.text_cells]).reshape(-1, 4)
        if gq.shape == wq.shape:
            quads += 1
            if len(gq):
                quad_px = max(quad_px, float(np.abs(gq - wq).max()))
            texts += sum(a.text == b.text for a, b in zip(g.text_cells,
                                                          w.text_cells))
            cells += len(g.text_cells)
        gl = [(c.label, c.cell_type.name) for c in g.layout_cells]
        layout += gl == [(c.label, c.cell_type.name)
                         for c in w.layout_cells]
        html += g.page_html == w.page_html
    return {"pages": len(got), "quad_counts_equal": quads,
            "quads_max_px": quad_px, "texts_equal": texts,
            "text_cells": cells, "layout_labels_equal": layout,
            "page_html_equal": html}


def phase_system_per_page(card, trees):
    """Phase 9f (module docstring). Returns the launches of each counted
    path: the per-page system, the runner's serial route and its three
    lanes."""
    import sys as _sys

    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops import cv_host
    from pdf_table_tpu_torch.pipeline.batch_runner import (BatchPipeline,
                                                           pack_pages)
    from pdf_table_tpu_torch.pipeline.system import OcrSystemTask

    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import contours_py

    t0 = time.perf_counter()
    cv_host.build_native()
    native_build_s = time.perf_counter() - t0
    raster, digital, rotated = system_pages()
    pages = [{"image": im} for im in raster] + digital
    for i, p in enumerate(pages):
        p["page"] = i
    t0 = time.perf_counter()
    probe = build_system("cuda", trees, 0.5)
    prob = probe.det_task.prob_map(probe.det_task.pre(raster[0])["image"])
    thresh = float(torch.quantile(prob.flatten()[::7].float(),
                                  SYS_THRESH_QUANTILE))
    system = build_system("cuda", trees, thresh)
    dtypes = {k: getattr(system, k).model_config.dtype
              for k in ("_det", "_layout", "_rec", "_tsr")}
    check(set(dtypes.values()) == {"bfloat16"},
          f"system_per_page: the policy gave {dtypes} on the card")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    system.ocr(pages)                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # the counted run times the host geometry too
    counted_run = []
    geometry, maps = host_geometry_ms(lambda: counted_run.append(counted(
        lambda: system.ocr(pages), system.tsr_task.model)), len(pages))
    out, launches, forwards = counted_run[0]
    errors = [o.metric.get("error") for o in out if "error" in o.metric]
    check(len(out) == len(pages) and not errors
          and all(o.page_html for o in out),
          f"system_per_page: {len(out)} outputs, errors {errors[:2]}")
    check(all(o.text_cells for o in out[:SYS_RASTER]),
          "system_per_page: a raster page has no text cells")
    check(forwards and launches["deform_conv2d"]
          + launches["deform_conv2d_flat_kc"] == 16 * len(forwards)
          and launches["resize_normalize"] == 0,
          f"system_per_page: launches {launches} for {len(forwards)} LORE "
          f"forwards (16 DCNs each; K3 never on the per-image path)")
    torch.cuda.reset_peak_memory_stats()
    run_s, results = [], []
    for _ in range(SYS_RUNS):
        t0 = time.perf_counter()
        results += system.ocr(pages)
        run_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_run = statistics.median(run_s)
    stages = {k: v["median"] for k, v in
              OcrSystemTask.timing_summary(results).items()}
    # every border of the counted run's maps, C++ and Python
    t0 = time.perf_counter()
    cpp = [cv_host.find_contours(m) for m in maps]
    cpp_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    t0 = time.perf_counter()
    py = [contours_py.find_contours(m) for m in maps]
    py_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    check(all(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b))
              for a, b in zip(cpp, py)),
          "system_per_page: the Python border following differs from the "
          "C++ one")
    prof = profile_run(lambda: system.ocr(pages), full=False)

    # the runner: the serial route, then the lanes on the raster pages
    runner_pages = [{"image": im, "page": i} for i, im in enumerate(raster)]
    n_chunks = len(pack_pages(raster))
    paths = {}
    for name, kw in (("runner_serial", {}), ("runner", {}),
                     ("runner_device_boxes_off", dict(device_boxes=False)),
                     ("runner_device_crops_off", dict(device_crops=False))):
        bp = BatchPipeline(system.config, batch_pages=8, device="cuda",
                           **kw)
        for k in ("_det", "_layout", "_rec", "_tsr", "_line_cls",
                  "_preprocess"):
            setattr(bp.system, k, getattr(system, k))
        run_pages = [dict(rotated, page=0)] if name == "runner_serial" \
            else runner_pages
        bp.run(run_pages)               # warm-up
        t0 = time.perf_counter()
        got, lanes_launch, lane_fw = counted(lambda: bp.run(run_pages),
                                             system.tsr_task.model)
        errors = [o.metric.get("error") for o in got if "error" in o.metric]
        check(len(got) == len(run_pages) and not errors
              and all(o.page_html for o in got),
              f"system_per_page: {name} gave errors {errors[:2]}")
        k3 = 0 if name == "runner_serial" else n_chunks
        check(lanes_launch["resize_normalize"] == k3
              and lanes_launch["deform_conv2d"]
              + lanes_launch["deform_conv2d_flat_kc"] == 16 * len(lane_fw),
              f"system_per_page: {name} launched {lanes_launch} for "
              f"{len(lane_fw)} LORE forwards")
        if name == "runner_serial":
            check(got[0].is_pdf and "recognition" in got[0].metric,
                  "system_per_page: the rotated page took no serial route")
        paths[name] = {"launches": lanes_launch, "lore_forwards": lane_fw,
                       "run_s": time.perf_counter() - t0,
                       "text_cells": [len(o.text_cells) for o in got]}

    # the same system in f32 against the port on the CPU
    f32 = build_system("cuda", trees, thresh, policy=False)
    cpu = build_system("cpu", trees, thresh, policy=False)
    few = pages[:SYS_CPU_RASTER] + [pages[SYS_RASTER]]
    want_t0 = time.perf_counter()
    want = cpu.ocr(few)
    cpu_s = time.perf_counter() - want_t0
    got = f32.ocr(few)
    diff = system_diff(got, want)
    summary = {
        "card": card, "dtypes": dtypes, "raster_pages": SYS_RASTER,
        "digital_pages": len(digital), "det_thresh": thresh,
        "native_build_s": native_build_s, "model_build_s": build_s,
        "warm_up_s": warm_s, "launches": launches,
        "lore_forwards": forwards, "run_s_median": per_run,
        "runs": len(run_s), "pages_per_s": len(pages) / per_run,
        "stage_ms_median": {k: v for k, v in stages.items()},
        "host_geometry_ms_per_page": geometry,
        "contour_maps": len(maps),
        "contours_all_cpp_ms_per_page": cpp_ms,
        "contours_all_python_ms_per_page": py_ms,
        "rotate_angles": [o.rotate_angle for o in out],
        "text_cells": [len(o.text_cells) for o in out],
        "tables": [len(o.table_html) for o in out],
        "peak_mem_gib": peak / 2 ** 30, "profile": prof, "paths": paths,
        "cpu": dict(diff, run_s=cpu_s)}
    print(json.dumps({"system_per_page": summary}))
    check(diff["quad_counts_equal"] == diff["pages"]
          and diff["quads_max_px"] <= SYS_QUAD_PX,
          f"system_per_page: card and CPU quads differ: {diff}")
    check(diff["texts_equal"] >= SYS_TEXT_MIN * diff["text_cells"],
          f"system_per_page: card and CPU texts differ: {diff}")
    check(diff["layout_labels_equal"] == diff["pages"]
          and got[-1].page_html == want[-1].page_html,
          f"system_per_page: card and CPU layout or digital HTML differ: "
          f"{diff}")
    return {"system_per_page": launches,
            **{k: v["launches"] for k, v in paths.items()}}


SERVE_RASTER = 4        # raster PNG requests a round
SERVE_ROUNDS = 16       # measured rounds of concurrent requests


def png_bytes(img) -> bytes:
    """An RGB page as PNG (PIL; the card's host has no cv2)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def two_page_pdf() -> bytes:
    """Two letter pages of the port's PdfWriter: running text and a wired
    table each."""
    from pdf_table_tpu_torch.pdfio import PdfWriter

    w = PdfWriter()
    for k in range(2):
        p = w.add_page(612, 792)
        for i in range(6):
            p.text(60, 740 - 20 * i, f"Page {k} line {i} of running text.")
        p.table(60, 580, [150, 100, 100], 24,
                [["name", "qty", "price"], ["bolts", str(40 + k), "0.10"],
                 ["nuts", "12", "0.05"]])
    return w.tobytes()


def chunks_of(shapes, batch_pages: int) -> int:
    """The runner's chunk count for pages of these (h, w): one bucket
    each, ``batch_pages`` canvases a chunk."""
    from collections import Counter

    from pdf_table_tpu_torch.pipeline.batch_runner import pick_page_bucket

    per = Counter(pick_page_bucket(h, w) for h, w in shapes)
    return sum(-(-n // batch_pages) for n in per.values())


def phase_serve(card, trees):
    """Phase 9g (module docstring). Returns the serve path's launches."""
    import base64
    import http.client
    import io
    import threading
    import zipfile

    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pdfio import PdfDocument
    from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
    from pdf_table_tpu_torch.serve import ExtractionService, make_server

    images = [make_page(400 + i) for i in range(SERVE_RASTER)]
    pdf = two_page_pdf()
    bodies = [(png_bytes(im), "image/png") for im in images] + \
        [(pdf, "application/pdf")]

    t0 = time.perf_counter()
    # a round's batch closes on its size (its requests), not on the
    # batcher's deadline (the default max_wait_ms); the runner keeps its
    # 8 pages a chunk
    svc = ExtractionService(OcrSystemConfig(), batch_pages=len(bodies))
    bp = build_pipeline("cuda", trees, policy=True)
    svc.pipeline = bp
    dtypes = {k: getattr(bp.system, k).model_config.dtype
              for k in ("_det", "_layout", "_rec", "_tsr")}
    check(set(dtypes.values()) == {"bfloat16"},
          f"serve: the policy gave {dtypes} on the card")
    svc.warm()
    build_s = time.perf_counter() - t0
    srv = make_server(svc, "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    # what the batcher ran: each batch's pages and outputs, LORE forwards,
    # and each batch's times: the batcher's wait (its first request queued
    # -> the batch closed), the payloads' decode (-> the run's start) and
    # the run
    batches, forwards, spans, queued = [], [], [], {}
    real_run, real_put, real_process = bp.run, svc.queue.put, svc._process

    def recorded_run(pages):
        spans[-1]["run0"] = time.perf_counter()
        out = real_run(pages)
        spans[-1]["run1"] = time.perf_counter()
        spans[-1]["lanes"] = bp.last_stats
        batches.append((pages, out))
        return out

    def timed_put(req, *a, **kw):
        queued[id(req)] = time.perf_counter()
        return real_put(req, *a, **kw)

    def timed_process(batch):
        spans.append({"first_queued": min(queued[id(r)] for r in batch),
                      "closed": time.perf_counter(), "requests": len(batch)})
        return real_process(batch)

    bp.run = recorded_run
    svc.queue.put = timed_put
    svc._process = timed_process
    model = bp.system.tsr_task.model
    real_forward = model.forward_packed
    model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                      real_forward(x))[1]

    def batch_ms(sp):
        return {"batcher_wait_ms": (sp["closed"] - sp["first_queued"]) * 1e3,
                "decode_ms": (sp["run0"] - sp["closed"]) * 1e3,
                "run_ms": (sp["run1"] - sp["run0"]) * 1e3}

    def request(method, path, body=None, ctype=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request(method, path, body,
                     {"Content-Type": ctype} if ctype else {})
        r = conn.getresponse()
        out = (r.status, json.loads(r.read()))
        conn.close()
        return out

    def round_():
        """Every body posted at once: [(status, answer, seconds)]."""
        res = [None] * len(bodies)

        def post(i):
            t = time.perf_counter()
            status, out = request("POST", "/v1/extract", *bodies[i])
            res[i] = (status, out, time.perf_counter() - t)

        ts = [threading.Thread(target=post, args=(i,))
              for i in range(len(bodies))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        return res

    try:
        round_()                        # warm-up
        torch.cuda.synchronize()
        n_warm, n_warm_spans = len(batches), len(spans)
        before = dict(svc.counters)
        reset_launch_counts()
        forwards.clear()
        t0 = time.perf_counter()
        answers = []
        for _ in range(SERVE_ROUNDS):
            answers.append(round_())
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k: launch_counts[k] for k in KERNELS}
        fw = list(forwards)
        counted = batches[n_warm:]
        counters = {k: svc.counters[k] - before[k] for k in before}
        times = [batch_ms(sp) for sp in spans[n_warm_spans:]
                 if "run1" in sp]
        lanes = [sp["lanes"] for sp in spans[n_warm_spans:] if "run1" in sp]
        per_batch = [sp["requests"] for sp in spans[n_warm_spans:]]
        n_spans = len(spans)
        prof = profile_run(round_, full=False)
        # the device's idle share of the traced round's runs alone
        run_ms = sum(batch_ms(sp)["run_ms"] for sp in spans[n_spans:]
                     if "run1" in sp)
        prof["run_ms"] = run_ms
        prof["run_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"]
                                     / run_ms)
        status, health = request("GET", "/healthz")
        xstatus, xlsx = request("POST", "/v1/extract?format=xlsx", pdf,
                                "application/pdf")
        _, metrics = request("GET", "/metrics")
    finally:
        srv.shutdown()
        svc.close()
        del model.forward_packed, svc.queue.put, svc._process
        bp.run = real_run

    errors = [a[1].get("error") for r in answers for a in r if a[0] != 200]
    check(not errors, f"serve: requests failed: {errors[:2]}")
    n_req = SERVE_ROUNDS * len(bodies)
    n_pages = SERVE_ROUNDS * (SERVE_RASTER + 2)
    check(counters["requests"] == n_req and counters["pages"] == n_pages
          and counters["errors"] == 0
          and 0 < counters["batches"] < n_req,
          f"serve: counters {counters} for {n_req} requests, {n_pages} "
          f"pages")
    check(status == 200 and health == {"ok": True, "platform": "gpu"},
          f"serve: /healthz answered {status} {health}")
    check("counters" in metrics, f"serve: /metrics answered {metrics}")
    # each answer against the batch that served it, run again directly
    doc = PdfDocument.open(pdf)
    equal = pages_seen = 0
    for pages, outs in counted:
        again = [dict(p, pdf_page=doc.load_page(p["page"]), pdf_doc=doc)
                 if "pdf_page" in p else p for p in pages]
        for p in again:
            p.pop("_tmp_path", None)
        ref = real_run(again)
        for o, r in zip(outs, ref):
            pages_seen += 1
            equal += (o.page_html, o.table_html) == (r.page_html,
                                                     r.table_html)
    # each answer is its batch's output
    served = {(o.page, o.page_html, tuple(o.table_html))
              for _, outs in counted for o in outs}
    answered = [(p["page"], p["html"], tuple(p["tables"]))
                for r in answers for a in r for p in a[1]["pages"]]
    check(len(answered) == n_pages and set(answered) <= served,
          "serve: an answer differs from its batch's output")
    check(pages_seen == n_pages and equal == pages_seen,
          f"serve: {equal} of {pages_seen} pages equal to "
          f"BatchPipeline.run on the same pages")
    check(xstatus == 200 and xlsx["tables"], f"serve: xlsx {xstatus}")
    sheets = [zipfile.ZipFile(io.BytesIO(base64.b64decode(
        t["xlsx_b64"]))).read("xl/worksheets/sheet1.xml").decode()
        for t in xlsx["tables"]]
    check(all("<sheetData>" in s for s in sheets)
          and any("bolts" in s for s in sheets),
          "serve: no xlsx answer holds the PDF's table")
    n_chunks = sum(chunks_of([o.image_shape for o in outs], bp.batch_pages)
                   for _, outs in counted)
    check(fw and launches["deform_conv2d"]
          + launches["deform_conv2d_flat_kc"] == 16 * len(fw)
          and launches["resize_normalize"] == n_chunks,
          f"serve: launches {launches} for {len(fw)} LORE forwards and "
          f"{n_chunks} chunks")
    lat = sorted(a[2] for r in answers for a in r)
    med = {k: float(np.median([t[k] for t in times])) for k in times[0]}
    summary = {
        "card": card, "dtypes": dtypes, "build_and_warm_s": build_s,
        "requests": n_req, "pages": n_pages, "batches": counters["batches"],
        "requests_per_s": n_req / wall, "pages_per_s": n_pages / wall,
        "latency_s_p50": float(np.percentile(lat, 50)),
        "latency_s_p95": float(np.percentile(lat, 95)),
        "requests_a_batch": per_batch, "batch_median_ms": med,
        # the runner's lanes a batch (host clock, a lane's wait for the
        # card included)
        "lane_median_ms": {k: float(np.median([ln[k] for ln in lanes])) * 1e3
                           for k in lanes[0] if k != "n_pages"},
        "batch_sum_ms": {k: sum(t[k] for t in times) for k in times[0]},
        "wall_ms": wall * 1e3,
        "launches": launches, "lore_forwards": fw, "chunks": n_chunks,
        "tables": sum(len(o.table_html) for _, outs in counted
                      for o in outs),
        "xlsx_books": len(sheets), "profile": prof,
        "equal_to_batch_pipeline": f"{equal}/{pages_seen}"}
    print(json.dumps({"serve": summary}))
    return launches


def phase_cli(card, trees):
    """Phase 9h (module docstring). Returns each CLI route's launches."""
    import contextlib
    import io
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch

    import pdf_table_tpu_torch.cli.main as cli_main
    from pdf_table_tpu_torch.entity.args import PdfTableCliArguments
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pdfio import PdfDocument
    from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
    from pdf_table_tpu_torch.utils.image_io import read_image

    page = make_page(500)
    page[400:400 + 6 * 40:40, 80:880] = 30
    page[400:640, 80:881:160] = 30
    t0 = time.perf_counter()
    probe = build_system("cuda", trees, 0.5)
    prob = probe.det_task.prob_map(probe.det_task.pre(page)["image"])
    thresh = float(torch.quantile(prob.flatten()[::7].float(),
                                  SYS_THRESH_QUANTILE))
    system = build_system("cuda", trees, thresh)
    build_s = time.perf_counter() - t0

    def the_system(cfg, device=None):
        """``main``'s system: the smoke's trees, the CLI's config."""
        system.config = cfg
        return system

    td = tempfile.mkdtemp(prefix="smoke_cli_")
    png = os.path.join(td, "page.png")
    with open(png, "wb") as f:
        f.write(png_bytes(page))
    pdf = os.path.join(td, "doc.pdf")
    with open(pdf, "wb") as f:
        f.write(two_page_pdf())
    scan = os.path.join(td, "scan.pdf")
    with open(scan, "wb") as f:
        f.write(scan_pdf(page))
    merge = types.SimpleNamespace(args=PdfTableCliArguments())

    def merged(pairs):
        return cli_main.PdfTableCli.make_pdf_output_html(merge, pairs)

    routes = {"cli_image": (png, ["--debug"]),
              "cli_pdf": (pdf, ["--batch_pages", "1"]),
              "cli_pdf_batch_pages_8": (pdf, ["--batch_pages", "8"]),
              "cli_scan": (scan, ["--batch_pages", "1"])}
    real = cli_main.OcrSystemTask
    cli_main.OcrSystemTask = the_system
    paths, seconds, outs = {}, {}, {}
    sink = io.StringIO()
    try:
        for name, (src, flags) in routes.items():
            out_dir = os.path.join(td, name)
            argv = ["--file_path_or_url", src, "--output_dir", out_dir,
                    *flags]
            with contextlib.redirect_stdout(sink):
                cli_main.main(argv)             # warm-up
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sink):
                rc, launches, fw = counted(lambda: cli_main.main(argv),
                                           system.tsr_task.model)
            seconds[name] = time.perf_counter() - t0
            check(rc == 0, f"cli: {name} exited {rc}")
            base = os.path.splitext(os.path.basename(src))[0]
            with open(os.path.join(out_dir, base + ".html"),
                      encoding="utf-8") as f:
                outs[name] = f.read()
            with open(os.path.join(out_dir, base + "_metrics.json")) as f:
                errors = [m for m in json.load(f)["pages"] if "error" in m]
            check(not errors, f"cli: {name}: {errors[:2]}")
            paths[name] = {"launches": launches, "lore_forwards": fw}
    finally:
        cli_main.OcrSystemTask = real

    # the same pages through the per-page system and the runner
    system.config.debug = True
    ref = system(image=read_image(png), page=0, src_id="page.png")
    check(outs["cli_image"] == merged([(0, ref.page_html)]),
          "cli: the image route's HTML differs from OcrSystemTask's")
    debug = read_image(os.path.join(td, "cli_image", "page_page1_debug.png"))
    check(debug is not None and debug.shape == ref.image.shape
          and np.array_equal(debug, ref.debug["render"]),
          "cli: the debug overlay was not written as rendered")
    system.config.debug = False
    doc = PdfDocument.open(pdf)
    per_page = [system(pdf_page=doc.load_page(i), pdf_doc=doc, page=i,
                       src_id="doc.pdf") for i in range(doc.page_count)]
    check(outs["cli_pdf"] == merged([(o.page, o.page_html)
                                     for o in per_page]),
          "cli: the per-page PDF route's HTML differs from OcrSystemTask's")
    sdoc = PdfDocument.open(scan)
    scanned = system(pdf_page=sdoc.load_page(0), pdf_doc=sdoc, page=0,
                     src_id="scan.pdf")
    check(outs["cli_scan"] == merged([(0, scanned.page_html)]),
          "cli: the scanned PDF's HTML differs from OcrSystemTask's")
    bp = BatchPipeline(system.config, batch_pages=8, device="cuda")
    bp.system = system
    batched = bp.run([{"pdf_page": doc.load_page(i), "pdf_doc": doc,
                       "page": i} for i in range(doc.page_count)])
    check(outs["cli_pdf_batch_pages_8"] == merged(
        [(o.page, o.page_html) for o in batched]),
        "cli: the batched PDF route's HTML differs from BatchPipeline.run's")
    for name in ("cli_image", "cli_scan"):
        im = paths[name]
        check(im["lore_forwards"] and im["launches"]["deform_conv2d"]
              + im["launches"]["deform_conv2d_flat_kc"]
              == 16 * len(im["lore_forwards"])
              and im["launches"]["resize_normalize"] == 0,
              f"cli: the {name} route launched {im['launches']} for "
              f"{len(im['lore_forwards'])} LORE forwards")
    check(paths["cli_pdf_batch_pages_8"]["launches"]["resize_normalize"]
          == 1, f"cli: the batched route launched "
                f"{paths['cli_pdf_batch_pages_8']['launches']}")
    summary = {"card": card, "model_build_s": build_s, "det_thresh": thresh,
               "run_s": seconds, "paths": paths,
               "tables": [len(ref.table_html)]
               + [len(o.table_html) for o in per_page]
               + [len(scanned.table_html)]}
    print(json.dumps({"cli": summary}))
    shutil.rmtree(td, ignore_errors=True)
    return {k: v["launches"] for k, v in paths.items()}


def phase_tsr_host_crop(card, trees):
    """The per-crop surface of LORE wireless (f32, bench.py's pipeline
    tree): ``batch_infer`` on the 8 crops of the TSR phases and
    ``__call__`` on one, on the card; crops/s beside
    ``batch_infer_from_pages`` on the same regions in the same call; the
    first TSR_CPU_CROPS crops and the call's input against the same task
    on the CPU slot by slot on every input (MATCH_MIN, HOST_CROP_DETS_PX,
    LOGI_TOL), their cells and table HTML and the call's compared and
    printed."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.models.lore.model import unpack_lore
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask
    from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

    pages, regions = tsr_inputs()
    crops = [np.ascontiguousarray(pages[pi, y1:y2, x1:x2])
             for pi, (x1, y1, x2, y2) in regions]
    kw = dict(model="Lore", task_type="wireless", variables=trees["lore"],
              **PIPE_LORE_KW)
    task = OcrTableStructureTask(device="cuda", **kw)
    dev_pages = torch.from_numpy(pages).cuda()
    task.batch_infer(crops)             # warm-up
    task.batch_infer_from_pages(dev_pages, regions)

    def timed_s(fn):
        out = []
        for _ in range(TSR_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    got = task.batch_infer(crops)
    one = task(crops[0])
    host_s = timed_s(lambda: task.batch_infer(crops))
    pages_s = timed_s(lambda: task.batch_infer_from_pages(dev_pages,
                                                          regions))
    call_s = timed_s(lambda: task(crops[0]))
    cpu = OcrTableStructureTask(device="cpu", **kw)
    few = crops[:TSR_CPU_CROPS]
    want = cpu.batch_infer(few)
    want_one = cpu(crops[0])
    html = OcrTableToHtmlTask()

    # slot by slot on the same inputs: the uint8 warps, normalized as
    # batch_infer does, and __call__'s float warp, normalized on the host
    u8 = np.concatenate([task.pre.warp_u8(c)["image_u8"] for c in few])

    def packed(t, x, from_u8):
        x = x.to(t.device)
        with torch.inference_mode():
            if from_u8:
                x = (x.float().flip(-1) / 255.0 - t.mean) / t.std
            return unpack_lore(t._forward_packed(x).cpu().numpy())

    inputs = [(torch.from_numpy(u8), True),
              (torch.from_numpy(task.host_preprocess(crops[0])[0]), False)]
    slots = {"match": 1.0, "dets_px": 0.0, "logi": 0.0, "inputs": 0}
    for x, from_u8 in inputs:
        pa, pb = packed(task, x, from_u8), packed(cpu, x, from_u8)
        for j in range(len(x)):
            ca = {tuple(c): i for i, c in enumerate(pa["centers"][j])
                  if pa["valid"][j, i]}
            cb = {tuple(c): i for i, c in enumerate(pb["centers"][j])
                  if pb["valid"][j, i]}
            common = sorted(set(ca) & set(cb))
            slots["match"] = min(slots["match"], len(common)
                                 / max(len(ca), len(cb), 1))
            slots["inputs"] += 1
            if not common:
                continue
            ia = [ca[c] for c in common]
            ib = [cb[c] for c in common]
            slots["dets_px"] = max(slots["dets_px"], float(np.abs(
                pa["dets"][j, ia] - pb["dets"][j, ib]).max()))
            la, lb = pa["stacked_logi"][j, ia], pb["stacked_logi"][j, ib]
            slots["logi"] = max(slots["logi"], float(
                np.abs(la - lb).max() / max(np.abs(lb).max(), 1e-6)))
    pairs = list(zip(got, want)) + [(one, want_one)]
    cells_equal = [len(a["cells"]) == len(b["cells"]) and all(
        x["logic"] == y["logic"] for x, y in zip(a["cells"], b["cells"]))
        for a, b in pairs]
    html_equal = [html(a, []) == html(b, []) for a, b in pairs]
    summary = {"card": card, "crops": len(crops),
               "batch_infer_s": host_s,
               "batch_infer_crops_per_s": len(crops) / host_s,
               "from_pages_s": pages_s,
               "from_pages_crops_per_s": len(crops) / pages_s,
               "call_s": call_s,
               "cells": [len(r["cells"]) for r in got],
               "cpu_cells": [len(r["cells"]) for r in want]
               + [len(want_one["cells"])],
               "cpu_slots": slots, "cpu_cells_equal": cells_equal,
               "cpu_html_equal": html_equal}
    print(json.dumps({"tsr_host_crop": summary}))
    check(all(r["cells"] for r in got), "a crop gave no cells")
    check(slots["match"] >= MATCH_MIN
          and slots["dets_px"] <= HOST_CROP_DETS_PX
          and slots["logi"] < LOGI_TOL,
          f"card and CPU slots differ on the crops: {slots}")


def phase_pipeline_arm(card, trees, tsr: str, tsr_tree):
    """The pipeline phase's run with ``tsr`` (SLANet or TableMaster at
    full width, T = 500, or Cycle-CenterNet at 1024^2, f32) in place of
    LORE, built by the system from ``table_structure_model``: the same
    pages, a warm-up, one counted run (K3 once a chunk; K1 16 times a
    CenterNet sub-batch, else never; K2 never), the median of timed runs
    (pages/s, lanes, peak memory), idle share; pages against the CPU. The
    CenterNet arm then runs LoreAndLineCell on the same pages: every table
    must carry merged cells. Returns the launch counts (and the
    LoreAndLineCell run's under ``"lore_line_cell"``)."""
    import re

    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)

    n_pages, n_cpu = PIPE_ARM_PAGES[tsr]
    imgs = [make_page(i) for i in range(n_pages)]
    pages = [{"image": im, "page": i} for i, im in enumerate(imgs)]
    trees = dict(trees, tsr=tsr_tree)
    t0 = time.perf_counter()
    bp = build_pipeline("cuda", trees, tsr)
    bp.run(pages)                       # warm-up, builds the TSR task
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(bp.system.tsr_task.model_name == tsr, "the system built another "
          "TSR model")
    n_chunks = -(-n_pages // bp.batch_pages)
    tsr_model = bp.system.tsr_task.model
    forwards = []
    if tsr == "CenterNet":
        real_forward = tsr_model.forward_packed
        tsr_model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                              real_forward(x))[1]
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    if forwards:
        del tsr_model.forward_packed
    errors = [o.metric.get("error") for o in out if o.metric.get("error")]
    check(len(out) == n_pages and not errors,
          f"{tsr} pipeline: pages carry errors: {errors[:3]}")
    check(all(o.page_html for o in out), f"{tsr} pipeline: a page has no "
          f"page_html")
    kind = ARM_KINDS[tsr]
    structs = [r for o in out for r in o.table_structures]
    check(structs and all(r["type"] == kind for r in structs),
          f"{tsr} pipeline: no table reached {tsr}")
    k1 = CN_DCNS * len(forwards) if tsr == "CenterNet" else 0
    check(launches["resize_normalize"] == n_chunks
          and launches["deform_conv2d"] == k1
          and launches["deform_conv2d_flat_kc"] == 0
          and (tsr != "CenterNet" or forwards),
          f"{tsr} pipeline launched {launches} for {n_chunks} chunks and "
          f"{len(forwards)} CenterNet sub-batches")

    torch.cuda.reset_peak_memory_stats()
    run_s, lanes = [], []
    for _ in range(PIPE_TSR_RUNS):
        t0 = time.perf_counter()
        bp.run(pages)
        run_s.append(time.perf_counter() - t0)
        lanes.append(bp.last_stats)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    lane_ms = {k: statistics.median(st[k] for st in lanes) * 1e3
               for k in lanes[0] if k != "n_pages"}
    prof = profile_run(lambda: bp.run(pages), full=False)
    few = pages[:n_cpu]
    got = bp.run(few)
    cpu = build_pipeline("cpu", trees, tsr)
    t0 = time.perf_counter()
    want = cpu.run(few)
    cpu_s = time.perf_counter() - t0
    cmp = pipeline_diff(got, want)
    summary = {
        "card": card, "tsr": tsr, "pages": n_pages, "chunks": n_chunks,
        "launches": launches, "tsr_sub_batches": forwards,
        "warm_up_s": warm_s, "counted_run_s": counted_s,
        "run_s_median": per_run, "run_s_min": min(run_s),
        "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": n_pages / per_run,
        "ms_per_page": per_run * 1e3 / n_pages, "lane_ms": lane_ms,
        "peak_mem_gib": peak / 2 ** 30, "tables": len(structs),
        "tokens": sum(len(r.get("structure_tokens", ())) for r in structs),
        "cells": sum(len(r["cells"]) for r in structs),
        "table_html_with_text": sum(
            bool(re.search(r"<td[^>]*>[^<]+</td>", h))
            for o in out for h in o.table_html),
        "page_html_bytes": [len(o.page_html) for o in out[:4]],
        "profile": prof, "cpu": {"run_s": cpu_s, **cmp}}
    if tsr == "CenterNet":
        summary["lore_line_cell"] = lore_line_cell_run(trees, pages)
        launches = dict(launches,
                        lore_line_cell=summary["lore_line_cell"]["launches"])
    print(json.dumps({f"pipeline_{PHASE_NAMES[tsr][4:]}": summary}))
    check(not [o for o in want if o.metric.get("error")],
          f"the CPU {tsr} pipeline gave errors")
    check(cmp["quads_same_count"] and cmp["quad_px"] <= PIPE_QUAD_TOL,
          f"{tsr} pipeline: quads differ from the CPU's")
    check(cmp["text_share"] >= PIPE_TEXT_MIN,
          f"{tsr} pipeline: texts equal on {cmp['text_share']:.3f} of crops")
    check(cmp["page_html_equal"] == cmp["page_html_checked"],
          f"{tsr} pipeline: page_html differs where its inputs are equal")
    return launches


def lore_line_cell_run(trees, pages) -> dict:
    """``table_structure_model="LoreAndLineCell"`` through the runner on
    ``pages`` (the pipeline phase's LORE wireless f32 plus the line cells
    of each window): every page without error and with page_html, every
    table merged with cells."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)

    bp = build_pipeline("cuda", trees, "LoreAndLineCell")
    bp.run(pages)                       # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    structs = [r for o in out for r in o.table_structures]
    check(not [o for o in out if o.metric.get("error")]
          and all(o.page_html for o in out),
          "LoreAndLineCell pipeline: a page failed or has no page_html")
    check(structs and all(r["type"] == "lore_line_cell_merge"
                          and r["cells"] for r in structs),
          "LoreAndLineCell pipeline: a table without merged cells")
    return {"pages": len(pages), "run_s": run_s, "launches": launches,
            "pages_per_s": len(pages) / run_s, "tables": len(structs),
            "cells": [len(r["cells"]) for r in structs[:8]],
            "lane_ms": {k: v * 1e3 for k, v in bp.last_stats.items()
                        if k != "n_pages"}}


# Cycle-CenterNet and LGPMA (the rest of table structure)
CN_VAR_GAIN = 2.0       # calibrated DLA variances doubled (else chaotic)
CN_QUAD = 3.0           # feature-map px: cell corners, vertex centres
CN_CPU_CROPS = 2        # crops held against the CPU (one of each size)
CN_INPUT_TOL = 1e-4     # card vs CPU: normalized inputs, max |diff|
CN_HEADS_TOL = 1e-4     # card vs CPU: heads, max |diff| / max |head|
CN_TIE_GAP = 1e-4       # decode slots compared up to the first near-tie
CN_DECODE_TOL = 1e-3    # feature-map px and scores, on those slots
CN_YARD_TOL = 1e-3      # f32 kernel vs plain-DCN yardstick, relative
CN_RUNS = 3
CN_DCNS = 16            # deform convs of one DLA trunk forward
LGPMA_GAIN = 8.0        # the bbox head's class and delta logits spread
LGPMA_RUNS = 1          # timed runs (the host post is seconds a run)
LGPMA_CPU_CROPS = 2
LGPMA_TOL = 1e-4        # card vs CPU: inputs (abs), maps and heads (rel)
LGPMA_TIE_GAP = 1e-4    # proposals compared up to the first near-tie
LGPMA_PROP_PX = 1e-2    # model-input px


def centernet_tree(task, dev_pages, regions):
    """A seeded full-width Cycle-CenterNet tree (offset convs perturbed),
    BatchNorm statistics calibrated on the card on the task's first
    sub-batch of crops and the variances doubled (calibrated as is, a
    random DLA stack is chaotic); both heatmap channels at 0.5, so
    that cells and vertices pass the 0.3 threshold; cell corners and each
    vertex's centres at +-CN_QUAD feature-map px, so that vertices snap
    (the CPU tests' tree)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.engine.params import (
        calibrate_batch_stats, init_centernet, perturb_conv_offset_mask,
        scale_batch_variances)

    (_s, _m, x), *_ = task.sub_batches(dev_pages, regions)
    net = task.model
    net.forward = net.heads
    tree = scale_batch_variances(calibrate_batch_stats(
        net, perturb_conv_offset_mask(init_centernet(task.model_config, 0),
                                      seed=1), x), CN_VAR_GAIN)
    del net.forward
    heads = tree["params"]["trunk"]["heads"]
    heads["hm_out"]["bias"] = np.zeros(2, np.float32)
    quad = CN_QUAD * np.array([1, 1, -1, 1, -1, -1, 1, -1], np.float32)
    heads["v2c_out"]["bias"] = quad.copy()
    heads["c2v_out"]["bias"] = -quad
    torch.cuda.synchronize()
    return tree


def rel_err(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-6))


def centernet_snaps(task, packed_np) -> int:
    """Corners of cells above threshold that the vertex snap moves, over
    the crops of a download."""
    import numpy as np

    from pdf_table_tpu_torch.models.center_net.model import unpack_centernet
    from pdf_table_tpu_torch.models.center_net.processor import \
        group_bbox_by_gbox

    cfg = task.model_config
    n = 0
    for j in range(len(packed_np)):
        raw = unpack_centernet(packed_np[j:j + 1], cfg.K)
        b9 = np.concatenate([raw["dets"][0], raw["scores"][0][:, None]], 1)
        out = group_bbox_by_gbox(b9.copy(), raw["gboxes"][0],
                                 cfg.score_thresh, cfg.v2c_dist_thresh,
                                 cfg.c2v_dist_thresh)
        moved = (out[:, :8] != b9[:, :8]).reshape(-1, 4, 2).any(-1)
        n += int(moved[b9[:, 8] >= cfg.score_thresh].sum())
    return n


def centernet_stages(task, dev_pages, regions) -> dict:
    """One sub-batch's stages, each timed alone (host_ms)."""
    import torch

    with torch.inference_mode():
        (sub, metas, x), *_ = task.sub_batches(dev_pages, regions)
        heads = task.model.heads(x)
        packed = task.model.forward_packed(x)
        packed_np = packed.cpu().numpy()
        return {
            "pre": host_ms(lambda: list(task.sub_batches(dev_pages,
                                                         regions[:len(sub)]))),
            "forward": host_ms(lambda: task.model.heads(x)),
            "decode": host_ms(lambda: task.model.decode(heads)),
            "download": host_ms(lambda: packed.cpu()),
            "host_post": host_ms(lambda: [
                task._post_one(packed_np[j:j + 1], m)
                for j, m in enumerate(metas)], iters=2),
            "crops": len(sub)}


def prefix_before_tie(scores, gap) -> int:
    """Leading slots of a descending score list before its first near-tie
    (two neighbours closer than ``gap``)."""
    import numpy as np

    close = np.flatnonzero(np.abs(np.diff(scores)) < gap)
    return int(close[0]) if len(close) else len(scores)


def centernet_agreement(task, cpu, dev_pages, pages, regions) -> dict:
    """The card against the same port on the CPU on CN_CPU_CROPS crops:
    the normalized inputs, the heads, and the decode: cell slots (dets,
    scores) and vertex slots (gboxes) up to the CPU's first near-tie of
    their scores, in score order. The cells after the host post are
    compared whole and reported: their logic clusters every cell of the
    crop, and the vertex snap takes the first qualifying vertex in score
    order, so a near-tie anywhere can move them."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.models.center_net.model import unpack_centernet

    regions = regions[:CN_CPU_CROPS]
    k = task.model_config.K
    with torch.inference_mode():
        (_s, _m, x), = task.sub_batches(dev_pages, regions)
        (_s, _m, xc), = cpu.sub_batches(pages, regions)
        ha, hc = task.model.heads(x), cpu.model.heads(xc)
        inputs = float((x.cpu() - xc).abs().max())
        heads = max(rel_err(ha[n].cpu(), hc[n]) for n in hc)
        pa = task.model.forward_packed(x).cpu().numpy()
        pc = cpu.model.forward_packed(xc).numpy()
    out = {"inputs_max_abs": inputs, "heads_rel": heads,
           "cells_compared": [], "vertices_compared": [],
           "decode_max_abs": 0.0}
    for j in range(len(regions)):
        a, c = unpack_centernet(pa[j:j + 1], k), unpack_centernet(
            pc[j:j + 1], k)
        n = prefix_before_tie(c["scores"][0], CN_TIE_GAP)
        m = prefix_before_tie(c["gboxes"][0, :, 10], CN_TIE_GAP)
        out["cells_compared"].append(n)
        out["vertices_compared"].append(m)
        out["decode_max_abs"] = max(
            out["decode_max_abs"],
            float(np.abs(a["dets"][0, :n] - c["dets"][0, :n]).max(
                initial=0.0)),
            float(np.abs(a["scores"][0, :n] - c["scores"][0, :n]).max(
                initial=0.0)),
            float(np.abs(a["gboxes"][0, :m] - c["gboxes"][0, :m]).max(
                initial=0.0)))
    got = task.batch_infer_from_pages(dev_pages, regions)
    t0 = time.perf_counter()
    want = cpu.batch_infer_from_pages(pages, regions)
    out["cpu_s"] = time.perf_counter() - t0
    out["cells_card_cpu"] = [[len(g["cells"]), len(w["cells"])]
                             for g, w in zip(got, want)]
    out["cells_equal"] = [g == w for g, w in zip(got, want)]
    return out


def phase_tsr_centernet(card, pages, regions):
    """``OcrTableStructureTask(model="CenterNet")`` at full width (1024^2,
    head_conv 256, K 300, MK 600, f32) on the 8 table regions, resident on
    the card, through ``batch_infer_from_pages``: the counted run (K1 at
    every DCN of the trunk, 16 a sub-batch), a bf16 forward of the
    sub-batch of 8 (K1's and K2's launches as the flat-kc route picks
    them), the plain-DCN yardstick, crops/s, stage ms, peak memory, idle
    share, snapped vertices and agreement with the same port on the CPU.
    Returns the tree and the launch counts of the f32 run and the bf16
    forward."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.center_net.config import CenterNetConfig
    from pdf_table_tpu_torch.models.center_net.model import CycleCenterNet
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    t0 = time.perf_counter()
    dev_pages = torch.from_numpy(pages).cuda()
    tree = centernet_tree(OcrTableStructureTask(model="CenterNet",
                                                device="cuda"),
                          dev_pages, regions)
    task = OcrTableStructureTask(model="CenterNet", device="cuda",
                                 variables=tree)
    build_s = time.perf_counter() - t0
    cfg = task.model_config
    n_sub = len(list(task.sub_batches(dev_pages, regions)))

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(dev_pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    print(json.dumps({"tsr_centernet_launches": launches,
                      "sub_batches": n_sub}))
    check(launches["deform_conv2d"] == CN_DCNS * n_sub
          and launches["deform_conv2d_flat_kc"] == 0
          and launches["resize_normalize"] == 0,
          f"CenterNet: launches {launches} for {n_sub} f32 sub-batches")
    check(len(results) == len(regions)
          and all(r["type"] == "center_net" for r in results),
          "CenterNet: one center_net result per region")
    check(all(np.isfinite(c["bbox"]).all() and len(c["logic"]) == 4
              for r in results for c in r["cells"]),
          "CenterNet: cells are not finite")
    cells = [len(r["cells"]) for r in results]
    check(sum(cells) > 0, "CenterNet: no cell passed the threshold")

    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(CN_RUNS):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(dev_pages, regions)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    stages = centernet_stages(task, dev_pages, regions)
    prof = f32_body_traced(profile_run(
        lambda: task.batch_infer_from_pages(dev_pages, regions)),
        "tsr_centernet")

    # one bf16 forward of the sub-batch of 8, counted
    (_s, _m, x), *_ = task.sub_batches(dev_pages, regions)
    with torch.inference_mode():
        share = k1_device_share(lambda: task.model.heads(x))
    bf16 = CycleCenterNet(CenterNetConfig(dtype="bfloat16")).eval()
    load_flax_variables(bf16, tree)
    bf16.to("cuda")
    with torch.inference_mode():
        bf16.forward_packed(x).cpu()             # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        packed_bf16 = bf16.forward_packed(x).cpu().numpy()
        torch.cuda.synchronize()
    bf16_launches = {k: launch_counts[k] for k in KERNELS}
    print(json.dumps({"tsr_centernet_bf16_launches": bf16_launches,
                      "crops": int(x.shape[0])}))
    check(bf16_launches["deform_conv2d"] > 0
          and bf16_launches["deform_conv2d"]
          + bf16_launches["deform_conv2d_flat_kc"] == CN_DCNS,
          f"CenterNet bf16: launches {bf16_launches}")
    check(np.isfinite(packed_bf16).all(), "CenterNet bf16: not finite")

    # the plain-DCN yardstick on the same tree and crops
    plain = CycleCenterNet(cfg, plain_dcn=True).eval()
    load_flax_variables(plain, tree)
    plain.to("cuda")
    with torch.inference_mode():
        ha = task.model.heads(x)
        packed = task.model.forward_packed(x).cpu().numpy()
        torch.cuda.synchronize()
        before = dict(launch_counts)
        hb = plain.heads(x)
        torch.cuda.synchronize()
        check(dict(launch_counts) == before,
              "the plain yardstick launched a kernel")
        yard = {k: rel_err(ha[k], hb[k]) for k in hb}
    snaps = centernet_snaps(task, packed)
    del plain, bf16

    cpu = OcrTableStructureTask(model="CenterNet", device="cpu",
                                variables=tree)
    agree = centernet_agreement(task, cpu, dev_pages, pages, regions)
    summary = {
        "card": card, "model": "CenterNet", "resolution": list(
            cfg.resolution), "head_conv": cfg.head_conv, "K": cfg.K,
        "MK": cfg.MK, "dtype": cfg.dtype, "crops": len(regions),
        "sub_batches": n_sub, "launches": launches,
        "bf16_forward_launches": bf16_launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "peak_mem_gib": peak / 2 ** 30, "stage_ms": stages,
        "profile": prof, "forward_k1": share, "cells": cells,
        "snapped_vertices": snaps, "yardstick_heads_rel": yard, "cpu": agree}
    print(json.dumps({"tsr_centernet": summary}))
    check(share["f32_body"], "CenterNet: the forward's trace shows no "
          "dcn_tf32_kernel")
    check(max(yard.values()) <= CN_YARD_TOL,
          f"CenterNet: the kernel's heads differ from the plain DCN's: "
          f"{yard}")
    check(snaps > 0, "CenterNet: no vertex snapped")
    check(agree["inputs_max_abs"] <= CN_INPUT_TOL,
          f"CenterNet: inputs differ from the CPU's: "
          f"{agree['inputs_max_abs']:.3g}")
    check(agree["heads_rel"] <= CN_HEADS_TOL,
          f"CenterNet: heads differ from the CPU's: {agree['heads_rel']:.3g}")
    check(min(agree["cells_compared"]) > 0
          and min(agree["vertices_compared"]) > 0
          and agree["decode_max_abs"] <= CN_DECODE_TOL,
          f"CenterNet: the decode differs from the CPU's before the first "
          f"near-tie: {agree['decode_max_abs']:.3g} "
          f"({agree['cells_compared']}, {agree['vertices_compared']})")
    return tree, {"f32": launches, "bf16": bf16_launches}


def lgpma_tree(task, dev_pages, regions):
    """A seeded full-width LGPMA tree, BatchNorm statistics calibrated on
    the card on the first crop, variances doubled, the bbox head's class
    and delta logits spread x LGPMA_GAIN (the CPU tests' tree)."""
    import torch

    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_lgpma,
                                                   scale_batch_variances)

    (_s, _m, x), *_ = task.sub_batches(dev_pages, regions)
    net = task.model
    net.forward = net.levels
    tree = scale_batch_variances(calibrate_batch_stats(
        net, init_lgpma(task.model_config, 0), x), 2.0)
    del net.forward
    for k in ("fc_cls", "fc_reg"):
        tree["params"]["bbox_head"][k]["kernel"] *= LGPMA_GAIN
    torch.cuda.synchronize()
    return tree


def lgpma_agreement(task, cpu, dev_pages, pages, regions) -> dict:
    """The card against the same port on the CPU on LGPMA_CPU_CROPS crops:
    the inputs, the FPN levels, the proposals up to the CPU's first
    near-tie of objectness, the bbox, LPMA and GPMA heads on the CPU's
    RoIs, and the cells (equal where the proposals are)."""
    import torch

    out = {"inputs_max_abs": 0.0, "levels_rel": 0.0, "heads_rel": 0.0,
           "props_compared": [], "props_px": 0.0, "cells_equal": [],
           "cpu_s": 0.0}
    for region in regions[:LGPMA_CPU_CROPS]:
        with torch.inference_mode():
            (_s, (meta,), x), = task.sub_batches(dev_pages, [region])
            (_s, _m, xc), = cpu.sub_batches(pages, [region])
            out["inputs_max_abs"] = max(out["inputs_max_abs"], float(
                (x.cpu() - xc).abs().max()))
            t0 = time.perf_counter()
            want = cpu.model(xc)
            lc = cpu.model.levels(xc)
            out["cpu_s"] += time.perf_counter() - t0
            la = task.model.levels(x)
            out["levels_rel"] = max([out["levels_rel"]] + [
                rel_err(a.cpu(), c) for a, c in zip(la, lc)])
            pa, _ = task.model.rpn(la, tuple(x.shape[1:3]))
            _, sc = cpu.model.rpn(lc, tuple(xc.shape[1:3]))
            n = prefix_before_tie(sc.numpy(), LGPMA_TIE_GAP)
            out["props_compared"].append(n)
            out["props_px"] = max(out["props_px"], float(
                (pa[:n].cpu() - want["proposals"][0, :n]).abs().max()))
            m = task.model
            rois = want["proposals"][0].cuda()
            cls, _ = m.bbox_head(m.extract(la, rois, 7))
            masks = m.mask_head(m.extract(
                la, want["mask_boxes"][0].cuda(), 14))
            seg, reg = m.global_seg_head(la[0])
            out["heads_rel"] = max([out["heads_rel"]] + [
                rel_err(a.cpu(), want[k].reshape(a.shape))
                for a, k in ((cls, "cls_probs"), (masks, "lpma_masks"),
                             (seg, "gpma_seg"), (reg, "gpma_reg"))])
            got_raw = {k: v.cpu().numpy()
                       for k, v in task._forward_packed(x).items()}
            want_raw = {k: want[k].numpy() for k in got_raw}
        if n == len(sc):
            out["cells_equal"].append(task.post(got_raw, meta)
                                      == cpu.post(want_raw, meta))
    return out


def phase_tsr_lgpma(card, pages, regions):
    """``OcrTableStructureTask(model="Lgpma")`` at full width (ResNet-50,
    FPN 256, max side 800, 512 proposals, fc 1024, mask_top 256, f32), one
    crop a forward, on the 8 table regions resident on the card: the
    counted run launches none of K1-K3 (JAX's lane reaches no Pallas
    kernel); crops/s, stage ms, peak memory, idle share and agreement with
    the same port on the CPU. Returns the launch counts."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    t0 = time.perf_counter()
    dev_pages = torch.from_numpy(pages).cuda()
    tree = lgpma_tree(OcrTableStructureTask(model="Lgpma", device="cuda"),
                      dev_pages, regions)
    task = OcrTableStructureTask(model="Lgpma", device="cuda",
                                 variables=tree)
    build_s = time.perf_counter() - t0
    cfg = task.model_config

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(dev_pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    check(sum(launches.values()) == 0, f"the LGPMA lane launched {launches}")
    check(len(results) == len(regions)
          and all(r["type"] == "lgpma" for r in results),
          "LGPMA: one lgpma result per region")
    check(all(np.isfinite(c["bbox"]).all() for r in results
              for c in r["cells"]), "LGPMA: cells are not finite")
    cells = [len(r["cells"]) for r in results]
    check(sum(cells) > 0, "LGPMA: no cell")

    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(LGPMA_RUNS):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(dev_pages, regions)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        (_s, (meta,), x), *_ = task.sub_batches(dev_pages, regions)
        raw = task._forward_packed(x)
        host = {k: v.cpu().numpy() for k, v in raw.items()}
        stages = {
            "pre": host_ms(lambda: next(iter(task.sub_batches(
                dev_pages, regions[:1])))),
            "forward": host_ms(lambda: task.model(x)),
            "download": host_ms(lambda: {k: v.cpu()
                                         for k, v in raw.items()}),
            "host_post": host_ms(lambda: task._post_one(host, meta),
                                 iters=2),
            "input": list(x.shape[1:3])}
    prof = profile_run(lambda: task.batch_infer_from_pages(
        dev_pages, regions[:2]), full=False)
    cpu = OcrTableStructureTask(model="Lgpma", device="cpu", variables=tree)
    agree = lgpma_agreement(task, cpu, dev_pages, pages, regions)
    summary = {
        "card": card, "model": "Lgpma", "depth": cfg.backbone_depth,
        "fpn": cfg.fpn_channels, "max_side": cfg.max_side,
        "proposals": cfg.num_proposals, "fc": cfg.fc_dim,
        "mask_top": cfg.mask_top, "dtype": cfg.dtype,
        "crops": len(regions), "launches": launches,
        "model_build_s": build_s, "first_run_s": first_s,
        "run_s_median": per_run, "run_s_min": min(run_s),
        "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "peak_mem_gib": peak / 2 ** 30, "stage_ms_one_crop": stages,
        "profile_two_crops": prof, "cells": cells, "cpu": agree}
    print(json.dumps({"tsr_lgpma": summary}))
    check(agree["inputs_max_abs"] <= LGPMA_TOL,
          f"LGPMA: inputs differ from the CPU's: {agree['inputs_max_abs']}")
    check(agree["levels_rel"] <= LGPMA_TOL and agree["heads_rel"]
          <= LGPMA_TOL, f"LGPMA: maps or heads differ from the CPU's: "
          f"{agree['levels_rel']:.3g}, {agree['heads_rel']:.3g}")
    check(min(agree["props_compared"]) > 0
          and agree["props_px"] <= LGPMA_PROP_PX,
          f"LGPMA: proposals differ from the CPU's before the first "
          f"near-tie: {agree['props_px']:.3g} px")
    check(all(agree["cells_equal"]), "LGPMA: cells differ from the CPU's "
          "on equal proposals")
    return launches


# DocXLayout and the rest of the backbones
DOCX_VAR_GAIN = 2.0     # calibrated DLA variances doubled (else chaotic)
DOCX_QUAD = 20.0        # feature-map px: the wh bias, boxes overlap
# the "table" class lifted: one table a page reaches into the page (the
# random heads peak in the warp's zero padding beside it)
DOCX_TABLE_BIAS = 0.3
DOCX_RUNS = 3
DOCX_CPU_PAGES = 2
DOCX_INPUT_TOL = 1e-4   # card vs CPU: normalized inputs, max |diff|
DOCX_HEADS_TOL = 1e-4   # card vs CPU: heads, max |diff| / max |head|
DOCX_YARD_TOL = 1e-3    # f32 kernel vs plain-DCN yardstick, relative
DOCX_TIE_GAP = 1e-4     # cells compared up to the first near-tie
DOCX_BOX_PX = 1e-2      # canvas px, on those cells
DOCX_SCORE_TOL = 1e-4
DOCX_PIPE_PAGES = 16
DOCX_PIPE_CPU_PAGES = 1
DET_MODELS = ("db_resnet18", "db_resnet50", "db_proxylessnas")
DETB_VAR_GAIN = 2.0     # calibrated ResNet / NAS variances doubled
DETB_RUNS = 5
DETB_THRESH_QUANTILE = 0.8
DETB_CPU_PAGES = 2
REC_MODELS = ("CRNN", "ConvNextViT", "LightweightEdge")
# the CTC head's kernel gain and whether its bias is zeroed (CRNN's LSTMs
# squash its features to some 1e-2), as the CPU tests' trees
RECB_HEAD = {"CRNN": (5.0, True), "ConvNextViT": (0.2, False),
             "LightweightEdge": (0.2, False)}
RECB_GAMMA = 0.1        # ConvNext layer scale (1e-6 at init)
RECB_RUNS = 3
RECB_CPU_PAGES = 2      # pages whose crops are held against the CPU
# K1's kernels: the f32 body (its weight split and tap-group sum passes
# with it) and the bf16 body
K1_KERNELS = ("dcn_tf32_kernel", "stage_weight_tf32_kernel",
              "reduce_tf32_kernel", "dcn_wgmma_kernel")


def docx_tree(task, dev_pages):
    """A seeded full-width DocXLayout tree (offset convs perturbed),
    BatchNorm statistics calibrated on the card on the task's own warped
    canvases and the variances doubled; the 11 layout and 2 column
    heatmaps at 0.5 (the "table" class at sigmoid(DOCX_TABLE_BIAS)), the
    wh bias a +-DOCX_QUAD px quad, so that detections pass 0.3 and the
    polygon NMS suppresses (the CPU tests' tree)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.engine.params import (
        calibrate_batch_stats, init_docx_layout, perturb_conv_offset_mask,
        scale_batch_variances)

    with torch.inference_mode():
        x = task.preprocess(dev_pages)
    net = task.model
    net.forward = net.heads
    tree = scale_batch_variances(calibrate_batch_stats(
        net, perturb_conv_offset_mask(init_docx_layout(task.model_config, 0),
                                      seed=1), x.clone()), DOCX_VAR_GAIN)
    del net.forward
    heads = tree["params"]["dla"]["heads"]
    heads["hm_out"]["bias"] = np.zeros(11, np.float32)
    heads["hm_out"]["bias"][7] = DOCX_TABLE_BIAS
    heads["hm_sub_out"]["bias"] = np.zeros(2, np.float32)
    heads["wh_out"]["bias"] = DOCX_QUAD * np.array(
        [1, 1, -1, 1, -1, -1, 1, -1], np.float32)
    torch.cuda.synchronize()
    return tree


def docx_cells_agree(got, want) -> dict:
    """Layout cells per page of two runs, compared up to the first
    near-tie of ``want``'s scores (they come in score order): how many
    were compared, labels equal, worst box px and score difference."""
    import numpy as np

    out = {"compared": [], "cells": [], "labels_equal": True,
           "box_px": 0.0, "score": 0.0}
    for g, w in zip(got, want):
        n = prefix_before_tie(np.asarray([c.score for c in w]),
                              DOCX_TIE_GAP)
        out["compared"].append(min(n, len(g)))
        out["cells"].append([len(g), len(w)])
        for a, b in zip(g[:n], w[:n]):
            out["labels_equal"] &= (a.label, a.cell_type.name) == \
                (b.label, b.cell_type.name)
            out["box_px"] = max(out["box_px"], float(
                np.abs(np.subtract(a.bbox, b.bbox)).max()))
            out["score"] = max(out["score"], abs(a.score - b.score))
    return out


def k1_device_share(fn) -> dict:
    """K1's device ms in one traced ``fn()``, its share of the device busy
    time, and whether its f32 body ran."""
    from torch.profiler import ProfilerActivity

    wall, events = _trace(fn, [ProfilerActivity.CUDA])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events
             if any(k in e.key for k in K1_KERNELS)) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "k1_ms": k1,
            "k1_share": k1 / busy if busy else None,
            "f32_body": any("dcn_tf32_kernel" in e.key for e in events)}


def docx_stages(task, dev_pages) -> dict:
    """The chunk's stages, each timed alone (host_ms)."""
    import torch

    from pdf_table_tpu_torch.models.docx_layout.model import unpack_docx

    with torch.inference_mode():
        x = task.preprocess(dev_pages)
        heads = task.forward(x)
        handle, metas = task.enqueue(dev_pages)
        packed = handle.cpu().numpy()
        k = task.model_config.top_k
        return {
            "warp_normalize": host_ms(lambda: task.preprocess(dev_pages)),
            "forward": host_ms(lambda: task.forward(x)),
            "decode": host_ms(lambda: task.decode(heads)),
            "download": host_ms(lambda: handle.cpu()),
            "host_pnms": host_ms(lambda: [
                task.post.to_layout_cells(task.post(unpack_docx(
                    packed[i], k), m)) for i, m in enumerate(metas)],
                iters=2)}


def phase_layout_docx(card):
    """``OcrLayoutTask(model="DocXLayout")`` at full width (768^2,
    head_conv 256, f32) on the detection phase's 8 canvases, resident on
    the card: the counted run (K1 at each of the trunk's 16 DCNs a forward,
    K2 and K3 never), pages/s, stage ms, peak memory, idle share and K1's
    share of the device time; one bf16 forward (K1's and K2's launches as
    the flat-kc route picks them); the plain-DCN yardstick; 2 canvases
    against the same port on the CPU. Returns the tree and the launch
    counts of the f32 run and the bf16 forward."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.docx_layout.config import \
        DocXLayoutConfig
    from pdf_table_tpu_torch.models.docx_layout.model import DocXLayoutModel
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pipeline.batch_runner import pack_pages
    from pdf_table_tpu_torch.tasks.layout import (DOCX_SUB_BATCH,
                                                  OcrLayoutTask)

    (bucket, g), = pack_pages([make_page(i)
                               for i in range(DET_PAGES)]).items()
    canvases = g["images"]
    dev_pages = torch.from_numpy(canvases).cuda()
    t0 = time.perf_counter()
    tree = docx_tree(OcrLayoutTask(model="DocXLayout", device="cuda"),
                     dev_pages)
    task = OcrLayoutTask(model="DocXLayout", device="cuda", variables=tree)
    build_s = time.perf_counter() - t0
    cfg = task.model_config
    n_sub = -(-len(canvases) // DOCX_SUB_BATCH)

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cells = task.batch_infer_from_pages(dev_pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    print(json.dumps({"layout_docx_launches": launches,
                      "forwards": n_sub}))
    check(launches["deform_conv2d"] == CN_DCNS * n_sub
          and launches["deform_conv2d_flat_kc"] == 0
          and launches["resize_normalize"] == 0,
          f"DocXLayout: launches {launches} for {n_sub} f32 forwards")
    check(len(cells) == len(canvases) and all(cells),
          "DocXLayout: a page without layout cells")
    H, W = bucket
    check(all(0 <= c.bbox[0] <= c.bbox[2] <= W and 0 <= c.bbox[1]
              <= c.bbox[3] <= H for p in cells for c in p),
          "DocXLayout: cells outside their canvas")
    labels = sorted({c.label for p in cells for c in p})

    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(DOCX_RUNS):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(dev_pages)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    stages = docx_stages(task, dev_pages)
    prof = profile_run(lambda: task.batch_infer_from_pages(dev_pages),
                       full=False)
    with torch.inference_mode():
        x = task.preprocess(dev_pages)
        share = k1_device_share(lambda: task.forward(x))

    # one bf16 forward of the 8 canvases, counted
    bf16 = DocXLayoutModel(DocXLayoutConfig(dtype="bfloat16")).eval()
    load_flax_variables(bf16, tree)
    bf16.to("cuda")
    with torch.inference_mode():
        bf16.forward_packed(x).cpu()             # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        packed_bf16 = bf16.forward_packed(x).cpu().numpy()
        torch.cuda.synchronize()
    bf16_launches = {k: launch_counts[k] for k in KERNELS}
    print(json.dumps({"layout_docx_bf16_launches": bf16_launches,
                      "pages": int(x.shape[0])}))
    check(bf16_launches["deform_conv2d"] > 0
          and bf16_launches["deform_conv2d"]
          + bf16_launches["deform_conv2d_flat_kc"] == CN_DCNS
          and bf16_launches["resize_normalize"] == 0,
          f"DocXLayout bf16: launches {bf16_launches}")
    check(np.isfinite(packed_bf16).all(), "DocXLayout bf16: not finite")
    del bf16

    # the plain-DCN yardstick on the same tree and inputs
    plain = DocXLayoutModel(cfg, plain_dcn=True).eval()
    load_flax_variables(plain, tree)
    plain.to("cuda")
    with torch.inference_mode():
        ha = task.model.heads(x)
        torch.cuda.synchronize()
        before = dict(launch_counts)
        hb = plain.heads(x)
        torch.cuda.synchronize()
        check(dict(launch_counts) == before,
              "the plain yardstick launched a kernel")
        yard = {k: rel_err(ha[k], hb[k]) for k in hb}
    del plain, ha, hb

    # the card against the same port on the CPU
    cpu = OcrLayoutTask(model="DocXLayout", device="cpu", variables=tree)
    few = canvases[:DOCX_CPU_PAGES]
    metas = [dict(task.pre.plan(H, W)[1]) for _ in range(len(few))]
    with torch.inference_mode():
        xa = task.preprocess(dev_pages[:DOCX_CPU_PAGES])
        xc = cpu.preprocess(torch.from_numpy(few))
        inputs = float((xa.cpu() - xc).abs().max())
        ha = task.forward(xa)
        t0 = time.perf_counter()
        hc = cpu.forward(xc)
        cpu_s = time.perf_counter() - t0
        heads = max(rel_err(ha[n].cpu(), hc[n]) for n in hc)
        got = [r["layout_cells"]
               for r in task.results(task.decode(ha), metas)]
        want = [r["layout_cells"]
                for r in cpu.results(cpu.decode(hc), metas)]
    agree = docx_cells_agree(got, want)
    summary = {
        "card": card, "model": "DocXLayout", "resolution": list(
            cfg.resolution), "head_conv": cfg.head_conv, "top_k": cfg.top_k,
        "dtype": cfg.dtype, "pages": len(canvases), "canvas": list(bucket),
        "forwards": n_sub, "launches": launches,
        "bf16_forward_launches": bf16_launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": len(canvases) / per_run,
        "peak_mem_gib": peak / 2 ** 30, "stage_ms": stages, "profile": prof,
        "forward_k1": share, "cells": [len(p) for p in cells],
        "labels": labels, "yardstick_heads_rel": yard,
        "cpu": {"inputs_max_abs": inputs, "heads_rel": heads,
                "forward_s": cpu_s, **agree}}
    print(json.dumps({"layout_docx": summary}))
    check(share["f32_body"], "DocXLayout: the forward's trace shows no "
          "dcn_tf32_kernel")
    check(max(yard.values()) <= DOCX_YARD_TOL,
          f"DocXLayout: the kernel's heads differ from the plain DCN's: "
          f"{yard}")
    check(inputs <= DOCX_INPUT_TOL,
          f"DocXLayout: inputs differ from the CPU's: {inputs:.3g}")
    check(heads <= DOCX_HEADS_TOL,
          f"DocXLayout: heads differ from the CPU's: {heads:.3g}")
    check(min(agree["compared"]) > 0 and agree["labels_equal"]
          and agree["box_px"] <= DOCX_BOX_PX
          and agree["score"] <= DOCX_SCORE_TOL,
          f"DocXLayout: cells differ from the CPU's before the first "
          f"near-tie: {agree}")
    return tree, {"f32": launches, "bf16": bf16_launches}


def phase_pipeline_docx(card, trees, tree):
    """The pipeline phase's 16 pages through ``BatchPipeline.run`` with
    ``layout_model="DocXLayout"`` (full width, f32, on ``tree``) and LORE
    wireless: a warm-up, one counted run (K3 once a chunk, K1 16 times a
    DocXLayout forward and a LORE sub-batch, K2 never), a timed run
    (pages/s, lanes, peak memory), idle share; one page against the same
    pipeline on the CPU."""
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask

    imgs = [make_page(i) for i in range(DOCX_PIPE_PAGES)]
    pages = [{"image": im, "page": i} for i, im in enumerate(imgs)]

    def build(device):
        bp = build_pipeline(device, trees)
        bp.system.config.layout_model = "DocXLayout"
        bp.system._layout = OcrLayoutTask(model="DocXLayout", device=device,
                                          variables=tree)
        return bp

    t0 = time.perf_counter()
    bp = build("cuda")
    bp.run(pages)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_chunks = -(-DOCX_PIPE_PAGES // bp.batch_pages)
    counted = {"layout": [], "lore": []}
    models = {"layout": (bp.system.layout_task.model, "heads"),
              "lore": (bp.system.tsr_task.model, "forward_packed")}
    for key, (m, fn) in models.items():
        setattr(m, fn, (lambda r, k: lambda x: (
            counted[k].append(x.shape[0]), r(x))[1])(getattr(m, fn), key))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    for m, fn in models.values():
        delattr(m, fn)
    errors = [o.metric.get("error") for o in out if o.metric.get("error")]
    check(len(out) == DOCX_PIPE_PAGES and not errors,
          f"DocXLayout pipeline: pages carry errors: {errors[:3]}")
    check(all(o.page_html for o in out),
          "DocXLayout pipeline: a page has no page_html")
    n_tables = sum(len(o.table_structures) for o in out)
    check(n_tables > 0 and counted["lore"],
          "DocXLayout pipeline: no table reached LORE")
    forwards = len(counted["layout"]) + len(counted["lore"])
    check(len(counted["layout"]) == n_chunks
          and launches["resize_normalize"] == n_chunks
          and launches["deform_conv2d"] == CN_DCNS * forwards
          and launches["deform_conv2d_flat_kc"] == 0,
          f"DocXLayout pipeline launched {launches} for {n_chunks} chunks, "
          f"{counted}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bp.run(pages)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lane_ms = {k: v * 1e3 for k, v in bp.last_stats.items()
               if k != "n_pages"}
    prof = profile_run(lambda: bp.run(pages), full=False)
    few = pages[:DOCX_PIPE_CPU_PAGES]
    got = bp.run(few)
    cpu = build("cpu")
    t0 = time.perf_counter()
    want = cpu.run(few)
    cpu_s = time.perf_counter() - t0
    cmp = pipeline_diff(got, want)
    cmp["layout"] = docx_cells_agree([o.layout_cells for o in got],
                                     [o.layout_cells for o in want])
    summary = {
        "card": card, "layout": "DocXLayout", "tsr": "Lore",
        "pages": DOCX_PIPE_PAGES, "chunks": n_chunks, "launches": launches,
        "layout_forwards": counted["layout"],
        "lore_sub_batches": counted["lore"], "warm_up_s": warm_s,
        "counted_run_s": counted_s, "run_s": run_s,
        "pages_per_s": DOCX_PIPE_PAGES / run_s,
        "ms_per_page": run_s * 1e3 / DOCX_PIPE_PAGES, "lane_ms": lane_ms,
        "peak_mem_gib": peak / 2 ** 30, "tables": n_tables,
        "layout_cells": sum(len(o.layout_cells) for o in out),
        "profile": prof, "cpu": {"run_s": cpu_s, **cmp}}
    print(json.dumps({"pipeline_docx": summary}))
    check(not [o for o in want if o.metric.get("error")],
          "the CPU DocXLayout pipeline gave errors")
    check(cmp["quads_same_count"] and cmp["quad_px"] <= PIPE_QUAD_TOL,
          "DocXLayout pipeline: quads differ from the CPU's")
    lay = cmp["layout"]
    check(min(lay["compared"]) > 0 and lay["labels_equal"]
          and lay["box_px"] <= DOCX_BOX_PX
          and lay["score"] <= DOCX_SCORE_TOL,
          f"DocXLayout pipeline: layout cells differ from the CPU's: {lay}")
    check(cmp["text_share"] >= PIPE_TEXT_MIN,
          f"DocXLayout pipeline: texts equal on {cmp['text_share']:.3f} of "
          f"crops")
    check(cmp["page_html_equal"] == cmp["page_html_checked"],
          "DocXLayout pipeline: page_html differs where its inputs are "
          "equal")
    return launches


def digital_pdf():
    """Eight letter and A3 pages written with the port's PdfWriter: three
    wired tables of different shapes, two tables on one page, a text-only
    page, a merged-header table, an A3 landscape page (2382x1684 px at 144
    dpi: scaled to fit the 2048x1536 bucket) and a page authored rotated
    by 90 degrees. -> (PDF bytes, index of the A3 page, of the rotated
    one)."""
    from pdf_table_tpu_torch.pdfio import PdfWriter

    w = PdfWriter()
    for k, (cols, rows) in enumerate(((4, 4), (3, 7), (6, 3))):
        p = w.add_page(612, 792)
        for i in range(3):
            p.text(60, 740 - 20 * i, f"Page {k} paragraph line {i}, text "
                   f"before the table.")
        p.table(60, 660, [460 / cols] * cols, 24,
                [[f"r{r}c{c}" for c in range(cols)] for r in range(rows)])
        p.text(60, 640 - 24 * rows, "A closing line under the table.")
    p = w.add_page(612, 792)
    p.text(60, 750, "Two tables on one page.")
    p.table(60, 700, [90, 90], 22, [["k", "v"], ["a", "1"], ["b", "2"]])
    p.text(60, 600, "A paragraph between the tables.")
    p.table(60, 560, [70, 70, 70], 22,
            [["x", "y", "z"], ["1", "2", "3"], ["4", "5", "6"]])
    p = w.add_page(612, 792)
    for i in range(24):
        p.text(60, 740 - 26 * i, f"Text-only line {i}: no table on this "
               f"page, only running text.")
    p = w.add_page(612, 792)
    p.text(60, 740, "A merged header.")
    for y in (700, 676, 652):
        p.line(60, y, 360, y, lw=0.8)
    for x in (60, 360):
        p.line(x, 652, x, 700, lw=0.8)
    p.line(210, 652, 210, 676, lw=0.8)
    p.text(180, 684, "HEAD", size=10)
    p.text(100, 660, "left", size=10)
    p.text(260, 660, "right", size=10)
    a3 = len(w.pages)
    p = w.add_page(1191, 842)
    p.text(60, 800, "An A3 landscape page above the largest bucket.")
    p.table(60, 760, [180] * 6, 28,
            [[f"a{r}{c}" for c in range(6)] for r in range(8)], size=11)
    rot = len(w.pages)
    p = w.add_page(612, 792)
    for i in range(8):
        p.ops.append(f"BT /F1 11 Tf 0 1 -1 0 {100 + 40 * i} 120 Tm "
                     f"(a line written rotated {i}) Tj ET")
    return w.tobytes(), a3, rot


def digital_cells(cells) -> list:
    return [(c.bbox, c.text, c.cell_type.name) for c in cells]


def table_regions(cells) -> list:
    return [c.bbox for c in cells if c.cell_type.name == "TABLE"]


def phase_pipeline_digital(card, trees):
    """Digital PDF pages (``digital_pdf``) read with the port's reader
    (built here) through ``BatchPipeline.run`` with the pipeline phase's
    configuration and trees, interleaved with 8 raster pages of the same
    canvas bucket, so that chunks mix them: a warm-up, one counted run (K3
    once a chunk, K1 16 times a LORE sub-batch of the raster pages' tables,
    K2 never), timed runs (pages/s, lanes), idle share; every digital
    page against the same pipeline on the CPU. Where PIL imports, the
    runner renders the digital pages (``render_page``); without it they
    carry the image of ``render_page_vector``."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pdfio import (PdfDocument, render_page,
                                           render_page_vector)
    from pdf_table_tpu_torch.pdfio.reader import build_native

    t0 = time.perf_counter()
    build_native()
    reader_build_s = time.perf_counter() - t0
    data, a3, rot = digital_pdf()
    t0 = time.perf_counter()
    doc = PdfDocument.open(data)
    pdf_pages = [doc.load_page(i) for i in range(doc.page_count)]
    reader_ms = (time.perf_counter() - t0) * 1e3 / len(pdf_pages)
    t0 = time.perf_counter()
    vector = [render_page_vector(doc, pg) for pg in pdf_pages]
    vector_ms = (time.perf_counter() - t0) * 1e3 / len(pdf_pages)
    try:
        import PIL  # noqa: F401
        has_pil = True
        t0 = time.perf_counter()
        for pg in pdf_pages:
            render_page(doc, pg)
        render_ms = (time.perf_counter() - t0) * 1e3 / len(pdf_pages)
    except ImportError:
        has_pil, render_ms = False, None

    def digital(i):
        page = {"pdf_page": pdf_pages[i], "pdf_doc": doc}
        if not has_pil:
            page["image"] = vector[i]
        return page

    h, w = vector[0].shape[:2]
    raster = [make_page(100 + i, h, w) for i in range(DIGITAL_RASTER)]
    pages = []
    for i in range(max(len(pdf_pages), len(raster))):
        if i < len(raster):
            pages.append({"image": raster[i]})
        if i < len(pdf_pages):
            pages.append(digital(i))
    for i, p in enumerate(pages):
        p["page"] = i
    is_digital = ["pdf_page" in p for p in pages]
    rot_i = [i for i, p in enumerate(pages)
             if p.get("pdf_page") is pdf_pages[rot]][0]
    a3_i = [i for i, p in enumerate(pages)
            if p.get("pdf_page") is pdf_pages[a3]][0]

    bp = build_pipeline("cuda", trees)
    t0 = time.perf_counter()
    bp.run(pages)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    tsr_model = bp.system.tsr_task.model
    forwards = []
    real_forward = tsr_model.forward_packed
    tsr_model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                          real_forward(x))[1]
    chunks = []
    real_chunks = bp._chunks

    def counted_chunks(images):
        cs = real_chunks(images)
        chunks.extend(len(c["indices"]) for c in cs)
        return cs

    bp._chunks = counted_chunks
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    del tsr_model.forward_packed, bp._chunks
    check(len(out) == len(pages), "pipeline_digital: one output per page")
    errors = {i: o.metric.get("error") for i, o in enumerate(out)
              if o.metric.get("error")}
    check(not errors and out[rot_i].is_pdf
          and "recognition" in out[rot_i].metric,
          f"pipeline_digital: errors {errors} (the rotated page runs the "
          f"serial per-page system)")
    check(all(o.page_html for o in out),
          "pipeline_digital: a page has no page_html")
    check([o.is_pdf for o in out] == is_digital,
          "pipeline_digital: is_pdf differs from the pages' kind")
    big = out[a3_i]
    check(big.image_shape[0] <= 2048 and big.image_shape[1] <= 1536
          and big.pdf_scale == big.image_shape[0] / pdf_pages[a3].height,
          f"pipeline_digital: the A3 page is {big.image_shape}, "
          f"pdf_scale {big.pdf_scale}")
    n_digital_tables = sum(len(o.table_html) for o in out if o.is_pdf)
    check(n_digital_tables >= 6,
          f"pipeline_digital: {n_digital_tables} digital tables")
    check(forwards and sum(len(o.table_structures)
                           for o in out if not o.is_pdf) > 0,
          "pipeline_digital: no raster table reached LORE")
    check(launches["resize_normalize"] == len(chunks)
          and launches["deform_conv2d"] == 16 * len(forwards)
          and launches["deform_conv2d_flat_kc"] == 0,
          f"pipeline_digital launched {launches} for {len(chunks)} chunks "
          f"and {len(forwards)} LORE sub-batches")

    torch.cuda.reset_peak_memory_stats()
    run_s, lanes = [], []
    for _ in range(DIGITAL_RUNS):
        t0 = time.perf_counter()
        bp.run(pages)
        run_s.append(time.perf_counter() - t0)
        lanes.append(bp.last_stats)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()
    lane_ms = {k: statistics.median(st[k] for st in lanes) * 1e3
               for k in lanes[0] if k != "n_pages"}
    prof = profile_run(lambda: bp.run(pages), full=False)

    # every digital page but the rotated one (its OCR is held in
    # system_per_page) against the same pipeline on the CPU
    only = [i for i, d in enumerate(is_digital) if d and i != rot_i]
    cpu = build_pipeline("cpu", trees)
    t0 = time.perf_counter()
    want = cpu.run([pages[i] for i in only])
    cpu_s = time.perf_counter() - t0
    got = [out[i] for i in only]
    cells_equal = regions_equal = tables_equal = 0
    for g, wt in zip(got, want):
        cells_equal += digital_cells(g.text_cells) == \
            digital_cells(wt.text_cells)
        ga, wa = table_regions(g.layout_cells), table_regions(wt.layout_cells)
        same = len(ga) == len(wa) and (not ga or float(np.abs(
            np.subtract(ga, wa)).max()) <= LAYOUT_BOX_TOL)
        regions_equal += same
        tables_equal += same and g.table_html == wt.table_html
    summary = {
        "card": card, "pages": len(pages), "digital_pages": len(only),
        "raster_pages": len(raster), "chunks": chunks,
        "launches": launches, "lore_sub_batches": forwards,
        "pil": has_pil, "reader_build_s": reader_build_s,
        "reader_ms_per_page": reader_ms,
        "render_vector_ms_per_page": vector_ms,
        "render_ms_per_page": render_ms, "warm_up_s": warm_s,
        "counted_run_s": counted_s, "run_s_median": per_run,
        "runs": len(run_s), "pages_per_s": len(pages) / per_run,
        "lane_ms": lane_ms, "peak_mem_gib": peak / 2 ** 30,
        "digital_tables": n_digital_tables,
        "a3_image_shape": list(big.image_shape), "profile": prof,
        "cpu": {"run_s": cpu_s, "digital_pages": len(got),
                "text_cells_equal": cells_equal,
                "layout_regions_equal": regions_equal,
                "table_html_equal_where_regions_equal": tables_equal}}
    print(json.dumps({"pipeline_digital": summary}))
    check(cells_equal == len(got),
          f"pipeline_digital: vector text cells equal to the CPU's on "
          f"{cells_equal} of {len(got)} digital pages")
    check(tables_equal == regions_equal,
          "pipeline_digital: table_html differs from the CPU's where the "
          "layout regions are equal")
    return launches


def jpeg_bytes(img, mode="RGB") -> bytes:
    """An RGB page as a JPEG of ``mode`` (RGB, L or CMYK), through PIL."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG")
    return buf.getvalue()


def scan_pdf(img, ocr_lines: int = 0) -> bytes:
    """One page of the port's PdfWriter holding ``img`` as a JPEG scan
    placed 1:1 at 144 dpi, with ``ocr_lines`` lines of invisible text
    (render mode 3, as OCR tools write it)."""
    from pdf_table_tpu_torch.pdfio import PdfWriter

    h, w = img.shape[:2]
    writer = PdfWriter()
    p = writer.add_page(w / 2, h / 2)
    p.image(jpeg_bytes(img), 0, 0, w / 2, h / 2, w, h)
    for k in range(ocr_lines):
        p.ops.append(f"BT 3 Tr /F1 10 Tf 36 {h / 2 - 40 - 18 * k:g} Td "
                     f"(scanned line {k} read by OCR) Tj ET")
    return writer.tobytes()


def scanned_pdf() -> bytes:
    """The pipeline phase's 16 pages (make_page) as one PDF of JPEG scans
    written by PIL at 144 dpi, so that the runner's 144 dpi places each
    1:1; page SCAN_GREY a grey JPEG, page SCAN_CMYK a CMYK one."""
    import io

    from PIL import Image

    modes = {SCAN_GREY: "L", SCAN_CMYK: "CMYK"}
    ims = [Image.fromarray(make_page(i)).convert(modes.get(i, "RGB"))
           for i in range(PIPE_PAGES)]
    buf = io.BytesIO()
    ims[0].save(buf, format="PDF", save_all=True, append_images=ims[1:],
                resolution=144)
    return buf.getvalue()


def same_outputs(got, want) -> list:
    """Indices of the pages whose quads, texts, layout cells, table_html
    or page_html differ."""
    import numpy as np

    def key(o):
        return ([(np.asarray(c.poly).tobytes(), c.text, c.score)
                 for c in o.text_cells],
                [(np.asarray(c.bbox).tobytes(), c.label, c.score)
                 for c in o.layout_cells], o.table_html, o.page_html)

    return [i for i, (g, w) in enumerate(zip(got, want)) if key(g) != key(w)]


def phase_decode():
    """Phase 9d (module docstring). Returns its summary."""
    import hashlib
    import importlib.util
    import io
    import struct

    import numpy as np
    import PIL
    from PIL import Image, ImageFile

    from pdf_table_tpu_torch.utils.codec_libs import libtiff, openjpeg
    from pdf_table_tpu_torch.utils.image_io import (ImageDecodeError,
                                                    decode_image)

    libs = {}
    for name, load in (("libopenjp2", openjpeg), ("libtiff", libtiff)):
        try:
            libs[name] = load().path
        except RuntimeError as e:
            check(False, f"decode: {e}")
    print(json.dumps({"decode_libraries": libs}))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "image_decode")
    with open(os.path.join(root, "digests.json")) as f:
        digests = json.load(f)["files"]
    pil_globals = (Image.MAX_IMAGE_PIXELS, ImageFile.LOAD_TRUNCATED_IMAGES)
    for name, want in sorted(digests.items()):
        with open(os.path.join(root, name), "rb") as f:
            rgb = decode_image(f.read())
        got = None if rgb is None else {
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "shape": list(rgb.shape)}
        check(got == want, f"decode: {name} gives {got} with PIL "
                           f"{PIL.__version__}, cv2 5.0.0 gave {want}")
    side, grey = DECODE_BIG_SIDE, 137
    buf = io.BytesIO()
    Image.new("L", (side, side), grey).save(buf, format="JPEG", quality=90)
    big = buf.getvalue()
    try:
        Image.open(io.BytesIO(big))
        refused = False
    except Image.DecompressionBombError:
        refused = True
    check(refused, "decode: Image.open took the 13,400^2 JPEG, so it tests "
                   "nothing of PIL's limit")
    t = time.perf_counter()
    rgb = decode_image(big)
    big_s = time.perf_counter() - t
    check(rgb is not None and rgb.shape == (side, side, 3)
          and int(rgb.min()) == int(rgb.max()) == grey,
          "decode: the 13,400^2 flat grey JPEG did not decode to its value")
    del rgb
    small = io.BytesIO()
    Image.new("RGB", (64, 48), (90, 120, 200)).save(small, format="JPEG")
    small = small.getvalue()
    i = small.index(b"\xff\xc0")
    over = small[:i + 5] + struct.pack(">HH", 30000, 40000) + small[i + 9:]
    try:
        decode_image(over)
        raised = False
    except ImageDecodeError:
        raised = True
    check(raised, "decode: a 40,000 x 30,000 header did not raise")
    # a 30 x 20 frame of palette indices at (100, 200) on a 16,384 x 10,923
    # screen (178,962,432 pixels), disposal 2, background index 9
    pal = np.arange(768, dtype=np.uint32).reshape(256, 3) * 7 % 256
    frame = np.arange(600, dtype=np.uint32).reshape(20, 30) * 11 % 256
    codes = [(256, 9)]
    for k, v in enumerate(frame.ravel()):
        if k and k % 254 == 0:
            codes.append((256, 9))
        codes.append((int(v), 9))
    codes.append((257, 9))
    lzw, acc, nbits = bytearray(), 0, 0
    for code, n in codes:
        acc |= code << nbits
        nbits += n
        while nbits >= 8:
            lzw.append(acc & 255)
            acc >>= 8
            nbits -= 8
    lzw.append(acc)
    gif = (b"GIF89a" + struct.pack("<HHBBB", 16384, 10923, 0xF7, 9, 0)
           + pal.astype(np.uint8).tobytes() + b"\x21\xf9\x04\x08\0\0\0\0"
           + b"\x2c" + struct.pack("<HHHHB", 100, 200, 30, 20, 0) + b"\x08"
           + b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                      for i in range(0, len(lzw), 255)) + b"\0\x3b")
    t = time.perf_counter()
    rgb = decode_image(gif)
    gif_s = time.perf_counter() - t
    check(rgb is not None and rgb.shape == (10923, 16384, 3)
          and (rgb[0, 0] == pal[9]).all() and (rgb[-1, -1] == pal[9]).all()
          and (rgb[200:220, 100:130] == pal[frame]).all(),
          "decode: the GIF over PIL's bomb check did not decode to its "
          "background and frame")
    del rgb
    # a 300 dpi A4 page as an ASCII P3 (the port's ReadNumber loop in C++)
    # and a 16,400^2 grey TIFF in one strip (libtiff's scanline route)
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(root, "make_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    p3, samples = tool.page_ascii_pnm(3)
    t = time.perf_counter()
    rgb = decode_image(p3)
    p3_s = time.perf_counter() - t
    check(rgb is not None and np.array_equal(rgb, samples),
          "decode: the page-sized P3 did not decode to its samples")
    del rgb, p3, samples
    tside = 16400
    tiff = tool.strip_tiff(tool.grey_strip(tside), tside, tside, 1)
    t = time.perf_counter()
    rgb = decode_image(tiff)
    tiff_s = time.perf_counter() - t
    x = np.arange(tside)
    check(rgb is not None and rgb.shape == (tside, tside, 3) and all(
        np.array_equal(rgb[y, :, c], (x + 7 * y) % 251)
        for y in (0, 1, tside - 1) for c in range(3)),
        "decode: the 16,400^2 single-strip grey TIFF did not decode to its "
        "samples")
    del rgb, tiff
    check(Image.MAX_IMAGE_PIXELS is pil_globals[0]
          and ImageFile.LOAD_TRUNCATED_IMAGES is pil_globals[1],
          "decode: a PIL global was written")
    # the host geometry (F16-F19) on this host against cv2's digests
    spec = importlib.util.spec_from_file_location(
        "host_geometry", os.path.join(root, "host_geometry.py"))
    geo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(geo)
    t = time.perf_counter()
    got_geo = geo.port_outputs()
    geo_s = time.perf_counter() - t
    want_geo = geo.load_digests()
    geo_off = [k for k in sorted(want_geo) if got_geo.get(k) != want_geo[k]]
    check(not geo_off, f"decode: the host geometry of {geo_off} differs "
                       f"from cv2 5.0.0's digests on this host")
    out = {"pil": PIL.__version__, "fixtures": len(digests),
           "big_side": side, "big_decode_s": big_s, "big_jpeg_bytes":
           len(big), "big_gif_decode_s": gif_s, "p3_page_decode_s": p3_s,
           "big_tiff_strip_decode_s": tiff_s,
           "host_geometry_cases": len(want_geo), "host_geometry_s": geo_s}
    print(json.dumps({"decode": out}))
    return out


def phase_html():
    """Phase 9e (module docstring). Returns its summary."""
    import importlib.util
    import platform

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    spec = importlib.util.spec_from_file_location(
        "html_soup", os.path.join(root, "html_soup.py"))
    soup = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soup)
    with open(os.path.join(root, "data", "html_tree", "cases.json")) as f:
        fixtures = json.load(f)
    t = time.perf_counter()
    got = [soup.digest(soup.port_tree(c["input"])) for c in fixtures["cases"]]
    parse_s = time.perf_counter() - t
    off = [i for i, (g, c) in enumerate(zip(got, fixtures["cases"]))
           if g != c["sha256"]]
    check(not off, f"html: the trees of cases {off[:20]} differ from lxml "
                   f"{fixtures['lxml']} / libxml2 {fixtures['libxml2']}'s "
                   f"on Python {platform.python_version()}")
    out = {"cases": len(got), "parse_s": parse_s,
           "python": platform.python_version()}
    print(json.dumps({"html": out}))
    return out


def phase_pipeline_scanned(card, trees):
    """Phase 9s (module docstring). Returns its counted run's launches."""
    import shutil

    import numpy as np
    import torch
    from PIL import features

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.pdfio import PdfDocument, render_page
    from pdf_table_tpu_torch.pdfio.reader import build_native
    from pdf_table_tpu_torch.pdfio.render import render_pdf
    from pdf_table_tpu_torch.utils.image_io import decode_image

    check(features.check("jpg"), "pipeline_scanned: PIL cannot decode JPEG")
    build_native()
    data = scanned_pdf()
    doc = PdfDocument.open(data)
    scans = [doc.load_page(i) for i in range(doc.page_count)]
    check(len(scans) == PIPE_PAGES and all(
        [m.filter for m in pg.images] == ["DCTDecode"] and not pg.texts
        for pg in scans), "pipeline_scanned: PIL did not write one JPEG a "
                          "page")
    ocr_doc = PdfDocument.open(scan_pdf(make_page(PIPE_PAGES), 20))
    ocr_page = ocr_doc.load_page(0)
    check(ocr_page.texts and all(t.invisible for t in ocr_page.texts),
          "pipeline_scanned: the OCR layer is not read as invisible text")
    pages = [{"pdf_page": pg, "pdf_doc": doc, "page": i}
             for i, pg in enumerate(scans)]
    pages.append({"pdf_page": ocr_page, "pdf_doc": ocr_doc,
                  "page": PIPE_PAGES})

    # the JPEG streams decoded: the same pages given as images
    streams = [doc.get_image_bytes(pg.images[0].obj_num) for pg in scans]
    check(all(kind == 1 for _, kind in streams),
          "pipeline_scanned: a scan's stream was not passed through encoded")
    t0 = time.perf_counter()
    decoded = [decode_image(b) for b, _ in streams]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(decoded)
    jpeg_mean = [float(np.abs(d.astype(np.int16) - make_page(i)).mean())
                 for i, d in enumerate(decoded)]
    check(max(jpeg_mean) <= SCAN_JPEG_MEAN,
          f"pipeline_scanned: a decoded scan is {max(jpeg_mean):.2f} grey "
          f"levels from its page on average")
    t0 = time.perf_counter()
    rendered = [render_page(doc, pg) for pg in scans]
    render_ms = (time.perf_counter() - t0) * 1e3 / len(scans)
    check(all(np.array_equal(r, d) for r, d in zip(rendered, decoded)),
          "pipeline_scanned: a rendered scan differs from its decoded JPEG")
    image_pages = [{"image": d, "page": i} for i, d in enumerate(decoded)] \
        + [pages[-1]]

    bp = build_pipeline("cuda", trees)
    t0 = time.perf_counter()
    bp.run(pages)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    tsr_model = bp.system.tsr_task.model
    forwards, chunks = [], []
    real_forward, real_chunks = tsr_model.forward_packed, bp._chunks
    tsr_model.forward_packed = lambda x: (forwards.append(x.shape[0]),
                                          real_forward(x))[1]

    def counted_chunks(images):
        cs = real_chunks(images)
        chunks.extend(len(c["indices"]) for c in cs)
        return cs

    bp._chunks = counted_chunks
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = bp.run(pages)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    del tsr_model.forward_packed, bp._chunks
    check(len(out) == len(pages), "pipeline_scanned: one output per page")
    errors = {i: o.metric.get("error") for i, o in enumerate(out)
              if o.metric.get("error")}
    check(not errors, f"pipeline_scanned: errors {errors}")
    check([o.is_pdf for o in out] == [False] * PIPE_PAGES + [True],
          "pipeline_scanned: the scans must take the raster lane and the "
          "OCR'd scan the digital one")
    check(all(o.page_html for o in out[:PIPE_PAGES]),
          "pipeline_scanned: a scan has no page_html")
    check(not out[-1].text_cells,
          "pipeline_scanned: the invisible OCR text reached the page")
    n_tables = sum(len(o.table_html) for o in out)
    check(n_tables >= 1 and forwards,
          "pipeline_scanned: no scanned table reached LORE")
    check(launches["resize_normalize"] == len(chunks)
          and launches["deform_conv2d"] == 16 * len(forwards)
          and launches["deform_conv2d_flat_kc"] == 0,
          f"pipeline_scanned launched {launches} for {len(chunks)} chunks "
          f"and {len(forwards)} LORE sub-batches")

    run_s, raster_s = [], []
    for _ in range(SCAN_RUNS):
        t0 = time.perf_counter()
        bp.run(pages)
        run_s.append(time.perf_counter() - t0)
        raster_s.append(bp.last_stats["rasterize"])
    t0 = time.perf_counter()
    ref = bp.run(image_pages)
    image_run_s = time.perf_counter() - t0
    image_raster_s = bp.last_stats["rasterize"]
    differ = same_outputs(out[:PIPE_PAGES], ref[:PIPE_PAGES])

    # 2 scans on the card against the same pipeline on the CPU
    few = pages[:SCAN_CPU_PAGES]
    got = bp.run(few)
    cpu = build_pipeline("cpu", trees)
    t0 = time.perf_counter()
    want = cpu.run(few)
    cpu_s = time.perf_counter() - t0
    cmp = pipeline_diff(got, want)

    gs = shutil.which("gs")
    ghostscript = "absent: no gs binary on PATH"
    if gs:
        t0 = time.perf_counter()
        gs_pages = render_pdf(data, pages=[0, 1], backend="ghostscript")
        ghostscript = {"binary": gs, "s": time.perf_counter() - t0,
                       "shapes": [list(im.shape) for _, im in gs_pages]}
    per_run = statistics.median(run_s)
    summary = {
        "card": card, "pages": len(pages), "scans": PIPE_PAGES,
        "grey_page": SCAN_GREY, "cmyk_page": SCAN_CMYK, "chunks": chunks,
        "launches": launches, "lore_sub_batches": forwards,
        "tables": n_tables, "warm_up_s": warm_s, "counted_run_s": counted_s,
        "run_s": run_s, "runs": len(run_s), "pages_per_s":
            len(pages) / per_run,
        "rasterize_s": raster_s, "image_run_s": image_run_s,
        "image_run_rasterize_s": image_raster_s,
        "decode_ms_per_scan": decode_ms, "render_ms_per_scan": render_ms,
        "jpeg_mean_grey_levels_max": max(jpeg_mean),
        "pages_differing_from_the_image_run": differ,
        "ghostscript": ghostscript, "cpu": {"run_s": cpu_s, **cmp}}
    print(json.dumps({"pipeline_scanned": summary}))
    check(not differ, f"pipeline_scanned: scans {differ} differ from the "
                      f"same pages given as decoded images")
    check(not [o for o in want if o.metric.get("error")],
          "pipeline_scanned: the CPU pipeline gave errors")
    check(cmp["quads_same_count"] and cmp["quad_px"] <= PIPE_QUAD_TOL,
          f"pipeline_scanned: quads differ from the CPU's: "
          f"{cmp['quad_px']:.3g} px")
    lay = cmp["layout"]
    check(lay["same_count"] and lay["same_labels"]
          and lay["box_px"] <= LAYOUT_BOX_TOL
          and lay["score"] <= LAYOUT_SCORE_TOL,
          f"pipeline_scanned: layout survivors differ from the CPU's: {lay}")
    check(cmp["text_share"] >= PIPE_TEXT_MIN,
          f"pipeline_scanned: texts equal on {cmp['text_share']:.3f} of "
          f"crops")
    check(cmp["page_html_equal"] == cmp["page_html_checked"],
          "pipeline_scanned: page_html differs where its inputs are equal")
    return launches


def det_backbone_tree(task, canvases):
    """A seeded full-width tree of ``task``'s DBNet, BatchNorm statistics
    calibrated on the card on the chunk's detector input, variances
    doubled (a deep random ReLU stack is chaotic otherwise)."""
    import torch

    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_dbnet,
                                                   scale_batch_variances)

    (_idx, _shapes, bucket, canv), = list(task.chunks(canvases))
    with torch.inference_mode():
        x = task.normalize(torch.from_numpy(canv).cuda(),
                           task.det_size(bucket))
    return scale_batch_variances(calibrate_batch_stats(
        task.model, init_dbnet(task.model_config, 0), x.clone()),
        DETB_VAR_GAIN)


def phase_det_backbones(card):
    """``OcrDetectionTask`` with ``db_resnet18``, ``db_resnet50`` and
    ``db_proxylessnas`` at full width, f32, on the detection phase's 8
    pages (one chunk, 960x720 detector input, modelscope normalization on
    K3), the threshold at the 80th percentile of the first page's map:
    per model the counted run (K3 once a chunk, K1 and K2 never),
    pages/s, forward ms, peak memory, the yardstick on
    resize_normalize_plain's input, and the quads of 2 pages against the
    same port on the CPU (equal where the uint8 maps are). Returns the
    launch counts summed over the three."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

    pages = [make_page(i) for i in range(DET_PAGES)]
    total = {k: 0 for k in KERNELS}
    results = {}
    for model in DET_MODELS:
        t0 = time.perf_counter()
        probe = OcrDetectionTask(model=model, device="cuda", **DET_KW)
        tree = det_backbone_tree(probe, pages)
        del probe
        task = OcrDetectionTask(model=model, device="cuda", variables=tree,
                                **DET_KW)
        # the threshold at the 80th percentile of the first page's map:
        # above the bench's, a random map joins into a page-wide component
        (_i, _s, bucket, canv), = list(task.chunks(pages))
        with torch.inference_mode():
            x = task.normalize(torch.from_numpy(canv).cuda(),
                               task.det_size(bucket))
            u8 = task.quantize(task.model(x)["prob"])
        kw = dict(DET_KW, thresh=float(u8[0].float().quantile(
            DETB_THRESH_QUANTILE)) / 255.0)
        task.model_config.thresh = kw["thresh"]
        build_s = time.perf_counter() - t0
        n_chunks = sum(1 for _ in task.chunks(pages))
        torch.cuda.synchronize()
        reset_launch_counts()
        quads = task.batch_infer_from_pages(pages)
        torch.cuda.synchronize()
        launches = {k: launch_counts[k] for k in KERNELS}
        for k in KERNELS:
            total[k] += launches[k]
        check(launches["resize_normalize"] == n_chunks
              and launches["deform_conv2d"] == 0
              and launches["deform_conv2d_flat_kc"] == 0,
              f"{model}: launches {launches} for {n_chunks} chunks")
        check(all(q.dtype == np.float32 and q.shape[1:] == (4, 2)
                  and np.isfinite(q).all() for q in quads),
              f"{model}: quads are not finite (n, 4, 2) f32")
        torch.cuda.reset_peak_memory_stats()
        run_s = []
        for _ in range(DETB_RUNS):
            t0 = time.perf_counter()
            task.batch_infer_from_pages(pages)
            run_s.append(time.perf_counter() - t0)
        per_run = statistics.median(run_s)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            fwd = host_ms(lambda: task.model(x))
        prof = profile_run(lambda: task.batch_infer_from_pages(pages),
                           full=False)
        yard = det_yardstick(task, pages)
        # 2 pages against the same port on the CPU: the quads are equal
        # where the two uint8 maps are
        cpu = OcrDetectionTask(model=model, device="cpu", variables=tree,
                               **kw)
        few = pages[:DETB_CPU_PAGES]
        with torch.inference_mode():
            (_i, _s, b2, c2), = list(task.chunks(few))
            ua = task.quantize(task.model(task.normalize(
                torch.from_numpy(c2).cuda(), task.det_size(b2)))["prob"])
            uc = cpu.quantize(cpu.model(cpu.normalize(
                torch.from_numpy(c2), cpu.det_size(b2)))["prob"])
            same_map = [bool(torch.equal(ua[j].cpu(), uc[j]))
                        for j in range(len(few))]
        got = task.batch_infer_from_pages(few)
        t0 = time.perf_counter()
        want = cpu.batch_infer_from_pages(few)
        cpu_s = time.perf_counter() - t0
        quads_equal = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
        results[model] = {
            "card": card, "backbone": task.model_config.backbone,
            "inner_channels": task.model_config.inner_channels,
            "pages": len(pages), "chunks": n_chunks, "launches": launches,
            "thresh": kw["thresh"], "model_build_s": build_s,
            "run_s_median": per_run,
            "run_s_min": min(run_s), "run_s_max": max(run_s),
            "runs": len(run_s), "pages_per_s": len(pages) / per_run,
            "forward_ms": fwd, "peak_mem_gib": peak / 2 ** 30,
            "profile": prof, "quads_per_page": [len(q) for q in quads],
            "yardstick": yard,
            "cpu": {"run_s": cpu_s, "u8_maps_equal": same_map,
                    "quads_equal": quads_equal,
                    "quads_card_cpu": [[len(a), len(b)]
                                       for a, b in zip(got, want)]}}
        print(json.dumps({f"det_backbones_{model}": results[model]}))
        check(yard["input"] <= RN_TOL,
              f"{model}: det input differs: {yard['input']:.3g}")
        check(yard["prob"] <= DET_PROB_TOL,
              f"{model}: prob differs: {yard['prob']:.3g}")
        check(yard["u8_share"] <= DET_U8_SHARE,
              f"{model}: u8 maps differ in {yard['u8_share']:.3g} of pixels")
        check(yard["cc_equal"] and yard["cc_mean_rel"] <= CC_MEAN_RTOL,
              f"{model}: device boxes differ from the CPU's")
        check(all(q for q, s in zip(quads_equal, same_map) if s)
              and all(abs(len(a) - len(b)) <= 1
                      for a, b in zip(got, want)),
              f"{model}: quads differ from the CPU's: "
              f"{results[model]['cpu']}")
        del task, cpu, tree
        torch.cuda.empty_cache()
    return total


def rec_backbone_tree(model, canvases):
    """A seeded full-width tree of ``model``: biases and norms as
    initialized, the CTC head's kernel x RECB_HEAD's gain (CRNN's bias
    zeroed), ConvNext's layer scale RECB_GAMMA, BatchNorm statistics
    calibrated on the card on 16 strips 32 px tall of the first two
    canvases, normalized as the lane normalizes."""
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import tree_leaves
    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_rec)
    from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
    from pdf_table_tpu_torch.tasks.recognition import rec_config

    cfg = rec_config(model=model)
    v = init_rec(cfg, 0)
    gain, zero_bias = RECB_HEAD[model]
    v["params"]["ctc_head"]["kernel"] = v["params"]["ctc_head"]["kernel"] \
        * gain
    if zero_bias:
        v["params"]["ctc_head"]["bias"][:] = 0.0
    for path, a in tree_leaves(v):
        if path[-1] == "gamma":
            a[...] = RECB_GAMMA
    strips = torch.stack([torch.from_numpy(canvases[p, y:y + 32, 70:370])
                          for p in range(2)
                          for y in range(54, 54 + 36 * 8, 36)]).float().cuda()
    if model == "ConvNextViT":
        x = (0.299 * strips[..., 0] + 0.587 * strips[..., 1]
             + 0.114 * strips[..., 2])[..., None] / 255.0
    else:
        x = strips / 127.5 - 1.0
    return calibrate_batch_stats(CTCRecModel(cfg).cuda(), v, x)


def phase_rec_backbones(card):
    """``OcrRecognitionTask`` with ``CRNN``, ``ConvNextViT`` (its three
    300 px chunks a crop) and ``LightweightEdge`` at full width, f32, with
    the recognition phase's 0/180 classifier, canvases and quads: per model
    the counted run (no K1-K3 launch), crops/s, forward ms, peak memory,
    idle share, and the packed decode of the first RECB_CPU_PAGES pages'
    crops against the same port on the CPU.
    Returns the launch counts summed over the three."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.recognition import (OcrRecognitionTask,
                                                       unpack_rec)

    pp, pp_cpu, canvases, quads = rec_setup()
    cls, cls_cpu = pp.cls_task, pp_cpu.cls_task
    del pp, pp_cpu
    dev_pages = torch.from_numpy(canvases).cuda()
    cpu_pages = torch.from_numpy(canvases)
    n_crops = sum(len(q) for q in quads)
    total = {k: 0 for k in KERNELS}
    for model in REC_MODELS:
        t0 = time.perf_counter()
        tree = rec_backbone_tree(model, canvases)
        task = OcrRecognitionTask(model=model, device="cuda", variables=tree,
                                  cls_task=cls, **F32)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        texts, scores = task.batch_infer_from_pages(dev_pages, quads)
        torch.cuda.synchronize()
        launches = {k: launch_counts[k] for k in KERNELS}
        for k in KERNELS:
            total[k] += launches[k]
        check(sum(launches.values()) == 0,
              f"{model}: the recognition lane launched {launches}")
        chars = set(task.charset.id_to_char[1:])
        check([len(t) for t in texts] == [len(q) for q in quads]
              and all(isinstance(t, str) and set(t) <= chars
                      for p in texts for t in p),
              f"{model}: one text of the charset per quad")
        check(len({t for p in texts for t in p}) > n_crops // 2,
              f"{model}: the texts do not depend on the crops")
        torch.cuda.reset_peak_memory_stats()
        run_s = []
        for _ in range(RECB_RUNS):
            t0 = time.perf_counter()
            task.batch_infer_from_pages(dev_pages, quads)
            run_s.append(time.perf_counter() - t0)
        per_run = statistics.median(run_s)
        peak = torch.cuda.max_memory_allocated()
        groups = task.plan(quads)
        with torch.inference_mode():
            crops = [task.orient(*task.cut(dev_pages, g, task.upload(g)))
                     for g in groups]
            fwd = host_ms(lambda: [task.logits(c) for c in crops])
            few = quads[:RECB_CPU_PAGES]
            few_groups = task.plan(few)
            got = [task.enqueue(dev_pages, g).cpu().numpy()
                   for g in few_groups]
        prof = profile_run(lambda: task.batch_infer_from_pages(dev_pages,
                                                               quads),
                           full=False)
        cpu = OcrRecognitionTask(model=model, device="cpu", variables=tree,
                                 cls_task=cls_cpu, **F32)
        t0 = time.perf_counter()
        want = [cpu.enqueue(cpu_pages, g).numpy() for g in cpu.plan(few)]
        cpu_s = time.perf_counter() - t0
        n_few = sum(len(q) for q in few)
        equal = conf_err = 0
        for g, a, b in zip(few_groups, got, want):
            (ia, ka, ca), (ib, kb, cb) = (unpack_rec(a, g["n"]),
                                          unpack_rec(b, g["n"]))
            same = (ia == ib).all(1) & (ka == kb).all(1)
            equal += int(same.sum())
            if same.any():
                conf_err = max(conf_err, float(np.abs(ca - cb)[same].max()))
        cfg = task.model_config
        summary = {
            "card": card, "model": model, "backbone": cfg.backbone,
            "img_height": cfg.img_height,
            "width": [g["bucket"] for g in groups],
            "steps": int(got[0].shape[1] // 2), "crops": n_crops,
            "groups": [(g["bucket"], g["aa"], g["n"]) for g in groups],
            "launches": launches, "model_build_s": build_s,
            "run_s_median": per_run, "run_s_min": min(run_s),
            "run_s_max": max(run_s), "runs": len(run_s),
            "crops_per_s": n_crops / per_run, "forward_ms": fwd,
            "peak_mem_gib": peak / 2 ** 30, "profile": prof,
            "sample_texts": texts[0][:2],
            "cpu": {"run_s": cpu_s, "crops": n_few, "equal_crops": equal,
                    "equal_share": equal / n_few,
                    "conf_max_abs": conf_err}}
        print(json.dumps({f"rec_backbones_{model}": summary}))
        check(equal / n_few >= REC_EQUAL_MIN,
              f"{model}: only {equal} of {n_few} crops decode as on the "
              f"CPU")
        check(conf_err <= REC_CONF_TOL,
              f"{model}: confidences differ from the CPU's: {conf_err:.3g}")
        del task, cpu, tree
        torch.cuda.empty_cache()
    return total


def dcn_backward_bound(b, h, w, cin, cout):
    """Least time for one f32 DCN backward: max(ops / f32 peak, bytes /
    rate). Operations: dW = colsᵀ @ dout and dcols = dout @ W[t]ᵀ, 2 x 2 x
    P x 9 x Cin x Cout. Bytes: x, offset, mask, W and dout read once, dx,
    doffset, dmask, dW and dbias written once (``bytes_ms``); with the 9
    tap columns (P x 9 x Cin f32) written and read once more, as an
    unfused backward must (``columns_bytes_ms``)."""
    px = b * h * w
    flops = 4 * px * 9 * cin * cout
    io = 2 * (px * cin * 4 + px * 27 * 4 + 9 * cin * cout * 4) \
        + px * cout * 4 + cout * 4
    cols = 2 * px * 9 * cin * 4
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = io / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
            "bytes_ms": t_bytes, "columns_bytes_ms": (io + cols)
            / PEAK_BYTES * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def grad_errors(got, want) -> dict:
    """Each gradient's max |got - want| over its max |want|."""
    names = ("dx", "doffset", "dmask", "dweight", "dbias")
    return {n: float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
            for n, g, w in zip(names, got, want)}


def dyadic_inputs(gen, b, h, w, cin, cout):
    """bf16 DCN inputs and dout on coarse binary grids (x in 1/16 within
    +-2, offsets in 1/8 px within +-2.5, the mask in 1/16, W in 1/64 within
    +-1/2, dout in 1/8 within +-1): the sums the backward rounds to bf16
    are exact in f32, so f64 rounds them the same way."""
    import torch

    def grid(shape, lo, hi, step):
        return torch.randint(lo, hi + 1, shape, device="cuda",
                             generator=gen).float() * step

    args = (grid((b, h, w, cin), -32, 32, 1 / 16).bfloat16(),
            grid((b, h, w, 18), -20, 20, 1 / 8),
            grid((b, h, w, 9), 0, 16, 1 / 16),
            grid((3, 3, cin, cout), -32, 32, 1 / 64).bfloat16(),
            torch.randn(cout, device="cuda", generator=gen))
    return args, grid((b, h, w, cout), -8, 8, 1 / 8)


def rounding_points(args, gout, flat_kc, got):
    """The bf16 backward's rounding points: ``got`` (the Function's
    gradients) and the backward called with an f32 copy of W (dW before
    its final rounding) against f64 autograd of deform_conv2d_rounded.
    Returns each gradient's error: relative to its max for the f32 ones;
    for dx and the Function's dW (bf16) the largest |error| over |want| in
    units of 2^-8, at most 1 for a bf16 rounding of the f64 value."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (
        deform_conv2d_backward_plain, deform_conv2d_rounded)

    ts = [a.detach().double().requires_grad_() for a in args]
    want = torch.autograd.grad(
        deform_conv2d_rounded(*ts, flat_kc=flat_kc), ts, gout.double())
    x, off, mask, wt, bias = args
    dw32 = deform_conv2d_backward_plain(gout, x, off, mask, wt.float(), bias,
                                        flat_kc=flat_kc)[3]

    def rel(g, r):
        return float((g.double() - r).abs().max()
                     / r.abs().max().clamp_min(1e-30))

    def ulps(g, r):
        slack = TRAIN_ROUNDED_TOL * r.abs().max()
        return float(((g.double() - r).abs() - slack).clamp_min(0).div(
            r.abs().clamp_min(1e-30)).max() / BF16_ROUNDOFF)

    return {"doffset": rel(got[1], want[1]), "dmask": rel(got[2], want[2]),
            "dbias": rel(got[4], want[4]), "dweight_f32": rel(dw32, want[3]),
            "dx_ulps": ulps(got[0], want[0]),
            "dweight_ulps": ulps(got[3], want[3])}


def phase_train_dcn(gen):
    """The Function at the 7 DCN shapes of a wtw step (B = 4, 1024^2, f32)
    and one bf16 shape each through K1 and K2: forward against the plain
    version, gradients against autograd of the plain version; the bf16
    shapes on dyadic inputs also against f64 autograd of
    deform_conv2d_rounded (the backward's rounding points); forward and
    backward ms per DCN."""
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_backward_plain, deform_conv2d_chunked,
        deform_conv2d_chunked_plain, deform_conv2d_plain, deform_conv2d_tap)
    from pdf_table_tpu_torch.ops.kernels import launch_counts

    def grads(fn, args, gout):
        ts = [a.detach().requires_grad_() for a in args]
        out = fn(*ts)
        return out.detach(), torch.autograd.grad(out, ts, gout)

    rows = []
    cases = [(hw, ci, co, n, "float32", TRAIN_BATCH, "tap")
             for hw, ci, co, n in DCN_SHAPES_1024]
    b, h, w, ci, co = TRAIN_BF16_SHAPE
    cases += [(h, ci, co, 0, "bfloat16", b, "tap"),
              (h, ci, co, 0, "bfloat16", b, "flat_kc")]
    for hw, cin, cout, calls, dname, B, mode in cases:
        if dname == "float32":
            args = dcn_inputs(gen, B, hw, hw, cin, cout, torch.float32)
            gout = torch.randn(B, hw, hw, cout, device="cuda", generator=gen)
        else:
            args, gout = dyadic_inputs(gen, B, hw, hw, cin, cout)
        fn, plain, name = (deform_conv2d, deform_conv2d_plain,
                           "deform_conv2d")
        if mode == "flat_kc":
            fn, plain, name = (deform_conv2d_chunked,
                               deform_conv2d_chunked_plain,
                               "deform_conv2d_flat_kc")
        elif dname == "bfloat16":
            fn = deform_conv2d_tap
        n0 = launch_counts[name]
        got, g_k = grads(fn, args, gout)
        torch.cuda.synchronize()
        check(launch_counts[name] == n0 + 1, f"{name} did not launch once "
              f"under grad mode")
        want, g_p = grads(plain, args, gout)
        tag = f"train {name} {B}x{hw}^2 {cin}->{cout} {dname}"
        abs_err, rel = errors(got, want)
        check(rel < TOL[dname], f"{tag}: forward rel err {rel:.3g}")
        gerr = grad_errors(g_k, g_p)
        tol = TRAIN_GRAD_TOL if dname == "float32" else TRAIN_BF16_GRAD_TOL
        check(max(gerr.values()) < tol, f"{tag}: gradients {gerr}")
        row = {"batch": B, "hw": hw, "cin": cin, "cout": cout,
               "dtype": dname, "mode": mode, "calls_per_step": calls,
               "max_abs_err": abs_err, "rel_err": rel, "grad_rel_err": gerr}
        if dname == "bfloat16":
            rp = rounding_points(args, gout, mode == "flat_kc", g_k)
            row["rounding_points"] = rp
            check(max(v for k, v in rp.items() if "ulps" not in k)
                  < TRAIN_ROUNDED_TOL and rp["dx_ulps"] <= 1
                  and rp["dweight_ulps"] <= 1,
                  f"{tag}: the backward's rounding points {rp}")
        del g_k, g_p, got, want
        if dname == "float32":
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: deform_conv2d_tap(*args), 10)
            bwd_ms = cuda_ms(lambda: deform_conv2d_backward_plain(
                gout, *args), 5, 1)
            row.update(forward_ms=fwd_ms, backward_ms=bwd_ms,
                       forward_bound_ms=dcn_bound(B, hw, hw, cin, cout,
                                                  dname)[0],
                       backward=dcn_backward_bound(B, hw, hw, cin, cout))
        rows.append(row)
        del args, gout
    torch.cuda.empty_cache()
    return rows


def train_tree(cfg):
    """The seeded wtw tree with its offset convs perturbed (the deform
    convs sample between pixels and outside the maps)."""
    from pdf_table_tpu_torch.engine.params import (init_lore,
                                                   perturb_conv_offset_mask)

    return perturb_conv_offset_mask(init_lore(cfg, seed=0), seed=1)


def new_trainer(cfg, tree, out_dir, mesh=None, **kw):
    from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                        LoreTrainer)

    args = dict(learning_rate=TRAIN_LR, lr_schedule="constant",
                batch_size=TRAIN_BATCH, save_every=0, output_dir=out_dir)
    args.update(kw)
    tr = LoreTrainer(cfg, LoreTrainArgs(**args), mesh=mesh)
    tr.init_state(tree)
    return tr


def phase_train(card, dcn_rows):
    """LoreTrainer at full width on the card: the kernel step against the
    plain-DCN step, gradients on every leaf, launches, the loss over
    TRAIN_STEPS steps, step time and memory, then bit-exact resume. The
    checkpoints go to a temporary directory, removed at the end."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as out_dir:
        return train_steps(card, dcn_rows, out_dir)


def train_steps(card, dcn_rows, out_dir):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.data.synthetic import SyntheticTableDataset
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.models.lore.dla import DeformConvBlock
    from pdf_table_tpu_torch.ops.deform_conv import deform_conv2d_plain
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.train.optim import global_norm
    from pdf_table_tpu_torch.train.train_step import value_and_grad

    cfg = LoreConfig.wtw()
    check(cfg.dtype == "float32", "the wtw config is not f32")
    t0 = time.perf_counter()
    tree = train_tree(cfg)
    batch = SyntheticTableDataset(cfg, n=TRAIN_BATCH, seed=0).batch(
        list(range(TRAIN_BATCH)))
    data_s = time.perf_counter() - t0
    kern = new_trainer(cfg, tree, out_dir)
    plain = new_trainer(cfg, tree, out_dir)
    for m in plain.model.modules():
        if isinstance(m, DeformConvBlock):
            m.dcn = deform_conv2d_plain
    dev_batch = kern.to_device(batch)

    # (b) the first step: kernel against plain, on the same tree and batch
    res = {}
    for name, tr in (("kernel", kern), ("plain", plain)):
        losses, grads = value_and_grad(tr.apply, tr.loss, tr.state.params,
                                       dev_batch)
        unreached = sorted(k for k, g in grads.items() if g is None)
        reached = [g for g in grads.values() if g is not None]
        res[name] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "norm": float(global_norm(reached)), "unreached": unreached,
            "finite": all(bool(torch.isfinite(g).all()) for g in reached),
            "zero_leaves": sorted(k for k, g in grads.items()
                                  if g is not None and not bool(g.any()))}
        del grads, reached
        torch.cuda.empty_cache()
    rk, rp = res["kernel"], res["plain"]
    loss_err = {k: abs(rk["losses"][k] - v) / max(abs(v), 1e-30)
                for k, v in rp["losses"].items()}
    norm_err = abs(rk["norm"] - rp["norm"]) / rp["norm"]
    n_leaves = len(kern.state.params)

    # the counted step, then the plain step: parameters after one step
    torch.cuda.synchronize()
    reset_launch_counts()
    first = kern.train_step(batch)
    torch.cuda.synchronize()
    launches = {k: launch_counts[k] for k in KERNELS}
    first_plain = plain.train_step(batch)
    param_diff = max(float((kern.state.params[k] - p).detach().abs().max())
                     for k, p in plain.state.params.items())
    del plain
    torch.cuda.empty_cache()

    # the loss over TRAIN_STEPS steps on the one batch; step time, memory
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [first["loss"]], []
    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        losses.append(kern.train_step(batch)["loss"])
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(step_s) * 1e3
    prof = f32_body_traced(profile_run(lambda: kern.train_step(batch)),
                           "train")

    # remat: the stages checkpointed; the recompute launches K1 again. The
    # first step is counted and held to the kernel step; the second is
    # timed and its memory read, as the steps above
    remat = new_trainer(cfg, tree, out_dir, remat=True)
    reset_launch_counts()
    remat_first = remat.train_step(batch)
    remat_launches = launch_counts["deform_conv2d"]
    torch.cuda.synchronize()
    remat_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    remat.train_step(batch)
    remat_ms = (time.perf_counter() - t0) * 1e3
    remat_peak = torch.cuda.max_memory_allocated()
    del remat
    torch.cuda.empty_cache()

    # (c) save, restore into a fresh trainer, one step each: bit for bit
    ck = kern.save_train_state(os.path.join(out_dir, "train_state"))
    back = new_trainer(cfg, tree, out_dir)
    back.restore_train_state(ck)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        live = kern.train_step(batch)
        again = back.train_step(batch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    resume_equal = live == again and kern.state.step == back.state.step \
        and all(torch.equal(p, back.state.params[k])
                for k, p in kern.state.params.items()) \
        and all(torch.equal(kern.state.opt_state[n][k],
                            back.state.opt_state[n][k])
                for n in ("mu", "nu") for k in kern.state.params)

    f32 = [r for r in dcn_rows if r["dtype"] == "float32"]

    def per_step(key):
        return sum(r[key] * r["calls_per_step"] for r in f32)

    summary = {
        "card": card, "config": "LoreConfig.wtw()", "dtype": cfg.dtype,
        "batch": TRAIN_BATCH, "resolution": list(cfg.resolution),
        "data_s": data_s, "launches": launches,
        "remat_launches": remat_launches,
        "first_step": {"kernel": rk, "plain": rp, "loss_rel_err": loss_err,
                       "norm_rel_err": norm_err,
                       "param_max_abs_diff": param_diff,
                       "plain_step_loss": first_plain["loss"],
                       "remat_step_loss": remat_first["loss"]},
        "leaves": n_leaves, "losses": losses, "step_ms_median": step_ms,
        "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
        "images_per_s": TRAIN_BATCH / (step_ms / 1e3),
        "peak_mem_gib": peak / 2 ** 30,
        "step_mem_gib": (peak - held) / 2 ** 30,
        "remat_peak_mem_gib": remat_peak / 2 ** 30,
        "remat_step_mem_gib": (remat_peak - remat_held) / 2 ** 30,
        "remat_step_ms": remat_ms,
        "dcn_forward_ms_per_step": per_step("forward_ms"),
        "dcn_backward_ms_per_step": per_step("backward_ms"),
        "profile": prof, "resume_bit_exact": resume_equal,
    }
    print(json.dumps({"train": summary}))
    check(all(e < TRAIN_LOSS_TOL for e in loss_err.values()),
          f"train: kernel and plain loss terms differ: {loss_err}")
    check(norm_err < TRAIN_NORM_TOL,
          f"train: gradient norms differ by {norm_err:.3g}")
    check(rk["finite"] and rp["finite"], "train: a gradient is not finite")
    check(rk["unreached"] == rp["unreached"]
          and all(".heads.st" in k or ".project." in k
                  for k in rk["unreached"]),
          f"train: leaves without a gradient: {rk['unreached'][:8]}")
    check(not rk["zero_leaves"], f"train: zero gradients on "
          f"{rk['zero_leaves'][:8]}")
    check(launches["deform_conv2d"] == 16
          and launches["deform_conv2d_flat_kc"] == 0
          and launches["resize_normalize"] == 0,
          f"train: a step launched {launches}, expected K1 16 times")
    check(remat_launches == 32, f"train: a remat step launched K1 "
          f"{remat_launches} times, expected 32")
    check(abs(remat_first["loss"] - first["loss"])
          <= TRAIN_LOSS_TOL * abs(first["loss"]),
          f"train: the remat step's loss {remat_first['loss']} differs "
          f"from the kernel step's {first['loss']}")
    check(remat_peak - remat_held < peak - held,
          f"train: remat did not lower the step's memory: "
          f"{(remat_peak - remat_held) / 2 ** 30:.3f} GiB against "
          f"{(peak - held) / 2 ** 30:.3f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    check(resume_equal, "train: the restored step differs from the live one")
    return launches


# train_det: the bench's detector config (PP-OCRv4 det, f32) trained by
# train_quick_detector on bench.py's bar pages (bench_bar_page, copied)
# for bench.py's 250 steps: after 100 the prob map of a bench page is
# still above 0.3 on most of it from some inits, and no box is found
QD_SIZE, QD_BATCH, QD_LR, QD_STEPS = 320, 4, 1e-3, 250
# the first three steps' losses on the card against the same steps on the
# CPU (same tree, same batches): the first step's within 1e-4 (cuDNN sums
# its convs in another order); Adam then moves every element by about lr
# whatever its gradient's size, so elements whose gradient sits at
# round-off step differently on the two sides and the next losses follow:
# within 1e-3, twice the widest spread of two f32 runs of the same steps in
# tests/test_torch_det_train.py (JAX's f32 4.0e-4 and the port's 9.1e-5
# from JAX's float64 at the third step; the card read 8.5e-5 from the CPU)
QD_FIRST_TOL = 1e-4
QD_LATER_TOL = 1e-3
# the bench's thresholds for a trained detector (bench.py:172-173)
QD_THRESH, QD_BOX_THRESH = 0.3, 0.55
# one ctc_loss step of PP-OCRv4 rec (SVTR-LCNet, f32) on 32 crops of
# 48x160: the loss within 1e-4 relative of the CPU's, each params leaf's
# gradient within 1e-3 of the leaf's largest magnitude
CTC_CROPS, CTC_LOSS_TOL, CTC_GRAD_TOL = 32, 1e-4, 1e-3


def bench_bar_page(rng, size: int):
    """bench.py's training page for the bench detector: dark text-like
    bars on white and their xyxy boxes (bench.py:125-143)."""
    import numpy as np

    img = np.full((size, size, 3), 255, np.uint8)
    boxes = []
    y = int(rng.integers(10, 24))
    while y < size - 26:
        x = int(rng.integers(8, 24))
        for _ in range(int(rng.integers(1, 4))):
            w = int(rng.integers(40, 120))
            if x + w > size - 10:
                break
            h = int(rng.integers(10, 15))
            img[y:y + h, x:x + w] = int(rng.integers(20, 60))
            boxes.append([x, y, x + w, y + h])
            x += w + int(rng.integers(12, 22))
        y += int(rng.integers(22, 34))
    return img, boxes


def quick_train(device, steps: int, timed: bool = False) -> dict:
    """train_quick_detector on ``device`` with every step's loss kept
    through its ``on_step`` hook. Under ``timed``: a CUDA event after each
    step (step i's time runs from event i-1 to event i), and a light trace
    (device activity only) of the last step, opened after the step before
    it and closed after it."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
    from pdf_table_tpu_torch.train.quick_det import train_quick_detector

    losses, events, trace = [], [], {}

    def on_step(s, out):
        losses.append(out["loss"].detach())
        if not timed:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if s == steps - 2:
            torch.cuda.synchronize()
            trace["prof"] = profile(activities=[ProfilerActivity.CUDA])
            trace["prof"].__enter__()
            trace["t0"] = time.perf_counter()
        elif s == steps - 1 and "prof" in trace:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - trace["t0"]) * 1e3
            prof = trace.pop("prof")
            prof.__exit__(None, None, None)
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3
            trace.update(wall_ms=wall, device_busy_ms=busy,
                         idle_share=max(0.0, 1.0 - busy / wall))

    tree, first, last_loss = train_quick_detector(
        DbNetConfig.ppocr(**F32), bench_bar_page, steps=steps,
        size=QD_SIZE, batch_size=QD_BATCH, lr=QD_LR,
        rng=np.random.default_rng(0), device=device, on_step=on_step)
    if timed:
        torch.cuda.synchronize()
    trace.pop("t0", None)
    return {"tree": tree, "first": first, "last": last_loss,
            "losses": [float(x) for x in losses],
            "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
            "traced_step": trace}


def ctc_step(card) -> dict:
    """One ctc_loss forward and backward of PP-OCRv4 rec at full width on
    the card and on the CPU, same tree, crops and labels."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import (
        load_flax_variables, state_dict_to_flax, tree_leaves)
    from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                                   init_rec,
                                                   scale_batch_variances)
    from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.recognition import rec_config
    from pdf_table_tpu_torch.train.losses import ctc_loss

    cfg = rec_config(model="PP-OCRv4_rec", **F32)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (CTC_CROPS, 48, 160, 3)).astype(np.float32)
    # calibrated statistics, variances doubled: a random tree calibrated
    # as it is gives first-block gradients that two f32 runs disagree on
    # (tests/test_torch_det_train.py)
    tree = scale_batch_variances(calibrate_batch_stats(
        CTCRecModel(cfg), init_rec(cfg, 0), torch.from_numpy(x)), 2.0)
    lens = rng.integers(4, 13, CTC_CROPS)
    labels = np.zeros((CTC_CROPS, 12), np.int64)
    pads = np.ones((CTC_CROPS, 12), np.float32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.integers(1, cfg.vocab_size, n)
        pads[i, :n] = 0.0
    out = {}
    for dev in ("cuda", "cpu"):
        model = CTCRecModel(cfg)
        load_flax_variables(model, tree)
        model.to(dev)
        params = dict(model.named_parameters())
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
        loss = ctc_loss(model(torch.from_numpy(x).to(dev)),
                        torch.from_numpy(labels).to(dev),
                        torch.from_numpy(pads).to(dev))
        grads = torch.autograd.grad(loss, list(params.values()))
        if dev == "cuda":
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: launch_counts[k] for k in KERNELS}
        flax_grads = state_dict_to_flax(
            {k: g.detach().cpu() for k, g in zip(params, grads)},
            {"params": tree["params"]})["params"]
        out[dev] = (float(loss.detach()), dict(tree_leaves(flax_grads)))
    (gl, gg), (wl, wg) = out["cuda"], out["cpu"]
    errs = {"/".join(p): float((gg[p] - w).abs().max()
                               / max(float(w.abs().max()), 1e-30))
            for p, w in wg.items()}
    worst = max(errs, key=errs.get)
    return {"crops": CTC_CROPS, "crop_hw": [48, 160], "loss": gl,
            "cpu_loss": wl, "loss_rel_err": abs(gl - wl) / abs(wl),
            "grad_rel_err_max": errs[worst], "grad_worst_leaf": worst,
            "leaves": len(errs), "step_ms": step_ms, "launches": launches}


def phase_train_det(card):
    """The DBNet quick trainer on the card (see the module docstring)."""
    import statistics

    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

    cpu = quick_train("cpu", 3)
    first3 = quick_train("cuda", 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    run = quick_train("cuda", QD_STEPS, timed=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    # step i's time from event i-1 to event i, steps 1 .. QD_STEPS - 1;
    # step 1 carries a one-off warm-up of some seconds on the card, so the
    # statistics are of steps 2 on and step 1 is printed apart
    step_ms = run["step_ms"][1:]
    med = statistics.median(step_ms)
    errs = [abs(g - w) / abs(w) for g, w in zip(first3["losses"],
                                                cpu["losses"])]

    # the trained tree in the detection task, with the bench's thresholds
    task = OcrDetectionTask(model="PP-OCRv4_det", device="cuda",
                            variables=run["tree"], thresh=QD_THRESH,
                            box_thresh=QD_BOX_THRESH, max_candidates=48,
                            **F32)
    pages = [make_page(i) for i in range(DET_PAGES)]
    quads = task.batch_infer_from_pages(pages)
    boxes = [len(q) for q in quads]
    ctc = ctc_step(card)
    summary = {
        "card": card, "config": "DbNetConfig.ppocr(dtype='float32')",
        "size": QD_SIZE, "batch": QD_BATCH, "lr": QD_LR, "steps": QD_STEPS,
        "first_loss": run["first"], "last_loss": run["last"],
        "loss_ratio": run["last"] / run["first"],
        "losses_every_10": run["losses"][::10],
        "step_ms_median": med, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "second_step_ms": run["step_ms"][0],
        "images_per_s": QD_BATCH / (med / 1e3), "wall_s": wall_s,
        "peak_mem_gib": peak / 2 ** 30,
        "step_mem_gib": (peak - held) / 2 ** 30,
        "traced_step": run["traced_step"], "launches": launches,
        "first3_card": first3["losses"], "first3_cpu": cpu["losses"],
        "first3_rel_err": errs, "boxes_per_page": boxes,
        "boxes_per_page_mean": float(np.mean(boxes)), "ctc": ctc}
    print(json.dumps({"train_det": summary}))
    check(np.isfinite(run["losses"]).all() and run["last"] < run["first"],
          f"train_det: the loss did not fall: {run['first']} -> "
          f"{run['last']}")
    check(min(boxes) >= 1,
          f"train_det: the trained detector found no box on a bench page: "
          f"{boxes}")
    check(errs[0] <= QD_FIRST_TOL and max(errs[1:]) <= QD_LATER_TOL,
          f"train_det: the first three losses differ from the CPU's: "
          f"{errs}")
    check(all(v == 0 for v in launches.values()),
          f"train_det: the trainer launched {launches}, expected none")
    check(ctc["loss_rel_err"] <= CTC_LOSS_TOL
          and ctc["grad_rel_err_max"] <= CTC_GRAD_TOL,
          f"train_det: ctc_loss on the card differs from the CPU's: loss "
          f"{ctc['loss_rel_err']:.3g}, {ctc['grad_worst_leaf']} "
          f"{ctc['grad_rel_err_max']:.3g}")
    check(all(v == 0 for v in ctc["launches"].values()),
          f"train_det: the ctc step launched {ctc['launches']}")
    return ({k: launches[k] + ctc["launches"][k] for k in KERNELS},
            run["tree"])


def pp_det_onnx(path: str) -> None:
    """A Paddle-style ONNX file of seeded initializers for PP-OCRv4 det,
    in the order the port's module calls its layers (OIHW convs, IOHW
    transposed convs, BatchNorm as scale, bias, mean, var)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.onnx_reader import encode_test_onnx
    from pdf_table_tpu_torch.convert.onnx_shape_matcher import \
        call_ordered_slots
    from pdf_table_tpu_torch.engine.params import init_dbnet
    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
    from pdf_table_tpu_torch.models.dbnet.model import DBNet

    cfg = DbNetConfig.ppocr()
    template = init_dbnet(cfg)
    rng = np.random.default_rng(7)
    tensors = {}
    for coll, path_, kind in call_ordered_slots(
            DBNet(cfg).eval(), torch.zeros(1, 64, 64, 3)):
        node = template[coll]
        for k in path_.split("/"):
            node = node[k]
        shape = np.shape(node)
        if path_.endswith("/var") or path_.endswith("/scale"):
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[:-1]))
        else:
            a = rng.standard_normal(shape) * 0.05
        a = a.astype(np.float32)
        if kind == "Conv" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif kind == "ConvTranspose" and a.ndim == 4:
            a = a.transpose(2, 3, 0, 1)
        tensors[f"t{len(tensors)}"] = a
    with open(path, "wb") as f:
        f.write(encode_test_onnx(tensors))


def phase_convert(card):
    """Converted weights reach the tasks: PP-OCRv4 det through the
    converter's ONNX route into its weights_dir, a seeded LORE-wireless
    tree with the converter's writer into its own; both tasks built
    through the registry without ``variables`` (f32) give outputs
    bit-equal to the same tasks given the trees, on the card."""
    import tempfile

    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.__main__ import (convert_checkpoint,
                                                      main as convert_main,
                                                      spec)
    from pdf_table_tpu_torch.engine import params as P
    from pdf_table_tpu_torch.models.registry import weights_dir
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from pdf_table_tpu_torch.tasks.table_structure import (
        OcrTableStructureTask, lore_config)
    from pdf_table_tpu_torch.utils.constants import Constants

    def as_json(res):
        return json.dumps(res, sort_keys=True, default=lambda a: np.asarray(
            a).tolist())

    before = Constants.MODEL_CACHE_DIR
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache:
        Constants.MODEL_CACHE_DIR = cache
        try:
            onnx = os.path.join(cache, "model.onnx")
            pp_det_onnx(onnx)
            t0 = time.perf_counter()
            rc = convert_main(["--model", "pp_det", "--checkpoint", onnx])
            convert_s = time.perf_counter() - t0
            check(rc == 0, f"convert: the converter exited {rc}")
            det_tree, det_rep = convert_checkpoint(spec("pp_det"), onnx,
                                                   log=lambda m: None)
            lore_tree = lore_variables(lore_config("wireless", **F32))
            P.save_params(lore_tree, weights_dir("table_structure", "Lore",
                                                 "wireless"))
            pages = [make_page(i) for i in range(4)]
            regions = [(pi, box) for pi in range(4)
                       for box in ((70, 100, 880, 560), (70, 620, 880, 1150))]
            runs, counts = {}, {}
            for how in ("loaded", "given"):
                det = OcrDetectionTask(
                    model="PP-OCRv4_det", device="cuda", **DET_KW,
                    **({} if how == "loaded" else {"variables": det_tree}))
                tsr = OcrTableStructureTask(
                    model="Lore", task_type="wireless", device="cuda",
                    res_buckets="auto", vis_thresh=VIS_THRESH, **F32,
                    **({} if how == "loaded" else {"variables": lore_tree}))
                torch.cuda.synchronize()
                reset_launch_counts()
                runs[how] = (det.batch_infer_from_pages(pages),
                             tsr.batch_infer_from_pages(np.stack(pages),
                                                        regions))
                torch.cuda.synchronize()
                counts[how] = {k: launch_counts[k] for k in KERNELS}
                del det, tsr
                torch.cuda.empty_cache()
        finally:
            Constants.MODEL_CACHE_DIR = before
    (dq, tr), (dq2, tr2) = runs["loaded"], runs["given"]
    det_equal = len(dq) == len(dq2) and all(
        np.array_equal(a, b) for a, b in zip(dq, dq2))
    tsr_equal = as_json(tr) == as_json(tr2)
    summary = {"card": card, "convert_s": convert_s,
               "onnx_report": det_rep.summary(),
               "det_quads_per_page": [len(q) for q in dq],
               "tables": len(tr), "cells": sum(len(r.get("cells", []))
                                               for r in tr),
               "det_bit_equal": det_equal, "tsr_bit_equal": tsr_equal,
               "launches": counts["loaded"], "launches_given": counts["given"]}
    print(json.dumps({"convert": summary}))
    check(det_rep.ok, f"convert: the ONNX route missed {det_rep.missing[:4]}")
    check(det_equal and tsr_equal,
          "convert: the tasks on converted weights differ from the same "
          "tasks given the trees")
    check(counts["loaded"]["deform_conv2d"] > 0
          and counts["loaded"]["resize_normalize"] > 0,
          f"convert: launches {counts['loaded']}, expected K1 and K3")
    return counts["loaded"]



# det_polygon: DBNet's polygon mode (approxPolyDP at 1 % of the perimeter,
# the 0.7 score filter, the vertex offset) with the quick trainer's tree
# at the bench's trained thresholds, on POLY_PAGES bench pages: the card's
# __call__ against the CPU's. The prob maps agree within DET_PROB_TOL; a
# pixel whose side of the threshold differs between them must lie within
# that tolerance of it, and the polygons of the two runs are equal where
# no pixel differs (a differing pixel may change its contour's polygons),
# their scores within POLY_SCORE_TOL
POLY_PAGES = 4
POLY_SCORE_TOL = 1e-4
# the card the phases below drive (a CPU rehearsal at small sizes sets
# "cpu", with the CUDA calls stubbed)
DEVICE = "cuda"


def phase_det_polygon(card, tree):
    """DBNet's polygon mode on the card against the CPU (see above)."""
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

    kw = dict(variables=tree, thresh=QD_THRESH, box_thresh=QD_BOX_THRESH,
              return_polygon=True, **F32)
    card_task = OcrDetectionTask(model="PP-OCRv4_det", device=DEVICE, **kw)
    cpu_task = OcrDetectionTask(model="PP-OCRv4_det", device="cpu", **kw)
    pages = [make_page(i) for i in range(POLY_PAGES)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = [card_task(p) for p in pages]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in KERNELS}
    t0 = time.perf_counter()
    want = [cpu_task(p) for p in pages]
    cpu_s = time.perf_counter() - t0
    rows = []
    for p, g, w in zip(pages, got, want):
        x = card_task.pre(p)["image"]
        with torch.inference_mode():
            pg = card_task.prob_map(x).cpu().numpy()
            pw = cpu_task.prob_map(x).numpy()
        flips = (pg > QD_THRESH) != (pw > QD_THRESH)
        near = np.abs(pw - QD_THRESH) <= DET_PROB_TOL
        same = g["det_polygons"] == w["det_polygons"]
        rows.append({
            "prob_err": float(np.abs(pg - pw).max()),
            "flipped_px": int(flips.sum()),
            "flips_near_threshold": bool(near[flips].all()),
            "polygons": len(w["det_polygons"]),
            "polygons_equal": same,
            "vertices": [len(q) // 2 for q in w["det_polygons"][:8]],
            "score_err": float(np.abs(np.asarray(g["det_scores"])
                                      - np.asarray(w["det_scores"])).max())
            if same and len(w["det_scores"]) else 0.0,
            "is_polygon": bool(g.get("is_polygon"))})
    summary = {"card": card, "pages": POLY_PAGES, "card_s": card_s,
               "cpu_s": cpu_s, "launches": launches, "pages_rows": rows,
               "polygons": sum(r["polygons"] for r in rows)}
    print(json.dumps({"det_polygon": summary}))
    check(all(r["is_polygon"] for r in rows),
          "det_polygon: the card's output is not in polygon mode")
    check(summary["polygons"] >= POLY_PAGES,
          f"det_polygon: {summary['polygons']} polygons on {POLY_PAGES} "
          f"pages")
    check(all(r["prob_err"] <= DET_PROB_TOL for r in rows),
          f"det_polygon: prob maps differ from the CPU's: "
          f"{[r['prob_err'] for r in rows]}")
    check(all(r["flips_near_threshold"] for r in rows),
          "det_polygon: a pixel far from the threshold changed sides")
    check(all(r["polygons_equal"] for r in rows if not r["flipped_px"]),
          "det_polygon: polygons differ from the CPU's on equal bitmaps")
    check(all(r["score_err"] <= POLY_SCORE_TOL for r in rows),
          f"det_polygon: scores differ from the CPU's: "
          f"{[r['score_err'] for r in rows]}")
    return launches


# flops: model FLOPs (utils/flops.py: the dispatcher's contractions and
# every deform conv's hand count) over device time. Each bench-
# configuration model's forward at the shape the pipeline gives it (its
# largest call in one counted BatchPipeline.run of the PIPE_PAGES pages):
# GFLOPs, CUDA-event ms, and MFU against the card's dense peak for the
# model's dtype (f32 against the CUDA cores' peak, since the convs run
# with TF32 off; LORE's f32 DCNs run 3xTF32 on the tensor cores, so its
# f32 MFU may read high); then the whole run, its FLOPs over its host
# wall time. In bf16 (the policy) and f32. A LORE sub-batch's count must
# be the same with K1 as with the plain DCN
FLOPS_RUNS = 2
FLOPS_ITERS = 5


def phase_flops(card, trees):
    """Model FLOPs, times and MFU on the card (see above)."""
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.lore.model import LoreModel
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.utils.flops import count_flops, peak_flops

    imgs = [make_page(i) for i in range(PIPE_PAGES)]
    pages = [{"image": im, "page": i} for i, im in enumerate(imgs)]
    arms, launches = {}, {}
    for arm, policy in (("bf16", True), ("f32", False)):
        bp = build_pipeline(DEVICE, trees, policy=policy)
        s = bp.system
        models = {"detection": (s.det_task.model, "forward"),
                  "layout": (s.layout_task.model, "forward"),
                  "recognition": (s.rec_task.model, "forward"),
                  "textline_cls": (s.textline_cls_task.model, "forward"),
                  "lore": (s.tsr_task.model, "forward_packed")}
        bp.run(pages)                   # warm-up
        seen = {}

        def spy(name, model, method):
            real = getattr(model, method)

            def counted_call(*args):
                n, y = count_flops(real, *args)
                rec = seen.setdefault(name, {"flops": 0, "calls": 0,
                                             "big": (0, None, 0)})
                rec["flops"] += n
                rec["calls"] += 1
                if args[0].shape[0] >= rec["big"][0]:
                    rec["big"] = (args[0].shape[0], args, n)
                return y
            setattr(model, method, counted_call)

        for name, (model, method) in models.items():
            spy(name, model, method)
        torch.cuda.synchronize()
        reset_launch_counts()
        run_flops, out = count_flops(bp.run, pages)
        torch.cuda.synchronize()
        launches[arm] = {k: launch_counts[k] for k in KERNELS}
        for model, method in models.values():
            delattr(model, method)
        check(len(out) == PIPE_PAGES and not [
            o for o in out if o.metric.get("error")],
              f"flops: the {arm} run gave errors")
        check(set(seen) == set(models),
              f"flops: {arm}: no forward of {set(models) - set(seen)}")
        run_s = []
        for _ in range(FLOPS_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bp.run(pages)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
        wall = min(run_s)
        dtype = torch.bfloat16 if arm == "bf16" else torch.float32
        rows = {}
        for name, (model, method) in models.items():
            rec = seen[name]
            _, args, n = rec["big"]
            fn = getattr(model, method)
            with torch.inference_mode():
                ms = cuda_ms(lambda: fn(*args), FLOPS_ITERS)
            mdt = next(p.dtype for p in model.parameters()
                       if p.is_floating_point())
            peak = peak_flops(torch.bfloat16 if mdt == torch.bfloat16
                              else torch.float32)
            rows[name] = {"dtype": str(mdt).replace("torch.", ""),
                          "input": list(args[0].shape),
                          "gflops": n / 1e9, "ms": ms,
                          "tflops_per_s": n / (ms * 1e-3) / 1e12,
                          "mfu": n / (ms * 1e-3) / peak,
                          "run_gflops": rec["flops"] / 1e9,
                          "run_calls": rec["calls"]}
        lore_model, _ = models["lore"]
        _, lore_args, lore_n = seen["lore"]["big"]
        plain = LoreModel(lore_model.config, plain_dcn=True).to(DEVICE)
        plain.load_state_dict(lore_model.state_dict())
        with torch.inference_mode():
            plain_n, _ = count_flops(plain.eval().forward_packed, *lore_args)
        del plain
        torch.cuda.empty_cache()
        arms[arm] = {
            "models": rows, "run_gflops": run_flops / 1e9,
            "run_s_min": wall, "run_s": run_s,
            "run_tflops_per_s": run_flops / wall / 1e12,
            "run_mfu": run_flops / wall / peak_flops(dtype),
            "peak_tflops": peak_flops(dtype) / 1e12,
            "lore_gflops_kernel": lore_n / 1e9,
            "lore_gflops_plain": plain_n / 1e9,
            "launches": launches[arm]}
        check(plain_n == lore_n,
              f"flops: {arm}: LORE counts {lore_n} with K1 and {plain_n} "
              f"with the plain DCN")
        check(launches[arm]["deform_conv2d"] > 0
              and launches[arm]["resize_normalize"] > 0,
              f"flops: {arm}: launches {launches[arm]}")
        del bp, s, models
        torch.cuda.empty_cache()
    print(json.dumps({"flops": {"card": card, "pages": PIPE_PAGES,
                                **arms}}))
    return launches


# parallel: the dp mesh, GPipe and the dp step on the card. An
# in-process NCCL group of one rank: BatchPipeline(mesh) on the pipeline
# phase's PIPE_PAGES pages against the meshless run of the same tasks (pipeline_diff, the pipeline phase's
# rules), K1 and K3 counted on the mesh run; GPipe at one stage against
# sequential_apply (bit-equal: no communication); the dp LORE step at
# world size 1 against the meshless step (PAR_TRAIN_CFG, one step each
# from one tree, deterministic algorithms: bit-equal losses and
# parameters). Then two spawned processes, one gloo group, both on
# cuda:0 (NCCL refuses two ranks on one device): each builds the
# pipeline on the group's mesh and runs its half of the pages; rank 0's
# gathered outputs against the meshless run. Two processes sharing one
# card measure no scaling: their seconds are printed, not compared
PAR_WORLD = 2
PAR_TIMEOUT_S = 300
PAR_TRAIN_CFG = dict(resolution=(256, 256))
PAR_TRAIN_BATCH = 2


def _gloo_rank(rank, world, port, in_file, out_file):
    """One of the parallel phase's spawned gloo ranks on cuda:0."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.parallel.multihost import initialize

    set_float_precision()
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
               timeout=PAR_TIMEOUT_S)
    try:
        trees = torch.load(in_file, weights_only=False)
        t0 = time.perf_counter()
        bp = build_pipeline(DEVICE, trees, mesh=make_mesh())
        build_s = time.perf_counter() - t0
        pages = [{"image": make_page(i), "page": i}
                 for i in range(PIPE_PAGES)]
        dist.barrier()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = bp.run(pages)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        res = {"launches": {k: launch_counts[k] for k in KERNELS},
               "own_pages": bp.last_stats["n_pages"], "run_s": run_s,
               "build_s": build_s, "device": torch.cuda.current_device(),
               "pages": out if rank == 0 else None,
               "jax": "jax" in sys.modules}
        torch.save(res, out_file)
    finally:
        dist.destroy_process_group()


def gloo_ranks(trees, tmp) -> list:
    """The two spawned ranks' results (spawn_ranks)."""
    return spawn_ranks(_gloo_rank, PAR_WORLD, trees, tmp, PAR_TIMEOUT_S,
                       "parallel")


def dp_train_pair() -> dict:
    """One dp LORE step at world size 1 against the meshless step."""
    import tempfile

    import torch

    from pdf_table_tpu_torch.data.synthetic import SyntheticTableDataset
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                        LoreTrainer)

    cfg = LoreConfig.wtw(**PAR_TRAIN_CFG)
    tree = train_tree(cfg)
    batch = SyntheticTableDataset(cfg, n=PAR_TRAIN_BATCH, seed=0).batch(
        list(range(PAR_TRAIN_BATCH)))
    mesh = make_mesh(device=DEVICE)
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir, \
            torch_deterministic():
        for name, m in (("mesh", mesh), ("meshless", None)):
            tr = LoreTrainer(cfg, LoreTrainArgs(
                learning_rate=TRAIN_LR, lr_schedule="constant",
                batch_size=PAR_TRAIN_BATCH, save_every=0,
                output_dir=out_dir), mesh=m, device=DEVICE)
            tr.init_state(tree)
            losses = tr.train_step(batch)
            res[name] = (losses, {k: v.detach().clone()
                                  for k, v in tr.state.params.items()})
    (lm, pm), (ln, pn) = res["mesh"], res["meshless"]
    return {"losses_equal": lm == ln, "loss": lm["loss"],
            "params_equal": all(torch.equal(pm[k], pn[k]) for k in pn),
            "leaves": len(pn)}


@contextlib.contextmanager
def torch_deterministic():
    """``torch.use_deterministic_algorithms(True)`` within the block."""
    import torch

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def phase_parallel(card, trees):
    """Parallelism on the card (see above)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.parallel.pipeline import (gpipe_apply,
                                                       sequential_apply)

    pages = [{"image": make_page(i), "page": i} for i in range(PIPE_PAGES)]
    solo = build_pipeline(DEVICE, trees)
    solo.run(pages)                     # warm-up
    want = solo.run(pages)
    del solo
    mesh = make_mesh(device=DEVICE)
    try:
        check(dist.get_world_size() == 1 and dist.get_backend()
              == ("nccl" if DEVICE == "cuda" else "gloo"),
              "parallel: not a one-rank NCCL group")
        bp = build_pipeline(DEVICE, trees, mesh=mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = bp.run(pages)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        dp1 = {k: launch_counts[k] for k in KERNELS}
        cmp1 = pipeline_diff(got, want)
        del bp
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        stack = {"w": torch.randn(1, 64, 64, device=DEVICE, generator=gen)
                 * 0.1}
        mb = torch.randn(6, 8, 64, device=DEVICE, generator=gen)
        stage_fn = (lambda p, x: torch.tanh(x @ p["w"]))
        pp = make_mesh(axis_names=("pp",), device=DEVICE)
        gpipe_equal = torch.equal(gpipe_apply(stage_fn, stack, mb, pp),
                                  sequential_apply(stage_fn, stack, mb))
        train = dp_train_pair()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        t0 = time.perf_counter()
        ranks = gloo_ranks(trees, tmp)
        gloo_s = time.perf_counter() - t0
    cmp2 = pipeline_diff(ranks[0]["pages"], want)
    gloo = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    summary = {
        "card": card, "pages": PIPE_PAGES, "dp1_run_s": mesh_s,
        "dp1_launches": dp1, "dp1_vs_meshless": cmp1,
        "gpipe_one_stage_equal": gpipe_equal, "dp_train": train,
        "gloo_wall_s": gloo_s,
        "gloo_ranks": [{k: r[k] for k in ("own_pages", "run_s", "build_s",
                                          "launches", "device", "jax")}
                       for r in ranks],
        "gloo_vs_meshless": cmp2}
    print(json.dumps({"parallel": summary}))
    for tag, cmp in (("dp1", cmp1), ("gloo", cmp2)):
        check(cmp["quads_same_count"] and cmp["quad_px"] <= PIPE_QUAD_TOL,
              f"parallel: {tag}: quads differ: {cmp['quad_px']:.3g} px")
        lay = cmp["layout"]
        check(lay["same_count"] and lay["same_labels"]
              and lay["box_px"] <= LAYOUT_BOX_TOL
              and lay["score"] <= LAYOUT_SCORE_TOL,
              f"parallel: {tag}: layout differs: {lay}")
        check(cmp["text_share"] >= PIPE_TEXT_MIN,
              f"parallel: {tag}: texts equal on {cmp['text_share']:.3f}")
        check(cmp["page_html_equal"] == cmp["page_html_checked"] > 0,
              f"parallel: {tag}: page_html differs where its inputs are "
              f"equal")
    check(dp1["deform_conv2d"] > 0 and dp1["resize_normalize"] > 0,
          f"parallel: the dp run launched {dp1}")
    check(all(r["launches"]["resize_normalize"] > 0 for r in ranks)
          and gloo["deform_conv2d"] > 0,
          f"parallel: the gloo ranks launched "
          f"{[r['launches'] for r in ranks]}")
    check([r["own_pages"] for r in ranks] == [PIPE_PAGES / 2] * 2,
          "parallel: the ranks did not take half the pages each")
    check(not any(r["jax"] for r in ranks), "parallel: a rank imported JAX")
    check(gpipe_equal, "parallel: GPipe at one stage differs from "
          "sequential_apply")
    check(train["losses_equal"] and train["params_equal"],
          f"parallel: the dp step at world size 1 differs from the "
          f"meshless step: {train}")
    return {"parallel_dp1": dp1, "parallel_gloo": gloo}

# train_mesh: the LORE step on a (dp 1, tp 2, sp 2) mesh, four spawned
# gloo ranks sharing cuda:0 (NCCL refuses several ranks on one device), at
# LoreConfig.wtw()'s full width (dla34, hidden 256, f32) on a global batch
# of 2 at 1024^2, MESH_STEPS steps under deterministic algorithms (so that
# the replicated leaves can be held bit-equal across the ranks), against
# the meshless step on the same tree and batches in this process: the
# losses within MESH_LOSS_TOL relative, the params after the first step
# within 2 lr. Each rank's K1 launches: 16 a forward, each at its DCN's
# columns, the two ida_0 DCNs (256 columns, sharded by the rule) at 128
# beside the four 128-wide ones of ida_1. Four ranks on one card
# measure no scaling: their step time and memory are printed, not
# compared
MESH_DIMS = (1, 2, 2)
MESH_BATCH = 2
MESH_STEPS = 2
MESH_LOSS_TOL = 1e-4
MESH_TIMEOUT_S = 300


def spawn_ranks(target, world, inputs, tmp, timeout, tag) -> list:
    """``world`` spawned processes of ``target(rank, world, port, in_file,
    out_file)``, their results; a rank that fails or outlives ``timeout``
    fails the phase, and every rank is stopped."""
    import multiprocessing
    import socket

    import torch

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    in_file = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, in_file)
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, port, in_file, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        codes = [p.exitcode for p in procs]
        check(all(c == 0 for c in codes),
              f"{tag}: the gloo ranks exited {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(f, weights_only=False) for f in outs]


def _leaf_crc(t) -> int:
    import zlib

    return zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes())


def _mesh_rank(rank, world, port, in_file, out_file):
    """One rank of the train_mesh phase on cuda:0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.models.lore.dla import DeformConvBlock
    from pdf_table_tpu_torch.ops.kernels import (KERNELS, launch_columns,
                                                 launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.parallel.collectives import (
        collective_bytes, collective_calls, reset_collective_counts)
    from pdf_table_tpu_torch.parallel.multihost import initialize
    from pdf_table_tpu_torch.parallel.tensor_parallel import \
        ColumnDeformConvBlock

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    set_float_precision()
    torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
               timeout=MESH_TIMEOUT_S)
    try:
        inp = torch.load(in_file, weights_only=False)
        mesh = make_mesh(axis_names=("dp", "tp", "sp"),
                         devices=np.arange(world).reshape(MESH_DIMS))
        t0 = time.perf_counter()
        tr = new_trainer(LoreConfig.wtw(), inp["tree"], inp["out_dir"],
                         mesh=mesh, batch_size=MESH_BATCH)
        build_s = time.perf_counter() - t0
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_collective_counts()
        losses, step_ms, first = [], [], None
        for i, batch in enumerate(inp["batches"]):
            t0 = time.perf_counter()
            losses.append(tr.train_step(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                calls, nbytes = dict(collective_calls), dict(collective_bytes)
                whole = tr.whole(tr.state.params)
                crc = {k: _leaf_crc(v) for k, v in tr.state.params.items()}
                if rank == 0:
                    first = {k: v.cpu() for k, v in whole.items()}
                del whole
        res = {"losses": losses, "step_ms": step_ms, "build_s": build_s,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": {k: launch_counts[k] for k in KERNELS},
               "columns": {f"{n}@{c}": v
                           for (n, c), v in launch_columns.items()},
               "collective_calls_step1": calls,
               "collective_bytes_step1": nbytes,
               "crc": crc, "sharded": sorted(tr.state.sharding.dims),
               "dcns": {n: (int(m.weight.shape[3]),
                            isinstance(m, ColumnDeformConvBlock))
                        for n, m in tr.model.named_modules()
                        if isinstance(m, DeformConvBlock)},
               "tp_rank": mesh.get_local_rank("tp"),
               "first_params": first, "jax": "jax" in sys.modules,
               "device": torch.cuda.current_device()}
        torch.save(res, out_file)
    finally:
        dist.destroy_process_group()


def phase_train_mesh(card):
    """The train step on a dp x tp x sp mesh (see above)."""
    import tempfile

    import torch

    from pdf_table_tpu_torch.data.synthetic import SyntheticTableDataset
    from pdf_table_tpu_torch.models.lore.config import LoreConfig

    cfg = LoreConfig.wtw()
    tree = train_tree(cfg)
    batches = [SyntheticTableDataset(cfg, n=MESH_BATCH, seed=s).batch(
        list(range(MESH_BATCH))) for s in range(MESH_STEPS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp, \
            torch_deterministic():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = new_trainer(cfg, tree, tmp, batch_size=MESH_BATCH)
        want, want_ms, want_first = [], [], None
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            want.append(tr.train_step(batch))
            torch.cuda.synchronize()
            want_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                want_first = {k: v.detach().cpu()
                              for k, v in tr.state.params.items()}
        want_peak = torch.cuda.max_memory_allocated()
        del tr
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(_mesh_rank, 4, {"tree": tree,
                                            "batches": batches,
                                            "out_dir": tmp},
                            tmp, MESH_TIMEOUT_S, "train_mesh")
        ranks_s = time.perf_counter() - t0
    loss_err = max(abs(r["losses"][i][k] - want[i][k])
                   / max(abs(want[i][k]), 1e-12)
                   for r in ranks for i in range(MESH_STEPS)
                   for k in want[i])
    first = ranks[0]["first_params"]
    param_err = max(float((first[k] - want_first[k]).abs().max())
                    for k in want_first)
    sharded = set(ranks[0]["sharded"])
    unequal = sorted(k for k in ranks[0]["crc"] if len({
        (r["tp_rank"] if k in sharded else 0, r["crc"][k])
        for r in ranks}) != (MESH_DIMS[1] if k in sharded else 1))
    k1 = [r["launches"]["deform_conv2d"] for r in ranks]
    dcns = ranks[0]["dcns"]
    split = sorted(n for n, (_, col) in dcns.items() if col)
    widths = {c for c, _ in dcns.values()}
    # each rank's launches at each width: the steps times its DCNs there
    by_width = [{w: r["columns"].get(f"deform_conv2d@{w}", 0)
                 for w in widths} for r in ranks]
    want_width = {w: MESH_STEPS * sum(c == w for c, _ in dcns.values())
                  for w in widths}
    summary = {
        "card": card, "mesh": dict(zip(("dp", "tp", "sp"), MESH_DIMS)),
        "config": "LoreConfig.wtw() (dla34, hidden 256, f32)",
        "global_batch": MESH_BATCH, "resolution": list(cfg.resolution),
        "steps": MESH_STEPS, "losses": [r["losses"] for r in ranks[:1]],
        "meshless_losses": want, "loss_rel_err": loss_err,
        "param_err_step1": param_err, "lr": TRAIN_LR,
        "sharded_leaves": len(sharded), "replicas_unequal": unequal,
        "rank_step_ms": [r["step_ms"] for r in ranks],
        "meshless_step_ms": want_ms,
        "rank_peak_bytes": [r["peak_bytes"] for r in ranks],
        "meshless_peak_bytes": want_peak,
        "collective_calls_step1": ranks[0]["collective_calls_step1"],
        "collective_bytes_step1": ranks[0]["collective_bytes_step1"],
        "k1_launches": k1, "k1_launches_by_columns": by_width,
        "tp_split_dcns": {n: dcns[n][0] for n in split},
        "launches": [r["launches"] for r in ranks],
        "build_s": [r["build_s"] for r in ranks], "ranks_wall_s": ranks_s,
        "note": "four ranks share one card: no scaling is measured"}
    print(json.dumps({"train_mesh": summary}))
    check(loss_err < MESH_LOSS_TOL,
          f"train_mesh: losses {loss_err:.3g} from the meshless step's")
    check(param_err <= 2 * TRAIN_LR,
          f"train_mesh: params {param_err:.3g} from the meshless step's "
          f"after step 1")
    check(not unequal, f"train_mesh: replicated leaves differ across the "
          f"ranks: {unequal[:5]}")
    check(len(sharded) == 85, f"train_mesh: {len(sharded)} sharded leaves")
    check(k1 == [16 * MESH_STEPS] * 4 and len(dcns) == 16,
          f"train_mesh: K1 launched {k1} for {len(dcns)} DCNs")
    check(split == ["detector.dla_up.ida_0.node_1",
                    "detector.dla_up.ida_0.proj_1"]
          and all(dcns[n][0] == 128 for n in split)
          and all(b == want_width for b in by_width),
          f"train_mesh: the tp-split DCNs {split} or the launches by "
          f"columns {by_width} (want {want_width})")
    check(all(r["launches"]["deform_conv2d_flat_kc"] == 0 for r in ranks),
          "train_mesh: K2 launched in the f32 step")
    check(not any(r["jax"] for r in ranks),
          "train_mesh: a rank imported JAX")
    return {name: sum(r["launches"][name] for r in ranks)
            for name in ranks[0]["launches"]}


def demangle(sym: str) -> str:
    """The kernel's name (and integer template arguments) in a mangled
    symbol: the length-prefixed identifier that ends in "kernel"."""
    import re

    for m in re.finditer(r"(?<!\d)(\d+)", sym):
        ident = sym[m.end():m.end() + int(m.group(1))]
        if ident.endswith("kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", sym[m.end() + len(ident):])
            if args:
                ident += "<" + ",".join(re.findall(r"Li(\d+)E",
                                                   args.group(1))) + ">"
            return ident
    return sym


def ptxas_report(libs) -> list:
    """Registers and spills of every kernel function, from each library's
    nvcc log (``-Xptxas -v``), and the deform-conv bodies' dynamic shared
    memory per (mode or f32, channel tile, pixel warpgroups)."""
    import re

    from pdf_table_tpu_torch.ops.deform_conv import (_smem_bytes,
                                                     _smem_bytes_f32)

    report = []
    for name, lib in libs.items():
        fn = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = demangle(m.group(1))
                report.append({"source": name, "function": fn})
            elif fn and "registers" in line:
                report[-1]["ptxas"] = line.split(":", 1)[1].strip()
            elif fn and "spill" in line:
                report[-1]["spills"] = line.strip()
    smem = {f"{'flat_kc' if fk else 'tap'} n{n} wg{w}": _smem_bytes(fk, n, w)
            for fk in (False, True) for n in (64, 128, 256) for w in (1, 2)}
    smem.update({f"f32 n{n} wg{w}": _smem_bytes_f32(n, w)
                 for n in (64, 128, 256) for w in (1, 2)
                 if n < 256 or w == 1})
    report.append({"source": "deform_conv", "dynamic_smem_bytes": smem})
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS is deterministic only with a fixed workspace; the train
    # phase's resume check runs under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.ops.kernels import KERNELS, build

    set_float_precision()
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = build.build_all(sorted(set(KERNELS.values())))
    print(json.dumps({"build_s": time.perf_counter() - t0}))
    print(json.dumps({"ptxas": ptxas_report(libs)}))

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_s = {}

    def run(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[name] = time.perf_counter() - t

    rows = run("kernels", phase_kernels, gen)
    fk_rows = run("flat_kc", phase_flat_kc, gen)
    geo_k1, geo_k2 = run("geometry", phase_geometry, gen)
    windows = run("windows", phase_windows, gen)
    rows += geo_k1
    fk_rows += geo_k2
    rn_rows = run("resize", phase_resize, gen)
    wireless = run("slice", phase_slice, card, "wireless")
    wtw = run("wtw_slice", phase_slice, card, "wtw")
    rn_launches = run("detection", phase_detection, card)
    run("recognition", phase_recognition, card)
    layout_v = run("layout", phase_layout, card)
    run("surface", phase_surface, card, layout_v)
    pipe, pipe_trees, pipe_out = run("pipeline", phase_pipeline, card,
                                     layout_v)
    pipe_digital = run("pipeline_digital", phase_pipeline_digital, card,
                       pipe_trees)
    pipe_scanned = run("pipeline_scanned", phase_pipeline_scanned, card,
                       pipe_trees)
    run("decode", phase_decode)
    run("html", phase_html)
    run("bf16_models", phase_bf16_models, card)
    pipe_bf16 = run("pipeline_bf16", phase_pipeline_bf16, card, pipe_trees,
                    pipe_out)
    run("tsr_host_crop", phase_tsr_host_crop, card, pipe_trees)
    sys_paths = run("system_per_page", phase_system_per_page, card,
                    pipe_trees)
    serve_launches = run("serve", phase_serve, card, pipe_trees)
    cli_paths = run("cli", phase_cli, card, pipe_trees)
    tsr_pages, tsr_regions = tsr_inputs()
    sla_tree, _, sla = run("tsr_slanet", phase_tsr, card, "SLANet",
                           tsr_pages, tsr_regions)
    tm_tree, tm_results, tm = run("tsr_master", phase_tsr, card,
                                  "TableMaster", tsr_pages, tsr_regions)
    mtl = run("tsr_mtl_tabnet", phase_mtl_tabnet, card, tsr_pages,
              tsr_regions, tm_tree, tm_results)
    pipe_sla = run("pipeline_slanet", phase_pipeline_arm, card, pipe_trees,
                   "SLANet", sla_tree)
    pipe_tm = run("pipeline_master", phase_pipeline_arm, card, pipe_trees,
                  "TableMaster", tm_tree)
    cn_tree, cn = run("tsr_centernet", phase_tsr_centernet, card, tsr_pages,
                      tsr_regions)
    lg = run("tsr_lgpma", phase_tsr_lgpma, card, tsr_pages, tsr_regions)
    pipe_cn = run("pipeline_centernet", phase_pipeline_arm, card,
                  pipe_trees, "CenterNet", cn_tree)
    docx_tree_v, docx = run("layout_docx", phase_layout_docx, card)
    pipe_docx = run("pipeline_docx", phase_pipeline_docx, card, pipe_trees,
                    docx_tree_v)
    det_b = run("det_backbones", phase_det_backbones, card)
    rec_b = run("rec_backbones", phase_rec_backbones, card)
    train_rows = run("train_dcn", phase_train_dcn, gen)
    train = run("train", phase_train, card, train_rows)
    train_det, det_tree = run("train_det", phase_train_det, card)
    conv = run("convert", phase_convert, card)
    poly = run("det_polygon", phase_det_polygon, card, det_tree)
    flops = run("flops", phase_flops, card, pipe_trees)
    par = run("parallel", phase_parallel, card, pipe_trees)
    mesh_launches = run("train_mesh", phase_train_mesh, card)
    print(json.dumps({"phase_s": phase_s}))
    check("jax" not in sys.modules and "pdf_table_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")

    def by_path(name, **extra):
        """A kernel's launches on every counted path that runs it or not:
        the digital and scanned pipelines launch K3 once a chunk and K1 on
        their raster pages' LORE sub-batches; the token-model and LGPMA phases and the
        token pipeline arms launch K3 once a chunk (detection) and never
        K1 or K2; CenterNet
        and DocXLayout run K1 at every DCN (K2 too in bf16); the DBNet
        backbones launch K3 once a chunk, the recognizers nothing; the
        server runs K3 once a chunk and K1 at every LORE sub-batch of its
        batches, the CLI K1 on the image route's LORE forward and K3 on
        the batched PDF route's chunk."""
        return {**extra, "pipeline": pipe[name],
                "pipeline_digital": pipe_digital[name],
                "pipeline_scanned": pipe_scanned[name],
                "pipeline_bf16": pipe_bf16[name],
                "tsr_slanet": sla[name],
                "tsr_master": tm[name], "tsr_mtl_tabnet": mtl[name],
                "pipeline_slanet": pipe_sla[name],
                "pipeline_master": pipe_tm[name],
                "tsr_centernet": cn["f32"][name],
                "tsr_centernet_bf16_forward": cn["bf16"][name],
                "tsr_lgpma": lg[name], "pipeline_centernet": pipe_cn[name],
                "pipeline_lore_line_cell":
                    pipe_cn["lore_line_cell"][name],
                "layout_docx": docx["f32"][name],
                "layout_docx_bf16_forward": docx["bf16"][name],
                "pipeline_docx": pipe_docx[name],
                "det_backbones": det_b[name], "rec_backbones": rec_b[name],
                "train": train[name], "serve": serve_launches[name],
                "train_det": train_det[name], "convert": conv[name],
                "det_polygon": poly[name],
                "flops_pipeline_bf16": flops["bf16"][name],
                "flops_pipeline_f32": flops["f32"][name],
                "parallel_dp1": par["parallel_dp1"][name],
                "parallel_gloo": par["parallel_gloo"][name],
                "train_mesh": mesh_launches[name],
                **{path: counts[name] for path, counts in sys_paths.items()},
                **{path: counts[name] for path, counts in cli_paths.items()}}

    print(card)
    print(json.dumps(kernels_line(
        rows, by_path("deform_conv2d",
                      lore_wireless=wireless["deform_conv2d"],
                      lore_wtw=wtw["deform_conv2d"]), fk_rows,
        by_path("deform_conv2d_flat_kc",
                lore_wtw=wtw["deform_conv2d_flat_kc"]), rn_rows,
        by_path("resize_normalize", detection=rn_launches), train_rows,
        windows)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
