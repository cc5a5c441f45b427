"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure raises and
exits non-zero). Every run_training, run_prediction and served bin below
runs its steps as the port runs them on a card: each step shape eager
once, then captured as a CUDA graph and replayed (train/capture.py), so
K1's and K2's launch counts come from replays (a replay adds the
launches its capture recorded). Each run_training is timed beside the
same call with every step eager (eager_steps(), which keeps the port
from building its graph cache), with its captures, replays, capture
seconds and graph memory printed. The exceptions are the schemes whose
steps the port runs eagerly by decision, FSDP2 ([fsdp]) and gloo
([multibranch], [graphshard]), whose graph_report or header line says
why.

1. device      torch/CUDA versions and the card's name and power limit;
               exits 2 without a CUDA device.
2. build       the kernels' library, built from csrc/edge_pipeline.cu (K1)
               and csrc/edge_pipeline_bwd.cu (K2), which share
               csrc/edge_tile.cuh, for sm_90a on every run (one nvcc per
               source, in parallel, then one link); each kernel's ptxas
               registers and spills. Where a gitignored prior_kernels/
               holds an earlier version's two .cu files, that version is
               built too, in parallel, for phase 5.
3. kernel      K1 (the fused edge pipeline) against its plain PyTorch
               version on the card, at the shapes of the served bins and
               of the headline train step (F_in = F_out = 128; the
               headline's windows hold more valid slots than one staging
               pass), every flavour (a; a,b; a,W; a,b,W)
               in f32 and bf16 and with bf16 a/b and an f32 W, plus a
               plan with an empty window and static padding, and E = 0;
               two runs must give the same bits. Times with CUDA events:
               the kernel, the plain version, the bound from bytes and
               operations, and index_add_ for the reduce-only flavour.
4. kernel-bwd  K2 (the pullback) against its plain version at the train
               bins' shapes and the headline train step's in every flavour
               and dtype mix, the empty-window plan and E = 0, same bits on
               two runs; timed like K1.
5. shapes      K1 and K2 (a,b,W, f32) at the main path's three shapes:
               the largest served bin, the first train bin of the BCC run
               and the headline batch: each kernel's launch shape (CTAs,
               cluster, threads, dynamic shared memory), its time, the
               plain version's, the bound and, with prior_kernels/, the
               earlier kernels' time in turns in the same run after a
               check that they agree.
6. slice       bench.py's headline SchNet at full width (4 CFConv layers,
               128 filters, 50 Gaussians, hidden 128, graph head 2x128
               shared + [128, 128]) with random weights from a seeded
               generator, serving 256 synthetic qm9 requests through
               DynamicBatcher -> ServingEngine(device="cuda"), which
               captures one forward graph per budget at warm-up and
               replays it per bin. Checks: one capture per budget and one
               replay per bin; every request has a finite result; K1's
               launch count rises
               by exactly 4 x dispatched bins during process(); each bin's
               served outputs equal a direct make_forward call on the same
               collated batch bit for bit; one bin matches the same model
               on the CPU's plain path.
6a. export     the same SchNet exported per served budget
               (export_inference: a program for the card and one for the
               CPU in each artifact; bytes and seconds printed), loaded
               into a fresh engine (ServingEngine.from_exported ->
               install_executables, one capture per budget) that serves
               the 256 requests: the same bins as the live engine, every
               output equal to the live engine's bit for bit, K1 launched
               4 x bins through the loaded programs; a bin served from the
               live graph and from the loaded program's, in turns (served
               ms and device ms); the CPU program of one artifact within
               the CPU tolerance of the card.
6b. loadbench  serve/loadgen.run_load_bench on the same SchNet
               (qm9 histogram, 256 requests, deadline 25 ms, batch 32, 4
               open bins, offered at 2 x the calibrated rate): every gate
               held (recompiles: no capture after warm-up; tail;
               keeps_up; complete); p50/p99, graphs/s, slot waste.
6c. fleet      serve/loadgen.run_fleet_bench as
               __graft_entry__.py's fleet_serving_drill sets it up
               (zinc_skew, 60 requests, deadline 30 ms, batch 6, 3
               replicas sharing the card, spec_affinity, replica 1 killed
               at 0.4 of the stream, per-replica telemetry shards) on the
               same SchNet: every gate held (no capture after warm-up, no
               in-deadline request dropped, p99 recovered, replica 1
               detected); tools/graftboard.py's fleet view of the shards
               finds replica 1 dead and covered by a reroute row. Then
               __graft_entry__.py's rollover drill: a 2-replica tier
               rolls over to the same snapshot while a stream of 40
               requests is served (the shadow engines capture while the
               old ones replay), nothing lost, outputs bit for bit across
               the swap, and a NaN snapshot refused with the old outputs
               bit for bit.
7. train       the same SchNet trained by run_training on the card (f32,
               batch 32, 2 epochs, packing named off so the run keeps the
               ladder batches the checks below take) on the BCC set of
               tests/test_graphs.py (300 configurations, seed 7), then
               run_prediction. Checks:
               finite losses, every step's loss finite and the last
               epoch's mean below the first step's loss, K1 launches = 4 x model
               forwards and K2 launches = 4 x train steps; the first train
               step on the card equals the same step on the CPU's plain
               path (loss, gradients, AdamW-updated parameters) in f32 and,
               at the bf16 tolerance, in bf16; whether two identical runs
               of that step give the same bits is reported. Then one train
               step at bench.py's headline shape (128 molecules of 9-30
               atoms, radius 4.0, 32 neighbours): card against the CPU's
               plain path (loss, gradients, updated parameters), then
               eager and device time and K1's and K2's share of it.
7a. guard      the divergence guard on the same SchNet and BCC
               train split (batch 32, one worst-case shape, 2 epochs of 7
               steps), every step through a graph cache: healthy, guard on
               equals guard off bit for bit (losses, parameters, AdamW
               state, step counts, learning rates) with single steps and
               supersteps of 4, K1 and K2 4 per step; nan:loss@3,9 and
               nan:batch@3,9 guarded (step 9 inside a replayed 4-step
               graph) equal bit for bit to the run that never takes steps
               3 and 9; the unguarded control goes non-finite;
               run_training under the rollback policy (max_bad_steps 1,
               max_rollbacks 1, containers every 2 steps) with
               nan:batch@3,4,10,11 rolls back once, then raises GuardHalt
               with its report; the replayed headline step's ms and graph
               pool bytes, guard on against off.
7b. preempt    three child processes of this script on the card
               (--preempt-child) run the BCC SchNet of [train] with the
               asynchronous writer saving every 3 steps: uninterrupted;
               killed by kill:train_step:14 (SIGKILL, return code -9,
               with a mid-epoch container of epoch 2 on disk); continued
               (Training.continue): parameters, AdamW state and the loss
               and lr history equal the uninterrupted run's bit for bit;
               the writer's snapshot ms, saves and bytes.
7c. lint       the port's static analysis on the card's host: the CLI
               (python -m hydragnn_tpu_torch.analysis --check --json) in
               a subprocess on this host's Python and CUDA torch must
               exit 0 (new/baselined/suppressed per rule, the torch
               version torch-api resolved against, seconds); then the
               host-sync rule held to the card: under
               torch.cuda.set_sync_debug_mode("warn"), one steady-state
               train epoch of [train]'s SchNet (its 4th, every step a
               replay, no capture) and one served bin of [slice] record
               the innermost hydragnn_tpu_torch frame of every
               synchronizing call; each site is a line the rule flags
               (suppressed or baselined) or lies outside its scope, with
               its count per step; K1 4 per forward, K2 4 per train step.
8. mlip-kernels  K1 and K2 in the reduce-only flavour at PaiNN's widths
               (F = 1, 3, 64, 192) on the plan of the first packed bin
               that md17.json's run_training trains on,
               against their plain versions in f32 and bf16 (same bits on
               two runs, K2 zero off the plan), each width's launch shape,
               and the times at F = 64 and 192 beside the bound, the plain
               version and index_add_; then K2's operator (K2 forward,
               K1/K2 backward) on the card against the CPU plain path in
               every flavour.
9. mlip        examples/md17/md17.json's PaiNN interatomic potential at
               full width (hidden 64, 3 layers, num_radial 20, graph head
               1x64 + [64, 64], add pooling; energy weight 1, force weight
               10) trained by run_training on the card (f32, 2 epochs,
               packing "auto", which packs) on bench.py's painn_md17_mlip
               molecules (256 of 19-23 atoms, seed 1, with energies and
               forces) split 0.8, then
               run_prediction. Checks: finite losses, finite energies and
               forces of the expected shapes, and K1 = K2 = 6 x (forwards
               + train steps) launches (12 of each per train step: 6 K1
               forward and 6 as K2's backward; 6 K2 in the force pass and
               6 in the loss's backward); whether the loss fell is
               reported; every train batch a packed bin of the budgets.
               The first MLIP train step on the card against the CPU
               plain path (loss, per-task losses, energies, forces,
               gradients; updated parameters shown) in f32 and bf16, on
               the first train batch run_training forms (packing
               resolved as it resolves it) from examples/md17/md17.py's
               MD17 stand-in (Morse energies and forces) and from bench's
               molecules: each within [train]'s tolerance or else within
               10 x the card's own floor, the median of five card steps
               with the scatter in place of K1/K2 (each its own atomic
               order; all five printed); 12 K1 and 12 K2 launches in the
               step. Then the step's eager and device
               time on bench's first packed bin.
9a. serve-forces  md17.json's PaiNN (random weights, seed 0)
               served with forces (ServingEngine(with_forces=True)) over
               96 MD17 stand-in frames, budgets fitted from their sizes
               (batch 32): K1 = K2 = 6 launches a bin; every served energy
               and force equals a direct energy_and_forces(create_graph=
               False) at its bin bit for bit; the first bin card vs the CPU
               plain path by [mlip]'s rule (energies at the f32 forward
               tolerance, forces at the gradient tolerance, or within 10 x
               the median of five card passes with index_add_ in place of
               K1/K2); the exported MLIP artifact per
               budget served through a fresh engine equals the live one
               bit for bit with K1 = K2 = 6 a bin; a full bin's and a
               one-request bin's device time (profiler over replays) with
               the indexing_backward_kernel share of each.
9b. md         MD rollouts (simulate/): md17.json's PaiNN at full width
               trained 1 epoch on the MD17 stand-in, then md17.json's own
               Simulation block (Langevin NVT, kT 0.1, friction 0.5, dt
               1e-3, 200 steps, K = 16, skin 0.4, 1,024 slots) from the
               first test frame (21 atoms) through
               hydragnn_tpu_torch.run_simulation on the card, each K-step
               macro a replayed CUDA graph: K1 = K2 = 6 x (1 + 200) force
               passes (the block plan built on the device from each step's
               list), finite energies, the rollout rows (k 16 x 12 + 8)
               read back by tools/graftboard.py, steps/s and ns/day. The
               first 16 steps one at a time, each card step against one
               step of the CPU plain path from the same state: positions,
               velocities and energies at the f32 forward tolerance,
               forces by [mlip]'s rule (the gradient tolerance or 10 x
               the card's scatter floor), the neighbor arrays, counters
               and key equal, also against the CPU's own trajectory
               (whose gap to the card's is reported). K = 1 against
               K = 16 (skin 0.01: rebuilds, the
               thermostat on, 64 steps) bit for bit, a second run the same
               bits, one macro eager, captured and replayed from one state
               bit for bit. The drills: 64 slots overflow at t = 0 and
               grow, equal to the roomy run; nan:force@20 halves dt with
               the prefix bit for bit; halts on spent halvings, the halt
               policy and spent growths; interrupted at step 96 through
               CheckpointWriter (a halving at 40 first), resumed with the
               ladder adopted, 192 steps equal to the uninterrupted run.
               One replayed K = 16 macro's device time (CUDA events), its
               profiler kernels (count, busy, idle share, K1, K2), its
               parts timed alone (the neighbor build with its selects,
               the device plan, the Langevin half steps, the force pass),
               and the same macro with rebuild_policy "never". K1/K2 reduce-only at
               F = 64 and 192 on the rollout's device plan (reduce_kernel_
               rows). LJ.json's SchNet (random weights) NVE from a 3x3x3
               cluster, 64 steps: K1 = K2 = 3 x 65, energy drift and
               momentum within tests/test_simulate.py's bounds, K1/K2
               a,b,W at its device plan against their plain versions.
9c. drivers    the port's example drivers (hydragnn_tpu_torch/drivers/),
               each through its main() in this process on the card:
               lennard_jones (--configs 64 --epochs 2 --simulate
               --sim_steps 64: LJ.json's SchNet potential trained, then NVE
               from a held-out configuration), md17 (--frames 60 --epochs
               2 --simulate: md17.json's PaiNN, then its own Simulation
               block, Langevin, 200 steps, K = 16), qm9 (--synthetic --mols
               200 --epochs 2), zinc in f32 and bf16 (--mols 200 --epochs
               2), csce_gap and ogb_gap (200 SMILES, 2 epochs), qm9_hpo
               (--trials 2 --epochs 2 --mols 200) and lsms (--configs 200
               --epochs 2). Checks: the generators' samples equal the CPU
               build bit for bit (sha256 of their records against the
               table tests/test_torch_drivers.py holds; md17's and zinc's
               also against [mlip]'s and [zinc]'s copies); every number a
               driver returns finite; each run_training, run_prediction
               and run_simulation call's K1 and K2 launches equal what the
               model predicts from its recorded forwards, train steps and
               force passes (launches_per_pass, predicted_launches); both
               rollouts finite with no containment event, and one rollout
               step of each fitted potential on the card within the f32
               tolerance of a CPU step from the same state (as [md] holds
               its steps); qm9_hpo's device memory after trial 2 within
               8 MiB of after trial 1. Where matplotlib imports, qm9 and
               md17 run with Visualization.create_plots (a copy of their
               example config) and the hook's plot files are checked (six
               for qm9's graph head; nine for md17's energy and forces,
               the force parity plot among them); where it does not, the
               phase says so and holds qm9's run to raise ImportError.
               Then the atomistic drivers (ATOMISTIC_RUNS), 2 epochs
               each at their example configs' widths: oc20 (MACE
               potential, 100 slabs), oc22 (SchNet, periodic), odac23
               (SchNet with FiLM graph_attr conditioning), oc25 (PaiNN
               hidden 32 potential on 120 periodic slabs and gas-phase
               frames mixed), mptrj (SAGE) and mptrj --forces (EGNN
               potential), alexandria (PNA on residualized per-atom
               targets), eam and eam --multitask (SchNet, graph and
               node heads), omat24 (SchNet potential, periodic), ani1x
               (SchNet) and ani1x --mlip (PaiNN potential), nabla2_dft
               (PaiNN), omol25 and transition1x (PNAPlus), qcml (MACE
               hidden 16), qm7x (DimeNet++) and qm7x --mlip (SchNet
               potential), each followed by qm7x_inference with its
               flags, which restores the run's checkpoint through
               run_prediction(config). The same checks: their data's
               sha256 against ATOMISTIC_DIGESTS (the CPU build), every
               number finite, each entry-point call's K1/K2 equal to
               predicted_launches (MACE one launch a layer; SAGE, EGNN
               and DimeNet none). Last, K1 and K2 reduce-only against
               their plain versions (f32 and bf16, same bits on two
               runs) at the widths these runs meet first, on each run's
               first train bin: oc25's F = 32 and 96, qcml's F = 144
               (four and a half 32-column slabs), timed beside the
               bound, the plain version and index_add_/index_select.
               Then the last nine drivers (ROADMAP item 16c; GFM_RUNS
               and RANK_RUNS): polymers (--chains 100 --epochs 2:
               polymers.json's SAGE and conv node head), multidataset
               (--per_family 60 --epochs 2: gfm_energy.json's SchNet, one
               encoder and three branches routed by dataset_id over
               molecules, periodic crystals and reaction paths),
               multidataset_hpo (--per_family 60 --trials 2 --epochs 1),
               sc26_hpo (--frames 64 --trials 12 --epochs 1: the whole
               grid of SchNet, EGNN and PAINN potentials at hidden 16 and
               32), structure_optimization (--epochs 2 --frames 64
               --blocks 2 --steps 20: a PaiNN potential, then the
               relaxation, each block's steps replayed from a captured
               step), uv_spectrum (--mols 100 --epochs 2: GIN, no K1/K2)
               and ising (--configs 100 --epochs 2: PNA, graph and node
               heads), each in this process; then the multibranch drivers,
               each starting its ranks as processes of the driver on
               cuda:0 over gloo: multibranch --epochs 2 at its default
               sizes (300/120/80) on 3 ranks and again with --nosync 2 at
               120/48/32, and multibranch_hpo --trials 2 --epochs 1 on 2
               ranks. Checks: their data's sha256 against GFM_DIGESTS;
               every count held to predicted_launches (the conv node head
               one a,W launch a layer of its own; GIN none; a relaxation
               pf x (blocks x steps + blocks + 2) K1 and pf x blocks x
               steps K2), each rank's own in the multibranch drivers
               (their ranks count K1/K2, forwards and train steps); the
               ranks' parameters equal bit for bit after each epoch, and
               with --nosync 2 moving on every second step only;
               multibranch_hpo's ranks running the same trials; the
               relaxation's energies finite and falling, one captured
               block equal to the eager block bit for bit and to the CPU
               plain path within rtol 1e-4 / atol 1e-3, and a descent
               step's eager, capture and replay times with the
               profiler's indexing_backward_kernel share, padded to the
               sample and to a fixed budget of n x 24 edge slots. Last,
               K1/K2 on sc26's first train bin: reduce-only at F = 16 and
               48 (PAINN hidden 16) and a,b,W at F = 16 (SchNet's
               16 filters, hidden 16), f32 and bf16 against their plain
               versions, same bits twice, timed.
10. zinc-kernels  K1 and K2 in the reduce-only flavour at PNA's moment-pass
               width (F = 128) on the first packed train bin of zinc.json's
               run, in f32 and bf16: against their plain versions (same
               bits on two runs, K2 zero off the plan), the launch shape
               and shared memory per CTA, and the times beside the bound,
               the plain version, index_add_ (K1) and index_select of g's
               rows (K2, the reduce-only pullback as one library call).
11. zinc       examples/zinc/zinc.json's PNAPlus + GPS at full width (hidden
               64, 3 layers, GPS multihead x4, pe_dim 8, num_nodes 40) on
               examples/zinc/zinc.py's 400 molecules (seed 0) split 0.8:
               zinc.json (f32) and zinc_bf16.json trained by run_training
               on the card (2 epochs each, packing "auto" resolved to the
               fitted budgets, printed), then run_prediction. Checks:
               finite losses, every train batch a packed bin, K1 launches
               = 3 x forwards and K2 launches = 3 x train steps, finite
               predictions; the first train step on the first packed bin,
               card against the CPU plain path in f32 and bf16 (loss,
               gradients, AdamW-updated parameters, running statistics; see
               hold_zinc_step for the scaling); the f32 step's eager and
               device time and kernel count.
11a. pipeline  the input feed at full width: md17.json's PaiNN on
               bench's molecules (packed (752, 7320, 40), (376, 3664, 20);
               12 K1 and 12 K2 a step) and zinc.json's PNAPlus + GPS
               (packed (1440, 2920, 120); 3 K1 a forward, 3 K2 a step)
               trained by run_training for 2 epochs four ways: through
               the collation workers (Parallelism.pipeline {workers 4,
               depth 4, chunk 4, packed}, prefetch 2), through them with
               packed off (each batch graph.collate's), serially (workers
               0, prefetch 0) and through the prefetch thread alone
               (workers 0, prefetch 2), each with the telemetry stream on;
               then zinc.json on 16,000 of zinc.py's molecules (~200
               packed train steps an epoch) through the workers, serially
               and through the prefetch thread. Checks: per-step losses,
               History and the final state (parameters, AdamW state) bit
               for bit across the feeds, equal K1/K2 launches, equal
               captures per epoch, no train step captured at epoch 1 or
               later on the short runs (the captures there are eval
               shapes' second sight, in every feed; the long run's epoch 1
               may fill a budget epoch 0 did not), no capture_error; the
               three batch assemblies
               (graph.collate, collate_packed, the column store) bit for
               bit on every train batch. Prints per feed: os.cpu_count()
               and the resolved plan, the run's seconds, per epoch the
               train pipeline's collate ms per batch, H2D ms per batch,
               reorder depth and starved deliveries, and the step clock's
               input wait per train step; per configuration the three
               assemblies' host ms per batch in one thread. Every
               run_training of every phase logs the feed it resolved
               ("[feed]" lines; the default on a host of 4 or more CPUs is
               the pipeline).
11b. formats   the dataset formats (after [pipeline], on its data): the
               native host library (hydragnn_tpu_torch/native.py, g++ at
               first use; a build failure fails the phase) takes every
               radius graph of the MD17 stand-in's frames (open, radius 4.0,
               24 neighbours) and of oc20.py's 200 slabs (periodic, cutoff
               5.0), each equal to the numpy path's edge set (rows (s, r,
               image) after one canonical sort), with both paths' host ms
               and the CPU model; md17.json's PaiNN (as [pipeline] runs it)
               from three .hgb files (Dataset.format "binary", preload
               false): run_training's train, val and test feeds over the
               files equal to its feeds over the in-memory lists, every
               delivery of two epochs bit for bit, serially and through the
               collation workers; run_training through both feeds equal to
               the runs fed the lists bit for bit (per-step losses, History,
               parameters and AdamW state, K1/K2); run_prediction(config)
               alone restores the checkpoint and predicts equal to the
               list-fed run's prediction bit for bit; md17's splits built
               into POSIX shared memory (data/diststore.StoreDataset), a
               spawned process of this script (--store-child NAME) attaches
               the train split and returns the digest of every unpacked
               sample (equal to the parent's), run_training on the store
               views equal to the .hgb run bit for bit, and no attach once
               the owner closed; zinc.json's PNAPlus + GPS from a pickle
               directory per split (pna_deg taken from the data) through the
               workers equal to the list-fed run bit for bit; zinc_long's
               16,000 molecules written into one .hgb container (subset
               views per split), one epoch through the workers, equal to
               the list-fed run bit for bit, its epoch seconds and input
               wait per dispatch beside the list-fed run's and [pipeline]'s;
               the files' bytes and one thread's ms to read a train batch's
               samples from each container against the list.
12. polymer-kernels  K1 and K2 in the conv node head's a,W flavour at
               (F_in, F_out) = (64, 64) and (64, 1), f32, on the plan of the
               first packed train bin of polymers.json's run: against their
               plain versions (same bits on two runs, K2 zero off the plan),
               launch shapes, times beside the bound and the plain version.
13. polymers   examples/open_polymers_2026/polymers.json's SAGE at full
               width (hidden 64, 3 layers; graph head 1x64 + [64, 64], conv
               node head [64, 64] + 1; AdamW 0.0005, batch 32) on the
               example's 300 chains (seed 26) split 0.8, trained by
               run_training on the card (3 epochs, packing "auto", which
               packs), then run_prediction(config) alone, which builds the
               model on the card and restores the run's checkpoint. Checks:
               finite losses, every train batch a packed bin, K1 launches = 3
               x forwards and K2 launches = 3 x train steps (the conv head's
               three layers), the restored tensors equal the run's final
               ones bit for bit, the predictions equal the in-process
               run_prediction(..., state=...) bit for bit or else within the
               f32 forward tolerance (which held is printed); the first train
               step on the first packed bin, card against the CPU plain path;
               the step's eager and device time and kernel count.
14. zoo        one train step each of GIN, MFC, CGCNN (polymers.json's
               widths) and GAT (csce_gap.json's: hidden 60, heads 6) on the
               first polymer bin, card against the CPU plain path, and one
               recalibrate_batch_stats pass of polymers.json's model, card
               against CPU.
15. mace-kernels  K1 and K2 in the reduce-only flavour at MACE's receiver-sum
               width (F = 288: 32 channels x 9 harmonic components) on the
               first packed train bin of oc20.json's run, in f32 and bf16:
               against their plain versions (same bits on two runs, K2 zero
               off the plan), the launch shape and shared memory per CTA,
               the times beside the bound, the plain version, index_add_
               (K1) and index_select (K2); K2's operator at F = 288,
               card against the CPU plain path.
16. oc20       examples/open_catalyst_2020/oc20.json's MACE potential at
               full width (hidden 32, 2 layers, max_ell 2, node_max_ell 2,
               correlation 2, num_radial 8; graph head 1x32 + [32, 32], add
               pooling; energy weight 1, force weight 25; AdamW 0.002, batch
               8) on this script's copy of oc20.py's 200 periodic slab +
               adsorbate systems (seed 0, Lennard-Jones labels under PBC)
               split 0.8, trained by run_training on the card (f32, 2
               epochs, packing "auto", which packs), then run_prediction.
               Checks: finite losses, energies and forces; every train batch
               a packed bin; K1 = K2 = 2 x (forwards + train steps); the
               first train step on the first packed bin, card against the
               CPU plain path by [mlip]'s rule, with 4 K1 and 4 K2 launches;
               the step's eager and device time and K1 + K2's share.
16a. dp        (PR 10) the same MACE under Parallelism {"scheme": "dp",
               "data": 1} over NCCL at world 1, the group made by the port's
               rendezvous (HYDRAGNN_TPU_COORDINATOR=localhost:<free port>):
               the first dp step on the first packed bin equals the single
               step bit for bit (loss, every parameter, the AdamW state)
               with 4 K1 and 4 K2 launches; three dp steps through a graph
               cache (1 eager, 1 capture, 2 replays) equal three eager dp
               steps bit for bit, and a replay's kernels include NCCL's
               all-reduce; replayed dp and single steps timed in turns, and
               the all-reduce of the flat gradient buffer alone in a graph;
               run_training 2 epochs and run_prediction with [oc20]'s checks;
               then run_training again with Training.Guard on: losses,
               parameters and the AdamW state equal bit for bit.
16b. fsdp      (PR 10) the same under "zero": true (FSDP2 fully_shard over
               the data group): the first step against dp's within the f32
               gradient tolerance (whether bit for bit printed);
               run_training with every step eager by the scheme's decision
               (printed on its graph_report line) and run_prediction with
               [oc20]'s checks; run_prediction(config) alone restores the
               checkpoint's full tensors bit for bit in one process and
               predicts within the f32 forward tolerance of the in-process
               pass. The run writes the sharded format
               (checkpoint_format "orbax": improving epochs, every 10 steps
               through the writer, final; each rank its own shards, no
               gather), which run_prediction(config) restores; a save with
               crash:orbax_between_replaces leaves final.old, restored bit
               for bit; the writer's snapshot and write ms and bytes in
               both formats for the same state.
17. egnn       examples/mptrj/mptrj_forces.json's EGNN (hidden 64, 3 layers,
               force weight 10, AdamW 0.001, batch 32) on this script's copy
               of examples/common/crystals.py's crystals (300, species Ni,
               Nb, Al, Ti, seed 3) split 0.8, trained by run_training on the
               card (2 epochs), then run_prediction: finite results, no
               K1/K2 launch (its sums run at the senders); the first step,
               card against the CPU plain path by [mlip]'s rule with the
               card's error the smallest of ten card steps (its own sums
               are atomics, and near a ReLU kink bimodal); the step's
               time.
18. pnaeq-kernels  K1 and K2 in the reduce-only flavour at PNAEq's
               receiver-sum widths (F = 2 and 3 in layer 0, at the input
               width 1; 128 and 192, PNA's moment pass [h, h*h] and the
               folded vector message at hidden 64) on the first packed
               train bin of the PNAEq run, in f32 and bf16, as
               [zinc-kernels] holds them; K2's operator at F = 192.
19. pnaeq      examples/md17/md17.json with mpnn_type "PNAEq" (what
               examples/md17/md17.py --mpnn_type PNAEq runs; hidden 64, 3
               layers, num_radial 20, radius 4.0) trained by run_training
               on the card (f32, 2 epochs, packing "auto", which packs)
               on the MD17 stand-in split 0.8, then run_prediction; the
               checks of [mlip] with K1 = K2 = 6 x (forwards + train
               steps); the first train step on the first packed bin, card
               against the CPU plain path (hold_mlip_step); one train step
               replayed against eager ([capture]'s replay_vs_eager).
20. dimenet    examples/qm7x/qm7x.json's DimeNet++ (hidden 64, 2 layers,
               num_radial 6, num_spherical 7, envelope 5, int_emb 64,
               basis_emb 8, out_emb 16; AdamW 0.001, batch 32) on this
               script's copy of examples/qm7x/train.py's 400 frames
               (``qm7x_frames``, seed 7) split 0.8: each train batch's real
               and padded node, edge and triplet counts (triplets refuse
               packing, so one worst-case shape) beside the ladder's;
               run_training on the card (f32, 2 epochs), then
               run_prediction: finite losses and predictions, one train
               shape, no K1/K2 launch (its sums are the plain segment_sum,
               as in the JAX package); the first train step, card against
               the CPU plain path (hold_zinc_step); one step replayed
               against eager (within [zinc]'s tolerance: index_add_
               atomics); the step's eager and device time, kernel count
               and indexing_backward_kernel time with the port's
               index_select gathers and with x[idx] in their place, in
               turns.
20a. multibranch  (PR 10) examples/multibranch/train.py's configuration
               (SchNet, hidden 32, 3 layers, radius 2.5, 16 Gaussians, batch
               8, AdamW 2e-3; branches of 300/120/80 molecules from the
               multibranch driver's make_branch_dataset, seeds 0, 1, 2,
               split 0.8) through run_training under "multibranch" on three
               ranks sharing the card: three processes of this script
               (--multibranch-rank R DIR), each on cuda:0, in a gloo group
               (NCCL refuses two ranks on one device; gloo's collectives are
               not captured, so the steps run eagerly). Checks: the split
               [1, 1, 1]; the ranks' parameters equal bit for bit after
               every step and their histories equal; rank 0's first step's
               gradients within the f32 gradient tolerance of a one-process
               reference on the card (the mean of the three sub-batches'
               losses, decoders rescaled by D / D_b); K1 = 3 x forwards and
               K2 = 3 x train steps on every rank; run_prediction's rows;
               each rank's step time, unguarded and guarded (the
               multibranch guard, per slot, eager as the step). Then, in
               the same processes: the run with Guard on and resume
               containers every 2 steps equal to it bit for bit; an epoch
               with NaN labels on branch 1's rank at one step, contained
               (branch 1's decoder and the encoder as before, branches 0
               and 2 as the clean step left them, bit for bit;
               window_bad_by_branch {"branch-1": 1, "encoder": 1}); the
               guarded run killed by SIGKILL mid-epoch, its container's
               branch_steps [s, s, s], and three continue processes equal
               to the uninterrupted run bit for bit. A failing rank fails
               the phase.
20b. graphshard graph-dimension sharding through the giant-graph
               driver's pieces (drivers/giant_graph.py), on four processes
               of this script (--graphshard-rank R D DIR) on cuda:0 in a
               gloo group: D = 4, one value_and_grad per scheme (all-gather,
               halo; both with ring attention) on the z-sorted 512-atom
               structure; D = 2 over ranks {0, 1}, the driver's
               configuration (giant.py's defaults: 512 atoms, 24
               configurations, hidden 32, 2 layers, 16 Gaussians, 2 heads,
               cutoff 3.2, Adam 3e-3) 3 epochs per scheme, then an 8,000-atom
               structure (a 20^3 grid, 4 configurations), 3 train steps per
               scheme. Checks: every rank exits 0; finite losses; the ranks'
               parameters equal bit for bit after every step; D = 4 and the
               first D = 2 steps (energy, forces, summed gradients) within
               tolerance of the one-process reference_mpnn_forward on the
               card and on the CPU plain path; halo energy equal to the
               all-gather one on every configuration of epoch 0 (rtol
               2e-5); no K1/K2 launch. Prints the hops and caps, the
               per-epoch lines, the transport per collective, and at 8,000
               atoms the median step ms, ms per collective kind, each rank's
               peak memory and the halo rows against N_pad.
21. capture    at each path's step shape (the SchNet headline batch, the
               first packed MLIP, ZINC, polymer and oc20 bins): one train step
               through the train loop's superstep eager and replayed, the
               replayed step against the eager one (bit for bit for SchNet
               and PaiNN, whose aggregations all run K1/K2; else at [zinc]'s
               card-vs-CPU tolerance, MACE's printing which held), each
               path's step time (CUDA events,
               back-to-back steps from the host batch), the graph's replays
               alone, and K1's and K2's device time inside replayed steps
               (profiler); one 2-step replay against 2 single replays on the
               headline step (bit for bit) and one 4-step replay against 4
               on the polymer bin (loss sums within rtol 1e-4); one replayed
               step per optimizer type (9) on the polymer bin against its
               eager step, all finite; an SGD learning-rate change reaching
               the next replay exactly, with no recapture; polymers.json
               trained with superstep steps 4 (the groups superstep_groups
               forms, 4-step dispatches, K1/K2 per forward and per step,
               the plateau scheduler cutting the rate every epoch with no
               capture after epoch 1).
22. report     the kernels JSON line (with each kernel's times at the
               three SchNet shapes under "by_shape", at PaiNN's widths
               under "mlip_widths", at PNA's under "zinc_width", at the
               conv node head's under "polymer_widths", at MACE's under
               "mace_width", at PNAEq's under "pnaeq_widths", at oc25's
               under "oc25_widths", at qcml's under "qcml_width" and at
               sc26's under "sc26_painn_widths" and "sc26_schnet_width";
               "launches" sums the serving (slice, export, loadbench,
               fleet, serve-forces), SchNet training, guard, preempt and lint,
               MLIP, MD, drivers (the first eight, the atomistic ones
               and the last nine, every rank's), ZINC, pipeline, formats, polymer, oc20, PNAEq, dp
               (its guarded run too), fsdp, multibranch and graphshard runs and the
               superstep run, "launches_by_path" splits them, DimeNet's and
               graphshard's 0 included), the
               card line, and the final {"ok": true, "device": ...} line.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import torch

F32_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_pallas_segment.py:341
BF16_TOL = dict(rtol=4e-2, atol=2.5e-1)  # tests/test_pallas_segment.py:342
VJP_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_pallas_segment.py:808
CPU_TOL = dict(rtol=1e-4, atol=1e-4)
# H100 SXM published peaks (dense): HBM bytes/s, f32 (no tensor cores)
# and bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
N_REQUESTS = 256
# Valid plan slots a window must exceed somewhere: four of the kernels'
# 64-slot chunks (kSub in csrc/edge_tile.cuh), so node sums carry across
# chunks and through every ring stage.
K_CHUNK = 256


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, replays=20, per_graph=10):
    """Device time of one call of ``fn``: ``per_graph`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's issue rate never shows (inputs stay L2-resident)."""
    from hydragnn_tpu_torch.train.capture import collector_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def eager_ms(fn, iters=50, warmup=5):
    """Stream time of ``fn`` issued eagerly from Python, back to back:
    the device waits on the host whenever issuing is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, dtype):
    """Least time for the work: ``nbytes`` over the HBM rate or ``ops``
    over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(*args):
    """K1's (bytes, ops, output dtype): ``ops/edge_pipeline.k1_work``,
    the count the telemetry's executable rows read too."""
    from hydragnn_tpu_torch.ops.edge_pipeline import k1_work as work

    return work(*args)


def k2_work(*args):
    """K2's (bytes, ops, cotangent dtype): ``ops/edge_pipeline.k2_work``."""
    from hydragnn_tpu_torch.ops.edge_pipeline import k2_work as work

    return work(*args)


# dtype mixes (a/b, W) and the flavours each takes: bf16 a/b with an f32
# master W needs W.
MIXES = {
    (torch.float32, torch.float32): ("a", "ab", "aw", "abw"),
    (torch.bfloat16, torch.bfloat16): ("a", "ab", "aw", "abw"),
    (torch.bfloat16, torch.float32): ("aw", "abw"),
}


def mix_name(a_dt, w_dt):
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    return names[a_dt] if a_dt == w_dt else f"{names[a_dt]}+{names[w_dt]}W"


def empty_window_plan(dev):
    """A plan with an empty node window and two static padding blocks."""
    import numpy as np

    from hydragnn_tpu_torch.ops.edge_pipeline import plan_blocks_static, static_block_bound

    rng = np.random.default_rng(3)
    n, e = 200, 400
    seg = np.sort(np.concatenate([rng.integers(0, 60, 200), rng.integers(120, 200, 200)]))
    plan = plan_blocks_static(seg, n, static_block_bound(e, n) + 2,
                              edge_valid=rng.random(e) > 0.1)
    return tuple(torch.from_numpy(p).to(dev) for p in plan), n, e


def window_fill(plan):
    """The most valid plan slots of any one node window."""
    perm, _, valid, window = plan
    be = perm.numel() // window.numel()
    return int(torch.bincount(window.long().repeat_interleave(be)[valid]).max())


def check_spans_passes(rows, tag):
    fill = max(r["window_fill"] for r in rows)
    check(fill > K_CHUNK, f"{tag}: no case puts more than {K_CHUNK} valid slots in a window")
    log(f"[{tag}] the fullest window holds {fill} valid slots (> {K_CHUNK}: node sums "
        f"carry across staged chunks)")


def batch_cases(batches, dev):
    """(key, plan, n, e, e_valid, batch) for each device batch, then the
    empty-window plan (batch None, not timed)."""
    out = []
    for key, batch in batches:
        plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
        out.append((key, plan, batch.num_nodes, batch.num_edges,
                    int(batch.edge_mask.sum()), batch))
    plan, n, e = empty_window_plan(dev)
    out.append(("empty_window", plan, n, e, int(plan[2].sum()), None))
    return out


def phase_device():
    if not torch.cuda.is_available():
        print(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
            "this script needs one GPU",
            file=sys.stderr,
        )
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; {card}")
    return card


def ptxas_lines(report):
    """Each kernel's ptxas -v report on one line: name, registers, shared
    memory and spills (static shared memory only; the dynamic amount is
    in the launch shapes)."""
    parts, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "registers" in line):
            parts.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    out = [(n, "; ".join(p)) for n, p in parts.items()]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
    except OSError:
        names = [n for n, _ in out]
    return [(short if short else n, what) for (n, what), short in zip(out, names)]


def phase_build():
    """Build the kernels from the checkout; with a ``prior_kernels/``
    directory (gitignored, holding an earlier version's two .cu files)
    build that version too, in parallel, to time both in one call."""
    import threading

    from hydragnn_tpu_torch.ops import cuda_build

    prior = None
    prior_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prior_kernels")
    sources = [os.path.join(prior_dir, f) for f in ("edge_pipeline.cu", "edge_pipeline_bwd.cu")]
    worker = None
    if all(os.path.exists(f) for f in sources):
        prior = {}
        worker = threading.Thread(target=lambda: prior.update(cuda_build.compile_library(
            sources, os.path.join(prior_dir, "build", "libprior.so"))))
        worker.start()
    cuda_build.build(force=True)  # from the source, every run
    if worker is not None:
        worker.join()
        check("path" in prior, "the prior kernels did not build")
    r = cuda_build.build_report
    log(f"[build] K1 + K2 (one nvcc per source, started together, then the link): "
        f"{r['seconds']:.2f} s -> {os.path.relpath(r['path'])}")
    for name, what in ptxas_lines(r["ptxas"]):
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        log(f"[build]   ptxas: {name.split('(')[0]}: {what}")
    if prior is None:
        log("[build] no prior_kernels/ here: the earlier kernels are not timed in this run")
        return None
    log(f"[build] prior kernels from prior_kernels/ ({prior['seconds']:.2f} s, built "
        f"beside the checkout's)")
    return prior["path"]


def served_bins(samples, budgets):
    """One bin per budget shape, filled with requests in arrival order
    until the next one would not fit (the serving engine warms and
    serves exactly these shapes)."""
    bins = {}
    for spec in budgets:
        members, n, e = [], 0, 0
        for s in samples:
            if not spec.fits(n + s.num_nodes, e + s.num_edges, len(members) + 1):
                break
            members.append(s)
            n, e = n + s.num_nodes, e + s.num_edges
        bins[spec] = members
    return bins


def served_batches(samples, budgets):
    """(key, batch on the card) for each served bin of ``served_bins``."""
    from hydragnn_tpu_torch.data.graph import collate

    return [
        (f"n{spec.num_nodes}_e{spec.num_edges}",
         collate(members, spec.pad_spec(), with_segment_plan=True).to("cuda"))
        for spec, members in served_bins(samples, budgets).items()
    ]


def phase_kernel(samples, budgets, headline):
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    f = 128
    batches = served_batches(samples, budgets) + [headline]
    rows = []
    main = None
    for key, plan, n, e, e_valid, batch in batch_cases(batches, dev):
        slots, blocks = plan[0].numel(), plan[3].numel()
        fill = window_fill(plan)
        for (a_dt, w_dt), flavours in MIXES.items():
            a = torch.randn(e, f, generator=gen).to(dev, a_dt)
            b = torch.randn(e, f, generator=gen).to(dev, a_dt)
            w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev, w_dt)
            for stages in flavours:
                args = (a, b if "b" in stages else None, w if "w" in stages else None,
                        *plan, n)
                with torch.no_grad():
                    got = edge_pipeline_planned(*args)
                    again = edge_pipeline_planned(*args)
                    ref = edge_pipeline_plain(*args)
                torch.cuda.synchronize()
                name = mix_name(a_dt, w_dt)
                check(torch.equal(got, again), f"{key} {stages} {name}: two runs differ")
                check(got.dtype == ref.dtype, f"{key} {stages} {name}: output dtype")
                tol = F32_TOL if a_dt == torch.float32 else BF16_TOL
                torch.testing.assert_close(got.float(), ref.float(), **tol)
                err = float((got.float() - ref.float()).abs().max())
                row = {"shape": key, "flavour": stages, "dtype": name, "n": n,
                       "e_valid": e_valid, "window_fill": fill, "max_abs_err": err}
                if batch is not None:
                    with torch.no_grad():
                        row["ms"] = time_ms(lambda: edge_pipeline_planned(*args))
                        row["plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
                    nbytes, ops, out_dt = k1_work(e_valid, n, f, f, slots, blocks, a_dt,
                                                  w_dt, "b" in stages, "w" in stages)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, out_dt)
                    row["library_ms"] = None
                    if stages == "a":
                        a_valid = a[batch.edge_mask]
                        rcv_valid = batch.receivers[batch.edge_mask].long()
                        out = torch.zeros(n, f, dtype=a_dt, device=dev)
                        row["library_ms"] = time_ms(
                            lambda: out.index_add_(0, rcv_valid, a_valid))
                    if stages == "abw" and name == "f32" and (main is None or n > main["n"]):
                        main = row
                rows.append(row)
                log(f"[kernel] {key} {stages} {name}: max|err| {err:.3g}" + timing_note(row))
    # E = 0: zeros without a launch
    before = edge_pipeline_planned.launches
    with torch.no_grad():
        z = edge_pipeline_planned(a[:0], b[:0], w, *plan, n)
    check(edge_pipeline_planned.launches == before and z.shape == (n, f)
          and not bool(z.any()), "E=0 must return zeros without a launch")
    log(f"[kernel] E=0: zeros {tuple(z.shape)} {z.dtype}, no launch")
    check_spans_passes(rows, "kernel")
    log(f"[kernel] {len(rows)} comparisons passed (f32 rtol 1e-5 atol 1e-4, "
        f"bf16 rtol 4e-2 atol 2.5e-1; identical bits on two runs)")
    return main, rows


def timing_note(row):
    if "ms" not in row:
        return ""
    return (f", kernel {row['ms'] * 1e3:.1f} us, plain {row['plain_ms'] * 1e3:.1f} us,"
            f" bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})"
            + (f", index_add_ {row['library_ms'] * 1e3:.1f} us"
               if row.get("library_ms") is not None else ""))


def phase_kernel_bwd(batches):
    """K2 against its plain version on the train bins' and the headline
    step's plans (and the empty-window plan), every flavour and dtype
    mix."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    f = 128
    rows = []
    main = None
    for key, plan, n, e, e_valid, batch in batch_cases(batches, dev):
        slots, blocks = plan[0].numel(), plan[3].numel()
        fill = window_fill(plan)
        covered = torch.zeros(e, dtype=torch.bool, device=dev)
        covered[plan[0][plan[2]].long()] = True
        for (a_dt, w_dt), flavours in MIXES.items():
            a = torch.randn(e, f, generator=gen).to(dev, a_dt)
            b = torch.randn(e, f, generator=gen).to(dev, a_dt)
            w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev, w_dt)
            for stages in flavours:
                g_dt = torch.promote_types(a_dt, w_dt) if "w" in stages else a_dt
                g = torch.randn(n, f, generator=gen).to(dev, g_dt)
                args = (g, a, b if "b" in stages else None,
                        w if "w" in stages else None, *plan, n)
                got = edge_pipeline_bwd_planned(*args)
                again = edge_pipeline_bwd_planned(*args)
                ref = edge_pipeline_bwd_plain(*args)
                torch.cuda.synchronize()
                name = mix_name(a_dt, w_dt)
                tol = VJP_TOL if a_dt == torch.float32 else BF16_TOL
                err = 0.0
                for which, x, y, z in zip("abw", got, again, ref):
                    check((x is None) == (z is None), f"{key} {stages} {name}: d{which}")
                    if z is None:
                        continue
                    check(x.dtype == z.dtype and torch.equal(x, y),
                          f"{key} {stages} {name}: d{which} dtype or two runs differ")
                    torch.testing.assert_close(x.float(), z.float(), **tol)
                    if which != "w":
                        check(not bool(x[~covered].any()),
                              f"{key} {stages} {name}: d{which} nonzero off the plan")
                    err = max(err, float((x.float() - z.float()).abs().max()))
                row = {"shape": key, "flavour": stages, "dtype": name, "n": n,
                       "e_valid": e_valid, "window_fill": fill, "max_abs_err": err}
                if batch is not None:
                    row["ms"] = time_ms(lambda: edge_pipeline_bwd_planned(*args))
                    row["plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(*args))
                    nbytes, ops, _ = k2_work(e, e_valid, n, f, f, slots, blocks, a_dt,
                                             w_dt, "b" in stages, "w" in stages)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, g_dt)
                    row["library_ms"] = None
                    if stages == "abw" and name == "f32" and (main is None or n > main["n"]):
                        main = row
                rows.append(row)
                log(f"[kernel-bwd] {key} {stages} {name}: max|err| {err:.3g}"
                    + timing_note(row))
    before = edge_pipeline_bwd_planned.launches
    z = edge_pipeline_bwd_planned(g, a[:0], b[:0], w, *plan, n)
    check(edge_pipeline_bwd_planned.launches == before and z[0].shape == (0, f)
          and z[2].shape == (f, f) and not bool(z[2].any()),
          "E=0 must return empty d_a and zero d_W without a launch")
    log("[kernel-bwd] E=0: empty d_a/d_b, zero d_W, no launch")
    check_spans_passes(rows, "kernel-bwd")
    log(f"[kernel-bwd] {len(rows)} comparisons passed (f32 rtol 1e-4 atol 1e-3, "
        f"bf16 rtol 4e-2 atol 2.5e-1; identical bits on two runs; zero rows off the plan)")
    return main, rows


def launch_shape(lib, which, n, e, f_in, f_out, bn, has_b=True, has_w=True):
    """The checkout's kernel launch shape from its library: CTAs, CTAs per
    cluster, threads, dynamic shared memory bytes (and K1's columns per
    CTA or K2's finishing CTAs)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    if which == "k1":
        lib.hg_edge_pipeline_fwd_shape(n, f_in, f_out, bn, 0, int(has_b), int(has_w), out)
        keys = ("ctas", "cluster", "threads", "smem_bytes", "columns_per_cta")
    else:
        lib.hg_edge_pipeline_bwd_shape(e, n, f_in, f_out, bn, 0, int(has_b), int(has_w), out)
        keys = ("ctas", "cluster", "threads", "smem_bytes", "finish_ctas")
    return dict(zip(keys, list(out)))


class PriorKernels:
    """The earlier K1 and K2 (their C interface: K1's as now, K2's
    without the coverage mask, zeroing d_a/d_b itself), loaded from the
    library phase_build made from ``prior_kernels/``; f32 a,b,W only."""

    def __init__(self, path):
        import ctypes

        self.lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.hg_edge_pipeline_fwd.argtypes = [p] * 8 + [i] * 10 + [p]
        self.lib.hg_edge_pipeline_fwd.restype = i
        self.lib.hg_edge_pipeline_bwd.argtypes = [p] * 12 + [i] * 10 + [p]
        self.lib.hg_edge_pipeline_bwd.restype = i

    def fwd(self, a, b, w, plan, n, bn=32):
        perm, seg, valid, window = plan
        out = torch.empty((n, w.shape[1]), dtype=torch.float32, device=a.device)
        err = self.lib.hg_edge_pipeline_fwd(
            a.data_ptr(), b.data_ptr(), w.data_ptr(), perm.data_ptr(), seg.data_ptr(),
            valid.view(torch.uint8).data_ptr(), window.data_ptr(), out.data_ptr(),
            a.shape[0], n, a.shape[1], w.shape[1], perm.numel() // window.numel(), bn,
            window.numel(), 0, 1, 1, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"prior K1 launch failed: {err}")
        return out

    def bwd(self, g, a, b, w, plan, n, bn=32):
        perm, seg, valid, window = plan
        d_a, d_b, d_w = torch.empty_like(a), torch.empty_like(b), torch.empty_like(w)
        part = torch.empty(((n + bn - 1) // bn, *w.shape), dtype=torch.float32,
                           device=a.device)
        err = self.lib.hg_edge_pipeline_bwd(
            g.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), perm.data_ptr(),
            seg.data_ptr(), valid.view(torch.uint8).data_ptr(), window.data_ptr(),
            d_a.data_ptr(), d_b.data_ptr(), d_w.data_ptr(), part.data_ptr(),
            a.shape[0], n, a.shape[1], w.shape[1], perm.numel() // window.numel(), bn,
            window.numel(), 0, 1, 1, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"prior K2 launch failed: {err}")
        return d_a, d_b, d_w


def phase_shapes(shapes, prior_path):
    """K1 and K2 (a,b,W, f32, F = 128) at the main path's three shapes:
    the largest served bin, the first train bin of the BCC run, and the
    headline train batch. Each: the launch shape, the kernel's time, the
    plain version's, the bound and, with ``prior_kernels/``, the earlier
    kernels' time in the same call (timed in turns: earlier, now, now,
    earlier; each reported as the mean of its two readings), after a
    check that the earlier kernels give the same results."""
    from hydragnn_tpu_torch.ops.cuda_build import load_library
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    lib = load_library()
    prior = PriorKernels(prior_path) if prior_path else None
    gen = torch.Generator().manual_seed(4)
    dev = torch.device("cuda")
    f = 128
    rows = []
    for label, batch in shapes:
        plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
        n, e = batch.num_nodes, batch.num_edges
        e_valid = int(batch.edge_mask.sum())
        slots, blocks = plan[0].numel(), plan[3].numel()
        a, b = (torch.randn(e, f, generator=gen).to(dev) for _ in range(2))
        w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev)
        g = torch.randn(n, f, generator=gen).to(dev)
        k1 = lambda: edge_pipeline_planned(a, b, w, *plan, n)  # noqa: E731
        k2 = lambda: edge_pipeline_bwd_planned(g, a, b, w, *plan, n)  # noqa: E731
        row = {"shape": label, "n": n, "e": e, "e_valid": e_valid,
               "windows": (n + 31) // 32, "window_fill": window_fill(plan)}
        for which, fn, plain, old in (
                ("k1", k1, lambda: edge_pipeline_plain(a, b, w, *plan, n),
                 prior and (lambda: prior.fwd(a, b, w, plan, n))),
                ("k2", k2, lambda: edge_pipeline_bwd_plain(g, a, b, w, *plan, n),
                 prior and (lambda: prior.bwd(g, a, b, w, plan, n)))):
            with torch.no_grad():
                r = {"launch": launch_shape(lib, which, n, e, f, f, 32)}
                if which == "k1":
                    nbytes, ops, dt = k1_work(e_valid, n, f, f, slots, blocks, torch.float32,
                                              torch.float32, True, True)
                else:
                    nbytes, ops, dt = k2_work(e, e_valid, n, f, f, slots, blocks,
                                              torch.float32, torch.float32, True, True)
                r["bound_ms"], r["bound_by"] = bound(nbytes, ops, dt)
                if old is not None:
                    got, was = fn(), old()
                    torch.cuda.synchronize()
                    for x, y in zip(got if which == "k2" else [got],
                                    was if which == "k2" else [was]):
                        torch.testing.assert_close(x, y, **VJP_TOL)
                    t = [time_ms(old), time_ms(fn), time_ms(fn), time_ms(old)]
                    r["ms"], r["prior_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                    r["ms_runs"], r["prior_ms_runs"] = t[1:3], [t[0], t[3]]
                else:
                    r["ms"], r["prior_ms"] = time_ms(fn), None
                r["plain_ms"] = time_ms(plain)
            row[which] = r
            prior_note = (f", earlier kernel {r['prior_ms'] * 1e3:.1f} us "
                          f"({r['prior_ms_runs'][0] * 1e3:.1f}, {r['prior_ms_runs'][1] * 1e3:.1f})"
                          if r["prior_ms"] is not None else ", earlier kernel not timed")
            log(f"[shapes] {which.upper()} {label} (n {n}, e {e}, {e_valid} valid, "
                f"{row['windows']} windows): {r['launch']}; kernel {r['ms'] * 1e3:.1f} us"
                f"{prior_note}, plain {r['plain_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        rows.append(row)
    return rows


FULL_WIDTH_ARCH = {
    "mpnn_type": "SchNet", "radius": 4.0, "max_neighbours": 32, "num_gaussians": 50,
    "num_filters": 128, "hidden_dim": 128, "num_conv_layers": 4,
    "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 128,
                               "num_headlayers": 2, "dim_headlayers": [128, 128]}},
    "task_weights": [1.0],
}


def full_width_config():
    """The served/trained model's spec, from ``FULL_WIDTH_ARCH``."""
    from hydragnn_tpu_torch.config import normalize_output_heads
    from hydragnn_tpu_torch.models.spec import model_config_from_dict

    arch = dict(FULL_WIDTH_ARCH, input_dim=1, output_type=["graph"], output_dim=[1],
                output_heads=normalize_output_heads(FULL_WIDTH_ARCH["output_heads"]))
    return model_config_from_dict({
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {"output_names": ["energy"]},
        }
    })


def phase_slice(samples, budgets, settings):
    import numpy as np

    from hydragnn_tpu_torch.export import make_forward
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import ServingEngine

    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    engine = ServingEngine(model, cfg, None, budgets, example=samples[0],
                           settings=settings, device="cuda")
    log(f"[slice] SchNet {cfg.num_conv_layers}x{cfg.num_filters} filters, "
        f"{n_params} parameters; budgets "
        f"{[(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]}; "
        f"warm-up {time.perf_counter() - t0:.2f} s {engine.warmup_ms}")
    batcher = DynamicBatcher(budgets, deadline_ms=settings.deadline_ms,
                             max_open_bins=settings.max_open_bins)
    reqs = [batcher.submit(s) for s in samples]
    batcher.close()
    edge_pipeline_planned.launches = 0
    t0 = time.perf_counter()
    records = engine.process(batcher)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = edge_pipeline_planned.launches
    check(launches == cfg.num_conv_layers * len(records),
          f"K1 launched {launches} times for {len(records)} bins "
          f"(want {cfg.num_conv_layers} per bin)")
    graphs = engine.graphs
    check(graphs.captures == len(budgets) and graphs.replays == len(records)
          and graphs.eager_runs == len(budgets),
          f"engine: {graphs.captures} captures, {graphs.replays} replays, "
          f"{graphs.eager_runs} eager forwards for {len(budgets)} budgets, "
          f"{len(records)} bins")
    log(f"[slice] served {len(reqs)} requests in {len(records)} bins, each a replay of its "
        f"budget's captured forward ({graphs.captures} graphs captured in "
        f"{graphs.capture_seconds:.2f} s at warm-up), K1 launches {launches} = "
        f"{cfg.num_conv_layers} x {len(records)}")
    for r in reqs:
        check(r.result is not None and r.result[0].shape == (1,)
              and bool(np.isfinite(r.result[0]).all()), f"request {r.req_id}: bad result")
    forward = make_forward(model, cfg)
    for rec in records:
        batch = engine.collate_bin([q.sample for q in rec["reqs"]], rec["spec"])
        out = forward(batch.to("cuda"))[0].cpu().numpy()
        for gi, q in enumerate(rec["reqs"]):
            check(np.array_equal(out[gi], q.result[0]),
                  f"bin {rec['key']}: served output differs from a direct forward")
    log(f"[slice] every bin's served outputs equal a direct make_forward bit for bit")
    rec = records[0]
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_batch = engine.collate_bin([q.sample for q in rec["reqs"]], rec["spec"]).to("cpu")
    cpu_out = make_forward(cpu_model, cfg)(cpu_batch)[0].numpy()
    served = np.stack([q.result[0] for q in rec["reqs"]])
    with torch.no_grad():
        h_gpu = model.encode(cpu_batch.to("cuda"))[0].cpu().numpy()
        h_cpu = cpu_model.encode(cpu_batch)[0].numpy()
    # The random-weight model's activations are small (~1e-4), so besides
    # rtol/atol 1e-4 the check also holds each error to 1e-4 of the
    # reference's largest magnitude (stricter here, never looser).
    for name, got, ref in (("outputs", served, cpu_out[: len(rec["reqs"])]),
                           ("node representations", h_gpu, h_cpu)):
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        np.testing.assert_allclose(got, ref, **CPU_TOL)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
        log(f"[slice] bin {rec['key']} {name}, card vs CPU plain path: max|err| "
            f"{err:.3g}, max|ref| {scale:.3g} (rtol 1e-4; atol 1e-4 and 1e-4 x max|ref|)")
    roll = engine.rollup()
    collate_ms = [1e3 * (r["t_dispatch"] - r["t_collate"]) for r in records]
    log(f"[slice] {len(reqs) / wall:.1f} requests/s over the burst ({wall * 1e3:.1f} ms); "
        f"latency p50 {roll['p50_ms']:.2f} ms p99 {roll['p99_ms']:.2f} ms "
        f"(all {len(reqs)} enqueued at once); host collate+launch per bin "
        f"{np.mean(collate_ms):.2f} ms mean; node fill {roll['node_fill']:.3f}")
    served_bin = {}
    for spec in budgets:
        host = engine.collate_bin(samples[:4], spec)
        dev_batch = host.to("cuda")
        key = (spec.num_nodes, spec.num_edges, spec.num_graphs)
        eager = eager_ms(lambda: forward(dev_batch))
        served = eager_ms(lambda: [o.clone() for o in graphs.replay(key, [host])])
        replay = time_ms(lambda: forward(dev_batch), replays=10, per_graph=2)
        served_bin[f"n{spec.num_nodes}_e{spec.num_edges}"] = {
            "eager_ms": eager, "replay_ms": served, "device_ms": replay}
        log(f"[slice] one forward at n{spec.num_nodes}_e{spec.num_edges}: "
            f"{eager:.3f} ms issued eagerly from Python, {served:.3f} ms as the engine "
            f"serves it (host pack + one copy + replay of the budget's graph + output "
            f"copy), {replay:.3f} ms of device time (CUDA graph replay); the device idles "
            f"{100 * (1 - replay / eager):.0f}% of the eager forward")
    engine.close()
    return launches, len(records), served_bin


# ------------------------------------------- [export], [loadbench], [fleet]


def serve_all(engine, samples, budgets, settings):
    """Every sample through ``engine`` in one closed burst (the same bins
    for the same samples and budgets). Returns (requests, bin records)."""
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher

    batcher = DynamicBatcher(budgets, deadline_ms=settings.deadline_ms,
                             max_open_bins=settings.max_open_bins)
    reqs = [batcher.submit(s) for s in samples]
    batcher.close()
    records = engine.process(batcher)
    torch.cuda.synchronize()
    return reqs, records


def same_results(reqs_a, reqs_b, what):
    import numpy as np

    check(len(reqs_a) == len(reqs_b), f"{what}: {len(reqs_a)} vs {len(reqs_b)} requests")
    for a, b in zip(reqs_a, reqs_b):
        check(a.result is not None and b.result is not None
              and all(np.array_equal(x, y) for x, y in zip(a.result, b.result)),
              f"{what}: request {a.req_id} differs")


def phase_export(samples, budgets, settings):
    """The headline SchNet exported per served budget (a program for the
    card and one for the CPU in each artifact), loaded into a fresh
    engine (from_exported -> install_executables) that serves the
    slice's requests: outputs equal the live engine's bit for bit, K1
    launched 4 x bins through the loaded programs, the CPU program within
    the CPU tolerance of the card."""
    import numpy as np

    from hydragnn_tpu_torch.export import export_inference, load_exported
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.serve.engine import ServingEngine

    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    live = ServingEngine(model, cfg, None, budgets, example=samples[0], settings=settings,
                         device="cuda")
    artifacts, info = {}, {}
    for b in budgets:
        key = (b.num_nodes, b.num_edges, b.num_graphs)
        t0 = time.perf_counter()
        blob = export_inference(model, cfg, None, live.collate_bin([samples[0]], b),
                                devices=["cuda", "cpu"])
        info[f"n{b.num_nodes}_e{b.num_edges}"] = {
            "bytes": len(blob), "export_s": time.perf_counter() - t0}
        artifacts[key] = blob
    t0 = time.perf_counter()
    execs = ServingEngine.from_exported(artifacts, device="cuda")
    load_s = time.perf_counter() - t0
    offline = ServingEngine(model, cfg, None, budgets, example=samples[0], settings=settings,
                            warm=False, device="cuda")
    t0 = time.perf_counter()
    offline.install_executables(execs)
    install_s = time.perf_counter() - t0
    check(offline.graphs.captures == len(budgets) and offline.warm_runs == len(budgets),
          f"install captured {offline.graphs.captures} graphs for {len(budgets)} budgets")
    log(f"[export] artifacts (a card and a CPU program each): {json.dumps(info)}; loaded "
        f"in {load_s:.2f} s, installed (one eager run and one capture per budget) in "
        f"{install_s:.2f} s")
    reqs_live, recs_live = serve_all(live, samples, budgets, settings)
    edge_pipeline_planned.launches = 0
    reqs, records = serve_all(offline, samples, budgets, settings)
    launches = edge_pipeline_planned.launches
    check(launches == cfg.num_conv_layers * len(records),
          f"[export] K1 launched {launches} times through the loaded programs for "
          f"{len(records)} bins (want {cfg.num_conv_layers} per bin)")
    check([r["key"] for r in records] == [r["key"] for r in recs_live],
          "[export] the two engines formed different bins")
    same_results(reqs_live, reqs, "[export] loaded programs vs the live engine")
    log(f"[export] {len(reqs)} requests in {len(records)} bins through the loaded programs "
        f"(each bin a replay of its captured program): K1 launches {launches} = "
        f"{cfg.num_conv_layers} x {len(records)}; every output equals the live engine's bit "
        f"for bit")
    # installs again: each keeps one graph a budget and releases the one it
    # replaces (device memory steady); one whose last warm-up fails
    # releases what it captured and leaves the engine serving as before
    allocated = []
    for _ in range(2):
        offline.install_executables(execs)
        torch.cuda.synchronize()
        check(sorted(offline.graphs.graphs) == sorted(artifacts),
              f"[export] {len(offline.graphs.graphs)} graphs kept after a second install")
        allocated.append(torch.cuda.memory_allocated())
    check(allocated[1] == allocated[0],
          f"[export] device memory moved across repeated installs: {allocated} bytes")
    steps, runs = dict(offline.graphs.graphs), offline.warm_runs

    def refused(batch):
        raise RuntimeError("warm-up refused")

    last = list(execs)[-1]
    try:
        offline.install_executables({**execs, last: refused})
    except RuntimeError as e:
        check("warm-up refused" in str(e), f"[export] the failed install raised {e!r}")
    else:
        raise RuntimeError("check failed: [export] an install with a failing warm-up passed")
    torch.cuda.synchronize()
    check(all(offline.graphs.graphs[k] is steps[k] for k in steps)
          and len(offline.graphs.graphs) == len(steps) and offline.warm_runs == runs
          and torch.cuda.memory_allocated() == allocated[1],
          f"[export] a failed install changed the engine ({len(offline.graphs.graphs)} graphs, "
          f"{torch.cuda.memory_allocated()} bytes allocated against {allocated[1]})")
    reqs_again, _ = serve_all(offline, samples, budgets, settings)
    same_results(reqs_live, reqs_again, "[export] after the failed install")
    log(f"[export] two more installs kept {len(steps)} graphs with {allocated[1]} bytes "
        f"allocated each time; an install whose last warm-up failed released its "
        f"{len(steps) - 1} new graph(s) and left the outputs bit for bit")
    # a bin served from the live forward's graph and from the loaded
    # program's, in turns: host pack + one copy + replay + output copy,
    # and the replay's device time (profiler)
    timing = {}
    for spec in budgets:
        key = (spec.num_nodes, spec.num_edges, spec.num_graphs)
        host = live.collate_bin(samples[:4], spec)
        row = {}
        for name, eng in (("live", live), ("loaded", offline), ("live_again", live),
                          ("loaded_again", offline)):
            serve_bin = lambda: [o.clone() for o in eng.graphs.replay(key, [host])]  # noqa: E731
            row[f"{name}_served_ms"] = eager_ms(serve_bin)
            row[f"{name}_device_ms"] = device_profile(
                serve_bin, (cfg.num_conv_layers, 0), f"[export] {name} bin").get("device_ms")
        timing[f"n{spec.num_nodes}_e{spec.num_edges}"] = row
        log(f"[export] a bin at {key}, live forward vs loaded program in turns: served "
            + ", ".join(f"{row[f'{n}_served_ms']:.3f}" for n in ("live", "loaded", "live_again",
                                                                    "loaded_again"))
            + " ms; device " + ", ".join(
                "not measured" if row[f"{n}_device_ms"] is None else f"{row[f'{n}_device_ms']:.3f}"
                for n in ("live", "loaded", "live_again", "loaded_again")) + " ms")
    rec = records[0]
    host = offline.collate_bin([q.sample for q in rec["reqs"]], rec["spec"])
    cpu_fn = load_exported(artifacts[rec["key"]], device="cpu")
    cpu_out = cpu_fn(host.to("cpu"))[0].numpy()[: len(rec["reqs"])]
    served = np.stack([q.result[0] for q in rec["reqs"]])
    scale = float(np.abs(cpu_out).max())
    np.testing.assert_allclose(served, cpu_out, **CPU_TOL)
    np.testing.assert_allclose(served, cpu_out, rtol=1e-4, atol=1e-4 * scale)
    log(f"[export] the artifact's CPU program on bin {rec['key']} vs the card: max|err| "
        f"{float(np.abs(served - cpu_out).max()):.3g}, max|ref| {scale:.3g}")
    live.close()
    offline.close()
    return {"k1": launches, "bins": len(records), "artifacts": info, "load_s": load_s,
            "install_s": install_s, "bin_timing": timing}


def phase_loadbench(samples):
    """run_load_bench on the headline SchNet (qm9 histogram, 256 requests,
    the slice's serving settings) on the card: every gate held, no
    capture after warm-up."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.serve.loadgen import run_load_bench

    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    edge_pipeline_planned.launches = 0
    rep = run_load_bench(histogram="qm9", n_requests=N_REQUESTS, deadline_ms=25.0,
                         batch_size=32, max_open_bins=4, seed=0,
                         model_bits=(model, cfg, None), device="cuda")
    launches = edge_pipeline_planned.launches
    check(rep["ok"], f"[loadbench] gates failed: {rep['gates']} (p99 {rep['p99_ms']} ms vs "
          f"{rep['tail_budget_ms']} ms, captures after warm-up {rep['post_warmup_compiles']})")
    check(launches > 0 and launches % cfg.num_conv_layers == 0,
          f"[loadbench] K1 launched {launches} times (want {cfg.num_conv_layers} per bin)")
    log(f"[loadbench] {rep['requests']} qm9 requests offered at {rep['offered_rate_hz']} /s "
        f"(2 x the calibrated rate), budgets {rep['budgets']}: p50 {rep['p50_ms']} ms, p99 "
        f"{rep['p99_ms']} ms (tail budget {rep['tail_budget_ms']} ms), "
        f"{rep['graphs_per_sec']} graphs/s, slot waste {rep['slot_waste']}, node fill "
        f"{rep['node_fill']}, edge fill {rep['edge_fill']}, dispatch reasons "
        f"{rep['dispatch_reasons']}; captures after warm-up "
        f"{rep['post_warmup_compiles']}; gates {rep['gates']}; K1 launches {launches} "
        f"(warm-up probe and stream, {cfg.num_conv_layers} a bin)")
    rep["k1"] = launches
    return rep


def graftboard_fleet(path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    try:
        import graftboard
    finally:
        sys.path.pop(0)
    return graftboard.build_fleet(path)


def rollover_drill(model, cfg):
    """__graft_entry__.py's serving_rollover_drill on the card with the
    headline SchNet: a 2-replica tier rolls over to the same snapshot
    while a stream is served (the shadows capture while the old engines
    replay), then refuses a NaN snapshot."""
    import threading

    import numpy as np

    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve import AdmissionError, ServingTier
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.fleet import FleetSettings
    from hydragnn_tpu_torch.serve.loadgen import synthetic_request_samples

    samples = synthetic_request_samples("qm9", 64, seed=5)
    settings = ServingSettings(enabled=True, deadline_ms=15.0, max_open_bins=2, batch_size=4)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), settings, seed=0)
    tier = ServingTier(model, cfg, None, budgets, example=samples[0], settings=settings,
                       fleet=FleetSettings(replicas=2), device="cuda")
    try:
        def probe(batch):
            out = []
            for s in batch:
                fr = tier.submit(s)
                t_limit = time.monotonic() + 20.0
                while not fr.done and time.monotonic() < t_limit:
                    time.sleep(0.002)
                check(fr.result is not None, f"[fleet] probe request {fr.fleet_id} never "
                      f"resolved (shed={fr.shed}, reason={fr.shed_reason})")
                out.append(np.asarray(fr.result[0]).copy())
            return out

        before = probe(samples[:8])
        stream = []

        def drive():
            for s in samples[8:48]:
                stream.append(tier.submit(s))
                time.sleep(0.004)

        feeder = threading.Thread(target=drive, daemon=True)
        feeder.start()
        time.sleep(0.02)
        row = tier.rollover(model.state_dict())
        feeder.join(timeout=60)
        t_limit = time.monotonic() + 30.0
        while not all(r.done for r in stream) and time.monotonic() < t_limit:
            time.sleep(0.005)
        lost = [r.fleet_id for r in stream if r.result is None]
        check(not lost and len(stream) == 40,
              f"[fleet] {len(lost)}/{len(stream)} requests lost across the swap")
        check(row["drained"], f"[fleet] old generation(s) {row['undrained']} never drained")
        after = probe(samples[:8])
        check(all(np.array_equal(a, b) for a, b in zip(before, after)),
              "[fleet] outputs changed across the rollover (same snapshot)")
        bad = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v
               for k, v in model.state_dict().items()}
        try:
            tier.rollover(bad)
        except AdmissionError:
            pass
        else:
            raise RuntimeError("check failed: [fleet] a NaN snapshot was admitted")
        check(tier.rollovers == 1, f"[fleet] {tier.rollovers} rollovers after a refusal")
        untouched = probe(samples[:8])
        check(all(np.array_equal(a, b) for a, b in zip(before, untouched)),
              "[fleet] outputs changed after a refused rollover")
    finally:
        tier.close()
    log(f"[fleet] rollover drill: {len(stream)} requests served across the swap (0 lost; the "
        f"shadows warmed and captured in {row['warm_ms']} ms while the old engines served, "
        f"total {row['total_ms']} ms), outputs bit for bit across the swap, a NaN snapshot "
        f"refused with the old outputs bit for bit")
    return row


def phase_fleet():
    """run_fleet_bench as __graft_entry__.py's fleet_serving_drill sets it
    up (zinc_skew, 60 requests, 3 replicas, spec_affinity, replica 1
    killed at 0.4 of the stream) on the headline SchNet on the card, with
    per-replica telemetry shards read back by graftboard's fleet view;
    then the rollover drill."""
    import tempfile

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.serve.loadgen import run_fleet_bench

    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    with tempfile.TemporaryDirectory(prefix="fleet_shards_") as tdir:
        edge_pipeline_planned.launches = 0
        rep = run_fleet_bench(histogram="zinc_skew", n_requests=60, deadline_ms=30.0,
                              batch_size=6, replicas=3, policy="spec_affinity", seed=2,
                              kill_replica=1, kill_after_frac=0.4,
                              telemetry_base=os.path.join(tdir, "telemetry.jsonl"),
                              model_bits=(model, cfg, None), device="cuda")
        launches = edge_pipeline_planned.launches
        check(rep["ok"], f"[fleet] gates failed: {rep['gates']} (p99_recovery "
              f"{rep['p99_recovery_ms']} ms vs {rep['tail_budget_ms']} ms, router "
              f"{rep['router']})")
        fl = graftboard_fleet(tdir)
    sv = fl.get("serving")
    check(sv is not None, "[fleet] graftboard rendered no serving section from the shards")
    check(1 in [int(d) for d in fl["heartbeats"]["dead"]],
          f"[fleet] graftboard did not find replica 1 dead (dead={fl['heartbeats']['dead']})")
    check(not sv["dead_without_reroute"],
          f"[fleet] dead replica(s) {sv['dead_without_reroute']} have no reroute row")
    check(launches > 0 and launches % cfg.num_conv_layers == 0,
          f"[fleet] K1 launched {launches} times (want {cfg.num_conv_layers} per bin)")
    log(f"[fleet] 3 replicas (threads sharing the card), spec_affinity, {rep['requests']} "
        f"zinc_skew requests at {rep['offered_rate_hz']} /s, replica 1 killed at 0.4: gates "
        f"{rep['gates']}; p50 {rep['p50_ms']} ms, p99 {rep['p99_ms']} ms, p99 after "
        f"detection {rep['p99_recovery_ms']} ms (tail budget {rep['tail_budget_ms']} ms); "
        f"router {json.dumps(rep['router'])}; captures after warm-up "
        f"{rep['post_warmup_compiles']}; graftboard: dead {fl['heartbeats']['dead']}, "
        f"reroutes {sv['reroutes']}, dead without reroute {sv['dead_without_reroute']}; "
        f"K1 launches {launches}")
    drill = rollover_drill(model, cfg)
    return {"k1": launches, "report": {k: rep[k] for k in (
        "offered_rate_hz", "wall_s", "p50_ms", "p99_ms", "p99_recovery_ms", "tail_budget_ms",
        "gates", "router", "post_warmup_compiles")}, "rollover": drill}


def bcc_config(path, precision="fp32"):
    """tests/inputs/ci.json's data, targets and training settings (batch 32,
    AdamW at 0.01) with bench.py's full-width SchNet, for two epochs."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "chip_smoke_bcc", "format": "unit_test",
            "compositional_stratified_splitting": True, "path": {"total": path},
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                              "column_index": [0, 6, 7]},
            "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1], "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": dict(FULL_WIDTH_ARCH),
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["sum_x_x2_x3"],
                "output_index": [0], "type": ["graph"], "denormalize_output": False,
            },
            "Training": {
                "num_epoch": 2, "perc_train": 0.7, "loss_function_type": "mse",
                "batch_size": 32, "precision": precision,
                "Optimizer": {"type": "AdamW", "learning_rate": 0.01},
                # "auto" would pack this set (budgets 160/704/65 and
                # 80/352/33, PERF.md section 4); the phase keeps the
                # ladder batches its first-step check and the kernel
                # phases' train bins are taken from.
                "Parallelism": {"packing": {"enabled": False}},
            },
        },
    }


def assert_close_scaled(got, ref, tol, what, scale=None):
    """``got`` equals ``ref`` at ``tol``'s rtol and its atol times
    ``scale`` (``ref``'s largest magnitude unless given; never more than
    the atol itself). Returns (largest error, largest |ref|)."""
    import numpy as np

    scale = float(np.abs(ref).max()) if scale is None else scale
    check(scale > 0, f"{what}: reference is all zeros")
    np.testing.assert_allclose(got, ref, rtol=tol["rtol"],
                               atol=tol["atol"] * min(scale, 1.0), err_msg=what)
    return float(np.abs(got - ref).max()), scale


def one_step(model, cfg, training, batch, compute_dtype):
    """One AdamW step of ``model`` on ``batch``: (loss, {name: grad},
    {name: updated parameter}) on the host."""
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg, compute_dtype)
    _, loss, _ = step(TrainState(model, opt), batch)
    grads = {k: p.grad.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    params = {k: p.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    return float(loss), grads, params


@contextlib.contextmanager
def recorded_run():
    """While open, every step dispatch of the train loop and the test
    pass (``train.loop._dispatch``, eager or replayed) is recorded: its
    model forwards (one a step, ``rec["forwards"]``), each train step's
    loss kept on the card (``rec["losses"]``, [K] per dispatch, read
    after the run), each train batch's shape (nodes, edges, graphs;
    ``rec["shapes"]``) and the steps' kinds (their graph-cache keys'
    first two entries, ``rec["keys"]``)."""
    from hydragnn_tpu_torch.train import loop

    rec = {"forwards": 0, "losses": [], "shapes": [], "keys": set()}
    plain_dispatch = loop._dispatch

    def recorded(run, graphs, key, batches, device, **kw):
        out = plain_dispatch(run, graphs, key, batches, device, **kw)
        rec["forwards"] += len(batches)
        rec["keys"].add(tuple(key[:2]))
        if "train" in key[:2]:  # the single scheme's ("train", ...), dp's ("dp", "train", ...)
            rec["losses"].append(out[0].clone())
            rec["shapes"] += [(b.num_nodes, b.num_edges, b.num_graphs) for b in batches]
        return out

    loop._dispatch = recorded
    try:
        yield rec
    finally:
        loop._dispatch = plain_dispatch


@contextlib.contextmanager
def timed_calls(module, names):
    """While open, each named callable of ``module`` adds its wall
    seconds (between device synchronizations) to ``times[name]``."""
    times = {n: 0.0 for n in names}
    plain = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                times[name] += time.perf_counter() - t0
        return timed

    for n in names:
        setattr(module, n, wrap(n, plain[n]))
    try:
        yield times
    finally:
        for n in names:
            setattr(module, n, plain[n])


@contextlib.contextmanager
def eager_steps():
    """While open, run_training and run_prediction build no graph cache,
    so they issue every step eagerly: the baseline the replayed runs are
    timed against (the port itself has no such switch)."""
    from hydragnn_tpu_torch import runner

    plain = runner._step_graphs
    runner._step_graphs = lambda dev: None
    try:
        yield
    finally:
        runner._step_graphs = plain


def eager_seconds(fn):
    """Seconds of ``fn()`` (a run_training call) with every step eager."""
    with eager_steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def graph_report(tag, state, hist, train_s, eager_s, steady=None):
    """Hold and print what a run's graph cache did: every step went
    through it (replays, one capture per key, none twice), and with
    ``steady`` the epochs from that one on captured nothing new. A run
    whose plan keeps its steps eager (``state.eager_reason``: FSDP2, gloo)
    prints that decision instead. Returns the numbers for the report
    line."""
    graphs = state.graphs
    if graphs is None and state.eager_reason:
        log(f"[{tag}] run_training {train_s:.2f} s with every step eager by the scheme's "
            f"decision ({state.eager_reason}); epochs "
            f"{[round(x, 3) for x in hist.epoch_seconds]} s")
        return {"seconds": train_s, "eager": state.eager_reason,
                "epoch_seconds": hist.epoch_seconds}
    check(graphs is not None and graphs.replays > 0 and graphs.captures > 0,
          f"{tag}: the run's steps were not replayed from CUDA graphs")
    check(graphs.captures == len(graphs.graphs),
          f"{tag}: {graphs.captures} captures for {len(graphs.graphs)} graphs")
    if steady is not None:
        check(not any(hist.epoch_captures[steady:]),
              f"{tag}: captures per epoch {hist.epoch_captures}: the steady state "
              f"(epoch {steady} on) captured anew")
    mem = graphs.memory()
    out = {"seconds": train_s, "eager_seconds": eager_s, "captures": graphs.captures,
           "capture_seconds": graphs.capture_seconds, "replays": graphs.replays,
           "eager_steps": graphs.eager_runs, "epoch_captures": hist.epoch_captures,
           "epoch_seconds": hist.epoch_seconds,
           "graph_pool_bytes": mem["pool_bytes"], "keys": [list(map(str, k))
                                                           for k in graphs.graphs]}
    log(f"[{tag}] run_training {train_s:.2f} s with its steps replayed ({graphs.eager_runs} "
        f"eager first sights, {graphs.captures} captures in {graphs.capture_seconds:.2f} s, "
        f"{graphs.replays} replays; captures per epoch {hist.epoch_captures}; "
        f"{mem['graphs']} graphs whose pools reserved {mem['pool_bytes'] / 2**20:.1f} MiB; "
        f"epochs {[round(x, 3) for x in hist.epoch_seconds]} s) against {eager_s:.2f} s for "
        f"the same run_training with every step eager")
    return out


def phase_train(config, splits):
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    stages = ("_ingest_datasets", "update_config", "create_model_config", "resolve_packing",
              "GraphLoader", "select_optimizer", "_step_graphs", "train_validate_test")
    with recorded_run() as rec, timed_calls(runner, stages) as first_run:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k1, k2, n_fwd = (edge_pipeline_planned.launches,
                         edge_pipeline_bwd_planned.launches, rec["forwards"])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        rec["forwards"] = 0
        err, _, trues, preds = port.run_prediction(full, state=state, model=model, cfg=cfg)
        torch.cuda.synchronize()
        k1_pred, k2_pred, n_fwd_pred = (edge_pipeline_planned.launches,
                                        edge_pipeline_bwd_planned.launches, rec["forwards"])
    eager_s, _ = eager_seconds(lambda: port.run_training(config, device="cuda"))
    graphs = graph_report("train", state, hist, train_s, eager_s)
    log(f"[train] the process's first run_training ({train_s:.2f} s) by call: "
        + ", ".join(f"{n} {t:.3f} s" for n, t in first_run.items())
        + f"; the rest {train_s - sum(first_run.values()):.3f} s")
    layers = cfg.num_conv_layers
    steps = torch.cat(rec["losses"]).double().cpu().numpy()
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [err]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"non-finite loss in {losses} or in the steps {steps.tolist()}")
    check(len(steps) == state.step, f"{len(steps)} step losses for {state.step} steps")
    check(hist.train_loss[-1] < hist.train_loss[0] and hist.train_loss[-1] < steps[0],
          f"train loss did not fall: epoch means {hist.train_loss}, first step {steps[0]}")
    check(k2 == layers * state.step and state.step > 0,
          f"K2 launched {k2} times in {state.step} train steps (want {layers} per step)")
    check(k1 == layers * n_fwd, f"K1 launched {k1} times in {n_fwd} forwards")
    check(k1_pred == layers * n_fwd_pred and k2_pred == 0 and n_fwd_pred > 0,
          f"run_prediction: K1 {k1_pred}, K2 {k2_pred}, {n_fwd_pred} forwards")
    check(np.isfinite(preds[0]).all() and preds[0].shape == trues[0].shape,
          "run_prediction: bad predictions")
    log(f"[train] run_training on the card ({train_s:.2f} s, {state.step} train steps, "
        f"{n_fwd} forwards): train loss {hist.train_loss}, val {hist.val_loss}, "
        f"test {hist.test_loss}; the last epoch's mean train loss is below the first "
        f"epoch's and below the first step's loss {steps[0]:.6g}")
    log(f"[train] per-step train loss: {[float(f'{x:.4g}') for x in steps]} "
        f"(largest {steps.max():.4g} at step {int(steps.argmax())})")
    log(f"[train] K2 launches {k2} = {layers} x {state.step} train steps; K1 launches "
        f"{k1} = {layers} x {n_fwd} forwards")
    log(f"[train] run_prediction: error {err:.6g} over {trues[0].shape[0]} graphs, "
        f"K1 launches {k1_pred} = {layers} x {n_fwd_pred} forwards, K2 0")

    # The first train step on the card against the CPU's plain path.
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    batch = next(iter(GraphLoader(splits[0], 32, shuffle=True, seed=0, fixed_pad="auto")))
    model0, cfg = create_model_config(full, "cuda", seed=0)
    parity = {}
    for precision, dtype, tol in (("fp32", torch.float32, VJP_TOL),
                                  ("bf16", torch.bfloat16, BF16_TOL)):
        card = one_step(copy.deepcopy(model0), cfg, training, batch.to("cuda"), dtype)
        cpu = one_step(copy.deepcopy(model0).to("cpu"), cfg, training, batch, dtype)
        worst = {"loss": assert_close_scaled(np.asarray(card[0]), np.asarray(cpu[0]),
                                             F32_TOL if dtype == torch.float32 else tol,
                                             f"{precision} loss")}
        for what, i in (("grad", 1), ("param", 2)):
            errs = [assert_close_scaled(card[i][k], cpu[i][k], tol, f"{precision} {what} {k}")
                    for k in cpu[i]]
            worst[what] = max(errs)
        worst["loss_value"] = card[0]
        parity[precision] = worst
        log(f"[train] first step, card vs CPU plain path, {precision}: loss {card[0]:.6g} vs "
            f"{cpu[0]:.6g}; worst |err| (|ref|) grads {worst['grad'][0]:.3g} "
            f"({worst['grad'][1]:.3g}), updated params {worst['param'][0]:.3g} "
            f"({worst['param'][1]:.3g}); rtol {tol['rtol']}, atol {tol['atol']} x "
            f"min(max|ref|, 1)")
        if precision == "fp32":
            again = one_step(copy.deepcopy(model0), cfg, training, batch.to("cuda"), dtype)
            same = again[0] == card[0] and all(
                np.array_equal(again[2][k], card[2][k]) for k in card[2])
            log(f"[train] two identical f32 steps on the card give "
                f"{'the same bits' if same else 'different bits'} (loss and parameters; "
                f"the h[snd] gather's backward adds with atomics)")
    log(f"[train] run_training's first step loss {steps[0]:.6g}; the f32 parity step "
        f"above (same model seed, same first batch) {parity['fp32']['loss_value']:.6g}")
    return {"k1": k1, "k2": k2, "steps": state.step, "forwards": n_fwd,
            "step_losses": steps.tolist(),
            "train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "test_loss": hist.test_loss, "prediction_error": err, "seconds": train_s,
            "graphs": graphs, "first_run_seconds": first_run, "parity": parity}


def molecules(n_configs, n_lo, n_hi, radius, max_neighbours, seed=0, forces=False,
              atomic_numbers=False):
    """bench.py's random molecules (``_molecules``), from the same seeded
    generator in its order of draws, with the port's radius graph:
    ``atomic_numbers`` draws node features 1..8 (else 0..4), ``forces``
    an energy and forces (else a graph target)."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_configs):
        n = int(rng.integers(n_lo, n_hi))
        pos = rng.uniform(0, 2.2 * n ** (1 / 3), size=(n, 3))
        lo, hi = (1, 9) if atomic_numbers else (0, 5)
        x = rng.integers(lo, hi, size=(n, 1)).astype(np.float32)
        ei = radius_graph(pos, radius, max_neighbours=max_neighbours)
        if forces:
            kw = {"energy": float(rng.normal()),
                  "forces": rng.normal(size=(n, 3)).astype(np.float32) * 0.1}
        else:
            kw = {"y_graph": np.array([rng.normal()], dtype=np.float32)}
        out.append(GraphSample(x=x, pos=pos.astype(np.float32), edge_index=ei, **kw))
    return out


def headline_batch():
    """bench.py's headline train batch: 128 molecules, collated with the
    block plan, on the host."""
    from hydragnn_tpu_torch.data.graph import PadSpec, collate

    samples = molecules(128, 9, 30, 4.0, 32, seed=0)
    return collate(samples, PadSpec.for_samples(samples), with_segment_plan=True)


def phase_train_timing(cpu_batch):
    """One train step at bench.py's headline shape: the card's step
    against the CPU's plain path, then eager time, device time from the
    profiler, and K1's and K2's share of it."""
    import numpy as np

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    batch = cpu_batch.to("cuda")
    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    training = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
    card = one_step(copy.deepcopy(model), cfg, training, batch, torch.float32)
    cpu = one_step(copy.deepcopy(model).to("cpu"), cfg, training, cpu_batch, torch.float32)
    loss_err = assert_close_scaled(np.asarray(card[0]), np.asarray(cpu[0]), F32_TOL,
                                   "headline loss")
    worst = {what: max(assert_close_scaled(card[i][k], cpu[i][k], VJP_TOL,
                                           f"headline {what} {k}") for k in cpu[i])
             for what, i in (("grad", 1), ("param", 2))}
    log(f"[train] headline step, card vs CPU plain path, fp32: loss {card[0]:.6g} vs "
        f"{cpu[0]:.6g} (|err| {loss_err[0]:.3g}); worst |err| (|ref|) grads "
        f"{worst['grad'][0]:.3g} ({worst['grad'][1]:.3g}), updated params "
        f"{worst['param'][0]:.3g} ({worst['param'][1]:.3g}); rtol 1e-4, atol 1e-3 x "
        f"min(max|ref|, 1)")
    model0 = copy.deepcopy(model)
    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg)
    state = TrainState(model, opt)
    e_valid = int(batch.edge_mask.sum())
    eager = eager_ms(lambda: step(state, batch), iters=20, warmup=3)
    prof = device_profile(lambda: step(state, batch), per_call=(4, 4), what="headline step")
    out = {"graphs": int(batch.graph_mask.sum()), "nodes": batch.num_nodes,
           "edges": batch.num_edges, "e_valid": e_valid, "eager_ms": eager,
           "cpu_parity": {"loss": loss_err[0], "grad": worst["grad"][0],
                          "param": worst["param"][0]}}
    out.update(prof)
    log(f"[train] one f32 train step at the headline shape (128 molecules, "
        f"{batch.num_nodes} nodes, {e_valid} edges; padded {batch.num_edges}): "
        f"{eager:.3f} ms issued eagerly, " + profile_note(prof, eager, "step"))
    return out, (model0, cfg, training)


def device_kernels(prof):
    """The kernels a ``torch.profiler`` run recorded on the device. The
    ranges user annotations leave on the device's timeline (such as
    ``Optimizer.step#AdamW.step``, which spans the optimizer's kernels)
    are not kernels and would count those kernels twice."""
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    check(not any(e.name.startswith("Optimizer.") for e in kernels),
          "the profiler's user-annotation ranges were not told apart from kernels")
    return kernels


def device_profile(fn, per_call, what, n_prof=5):
    """Device time of one call of ``fn`` from ``torch.profiler`` over
    ``n_prof`` calls: all kernels, K1's and K2's (with its finishing
    kernel), and kernels per call; checks that each call launches
    ``per_call`` = (K1, K2) kernels. Empty when the profiler recorded no
    device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    got = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
    check(got == (per_call[0] * n_prof, per_call[1] * n_prof),
          f"{what}: K1/K2 launched {got} in {n_prof} calls, want {per_call} per call")
    kernels = device_kernels(prof)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_prof
    if busy <= 0:
        return {}
    k1 = sum(e.time_range.elapsed_us() for e in kernels
             if "edge_pipeline_kernel<" in e.name) / 1e3 / n_prof
    k2 = sum(e.time_range.elapsed_us() for e in kernels
             if "edge_pipeline_bwd_kernel<" in e.name or "bwd_finish_kernel<" in e.name
             ) / 1e3 / n_prof
    # the sorted index_put_ that x[idx]'s backward runs (serial on equal
    # indices)
    indexing = [e for e in kernels if "indexing_backward_kernel" in e.name]
    return {"device_ms": busy, "k1_ms": k1, "k2_ms": k2,
            "kernels_per_call": len(kernels) // n_prof,
            "indexing_backward_ms": sum(e.time_range.elapsed_us() for e in indexing)
            / 1e3 / n_prof,
            "indexing_backward_per_call": len(indexing) // n_prof}


def profile_note(prof, eager, unit):
    if not prof:
        return "device time not measured (the profiler recorded no kernels)"
    busy, k1, k2 = prof["device_ms"], prof["k1_ms"], prof["k2_ms"]
    return (f"{busy:.3f} ms of device time (profiler, {prof['kernels_per_call']} kernels "
            f"per {unit}); K1 {k1:.3f} ms ({100 * k1 / busy:.1f}%), K2 {k2:.3f} ms "
            f"({100 * k2 / busy:.1f}%) of it; the device idles "
            f"{100 * (1 - busy / eager):.0f}% of the eager {unit}")


# ---------------------------------------------------------------- [mlip]

PAINN_WIDTHS = (1, 3, 64, 192)  # layer 0 (scalar, vector), layers 1-2


def md17_frames(n_frames=400, seed=0):
    """examples/md17/md17.py's MD17 stand-in (``synthetic_md17``), from
    the same seeded generator, with the port's radius graph: thermal
    perturbations of one random 21-atom molecule (aspirin's size), with
    energies and analytic forces of a Morse pair potential (D 0.5, a 1.2,
    r0 1.8), so the forces are the energy's gradient as in MD17."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    n_atoms, depth, width, r0 = 21, 0.5, 1.2, 1.8

    def morse(pos):
        diff = pos[:, None, :] - pos[None, :, :]
        d = np.linalg.norm(diff, axis=-1)
        np.fill_diagonal(d, np.inf)
        ex = np.exp(-width * (d - r0))
        energy = float((depth * (1.0 - ex) ** 2).sum() / 2.0)
        dedr = 2.0 * depth * width * (1.0 - ex) * ex
        with np.errstate(invalid="ignore"):
            unit = np.where(np.isfinite(d[..., None]), diff / d[..., None], 0.0)
        return energy, (-(dedr[..., None] * unit).sum(axis=1)).astype(np.float32)

    rng = np.random.default_rng(seed)
    z = rng.choice([1, 6, 8], n_atoms, p=[0.4, 0.45, 0.15]).astype(np.float32)
    base = rng.uniform(0, 2.2 * n_atoms ** (1 / 3), (n_atoms, 3))
    out = []
    for _ in range(n_frames):
        pos = (base + rng.normal(scale=0.12, size=base.shape)).astype(np.float32)
        energy, forces = morse(pos)
        out.append(GraphSample(x=z.reshape(-1, 1), pos=pos, energy=energy, forces=forces,
                               edge_index=radius_graph(pos, 4.0, max_neighbours=24)))
    return out


def closest_pair(samples):
    """The smallest distance between two atoms of one sample."""
    import numpy as np

    out = np.inf
    for s in samples:
        d = np.linalg.norm(s.pos[:, None, :] - s.pos[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        out = min(out, float(d.min()))
    return out


def mlip_data():
    """examples/md17/md17.json (its Simulation section is ignored) cut to
    2 epochs in f32, with two data sets split by its perc_train: bench.py's
    ``painn_md17_mlip`` molecules (``_molecules(256, 19, 24, 4.0, 32,
    seed=1, forces=True, atomic_numbers=True)``, bench.py:2497; random
    energies and forces) and examples/md17/md17.py's 400-frame MD17
    stand-in (Morse energies and their forces)."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "md17",
                        "md17.json")
    with open(path) as f:
        config = json.load(f)
    config["Verbosity"] = {"level": 0}
    training = config["NeuralNetwork"]["Training"]
    training["num_epoch"] = 2
    training["precision"] = "fp32"
    perc = float(training["perc_train"])
    t0 = time.perf_counter()
    samples = molecules(256, 19, 24, 4.0, 32, seed=1, forces=True, atomic_numbers=True)
    splits = split_dataset(samples, perc)
    md17 = split_dataset(md17_frames(), perc)
    log(f"[mlip] md17.json's PaiNN (hidden 64, 3 layers, num_radial 20, radius 4.0, "
        f"graph head 1x64 + [64, 64], add pooling; energy_weight 1, force_weight 10; "
        f"AdamW 0.002, batch 32), 2 epochs f32; bench's molecules: 256 of 19-23 atoms "
        f"(seed 1; closest atom pair {closest_pair(samples):.3f}), splits "
        f"{[len(x) for x in splits]}; MD17 stand-in: 400 frames of 21 atoms (closest "
        f"pair {closest_pair(md17[0]):.3f}), splits {[len(x) for x in md17]}; made in "
        f"{time.perf_counter() - t0:.2f} s")
    return config, splits, md17


def train_loader(config, trainset, plan=True):
    """The train loader run_training builds for ``config`` at seed 0, and
    its packed budgets (None where "auto" keeps the ladder): packing
    resolved as the runner resolves it. Without ``plan`` the same batches
    keep their edges in collation order and carry no block plan
    (aggregation takes the scatter, another summation order)."""
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import needs_triplets
    from hydragnn_tpu_torch.runner import packing_settings, resolve_packing

    bs = int(config["NeuralNetwork"]["Training"]["batch_size"])
    trips = needs_triplets(config["NeuralNetwork"]["Architecture"]["mpnn_type"])
    pk = packing_settings(config)
    packed, budgets, slack = resolve_packing(pk, bs, trainset, 0, trips=trips)
    loader = GraphLoader(trainset, bs, shuffle=True, seed=0, fixed_pad="auto",
                         with_triplets=trips, with_segment_plan=plan, packing=packed,
                         pack_budgets=budgets, pack_max_budgets=pk["max_budgets"],
                         pack_slack=slack, pack_max_graphs=pk["max_graphs"])
    return loader, budgets


def budget_keys(budgets):
    return [(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets or ()]


def bwd_fn_card_vs_cpu(tag, plan, n, e, f_in, f_out, flavours, gen):
    """K2's operator (K2 forward, K1/K2 backward: the force pass and
    its derivative in an MLIP step) on the card against the CPU plain
    path on ``plan``, in each flavour: its first derivatives and their
    gradients with respect to g, a, b and W, each within VJP_TOL scaled
    by its largest |ref|; its backward launches K1."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    for stages in flavours:
        has_b, has_w = "b" in stages, "w" in stages
        prim = {"g": torch.randn(n, f_out if has_w else f_in, generator=gen),
                "a": torch.randn(e, f_in, generator=gen),
                "b": torch.randn(e, f_in, generator=gen),
                "w": torch.randn(f_in, f_out, generator=gen) / f_in ** 0.5}
        names = ["g", "a"] + (["b"] if has_b else []) + (["w"] if has_w else [])
        res, counts = [], None
        for where in ("cuda", "cpu"):
            ins = {k: prim[k].to(where).requires_grad_(True) for k in names}
            where_plan = [t.to(where) for t in plan]
            outs = [o for o in edge_pipeline_bwd_planned(
                ins["g"], ins["a"], ins.get("b"), ins.get("w"), *where_plan, n, 32, 64)
                if o is not None]
            cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)).to(where)
                   for i, o in enumerate(outs)]
            k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
            grads = torch.autograd.grad(outs, [ins[k] for k in names], cot,
                                        allow_unused=True)
            if where == "cuda":
                torch.cuda.synchronize()
                counts = (edge_pipeline_planned.launches - k1,
                          edge_pipeline_bwd_planned.launches - k2)
            res.append([o.detach().cpu() for o in outs]
                       + [None if x is None else x.detach().cpu() for x in grads])
        err = 0.0
        for i, (x, y) in enumerate(zip(*res)):
            check((x is None) == (y is None), f"double backward {stages}: output {i}")
            if x is not None:
                err = max(err, assert_close_scaled(x.numpy(), y.numpy(), VJP_TOL,
                                                   f"double backward {stages} {i}")[0])
        check(counts[0] > 0, f"double backward {stages}: no K1 launch")
        log(f"[{tag}] K2's operator {stages}, F {f_in} -> {f_out}: the first "
            f"derivatives and their gradients (g, a, b, W) card vs CPU plain path, max|err| "
            f"{err:.3g}; its backward launched K1 {counts[0]}, K2 {counts[1]}")


def phase_mlip_kernels(batch):
    """K1 and K2 in the reduce-only flavour at PaiNN's widths on the first
    packed MLIP train bin's plan: against their plain versions in f32 and bf16
    (same bits on two runs, zero rows off the plan), each width's launch
    shape, and the times at F = 64 and 192 (f32) beside the bound, the
    plain version and, for K1, index_add_. Then K2's operator (K2
    forward, K1/K2 backward) on the card against the CPU plain path in
    every flavour."""
    from hydragnn_tpu_torch.ops.cuda_build import load_library
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    lib = load_library()
    dev = batch.seg_perm.device
    gen = torch.Generator().manual_seed(5)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    n, e = batch.num_nodes, batch.num_edges
    e_valid = int(batch.edge_mask.sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    covered = torch.zeros(e, dtype=torch.bool, device=dev)
    covered[plan[0][plan[2]].long()] = True
    rows = []
    for f in PAINN_WIDTHS:
        shapes = {k: launch_shape(lib, k, n, e, f, f, 32, has_b=False, has_w=False)
                  for k in ("k1", "k2")}
        log(f"[mlip-kernels] F = {f} (n {n}, e {e}, {e_valid} valid): K1 {shapes['k1']}; "
            f"K2 {shapes['k2']}")
        for dt, tol, vjp_tol in ((torch.float32, F32_TOL, VJP_TOL),
                                 (torch.bfloat16, BF16_TOL, BF16_TOL)):
            a = torch.randn(e, f, generator=gen).to(dev, dt)
            g = torch.randn(n, f, generator=gen).to(dev, dt)
            args = (a, None, None, *plan, n)
            with torch.no_grad():
                got, again = edge_pipeline_planned(*args), edge_pipeline_planned(*args)
                ref = edge_pipeline_plain(*args)
            d_a, d_b, d_w = edge_pipeline_bwd_planned(g, *args)
            d_again = edge_pipeline_bwd_planned(g, *args)[0]
            d_ref = edge_pipeline_bwd_plain(g, *args)[0]
            torch.cuda.synchronize()
            name = mix_name(dt, dt)
            check(torch.equal(got, again) and torch.equal(d_a, d_again),
                  f"F={f} {name}: two runs differ")
            check(got.dtype == dt and d_a.dtype == dt and d_b is None and d_w is None,
                  f"F={f} {name}: output types")
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            torch.testing.assert_close(d_a.float(), d_ref.float(), **vjp_tol)
            check(not bool(d_a[~covered].any()), f"F={f} {name}: K2 nonzero off the plan")
            row = {"f": f, "dtype": name, "n": n, "e_valid": e_valid,
                   "k1_launch": shapes["k1"], "k2_launch": shapes["k2"],
                   "k1_max_abs_err": float((got.float() - ref.float()).abs().max()),
                   "k2_max_abs_err": float((d_a.float() - d_ref.float()).abs().max())}
            if f >= 64 and dt == torch.float32:
                with torch.no_grad():
                    row["k1_ms"] = time_ms(lambda: edge_pipeline_planned(*args))
                    row["k1_plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
                    a_valid = a[batch.edge_mask]
                    rcv_valid = batch.receivers[batch.edge_mask].long()
                    out = torch.zeros(n, f, dtype=dt, device=dev)
                    row["k1_library_ms"] = time_ms(
                        lambda: out.index_add_(0, rcv_valid, a_valid))
                    row["k2_ms"] = time_ms(lambda: edge_pipeline_bwd_planned(g, *args))
                    row["k2_plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(g, *args))
                    # the reduce-only pullback is one gather of g's rows
                    row["k2_library_ms"] = time_ms(
                        lambda: g.index_select(0, batch.receivers))
                nbytes, ops, out_dt = k1_work(e_valid, n, f, f, slots, blocks, dt, dt,
                                              False, False)
                row["k1_bound_ms"], row["k1_bound_by"] = bound(nbytes, ops, out_dt)
                nbytes, ops, g_dt = k2_work(e, e_valid, n, f, f, slots, blocks, dt, dt,
                                            False, False)
                row["k2_bound_ms"], row["k2_bound_by"] = bound(nbytes, ops, g_dt)
                log(f"[mlip-kernels] F = {f} f32: K1 {row['k1_ms'] * 1e3:.1f} us, plain "
                    f"{row['k1_plain_ms'] * 1e3:.1f} us, index_add_ "
                    f"{row['k1_library_ms'] * 1e3:.1f} us, bound "
                    f"{row['k1_bound_ms'] * 1e3:.2f} us ({row['k1_bound_by']}); K2 "
                    f"{row['k2_ms'] * 1e3:.1f} us, plain {row['k2_plain_ms'] * 1e3:.1f} us, "
                    f"index_select {row['k2_library_ms'] * 1e3:.1f} us, "
                    f"bound {row['k2_bound_ms'] * 1e3:.2f} us ({row['k2_bound_by']})")
            rows.append(row)
    log(f"[mlip-kernels] K1 and K2, reduce-only, F = {list(PAINN_WIDTHS)} in f32 and "
        f"bf16: {2 * len(rows)} comparisons passed (identical bits on two runs; K2 zero "
        f"off the plan)")

    bwd_fn_card_vs_cpu("mlip-kernels", plan, n, e, 64, 64, ("a", "ab", "aw", "abw"), gen)
    return rows


def mlip_step(model, cfg, training, batch, compute_dtype):
    """The first MLIP train step of ``model`` on ``batch``, on the host:
    graph energies and forces from the initial parameters, then one AdamW
    step on the energy + force loss (loss, per-task losses, gradients,
    updated parameters), and the K1/K2 launches of that step."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.mlip import energy_and_forces
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState, cast_batch

    def host(t):
        return t.detach().float().cpu().numpy()

    ge, forces = energy_and_forces(model, cast_batch(batch, compute_dtype), cfg,
                                   create_graph=False)
    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg, compute_dtype, compute_grad_energy=True)
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    _, loss, tasks = step(TrainState(model, opt), batch)
    launches = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
    return {"loss": host(loss), "tasks": host(tasks), "energies": host(ge),
            "forces": host(forces), "launches": launches,
            "grads": {k: host(p.grad if p.grad is not None else torch.zeros_like(p))
                      for k, p in model.named_parameters()},
            "params": {k: host(p) for k, p in model.named_parameters()}}


def mlip_step_timing(tag, model0, cfg, training, host_batch, per_step):
    """One f32 MLIP train step's eager time and, from the profiler, its
    device time, kernel count and K1's and K2's share, on ``host_batch``."""
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    batch = host_batch.to("cuda")
    timed = copy.deepcopy(model0)
    opt = select_optimizer(timed.parameters(), training)
    step = make_train_step(timed, opt, cfg, compute_grad_energy=True)
    state = TrainState(timed, opt)
    eager = eager_ms(lambda: step(state, batch), iters=20, warmup=3)
    prof = device_profile(lambda: step(state, batch), per_call=per_step,
                          what=f"{tag} step")
    e_valid = int(batch.edge_mask.sum())
    log(f"[{tag}] one f32 MLIP train step on the first train batch "
        f"({int(batch.graph_mask.sum())} graphs, {batch.num_nodes} nodes, {e_valid} "
        f"edges; padded {batch.num_edges}): {eager:.3f} ms issued eagerly, "
        + profile_note(prof, eager, "step"))
    return dict(prof, eager_ms=eager, nodes=batch.num_nodes, edges=batch.num_edges,
                e_valid=e_valid)


def mlip_run(config, splits, budgets, tag="mlip", data="bench's molecules", per_fwd=None,
             eager_baseline=True, keep=None):
    """run_training of an MLIP config on the card, then run_prediction on
    the test split: finite losses, energies and forces, every train batch
    a packed bin of ``budgets``, and K1/K2 launch counts: ``per_fwd`` of
    each per evaluation forward and twice that per train step (PaiNN's
    default: two per layer). Whether the last epoch's mean train loss
    fell below the first step's is reported, not held: on bench's random molecules (random
    force targets of ~0.1, atoms closer than half an angstrom, initial
    forces orders of magnitude larger than the targets) this config's
    loss does not fall within 2 epochs from every initialisation, in the
    JAX package either (PERF.md, PR 4). ``eager_baseline`` False skips
    the timing of the same run with every step eager; ``keep`` (a dict)
    receives the run's state, model, cfg, config and predictions."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    with recorded_run() as rec:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, datasets=splits,
                                                          device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k1, k2, n_fwd = (edge_pipeline_planned.launches,
                         edge_pipeline_bwd_planned.launches, rec["forwards"])
        steps = torch.cat(rec["losses"]).double().cpu().numpy()
        shapes = set(rec["shapes"])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        rec["forwards"] = 0
        err, tasks, trues, preds = port.run_prediction(full, datasets=splits, state=state,
                                                       model=model, cfg=cfg)
        torch.cuda.synchronize()
        k1_pred, k2_pred, n_fwd_pred = (edge_pipeline_planned.launches,
                                        edge_pipeline_bwd_planned.launches, rec["forwards"])
    if keep is not None:
        keep.update(state=state, model=model, cfg=cfg, full=full, preds=preds, err=err,
                    keys=rec["keys"])
    eager_s = None
    if eager_baseline:
        eager_s, _ = eager_seconds(lambda: port.run_training(config, datasets=splits,
                                                             device="cuda"))
    graphs = graph_report(tag, state, hist, train_s, eager_s)
    check(budgets is None or shapes <= set(budget_keys(budgets)),
          f"{data} train batches {sorted(shapes)} are not all packed bins "
          f"{budget_keys(budgets)}")
    # PaiNN's forward aggregates twice per layer (the scalar and the
    # folded vector message), each through K1; the force pass runs K2
    # once per aggregation, and a train step's backward K2 (the energy
    # loss through the forward) and K1 (K2's own backward) once more per
    # aggregation.
    if per_fwd is None:
        per_fwd = 2 * cfg.num_conv_layers
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [err]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"non-finite loss in {losses} or in the steps {steps.tolist()}")
    check(len(steps) == state.step > 0, f"{len(steps)} step losses for {state.step} steps")
    fell = hist.train_loss[-1] < steps[0]
    want = per_fwd * (n_fwd + state.step)
    check(k1 == want and k2 == want,
          f"run_training K1 {k1}, K2 {k2}, want {want} = {per_fwd} x ({n_fwd} "
          f"forwards + {state.step} train steps) each")
    check(k1_pred == k2_pred == per_fwd * n_fwd_pred and n_fwd_pred > 0,
          f"run_prediction K1 {k1_pred}, K2 {k2_pred} in {n_fwd_pred} forwards")
    n_test = len(splits[2])
    n_atoms = sum(s.num_nodes for s in splits[2])
    check(len(preds) == 2 and preds[0].shape == trues[0].shape == (n_test, 1)
          and preds[1].shape == trues[1].shape == (n_atoms, 3)
          and np.isfinite(preds[0]).all() and np.isfinite(preds[1]).all(),
          f"{data}: run_prediction wants finite energies [graphs, 1] and forces [atoms, 3]")
    log(f"[{tag}] {data}: run_training on the card ({train_s:.2f} s, {state.step} train "
        f"steps on {'packed bins' if budgets else 'batches'} {sorted(shapes)}, {n_fwd} forwards): train loss {hist.train_loss}, val {hist.val_loss}, "
        f"test {hist.test_loss}; the last epoch's mean train loss is "
        f"{'below' if fell else 'not below'} the first step's {steps[0]:.6g}")
    log(f"[{tag}] {data}: per-step train loss {[float(f'{x:.4g}') for x in steps]}")
    log(f"[{tag}] {data}: K1 launches {k1} and K2 launches {k2} = {per_fwd} x ({n_fwd} "
        f"forwards + {state.step} train steps): per train step {2 * per_fwd} of each, per "
        f"evaluation forward {per_fwd} of each")
    log(f"[{tag}] {data}: run_prediction error {err:.6g} (per task "
        f"{np.round(tasks, 6).tolist()}) over {n_test} samples, energies "
        f"{preds[0].shape}, forces {preds[1].shape}, all finite; K1 {k1_pred}, K2 "
        f"{k2_pred} = {per_fwd} x {n_fwd_pred} forwards")
    return {"k1": k1 + k1_pred, "k2": k2 + k2_pred, "steps": state.step,
            "forwards": n_fwd + n_fwd_pred, "step_losses": steps.tolist(),
            "train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "test_loss": hist.test_loss, "prediction_error": err, "seconds": train_s,
            "graphs": graphs, "loss_fell": bool(fell), "bins": sorted(shapes)}


def tensors(x, y):
    """(name, x, y) for each array of two like results: an array, or
    dicts of arrays by name."""
    if isinstance(x, dict):
        return [(k, x[k], y[k]) for k in y]
    return [("", x, y)]


def close_scaled(got, ref, tol):
    """``got`` equals ``ref`` as ``assert_close_scaled`` holds it."""
    import numpy as np

    scale = float(np.abs(ref).max())
    return bool(np.allclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0)))


def scaled_error(got, ref):
    """The largest |got - ref| over the largest |ref|."""
    import numpy as np

    scale = float(np.abs(ref).max())
    return float(np.abs(got - ref).max()) / scale if scale > 0 else float(np.abs(got).max())


N_FLOORS = 5  # card steps with the scatter in place of K1/K2 per first-step gate


def hold_mlip_step(tag, data, config, trainset, model0, cfg, training, precision, dtype, tol,
                   per_step, card_runs=1):
    """The first MLIP train step on the card against the CPU's plain path,
    on the first train batch run_training forms from ``trainset``, beside
    the same step on the card with the scatter (``index_add_``) in place
    of K1/K2, taken ``N_FLOORS`` times. Atoms closer than an angstrom give
    forces and gradients orders of magnitude above the targets, and then
    the card's other ops (matmuls, sin, sqrt) alone move the forces and
    gradients past [train]'s tolerances. So each result is held to
    ``tol`` or, where it misses, to 10 x the card's own floor: the median
    over the scatter steps of each step's largest error over the largest
    |ref| (each scatter step sums in its own atomic order, so one step's
    floor is one sample of that noise; the median of five does not hang
    on one lucky order). A wrong kernel is off by the whole result. The
    updated parameters are shown: AdamW's first step moves each entry by
    lr x sign(g), so an entry whose gradient is within that noise of zero
    flips on either step. Checks ``per_step`` = (K1, K2) launches in the
    card's step, none in the scatter and CPU steps.

    A stack whose own sums are ``index_add_`` (EGNN: no K1/K2 at all)
    makes the card's step one more sample of the same atomic noise, and
    near a ReLU's kink that noise is bimodal: an atomic order either
    keeps a unit on the CPU's side of the kink or flips it, and a flip
    moves the forces by ~1e-3 and the gradients by ~6e-5 of their
    largest, in about half the orders (so a median of five card steps
    against a median of five floors still fails a correct step). There
    ``card_runs`` card steps are taken and the card's error is the
    smallest of them: a correct implementation gives the CPU's result
    (within the rule) in some atomic orders, a wrong one in none. With
    one run (the K1/K2 paths, whose steps give the same bits every time)
    it is that run's."""
    import numpy as np

    what = f"{data} {precision}"
    planned = next(iter(train_loader(config, trainset)[0]))
    unplanned = next(iter(train_loader(config, trainset, plan=False)[0]))
    cards = [mlip_step(copy.deepcopy(model0), cfg, training, planned.to("cuda"), dtype)
             for _ in range(card_runs)]
    card = cards[0]
    scatters = [mlip_step(copy.deepcopy(model0), cfg, training, unplanned.to("cuda"), dtype)
                for _ in range(N_FLOORS)]
    cpu = mlip_step(copy.deepcopy(model0).to("cpu"), cfg, training, planned, dtype)
    check(all(c["launches"] == tuple(per_step) for c in cards)
          and all(sc["launches"] == (0, 0) for sc in scatters),
          f"{what} MLIP step: K1/K2 launched {[c['launches'] for c in cards]} (want "
          f"{tuple(per_step)}), without the plan {[sc['launches'] for sc in scatters]}")
    check(cpu["launches"] == (0, 0), "the CPU step launched a kernel")
    # energies are forward values; the loss is mostly the force term, a
    # function of first derivatives, as the rest are
    tols = {"loss": tol, "tasks": tol, "forces": tol, "grads": tol, "params": tol,
            "energies": F32_TOL if dtype == torch.float32 else tol}
    rows = {}
    for k, t in tols.items():
        oks = [all(close_scaled(a, b, t) for _, a, b in tensors(c[k], cpu[k])) for c in cards]
        errs = [max(scaled_error(a, b) for _, a, b in tensors(c[k], cpu[k])) for c in cards]
        ok, err = any(oks), min(errs)
        floors = [max(scaled_error(a, b) for _, a, b in tensors(sc[k], cpu[k]))
                  for sc in scatters]
        floor = float(np.median(floors))
        check(ok or k == "params" or err <= 10 * floor,
              f"{what} {k}: card vs CPU {err:.3g} x max|ref| (runs "
              f"{[float(f'{e:.3g}') for e in errs]}), outside the tolerance and above 10 x "
              f"the median scatter floor {floor:.3g} (floors "
              f"{[float(f'{f:.3g}') for f in floors]})")
        scale = max(float(np.abs(b).max()) for _, _, b in tensors(card[k], cpu[k]))
        rows[k] = (err, floor, ok, scale, floors, errs)
    log(f"[{tag}] first step, {data} (batch {planned.num_nodes} nodes, {planned.num_edges} "
        f"edges, {planned.num_graphs} graphs), card vs CPU plain path, {precision}: loss "
        f"{float(card['loss']):.6g} vs {float(cpu['loss']):.6g}; largest error / max|ref| "
        f"(median of {N_FLOORS} scatter floors), in rtol {tol['rtol']} atol {tol['atol']} x "
        f"min(max|ref|, 1), max|ref|: "
        + ", ".join(f"{k} {e:.3g} ({f:.3g}) {'yes' if ok else 'no'} {m:.3g}"
                    for k, (e, f, ok, m, _, _) in rows.items())
        + f"; K1 {card['launches'][0]}, K2 {card['launches'][1]} launches in the step")
    log(f"[{tag}] first step, {what}: the {N_FLOORS} scatter floors per result: "
        + "; ".join(f"{k} {[float(f'{x:.3g}') for x in fl]}"
                    for k, (_, _, _, _, fl, _) in rows.items()))
    if card_runs > 1:
        log(f"[{tag}] first step, {what}: the {card_runs} card steps' errors per result "
            f"(the smallest held): "
            + "; ".join(f"{k} {[float(f'{x:.3g}') for x in er]}"
                        for k, (_, _, _, _, _, er) in rows.items()))
    return rows


def phase_mlip(config, splits, md17_splits, budgets, first_batch):
    """md17.json's PaiNN potential trained by run_training on the card on
    bench's molecules, then run_prediction; the first MLIP train step on
    the card against the CPU plain path in f32 and bf16 with its launch
    counts (on the first train batch run_training forms from the MD17
    stand-in and from bench's molecules, the latter the first packed
    bin); the step's eager and device time on bench's first packed bin."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config

    run = mlip_run(config, splits, budgets)

    # The first MLIP train step on the card against the CPU's plain path,
    # on the first train batch of the MD17 stand-in and of bench's
    # molecules (hold_mlip_step).
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    per_fwd = 2 * cfg.num_conv_layers
    parity = {}
    for data, trainset in (("MD17 stand-in", md17_splits[0]), ("bench's molecules", splits[0])):
        for precision, dtype, tol in (("fp32", torch.float32, VJP_TOL),
                                      ("bf16", torch.bfloat16, BF16_TOL)):
            parity[f"{data} {precision}"] = hold_mlip_step(
                "mlip", data, config, trainset, model0, cfg, training, precision, dtype, tol,
                (2 * per_fwd, 2 * per_fwd))

    timing = mlip_step_timing("mlip", model0, cfg, training, first_batch,
                              (2 * per_fwd, 2 * per_fwd))
    return {"k1": run["k1"], "k2": run["k2"], "run": run, "parity": parity,
            "step_timing": timing, "step": (model0, cfg, training)}


# --------------------------------------------------------- [serve-forces]


def phase_serve_forces(mlip_config, md17_splits):
    """md17.json's PaiNN served with forces on the card over the MD17
    stand-in's frames (budgets fitted from their sizes): 6 K1 and 6 K2
    launches a bin; served energies and forces equal a direct
    energy_and_forces(create_graph=False) at each bin bit for bit, and
    the CPU plain path by [mlip]'s rule; the exported MLIP
    artifact per budget served through a fresh engine equals the live
    engine bit for bit; a full bin's and a one-request bin's device time
    with the indexing_backward_kernel share of each."""
    import numpy as np

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.graph import collate
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.export import export_inference
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.serve.engine import (
        ServingEngine,
        ServingSettings,
        fit_serving_budgets,
    )
    from hydragnn_tpu_torch.train.mlip import energy_and_forces

    config = update_config(copy.deepcopy(mlip_config), *md17_splits)
    model, cfg = create_model_config(config, "cuda", seed=0)
    frames = [s for split in md17_splits for s in split][:96]
    settings = ServingSettings(enabled=True, batch_size=32)
    budgets = fit_serving_budgets(*dataset_size_arrays(frames), settings)
    per_bin = 2 * cfg.num_conv_layers
    live = ServingEngine(model, cfg, None, budgets, example=frames[0], settings=settings,
                         with_forces=True, device="cuda")
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    reqs, records = serve_all(live, frames, budgets, settings)
    k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    check(k1 == k2 == per_bin * len(records),
          f"[serve-forces] K1 {k1}, K2 {k2} for {len(records)} bins (want {per_bin} each a bin)")
    for q, s in zip(reqs, frames):
        check(q.result[0].shape == () and q.result[1].shape == (s.num_nodes, 3)
              and all(bool(np.isfinite(r).all()) for r in q.result),
              f"[serve-forces] request {q.req_id}: bad result")
    for rec in records:
        batch = live.collate_bin([q.sample for q in rec["reqs"]], rec["spec"]).to("cuda")
        ge, forces = energy_and_forces(live.model, batch, cfg, create_graph=False)
        ge, forces = ge.detach().cpu().numpy(), forces.cpu().numpy()
        for gi, q in enumerate(rec["reqs"]):
            off, n = rec["offsets"][gi]
            check(np.array_equal(q.result[0], ge[gi])
                  and np.array_equal(q.result[1], forces[off:off + n]),
                  f"[serve-forces] bin {rec['key']}: served output differs from a direct "
                  f"energy_and_forces")
    log(f"[serve-forces] md17.json's PaiNN (hidden {cfg.hidden_dim}, {cfg.num_conv_layers} "
        f"layers) served with forces: {len(reqs)} MD17 stand-in frames in {len(records)} bins "
        f"of budgets {budget_keys(budgets)}, K1 {k1} = K2 {k2} = {per_bin} x {len(records)}; "
        f"every energy and force equals a direct energy_and_forces(create_graph=False) at "
        f"its bin bit for bit")
    # The first bin, card vs the CPU plain path. Close atoms give forces
    # far above the energies' scale, and then the card's other ops alone
    # move them past the tolerance: held by [mlip]'s rule, within the
    # tolerance or within 10 x the card's own floor (the median over
    # N_FLOORS card passes with index_add_ in place of K1/K2, each its
    # own atomic order, of the largest error over the largest |ref|).
    rec = records[0]
    group = [q.sample for q in rec["reqs"]]
    host = live.collate_bin(group, rec["spec"])
    cpu_model = copy.deepcopy(live.model).to("cpu")
    ge_c, f_c = energy_and_forces(cpu_model, host.to("cpu"), cfg, create_graph=False)
    k, n_real = len(group), sum(g.num_nodes for g in group)
    cpu = {"energies": ge_c.detach().numpy()[:k], "forces": f_c.numpy()[:n_real]}
    card = {"energies": np.stack([q.result[0] for q in rec["reqs"]]),
            "forces": np.concatenate([q.result[1] for q in rec["reqs"]])}
    unplanned = collate(group, rec["spec"].pad_spec()).to("cuda")
    floors = {"energies": [], "forces": []}
    for _ in range(N_FLOORS):
        ge_s, f_s = energy_and_forces(live.model, unplanned, cfg, create_graph=False)
        for name, got in (("energies", ge_s.detach().cpu().numpy()[:k]),
                          ("forces", f_s.cpu().numpy()[:n_real])):
            floors[name].append(scaled_error(got, cpu[name]))
    parity = {}
    for name, tol in (("energies", F32_TOL), ("forces", VJP_TOL)):
        err = scaled_error(card[name], cpu[name])
        ok = close_scaled(card[name], cpu[name], tol)
        floor = float(np.median(floors[name]))
        check(ok or err <= 10 * floor,
              f"[serve-forces] {name}: card vs CPU {err:.3g} x max|ref|, outside the "
              f"tolerance and above 10 x the median scatter floor {floor:.3g}")
        scale = float(np.abs(cpu[name]).max())
        parity[name] = {"error": err, "floor": floor, "in_tolerance": ok, "max_ref": scale}
        log(f"[serve-forces] bin {rec['key']} {name}, card vs CPU plain path: largest error "
            f"{err:.3g} x max|ref| ({scale:.3g}); in rtol {tol['rtol']:g} atol {tol['atol']:g} "
            f"x min(max|ref|, 1): {'yes' if ok else 'no'}; median scatter floor {floor:.3g} "
            f"(floors {[float(f'{x:.3g}') for x in floors[name]]})")
    # the MLIP artifact per budget
    arts = {}
    t0 = time.perf_counter()
    for b in budgets:
        arts[(b.num_nodes, b.num_edges, b.num_graphs)] = export_inference(
            model, cfg, None, live.collate_bin([frames[0]], b), with_forces=True,
            devices=["cuda"])
    export_s = time.perf_counter() - t0
    offline = ServingEngine(model, cfg, None, budgets, example=frames[0], settings=settings,
                            with_forces=True, warm=False, device="cuda")
    offline.install_executables(ServingEngine.from_exported(arts, device="cuda"))
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    reqs2, records2 = serve_all(offline, frames, budgets, settings)
    k1_art, k2_art = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    check(k1_art == k2_art == per_bin * len(records2),
          f"[serve-forces] artifact engine: K1 {k1_art}, K2 {k2_art} for {len(records2)} bins")
    same_results(reqs, reqs2, "[serve-forces] the exported MLIP artifact vs the live engine")
    log(f"[serve-forces] the exported MLIP artifacts ({[len(b) for b in arts.values()]} bytes, "
        f"exported in {export_s:.2f} s) served through from_exported -> "
        f"install_executables: K1 {k1_art} = K2 {k2_art}, energies and forces equal the live "
        f"engine's bit for bit (the loaded energy program differentiated at call time)")
    # a full bin against a one-request bin of the same budget
    spec = max(budgets, key=lambda b: b.num_nodes)
    key = (spec.num_nodes, spec.num_edges, spec.num_graphs)
    cap = max(i for i in range(1, len(frames) + 1)
              if spec.fits(int(sum(s.num_nodes for s in frames[:i])),
                           int(sum(s.num_edges for s in frames[:i])), i))
    shapes = {}
    for name, group in (("full", frames[:cap]), ("one_request", frames[:1])):
        host = live.collate_bin(group, spec)
        prof = device_profile(lambda: live.graphs.replay(key, [host]), (per_bin, per_bin),
                              f"[serve-forces] {name} bin")
        padded = spec.num_edges - int(host.edge_mask.sum())
        shapes[name] = dict(prof, molecules=len(group), padded_edges=padded)
        if prof:
            log(f"[serve-forces] {name} bin at {key} ({len(group)} molecules, {padded} "
                f"padded edges): {prof['device_ms']:.3f} ms of device time a replay "
                f"(profiler), indexing_backward_kernel {prof['indexing_backward_ms']:.3f} ms "
                f"({100 * prof['indexing_backward_ms'] / prof['device_ms']:.1f}%, "
                f"{prof['indexing_backward_per_call']} launches), K1 {prof['k1_ms']:.3f} ms, "
                f"K2 {prof['k2_ms']:.3f} ms, {prof['kernels_per_call']} kernels")
        else:
            log(f"[serve-forces] {name} bin: device time not measured (the profiler "
                f"recorded no kernels)")
    live.close()
    offline.close()
    return {"k1": k1 + k1_art, "k2": k2 + k2_art, "bins": len(records),
            "budgets": budget_keys(budgets), "parity": parity, "bins_by_shape": shapes,
            "export_s": export_s}


# ---------------------------------------------------------------- [md]

MD_PARITY_STEPS = 16  # card against the CPU plain path, step by step
MD_DISPATCH_STEPS = 64  # K = 1 against K = 16, small skin
MD_SMALL_SKIN = 0.01  # rebuilds within MD_DISPATCH_STEPS at md17.json's dt and kT
MD_DRILL_STEPS = 48  # overflow and nan:force drills
MD_NAN_STEP = 20
MD_INTERRUPT = 96  # the resume drill: interrupted here, 2 x this in all
MD_LADDER_NAN = 40  # the resume drill's dt halving, before the interrupt
LJ_STEPS = 64  # LJ.json's 300 steps cut for the time limit
MD_TIMED_REPLAYS = 20


def lj_cluster(ucells=(3, 3, 3), seed=0, vacancy_rate=0.05, jitter=0.05):
    """The positions of examples/LennardJones/LJ_data.py's
    ``configuration`` (numpy only, its draws in its order from
    ``default_rng(seed)``): a simple-cubic lattice (a = 3.8) with
    Gaussian jitter (0.05 a) and 5% vacancies, one species. The rollout
    builds its lists with open boundaries, as LennardJones.py's does, so
    the periodic cell is not kept."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    nx, ny, nz = ucells
    a = 3.8
    grid = np.array([(x, y, z) for x in range(nx) for y in range(ny) for z in range(nz)],
                    dtype=np.float64)
    rng = np.random.default_rng(seed)
    pos = grid * a + rng.normal(scale=jitter * a, size=grid.shape)
    keep = rng.uniform(size=len(pos)) > vacancy_rate
    if keep.sum() < 2:
        keep[:2] = True
    pos = pos[keep].astype(np.float32)
    n = len(pos)
    return GraphSample(x=np.ones((n, 1), np.float32), pos=pos,
                       edge_index=radius_graph(pos, 5.0), energy=0.0,
                       forces=np.zeros((n, 3), np.float32))


def md_engine(model, cfg, sample, block, **over):
    """A RolloutEngine for ``sample`` under ``block`` with ``over``'s keys
    replaced (``neighbor`` and ``guard`` merged)."""
    from hydragnn_tpu_torch.simulate import RolloutEngine, md_template_batch, simulation_settings

    b = copy.deepcopy(block)
    for k, v in over.items():
        b[k] = dict(b.get(k) or {}, **v) if isinstance(v, dict) else v
    s = simulation_settings({"Simulation": b})
    return RolloutEngine(model, None, cfg,
                         md_template_batch(sample.x, sample.pos, s.neighbor.max_edges), s)


def md_counts():
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    return edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches


def md_same(a, b, what):
    """Two rollouts' trajectories, velocities, energies and kinetic
    energies equal bit for bit."""
    import numpy as np

    for name in ("trajectory", "velocities", "energies", "kinetic"):
        x, y = getattr(a, name), getattr(b, name)
        check(x is not None and x.shape == y.shape and np.array_equal(x, y),
              f"[md] {what}: {name} differ")


def md_headline(config, model, cfg, state, start, per_pass):
    """md17.json's Simulation block through hydragnn_tpu_torch.run_simulation
    on the card with a telemetry stream: K1/K2 per force pass, finite
    energies, the rollout rows through tools/graftboard.py."""
    import tempfile

    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.simulate import macro_plan, simulation_settings

    s = simulation_settings(config)
    with tempfile.TemporaryDirectory(prefix="md_stream_") as tdir:
        run_cfg = copy.deepcopy(config)
        path = os.path.join(tdir, "telemetry.jsonl")
        run_cfg["NeuralNetwork"]["Training"]["Telemetry"] = {"enabled": True,
                                                             "stream_path": path}
        k0 = md_counts()
        t0 = time.perf_counter()
        res = port.run_simulation(run_cfg, sample=start, model=model, cfg=cfg, state=state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = (c - b for c, b in zip(md_counts(), k0))
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
        try:
            import graftboard

            rep = graftboard.build_report(path)
        finally:
            sys.path.pop(0)
        rows = [json.loads(line) for line in open(path) if line.strip()]
    plan = macro_plan(s.steps, s.superstep_k)
    rs = rep["rollout_summary"]
    rollout = [r for r in rows if r.get("t") == "rollout"]
    check(res.stats["steps"] == s.steps and res.stats["events"] == []
          and np.isfinite(res.energies).all() and np.isfinite(res.kinetic).all(),
          f"[md] md17.json's rollout: {res.stats}")
    want = per_pass * (1 + s.steps)
    check(k1 == k2 == want, f"[md] md17.json's rollout launched K1 {k1}, K2 {k2}; want "
          f"{want} = {per_pass} x (1 + {s.steps} force passes) each")
    check([r["k"] for r in rollout] == plan and rs["macros"] == len(plan)
          and rs["steps"] == s.steps and rs["halts"] == 0 and rs["overflow_events"] == 0,
          f"[md] rollout rows {[r['k'] for r in rollout]} / graftboard {rs} against the "
          f"macro plan {plan}")
    log(f"[md] md17.json's Simulation block through run_simulation (Langevin NVT, kT "
        f"{s.kb * s.temperature_k}, friction {s.friction}, dt {s.dt}, {s.steps} steps, K = "
        f"{s.superstep_k}, skin {s.neighbor.skin}, {s.neighbor.max_edges} slots): "
        f"{seconds:.3f} s, {res.stats['steps_per_sec']:.1f} steps/s, "
        f"{rollout[-1]['ns_per_day']} ns/day (dt read as fs), {res.stats['rebuilds']} "
        f"rebuilds, energy drift {res.stats['energy_drift']:.4g} (a thermostatted run); "
        f"K1 {k1} = K2 {k2} = {per_pass} x {1 + s.steps} force passes; {len(rollout)} "
        f"rollout rows (k {plan[0]} x {len(plan) - 1} + {plan[-1]}), read back by "
        f"graftboard: {rs}")
    return {"seconds": seconds, "steps_per_sec": res.stats["steps_per_sec"],
            "ns_per_day": rollout[-1]["ns_per_day"], "rebuilds": res.stats["rebuilds"],
            "k1": k1, "k2": k2, "rows": len(rollout), "rollout_summary": rs,
            "energy_drift": res.stats["energy_drift"]}


def md_forces_held(card, cpu, model, cfg, st):
    """The card's forces at ``st`` (its committed ``forces``) against the
    CPU plain path's force pass on the same input, by [mlip]'s rule:
    within the gradient tolerance or within 10 x the card's own floor
    (the median over N_FLOORS card force passes with index_add_ in place
    of K1/K2, each its own atomic order, of the largest error over the
    largest |ref|). Returns (error, in tolerance, floor)."""
    import dataclasses

    import numpy as np

    from hydragnn_tpu_torch.train.mlip import energy_and_forces

    h = {k: getattr(st, k).cpu() for k in ("pos", "senders", "receivers", "edge_mask")}
    ref = cpu._energy_forces(h["pos"], h["senders"], h["receivers"], h["edge_mask"])[1].numpy()
    got = st.forces.cpu().numpy()
    unplanned = dataclasses.replace(card.template, pos=st.pos, senders=st.senders,
                                    receivers=st.receivers, edge_mask=st.edge_mask)
    floors = [scaled_error(energy_and_forces(model, unplanned, cfg,
                                             create_graph=False)[1].cpu().numpy(), ref)
              for _ in range(N_FLOORS)]
    err, ok, floor = scaled_error(got, ref), close_scaled(got, ref, VJP_TOL), float(
        np.median(floors))
    check(ok or err <= 10 * floor,
          f"[md] forces, card vs CPU: {err:.3g} x max|ref|, outside the tolerance and above "
          f"10 x the median scatter floor {floor:.3g}")
    return err, ok, floor


def md_card_vs_cpu(model, cfg, start, block):
    """The first MD_PARITY_STEPS steps on the card against the CPU plain
    path, one step a dispatch from the card's initial state. Each card
    step is held against one CPU step from the same state (the inputs
    equal, as ROADMAP's parity rule asks): positions, velocities and
    energies within the f32 forward tolerance (atol scaled as
    assert_close_scaled scales it), the forces by [mlip]'s rule
    (md_forces_held), the neighbor arrays, counters and key equal. The
    CPU's own 16-step trajectory runs beside it: its neighbor arrays,
    counters and key equal the card's at every step, and its largest gap
    to the card's positions and velocities is reported (two free
    trajectories part by the force passes' rounding, which a steep
    potential amplifies)."""
    from hydragnn_tpu_torch.simulate import MDState

    def on_cpu(st):
        return MDState(**{k: v.cpu() for k, v in st.leaves().items()})

    card = md_engine(model, cfg, start, block)
    cpu = md_engine(copy.deepcopy(model).to("cpu"), cfg, start, block)
    st_c = card.init_state()
    free = on_cpu(st_c)
    forces = [md_forces_held(card, cpu, model, cfg, st_c)]
    worst, drift = {}, {}
    rebuild_steps = []
    for i in range(MD_PARITY_STEPS):
        step_h = cpu.run(on_cpu(st_c), 1).state
        st_c = card.run(st_c, 1).state
        free = cpu.run(free, 1).state
        for name in ("senders", "receivers", "edge_mask", "rebuilds", "good_steps", "key"):
            for other, what in ((step_h, "one CPU step"), (free, "the CPU's trajectory")):
                check(torch.equal(getattr(st_c, name).cpu(), getattr(other, name)),
                      f"[md] card vs {what}: {name} differ at step {i}")
        for name in ("pos", "vel", "energy"):
            got = getattr(st_c, name).cpu().numpy()
            err, _ = assert_close_scaled(got, getattr(step_h, name).numpy(), F32_TOL,
                                         f"[md] {name} at step {i}")
            worst[name] = max(worst.get(name, 0.0), err)
            drift[name] = max(drift.get(name, 0.0),
                              float(abs(got - getattr(free, name).numpy()).max()))
        forces.append(md_forces_held(card, cpu, model, cfg, st_c))
        if int(st_c.rebuilds) > len(rebuild_steps):
            rebuild_steps.append(i)
    f_err = max(f[0] for f in forces)
    f_out = sum(not f[1] for f in forces)
    log(f"[md] card vs CPU plain path, {MD_PARITY_STEPS} steps one at a time from the "
        f"card's initial state, each against one CPU step from the same state: positions, "
        f"velocities and energies within rtol 1e-5, atol 1e-4 (largest |card - CPU| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"); the forces of all {len(forces)} states by [mlip]'s rule (largest error "
        f"{f_err:.3g} x max|ref|; {f_out} outside the gradient tolerance, each within 10 x "
        f"its median scatter floor, floors {min(f[2] for f in forces):.3g}-"
        f"{max(f[2] for f in forces):.3g}); senders, receivers, edge mask, rebuild and step "
        f"counters and the key equal at every step, also against the CPU's own trajectory "
        f"(rebuilds at steps {rebuild_steps}), whose largest gap to the card's is "
        + ", ".join(f"{k} {v:.3g}" for k, v in drift.items()) + " (reported, not held)")
    return {"max_abs_err": worst, "free_running_gap": drift, "forces_error": f_err,
            "forces_outside_tolerance": f_out, "rebuild_steps": rebuild_steps}


def md_dispatch(model, cfg, start, block, per_pass):
    """K = 1 against K = 16 bit for bit with the thermostat on and
    rebuilds (skin MD_SMALL_SKIN); a second K = 16 run the same bits; one
    macro eager, then captured and replayed, then replayed, from the same
    state: the same bits each time. Returns the timing engine and its
    eager/replayed macro seconds."""
    small = {"neighbor": {"skin": MD_SMALL_SKIN}}
    runs = {}
    for tag, k in (("k1", 1), ("k16", 16), ("k16_again", 16)):
        eng = md_engine(model, cfg, start, block, superstep_k=k, **small)
        k0 = md_counts()
        runs[tag] = eng.run(eng.init_state(), MD_DISPATCH_STEPS, record=True)
        torch.cuda.synchronize()
        k1, k2 = (c - b for c, b in zip(md_counts(), k0))
        want = per_pass * (1 + MD_DISPATCH_STEPS)
        check(k1 == k2 == want, f"[md] K = {k}: K1 {k1}, K2 {k2}, want {want} each")
        gs = eng.graph_stats()
        check(gs["eager_runs"] == 1 and gs["captures"] == 1
              and gs["replays"] == MD_DISPATCH_STEPS // k - 1, f"[md] K = {k}: graphs {gs}")
    check(runs["k1"].stats["rebuilds"] == runs["k16"].stats["rebuilds"] > 0,
          f"[md] rebuilds {runs['k1'].stats['rebuilds']} vs {runs['k16'].stats['rebuilds']}")
    md_same(runs["k1"], runs["k16"], "K = 1 against K = 16")
    md_same(runs["k16"], runs["k16_again"], "two K = 16 runs")
    # one engine, one macro from the same state three times: eager,
    # captured + replayed, replayed
    eng = md_engine(model, cfg, start, block, **small)
    s0 = eng.init_state()
    outs, secs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        outs.append(eng.run(s0, 16, record=True))
        secs.append(time.perf_counter() - t0)
    md_same(outs[0], outs[1], "eager against captured-and-replayed")
    md_same(outs[0], outs[2], "eager against replayed")
    check(eng.graph_stats()["replays"] == 2, f"[md] {eng.graph_stats()}")
    log(f"[md] dispatch (skin {MD_SMALL_SKIN}, {MD_DISPATCH_STEPS} steps, Langevin): K = 1 "
        f"and K = 16 bit for bit (trajectory, velocities, energies, kinetic; "
        f"{runs['k1'].stats['rebuilds']} rebuilds each), a second K = 16 run bit for bit, "
        f"K1 = K2 = {per_pass} x {1 + MD_DISPATCH_STEPS} in each run; one 16-step macro from "
        f"one state eager ({secs[0] * 1e3:.1f} ms), captured and replayed "
        f"({secs[1] * 1e3:.1f} ms), replayed ({secs[2] * 1e3:.2f} ms host): bit for bit")
    return {"rebuilds": runs["k1"].stats["rebuilds"], "eager_macro_ms": secs[0] * 1e3,
            "capture_macro_ms": secs[1] * 1e3, "replay_macro_ms": secs[2] * 1e3,
            "capture_seconds": eng.capture_seconds}


def md_drills(model, cfg, start, block):
    """The containment drills of tests/test_simulate.py on the card:
    overflow growth, nan:force with a dt halving, halts, and the
    interrupt and resume through CheckpointWriter."""
    import tempfile

    import numpy as np

    from hydragnn_tpu_torch.simulate import RolloutHalt
    from hydragnn_tpu_torch.utils import faults
    from hydragnn_tpu_torch.utils.checkpoint import CheckpointWriter, load_resume_checkpoint

    out = {}
    roomy = md_engine(model, cfg, start, block)
    clean = roomy.run(roomy.init_state(), MD_DRILL_STEPS, record=True)
    tiny = md_engine(model, cfg, start, block, neighbor={"max_edges": 64})
    st = tiny.init_state()
    check(bool(st.poisoned), "[md] 64 slots did not overflow at t = 0")
    grown = tiny.run(st, MD_DRILL_STEPS, record=True)
    check(grown.stats["capacity_growths"] >= 1 and [e["action"] for e in grown.stats["events"]]
          == ["rebuild"] * grown.stats["capacity_growths"], f"[md] overflow: {grown.stats}")
    md_same(grown, clean, "the grown run against the roomy one")
    out["overflow"] = {"capacity": grown.stats["capacity"],
                       "events": grown.stats["events"]}

    faults.install(f"nan:force@{MD_NAN_STEP}")
    try:
        eng = md_engine(model, cfg, start, block)
        res = eng.run(eng.init_state(), MD_DRILL_STEPS, record=True)
    finally:
        faults.reset()
    check(res.stats["steps"] == MD_DRILL_STEPS and res.stats["dt_halvings"] == 1
          and [e["action"] for e in res.stats["events"]] == ["dt_halve"]
          and np.array_equal(res.trajectory[:MD_NAN_STEP], clean.trajectory[:MD_NAN_STEP])
          and not np.array_equal(res.trajectory[MD_NAN_STEP:], clean.trajectory[MD_NAN_STEP:])
          and np.isfinite(res.trajectory).all(), f"[md] nan:force@{MD_NAN_STEP}: {res.stats}")
    out["nan_force"] = {"dt": res.stats["dt"], "events": res.stats["events"]}

    halts = {}
    for name, spec, over, match in (
            ("dt halvings exhausted", "nan:force@5", {"guard": {"max_dt_halvings": 0}},
             "halvings exhausted"),
            ("halt policy", "nan:force@5", {"guard": {"on_nonfinite": "halt"}}, "non-finite"),
            ("growths exhausted", "", {"neighbor": {"max_edges": 64},
                                       "guard": {"max_capacity_growths": 0}},
             "capacity growths exhausted")):
        if spec:
            faults.install(spec)
        try:
            eng = md_engine(model, cfg, start, block, **over)
            try:
                eng.run(eng.init_state(), MD_DRILL_STEPS)
                raise RuntimeError(f"check failed: [md] {name}: the rollout did not halt")
            except RolloutHalt as e:
                check(match in str(e) and e.state is not None, f"[md] {name}: {e}")
                halts[name] = int(e.state.good_steps)
        finally:
            faults.reset()
    out["halts"] = halts

    # interrupt at MD_INTERRUPT through the writer, then resume: the whole
    # trajectory equals the uninterrupted one, at the adopted (halved) dt
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="md_resume_")
    os.chdir(work)
    try:
        faults.install(f"nan:force@{MD_LADDER_NAN}")
        try:
            full_e = md_engine(model, cfg, start, block)
            full = full_e.run(full_e.init_state(), 2 * MD_INTERRUPT, record=True)
            first = md_engine(model, cfg, start, block)
            half = first.run(first.init_state(), MD_INTERRUPT, record=True)
        finally:
            faults.reset()
        w = CheckpointWriter("md_resume")
        try:
            w.save(half.state, kind="auto", epoch=0, step=MD_INTERRUPT,
                   loop=first.ladder_state())
        finally:
            w.close()
        second = md_engine(model, cfg, start, block)
        restored, manifest = load_resume_checkpoint("md_resume", second.init_state())
        check(manifest is not None and manifest["step"] == MD_INTERRUPT,
              f"[md] resume manifest {manifest}")
        second.adopt_ladder(manifest["loop"])
        rest = second.run(restored, MD_INTERRUPT, record=True)
    finally:
        os.chdir(cwd)
    whole = np.concatenate([half.trajectory, rest.trajectory])
    check(first.dt_halvings == 1 and second.dt == first.dt == full_e.dt
          and rest.stats["events"] == [] and np.array_equal(whole, full.trajectory)
          and np.array_equal(np.concatenate([half.velocities, rest.velocities]),
                             full.velocities),
          f"[md] resume: dt {second.dt} vs {first.dt}, events {rest.stats['events']}")
    out["resume"] = {"dt": second.dt, "ladder": manifest["loop"]}
    log(f"[md] drills: overflow at 64 slots grown to {grown.stats['capacity']} "
        f"({grown.stats['events']}), {MD_DRILL_STEPS} steps equal to the roomy run bit for "
        f"bit; nan:force@{MD_NAN_STEP} -> one dt halving (dt {res.stats['dt']}), the "
        f"{MD_NAN_STEP}-step prefix bit for bit; halts {halts} (committed steps at the "
        f"halt); interrupted at {MD_INTERRUPT} through CheckpointWriter (a dt halving at "
        f"{MD_LADDER_NAN} before it), resumed with the ladder adopted (dt {second.dt}): "
        f"{2 * MD_INTERRUPT} steps equal to the uninterrupted run bit for bit")
    return out


def md_timing(model, cfg, start, block, per_pass):
    """One replayed K = 16 macro of md17.json's rollout: its device time
    (CUDA events over MD_TIMED_REPLAYS replays, twice), and from
    ``torch.profiler`` over 5 replays its kernels, their busy time, K1's
    and K2's, and the idle share of the kernels' span. Its parts timed
    alone at the macro's shapes, x 16 (time_ms: CUDA-graph replays): the
    neighbor build with its selects, the device plan, the two Langevin
    half steps (threefry noise included) and the force pass (the model's
    forward and backward, K1/K2 included, less the plan); the rest is the
    integrators, the containment selects and the packed rows. The same
    macro with rebuild_policy "never" (no list built). Launches made by
    the parts' timing are taken back out of the counts."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
        plan_blocks_device,
        static_block_bound,
    )
    from hydragnn_tpu_torch.simulate.integrators import ou_half_step

    def macro_ms(eng):
        g = eng._graphs[(16, False)].graph
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        g.replay()
        torch.cuda.synchronize()
        start_ev.record()
        for _ in range(MD_TIMED_REPLAYS):
            g.replay()
        end_ev.record()
        torch.cuda.synchronize()
        return start_ev.elapsed_time(end_ev) / MD_TIMED_REPLAYS

    engines = {}
    for policy in ("displacement", "never"):
        eng = md_engine(model, cfg, start, block, neighbor={"rebuild_policy": policy})
        st = eng.run(eng.init_state(), 48).state  # eager, capture + replay, replay
        check(eng.graph_stats()["captures"] == 1, f"[md] timing engine {eng.graph_stats()}")
        engines[policy] = (eng, st)
    times = {p: macro_ms(e) for p, (e, _) in engines.items()}
    times.update({f"{p}_again": macro_ms(e) for p, (e, _) in engines.items()})
    eng, st = engines["displacement"]
    g = eng._graphs[(16, False)].graph
    k0 = md_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    check(md_counts() == k0, "[md] a bare graph replay moved the launch counts")
    n, e = st.pos.shape[0], st.senders.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    node_mask = eng.template.node_mask
    skin2 = (0.5 * float(eng.settings.neighbor.skin)) ** 2

    def neighbor_and_select():
        snd, rcv, em, ovf = eng._neighbor(st.pos)
        need = torch.max(torch.sum((st.pos - st.ref_pos) ** 2, dim=-1)) > skin2
        return (torch.where(need, snd, st.senders), torch.where(need, rcv, st.receivers),
                torch.where(need, em, st.edge_mask), torch.where(need, st.pos, st.ref_pos),
                torch.where(need, ovf, zero))

    def thermostat():
        vel, key = ou_half_step(st.vel, st.key, eng._gamma_t, eng._kt_t, eng.masses,
                                node_mask, eng._dt_t)
        return ou_half_step(vel, key, eng._gamma_t, eng._kt_t, eng.masses, node_mask,
                            eng._dt_t)

    nb_ms = 16 * time_ms(neighbor_and_select)
    plan_ms = 16 * time_ms(lambda: plan_blocks_device(st.receivers, st.edge_mask, n,
                                                      static_block_bound(e, n)))
    thermo_ms = 16 * time_ms(thermostat)
    force_ms = 16 * time_ms(lambda: eng._energy_forces(st.pos, st.senders, st.receivers,
                                                       st.edge_mask)) - plan_ms
    edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches = k0
    macro = times["displacement"]
    row = {"macro_ms": macro, "macro_again_ms": times["displacement_again"],
           "never_ms": times["never"], "never_again_ms": times["never_again"],
           "neighbor_select_ms": nb_ms, "plan_ms": plan_ms, "thermostat_ms": thermo_ms,
           "force_pass_ms": force_ms, "rest_ms": macro - nb_ms - plan_ms - thermo_ms - force_ms}
    split = (f"alone x 16: neighbor build + select {nb_ms:.3f} ms, device plan {plan_ms:.3f}, "
             f"the two Langevin half steps {thermo_ms:.3f}, the force pass {force_ms:.3f} "
             f"(less the plan), the rest {row['rest_ms']:.3f}")
    if kernels:
        busy = sum(k.time_range.elapsed_us() for k in kernels) / 1e3 / 5
        span = (max(k.time_range.end for k in kernels)
                - min(k.time_range.start for k in kernels)) / 1e3 / 5
        k1 = sum(k.time_range.elapsed_us() for k in kernels
                 if "edge_pipeline_kernel<" in k.name) / 1e3 / 5
        k2 = sum(k.time_range.elapsed_us() for k in kernels
                 if "edge_pipeline_bwd_kernel<" in k.name or "bwd_finish_kernel<" in k.name
                 ) / 1e3 / 5
        row.update(profiled_busy_ms=busy, profiled_span_ms=span, k1_ms=k1, k2_ms=k2,
                   idle_share=1.0 - busy / span, kernels_per_macro=len(kernels) // 5)
        split = (f"profiler (5 replays): {row['kernels_per_macro']} kernels a macro, busy "
                 f"{busy:.3f} ms over a span of {span:.3f} (idle {100 * row['idle_share']:.1f}%"
                 f"), K1 {k1:.3f}, K2 {k2:.3f}; " + split)
    else:
        split = "the profiler recorded no kernels in the replayed graph; " + split
    log(f"[md] one replayed K = 16 macro of md17.json's rollout (N {n}, E {e}, "
        f"{per_pass} K1 + {per_pass} K2 a step; {card_line()}): {macro:.3f} / "
        f"{times['displacement_again']:.3f} ms (CUDA events, {MD_TIMED_REPLAYS} replays, "
        f"twice); {split}; the same macro with rebuild_policy \"never\" (no list built) "
        f"{times['never']:.3f} / {times['never_again']:.3f} ms")
    return row


def md_kernel_rows(eng, st):
    """K1 and K2 at the device plan of the rollout's list: reduce-only at
    PaiNN's widths (reduce_kernel_rows: against the plain versions, the
    times, the bound, index_add_ / index_select)."""
    batch = eng.force_batch(st.pos, st.senders, st.receivers, st.edge_mask)
    rows = []
    for f, seed in ((64, 21), (3 * 64, 22)):
        rows += reduce_kernel_rows("md-kernels", batch, f, seed,
                                   what="md17's rollout list at t = 0")
    return rows


def md_lj_run():
    """LJ.json's SchNet (random weights, seed 0) over a 3x3x3 cluster,
    NVE under LJ.json's Simulation block cut to LJ_STEPS steps, through
    run_simulation: K1/K2 launches per force pass, energy drift and total
    momentum within tests/test_simulate.py's bounds; K1/K2 (a,b,W) at the
    run's device plan against their plain versions, timed."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.simulate import total_momentum

    config = example_json("LennardJones", "LJ.json")
    cluster = lj_cluster()
    full = update_config(config, [cluster], [cluster], [cluster])
    full["Simulation"]["steps"] = LJ_STEPS
    model, cfg = create_model_config(full, "cuda", seed=0)
    per_pass = cfg.num_conv_layers
    k0 = md_counts()
    res = port.run_simulation(full, sample=cluster, model=model, cfg=cfg)
    torch.cuda.synchronize()
    k1, k2 = (c - b for c, b in zip(md_counts(), k0))
    check(res.stats["steps"] == LJ_STEPS and res.stats["events"] == [],
          f"[md] LJ: {res.stats}")
    check(k1 == k2 == per_pass * (1 + LJ_STEPS),
          f"[md] LJ: K1 {k1}, K2 {k2}, want {per_pass} x {1 + LJ_STEPS} each")
    total = res.energies + res.kinetic
    scale = max(abs(float(total[0])), float(res.kinetic[0]), 1e-3)
    drift = float(np.max(np.abs(total - total[0])))
    eng = md_engine(model, cfg, cluster, full["Simulation"])
    st = eng.init_state()
    mom = total_momentum(res.state.vel, eng.masses, eng.template.node_mask).cpu().numpy()
    check(drift < 1e-3 * scale and np.max(np.abs(mom)) < 1e-4,
          f"[md] LJ NVE: drift {drift:.3g} against 1e-3 x {scale:.3g}, momentum {mom}")
    # K1/K2 as SchNet runs them: a = h[snd] [E, 64], b = the filter, W [64, 64]
    batch = eng.force_batch(st.pos, st.senders, st.receivers, st.edge_mask)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    n, e = batch.num_nodes, batch.num_edges
    e_valid = int(batch.edge_mask.sum())
    f_in, f_out = cfg.num_filters, cfg.hidden_dim
    gen = torch.Generator().manual_seed(31)
    a = torch.randn(e, f_in, generator=gen).cuda()
    b = torch.randn(e, f_in, generator=gen).cuda()
    w = torch.randn(f_in, f_out, generator=gen).cuda()
    g = torch.randn(n, f_out, generator=gen).cuda()
    args = (a, b, w, *plan, n)
    with torch.no_grad():
        got, again, ref = (edge_pipeline_planned(*args), edge_pipeline_planned(*args),
                           edge_pipeline_plain(*args))
    d, d_again, d_ref = (edge_pipeline_bwd_planned(g, *args), edge_pipeline_bwd_planned(g, *args),
                         edge_pipeline_bwd_plain(g, *args))
    torch.cuda.synchronize()
    check(torch.equal(got, again) and all(torch.equal(x, y) for x, y in zip(d, d_again)),
          "[md] LJ K1/K2: two runs differ")
    torch.testing.assert_close(got, ref, **F32_TOL)
    for x, y in zip(d, d_ref):
        torch.testing.assert_close(x, y, **VJP_TOL)
    slots, blocks = plan[0].numel(), plan[3].numel()
    row = {"f_in": f_in, "f_out": f_out, "flavour": "abw", "n": n, "e": e, "e_valid": e_valid,
           "k1_max_abs_err": float((got - ref).abs().max()),
           "k2_max_abs_err": max(float((x - y).abs().max()) for x, y in zip(d, d_ref))}
    with torch.no_grad():
        row["k1_ms"] = time_ms(lambda: edge_pipeline_planned(*args))
        row["k1_plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
    row["k2_ms"] = time_ms(lambda: edge_pipeline_bwd_planned(g, *args))
    row["k2_plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(g, *args))
    nbytes, ops, out_dt = k1_work(e_valid, n, f_in, f_out, slots, blocks, torch.float32,
                                  torch.float32, True, True)
    row["k1_bound_ms"], row["k1_bound_by"] = bound(nbytes, ops, out_dt)
    nbytes, ops, g_dt = k2_work(e, e_valid, n, f_in, f_out, slots, blocks, torch.float32,
                                torch.float32, True, True)
    row["k2_bound_ms"], row["k2_bound_by"] = bound(nbytes, ops, g_dt)
    log(f"[md] LJ.json's SchNet (radius {cfg.radius}, hidden {cfg.hidden_dim}, "
        f"{cfg.num_conv_layers} layers, random weights) on a 3x3x3 cluster of "
        f"{cluster.num_nodes} atoms, NVE, {LJ_STEPS} steps (LJ.json's 300 cut), K = "
        f"{full['Simulation']['superstep_k']}: {res.stats['steps_per_sec']:.1f} steps/s, "
        f"{res.stats['rebuilds']} rebuilds; K1 {k1} = K2 {k2} = {per_pass} x "
        f"{1 + LJ_STEPS} force passes; energy drift {drift:.3g} (bound 1e-3 x {scale:.3g}), "
        f"total momentum {np.abs(mom).max():.3g} (bound 1e-4)")
    log(f"[md] LJ's device plan (n {n}, e {e}, {e_valid} valid, {blocks} blocks): K1 a,b,W "
        f"({f_in} -> {f_out}) {row['k1_ms'] * 1e3:.1f} us (plain "
        f"{row['k1_plain_ms'] * 1e3:.1f}, bound {row['k1_bound_ms'] * 1e3:.2f} us, "
        f"{row['k1_bound_by']}), K2 {row['k2_ms'] * 1e3:.1f} us (plain "
        f"{row['k2_plain_ms'] * 1e3:.1f}, bound {row['k2_bound_ms'] * 1e3:.2f} us, "
        f"{row['k2_bound_by']}); max|err| K1 {row['k1_max_abs_err']:.3g}, K2 "
        f"{row['k2_max_abs_err']:.3g}; same bits on two runs")
    return {"k1": k1, "k2": k2, "per_pass": per_pass, "atoms": cluster.num_nodes,
            "steps_per_sec": res.stats["steps_per_sec"], "rebuilds": res.stats["rebuilds"],
            "energy_drift_max": drift, "momentum_max": float(np.abs(mom).max()),
            "kernel_row": row}


def phase_md(mlip_config, md17_splits):
    """md17.json's PaiNN integrated on the card (9b in the module
    docstring). The counts start at 0 here; ``k1``/``k2`` are the
    launches of the phase's runs (training, rollouts), not those of the
    kernel comparisons."""
    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    t_phase = time.perf_counter()
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    path = [0, 0]

    def counted(fn, *args, **kw):
        k0 = md_counts()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for i, (c, b) in enumerate(zip(md_counts(), k0)):
            path[i] += c - b
        return out

    config = copy.deepcopy(mlip_config)
    config["NeuralNetwork"]["Training"]["num_epoch"] = 1
    t0 = time.perf_counter()
    state, model, cfg, hist, full = counted(port.run_training, config, datasets=md17_splits,
                                            device="cuda")
    train_s = time.perf_counter() - t0
    block = copy.deepcopy(mlip_config["Simulation"])
    full["Simulation"] = copy.deepcopy(block)
    start = md17_splits[2][0]
    per_pass = 2 * cfg.num_conv_layers
    log(f"[md] weights: md17.json's PaiNN trained 1 epoch on the MD17 stand-in "
        f"({train_s:.2f} s, train loss {hist.train_loss}); the start: the first test frame "
        f"({start.num_nodes} atoms; N = {start.num_nodes + 1} rows with the padding node)")
    headline = counted(md_headline, full, model, cfg, state, start, per_pass)
    parity = counted(md_card_vs_cpu, model, cfg, start, block)
    dispatch = counted(md_dispatch, model, cfg, start, block, per_pass)
    drills = counted(md_drills, model, cfg, start, block)
    timing = counted(md_timing, model, cfg, start, block, per_pass)
    check(path[0] > 0 and path[1] > 0, f"[md] the rollouts launched K1 {path[0]}, K2 {path[1]}")
    eng = md_engine(model, cfg, start, block)
    rows = md_kernel_rows(eng, eng.init_state())
    lj = md_lj_run()
    k1, k2 = path[0] + lj["k1"], path[1] + lj["k2"]
    seconds = time.perf_counter() - t_phase
    log(f"[md] phase: {seconds:.1f} s; K1 {k1}, K2 {k2} launched by its runs (training, "
        f"md17's rollouts, LJ's), the kernel comparisons not counted; {card_line()}")
    return {"k1": k1, "k2": k2, "seconds": seconds, "train_seconds": train_s,
            "headline": headline, "parity": parity, "dispatch": dispatch, "drills": drills,
            "timing": timing, "lj": lj, "kernel_rows": rows}


# ---------------------------------------------------------------- [drivers]

# Each driver's command line in [drivers]: the example drivers the port
# owns (hydragnn_tpu_torch/drivers/), every one on the card.
DRIVER_RUNS = (
    ("lennard_jones", ["--configs", "64", "--epochs", "2", "--simulate", "--sim_steps", "64"]),
    ("md17", ["--frames", "60", "--epochs", "2", "--simulate"]),
    ("qm9", ["--synthetic", "--mols", "200", "--epochs", "2"]),
    ("zinc", ["--mols", "200", "--epochs", "2"]),
    ("zinc", ["--mols", "200", "--epochs", "2", "--precision", "bf16"]),
    ("csce_gap", ["--mols", "200", "--epochs", "2"]),
    ("ogb_gap", ["--mols", "200", "--epochs", "2"]),
    ("qm9_hpo", ["--trials", "2", "--epochs", "2", "--mols", "200"]),
    ("lsms", ["--configs", "200", "--epochs", "2"]),
)
# The atomistic drivers' command lines in [drivers]: 2 epochs on 100-160
# structures or frames each; qm7x_inference predicts from the checkpoint
# the qm7x run before it saved (the same --epochs: the log name holds it).
ATOMISTIC_RUNS = (
    ("oc20", ["--systems", "100", "--epochs", "2"]),
    ("oc22", ["--systems", "100", "--epochs", "2"]),
    ("odac23", ["--systems", "100", "--epochs", "2"]),
    ("oc25", ["--systems", "120", "--epochs", "2"]),
    ("mptrj", ["--structures", "100", "--epochs", "2"]),
    ("mptrj", ["--structures", "100", "--epochs", "2", "--forces"]),
    ("alexandria", ["--structures", "100", "--epochs", "2"]),
    ("eam", ["--structures", "100", "--epochs", "2"]),
    ("eam", ["--structures", "100", "--epochs", "2", "--multitask"]),
    ("omat24", ["--structures", "100", "--epochs", "2"]),
    ("ani1x", ["--frames", "160", "--epochs", "2"]),
    ("ani1x", ["--frames", "160", "--epochs", "2", "--mlip"]),
    ("nabla2_dft", ["--frames", "120", "--epochs", "2"]),
    ("omol25", ["--frames", "120", "--epochs", "2"]),
    ("qcml", ["--frames", "160", "--epochs", "2"]),
    ("transition1x", ["--reactions", "12", "--epochs", "2"]),
    ("qm7x", ["--frames", "160", "--epochs", "2"]),
    ("qm7x_inference", ["--frames", "60", "--epochs", "2"]),
    ("qm7x", ["--frames", "160", "--epochs", "2", "--mlip"]),
    ("qm7x_inference", ["--frames", "60", "--epochs", "2", "--mlip"]),
)
RUN_FLAGS = ("--forces", "--multitask", "--mlip")  # in a run's tag
HPO_MEMORY_MIB = 8.0  # device memory after the last trial within this of after the first
# The sha256 of each generator's samples (pack_sample records; lsms: the
# files' bytes) at [drivers]' sizes, as the port's generators build them
# on the CPU (tests/test_torch_drivers.py holds them equal to the
# reference scripts' samples bit for bit): driver_digests() on the CPU.
DRIVER_DIGESTS = {
    "lj_data": "a085e6bb056d56f0176151759675c76dd5fe501ad31ba619374863d538a2cbdc",
    "md17": "439101057c3251c8a1ddefefe8a07c8926407d796fd6531d4251a87370bc6032",
    "qm9": "56104004b586fdb60ab246d4b0eb5e0299f7af468e9dded1f4493ebc8362d5ea",
    "zinc": "ff1d39e180e693d373035e45b7d18211b8f27df06fd046fae77a20bd1fac39f4",
    "csce_gap": "40cbf0cdf162c17a0afaa944c3fea418634fa904744a7592ce27a99863e4a18b",
    "ogb_gap": "65b59c8ecccf9d811bae4a5d6be6f91b453d0e438df21af95c55b5e6aacc3018",
    "lsms": "52e481b49b66aff5e28c5c4f0795ec3b88313cea573a5ba17c5da82614bc9121",
}


def driver_digests():
    """{generator: sha256} of each driver's data at [drivers]' sizes:
    LJ_data.create_dataset(64), the MD17 stand-in's 60 frames, 200
    synthetic qm9 and zinc molecules, the csce and ogb drivers' 200
    SMILES samples and deterministic_graph_data's 200 LSMS files (seed
    3). Host code only (numpy and the native cell list)."""
    import hashlib
    import tempfile

    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.drivers import csce_gap, lj_data, md17, ogb_gap, qm9, zinc

    out = {
        "lj_data": sample_digest(lj_data.create_dataset(64, cutoff=5.0)),
        "md17": sample_digest(md17.synthetic_md17(60)),
        "qm9": sample_digest(qm9.synthetic_qm9(200)),
        "zinc": sample_digest(zinc.synthetic_zinc(200)),
        "csce_gap": sample_digest(csce_gap.smiles_samples(200, csce_gap.CSCE_TYPES,
                                                          csce_gap.gap_target)),
        "ogb_gap": sample_digest(ogb_gap.smiles_samples(200, ogb_gap.OGB_TYPES,
                                                        ogb_gap.spectral_gap)),
    }
    with tempfile.TemporaryDirectory() as tmp:
        deterministic_graph_data(tmp, number_configurations=200, seed=3)
        h = hashlib.sha256()
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
        out["lsms"] = h.hexdigest()
    return out


# The same for the atomistic drivers' data at ATOMISTIC_RUNS' sizes
# (tests/test_torch_drivers_atomistic.py holds the generators equal to
# examples/'s and this table to the CPU build): atomistic_digests().
ATOMISTIC_DIGESTS = {
    "oc20": "6fa6ba0603686883a4c13537f8064dc8d24ca7bff3de86462a904d42cf64e7d0",
    "oc22": "974ca8da930be33638d4639d86e23e8c1a4b3f5ff2c98f20ae02dca8831865cd",
    "odac23": "c3350e49d02026a8510701a63e1bcba51629877a8f26fe4da90af4ac42c4a857",
    "oc25": "86ba3108b853a7dad8e85276c1a53144b27ae518087b4bc3aca0a0be9435baf4",
    "mptrj": "45200985a8cc244a693bb6718d62a74941c44cc2971a1d7f4637d0aeb81cc8b3",
    "alexandria": "125df8210a84a1c2da90202a5fab87fd9b941e6326fa7a14ed289580bf8197d7",
    "eam": "c882f87228242be2c532d8c5fb08111057ba1054b9ce141dd7996bb5dab147db",
    "eam_multitask": "300f7d36345bb4978faa2b94163838f94eb5b5f47cf88f0e08e9adf3601e171c",
    "omat24": "6c61e7976282893aac53cc90872f0fb1cbb7db59015558001bd1ddf1c1d47402",
    "ani1x": "31107a0e378ea4728a2164d26fad08b1a3d7791c666d710ca2f23b32d2abf32a",
    "nabla2_dft": "27b90032fb62fc37ba933c23cb0497ae8265d9698121457457576a1d57da8877",
    "omol25": "877ce18f1ae17e60d66ba31538b11b415c207cadcc96a304e21bfc41186c117f",
    "qcml": "7d59dc1769e79cbfc7223fa54f62ab4317cea331b0134776cd038e27bd605cb0",
    "transition1x": "70769f8272a2f37c3128caec5569b3f97dde0e2dbe896e56b6027faa3e725bb6",
    "qm7x": "2f77363ccb73ba5f4ca466f46616c66a380a17ce882106a40fa6a1eeb1c7b543",
    "qm7x_inference": "3cebd9fefec3e3ae943e1f0344cf7ae4ddec57739894b884df51e94a48c98447",
}


def atomistic_digests():
    """{data set: sha256} of the atomistic drivers' data at
    ATOMISTIC_RUNS' sizes: the oc20 slabs (100, seed 0), oc22's
    normalized slabs, odac23's conditioned set, oc25's shuffled mix of
    120, the crystals at each flag set the drivers use (mptrj, alexandria
    before its baseline, eam bulk and multitask, omat24: 100 each), the
    molecule frames of ani1x, nabla2_dft, omol25, qcml and qm7x (160
    and inference's 60) and transition1x's 12 reaction paths. Host code
    only (numpy and the native cell list)."""
    from hydragnn_tpu_torch.drivers import (
        alexandria,
        ani1x,
        eam,
        mptrj,
        nabla2_dft,
        oc20,
        oc22,
        oc25,
        odac23,
        omat24,
        omol25,
        qcml,
        qm7x,
    )
    from hydragnn_tpu_torch.drivers import crystals
    from hydragnn_tpu_torch.drivers.molecules import reaction_path_frames

    sets = {
        "oc20": oc20.synthetic_oc20(100),
        "oc22": oc22.oc22_samples(100),
        "odac23": odac23.conditioned_samples(100),
        "oc25": oc25.mixed_samples(120),
        "mptrj": mptrj.mptrj_samples(100),
        "alexandria": crystals.random_crystals(100, species=(28, 41, 13, 22), seed=11),
        "eam": eam.eam_samples(100),
        "eam_multitask": eam.eam_samples(100, multitask=True),
        "omat24": omat24.omat24_samples(100),
        "ani1x": ani1x.ani1x_samples(160),
        "nabla2_dft": nabla2_dft.nabla2_samples(120),
        "omol25": omol25.omol25_samples(120),
        "qcml": qcml.qcml_samples(160),
        "transition1x": reaction_path_frames(12),
        "qm7x": qm7x.build_dataset(160),
        "qm7x_inference": qm7x.build_dataset(60),
    }
    return {k: sample_digest(v) for k, v in sets.items()}


# alexandria's element baseline (a least squares through LAPACK's SVD) as
# the CPU build fits it on the train split of its 100 crystals: {Z:
# float.hex(coefficient)} of the four elements present
# (alexandria_baseline(); the others' coefficients multiply zero counts).
ALEXANDRIA_BASELINE = {13: "0x1.2baa5e34c88a5p-5", 22: "-0x1.aa6c27f14e9fap-6",
                       28: "0x1.203111dda3091p-4", 41: "-0x1.8fa32cd50d2c1p-4"}
TARGET_ULPS = 1  # alexandria's f32 targets from this host's baseline against the CPU build's


def alexandria_baseline():
    """(residualized splits, {Z: hex coefficient}) of alexandria's 100
    crystals, the baseline fitted on this host."""
    import numpy as np

    from hydragnn_tpu_torch.drivers import alexandria

    splits, coeff = alexandria.residual_splits(100)
    nonzero = np.flatnonzero(np.abs(coeff) > 1e-12)
    return splits, {int(z) + 1: float(coeff[z]).hex() for z in nonzero}


def alexandria_targets_held():
    """alexandria's residualized targets on this host against the CPU
    build's. The crystals are held bit for bit by their digest; the
    baseline goes through this host's LAPACK, so its coefficients are
    compared with ALEXANDRIA_BASELINE in ulps, and the per-atom f32
    targets made with them against those made with the CPU build's
    coefficients must agree within TARGET_ULPS."""
    import numpy as np

    from hydragnn_tpu_torch.drivers import alexandria

    splits, got = alexandria_baseline()
    check(set(got) == set(ALEXANDRIA_BASELINE),
          f"[drivers] alexandria's baseline fits elements {sorted(got)}")
    want = np.array([float.fromhex(ALEXANDRIA_BASELINE[z]) for z in sorted(got)])
    have = np.array([float.fromhex(got[z]) for z in sorted(got)])
    coeff_ulps = float((np.abs(have - want) / np.spacing(np.abs(want))).max())
    cpu = np.zeros(118)
    cpu[np.array(sorted(got)) - 1] = want
    ref, _ = alexandria.residual_splits(100, coeff=cpu)
    y = np.concatenate([s.y_graph for split in splits for s in split])
    y_ref = np.concatenate([s.y_graph for split in ref for s in split])
    target_ulps = float((np.abs(y - y_ref) / np.spacing(np.abs(y_ref))).max())
    check(target_ulps <= TARGET_ULPS,
          f"[drivers] alexandria's targets {target_ulps} ulps from the CPU build's")
    log(f"[drivers] alexandria's baseline on this host: coefficients {coeff_ulps:.0f} ulps "
        f"from the CPU build's (LAPACK's SVD), per-atom f32 targets {target_ulps:.0f} ulps "
        f"({'bit for bit' if target_ulps == 0 else f'within {TARGET_ULPS}'})")
    return {"coeff_ulps": coeff_ulps, "target_ulps": target_ulps}


# [drivers]' kernel checks at the widths the drivers meet first: (driver,
# example config, K1/K2 reduce-only widths) on its run's first train bin
DRIVER_WIDTHS = (("oc25", ("open_catalyst_2025", "oc25_energy.json"), (32, 96)),
                 ("qcml", ("qcml", "qcml_energy.json"), (144,)))


def driver_kernel_rows():
    """K1 and K2, reduce-only, on the first train bin of oc25's run (its
    mixed set of 120: PaiNN hidden 32, F = 32 scalar and 96 vector) and
    of qcml's (160 frames: MACE hidden 16, F = 16 x 9 = 144, four and a
    half 32-column slabs), in f32 and bf16 against their plain versions
    (``reduce_kernel_rows``): the run's own plan, as train_loader
    resolves packing for its config and train split."""
    from hydragnn_tpu_torch.drivers import common, oc25, qcml

    data = {"oc25": oc25.mixed_samples(120), "qcml": qcml.qcml_samples(160)}
    rows = {}
    for name, parts, widths in DRIVER_WIDTHS:
        config = example_json(*parts)
        loader, budgets = train_loader(config, common.split(data[name])[0])
        batch = next(iter(loader))
        what = (f"{name}'s first {'packed ' if loader.packing else ''}train bin (budgets "
                f"{budget_keys(budgets)})")
        rows[name] = [r for f in widths
                      for r in reduce_kernel_rows("drivers", batch.to("cuda"), f, 400 + f, what)]
    return rows


def launches_per_pass(cfg):
    """K1 launches of one forward of ``cfg``'s model on a planned batch
    (= K2 launches of its backward): SchNet one a,b,W launch a layer, PNA
    and PNAPlus one reduce-only moment pass a layer, PaiNN two
    reduce-only launches a layer (scalar and vector messages), MACE one
    reduce-only receiver sum a layer; GAT, SAGE, EGNN, DimeNet and GIN
    none (GAT's attention sums and SAGE's means are the plain scatter,
    EGNN sums at the senders, DimeNet's triplet sums through index_add_,
    GIN's through segment_sum). A conv node head adds one a,W launch a
    layer of its own, ``len(dim_headlayers) + 1``, for each node head on
    each conv branch. A stack not listed raises KeyError."""
    per_layer = {"SCHNET": 1, "PNA": 1, "PNAPLUS": 1, "PAINN": 2, "MACE": 1, "GAT": 0,
                 "SAGE": 0, "EGNN": 0, "DIMENET": 0, "GIN": 0}
    node_heads = sum(h.type == "node" for h in getattr(cfg, "heads", ()))
    conv = sum(len(b.dim_headlayers) + 1 for b in getattr(cfg, "node_branches", ())
               if b.node_head_type == "conv")
    return per_layer[cfg.mpnn_type.upper()] * cfg.num_conv_layers + node_heads * conv


def predicted_launches(call):
    """(K1, K2) a recorded entry-point call should launch, pf = K1 a
    forward: without forces pf K1 a forward and pf K2 a train step's
    backward. A potential's forward with forces is the forward and its
    pullback (pf K1, pf K2), as is a rollout's force pass (the t = 0 pass
    and one a step); its train step adds the loss's backward through the
    force pass: K1's backward (pf K2) and K2's (ops/edge_pipeline.
    _k2_backward: one K1 a launch, and one more K2 where the filter b is
    an operand, SchNet's a,b,W flavour; none in the reduce-only one). A
    relaxation's descent step is a forward and its pullback (pf K1, pf
    K2), an energy evaluation a forward (pf K1)."""
    cfg = call["cfg"]
    pf = launches_per_pass(cfg)
    if call["call"] == "run_simulation":
        return pf * call["force_passes"], pf * call["force_passes"]
    if call["call"] == "relax":
        return pf * (call["descent_steps"] + call["evaluations"]), pf * call["descent_steps"]
    fwd, steps = call["forwards"], call["train_steps"]
    if cfg.enable_interatomic_potential:
        with_b = cfg.mpnn_type.upper() == "SCHNET"
        return pf * (fwd + steps), pf * (fwd + steps) + (pf * steps if with_b else 0)
    return pf * fwd, pf * steps


@contextlib.contextmanager
def entry_point_calls():
    """While open, each run_training, run_prediction, run_simulation and
    relax (drivers/structure_optimization.py) call (however a driver
    reaches it) is recorded: its K1/K2 launches, its step dispatches
    (``recorded_run``: forwards, train steps), its model config, for a
    rollout its force passes and for a relaxation its descent steps and
    energy evaluations; the rollout's model, start and Simulation block,
    and the relaxation's model, sample, start and settings, are kept for
    the card-vs-CPU checks. Nothing of a run's state is kept, so trials
    free their graphs."""
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.drivers import structure_optimization as so
    from hydragnn_tpu_torch.simulate import engine

    calls = []
    plain = {"run_training": (runner, runner.run_training),
             "run_prediction": (runner, runner.run_prediction),
             "run_simulation": (engine, engine.run_simulation),
             "relax": (so, so.relax)}
    # run_prediction's model config, where the caller passes no cfg (a
    # prediction from the run's checkpoint builds its own)
    made = []
    plain_model = runner._prediction_model

    def prediction_model(*args, **kw):
        model, cfg = plain_model(*args, **kw)
        made.append(cfg)
        return model, cfg

    def wrap(name, fn):
        def counted(*args, **kw):
            made.clear()
            k0 = md_counts()
            with recorded_run() as rec:
                out = fn(*args, **kw)
            torch.cuda.synchronize()
            k1, k2 = (c - b for c, b in zip(md_counts(), k0))
            row = {"call": name, "k1": k1, "k2": k2, "forwards": rec["forwards"],
                   "train_steps": len(rec["shapes"])}
            if name == "run_training":
                row["cfg"], row["log_name"] = out[2], out[4]["_log_name"]
            elif name == "run_prediction" and made:
                row["cfg"] = made[-1]
            elif name == "relax":
                row.update(cfg=args[1], model=args[0], sample=args[2], pos0=args[3],
                           settings=dict(kw), descent_steps=kw["blocks"] * kw["steps"],
                           evaluations=kw["blocks"] + 2, result=out)
            else:
                row["cfg"] = kw["cfg"]
            if name == "run_simulation":
                row.update(force_passes=1 + int(out.stats["steps"]),
                           events=list(out.stats["events"]), model=kw["model"],
                           sample=kw["sample"], block=copy.deepcopy(args[0]["Simulation"]))
            calls.append(row)
            return out
        return counted

    for name, (mod, fn) in plain.items():
        setattr(mod, name, wrap(name, fn))
    runner._prediction_model = prediction_model
    try:
        yield calls
    finally:
        for name, (mod, fn) in plain.items():
            setattr(mod, name, fn)
        runner._prediction_model = plain_model


def driver_step_held(tag, call):
    """One rollout step of the driver's fitted potential on the card
    against one step of the CPU plain path from the same state (the
    card's initial state): positions, velocities and energies within the
    f32 forward tolerance, forces by [mlip]'s rule (md_forces_held), the
    neighbor arrays, counters and key equal."""
    from hydragnn_tpu_torch.simulate import MDState

    model, cfg, start, block = call["model"], call["cfg"], call["sample"], call["block"]
    card = md_engine(model, cfg, start, block)
    cpu = md_engine(copy.deepcopy(model).to("cpu"), cfg, start, block)
    st = card.init_state()
    st_cpu = MDState(**{k: v.cpu() for k, v in st.leaves().items()})
    one_cpu = cpu.run(st_cpu, 1).state
    one = card.run(st, 1).state
    for name in ("senders", "receivers", "edge_mask", "rebuilds", "good_steps", "key"):
        check(torch.equal(getattr(one, name).cpu(), getattr(one_cpu, name)),
              f"[drivers] {tag}: a card step vs a CPU step: {name} differ")
    worst = {}
    for name in ("pos", "vel", "energy"):
        worst[name], _ = assert_close_scaled(getattr(one, name).cpu().numpy(),
                                             getattr(one_cpu, name).numpy(), F32_TOL,
                                             f"[drivers] {tag}: {name} after one step")
    f_err, f_ok, floor = md_forces_held(card, cpu, model, cfg, one)
    held = ("within the gradient tolerance" if f_ok
            else f"within 10 x the scatter floor {floor:.3g}")
    log(f"[drivers] {tag}: one rollout step of the fitted potential (K = 1, from the card's "
        f"initial state, {start.num_nodes} atoms) card vs CPU plain path: positions, "
        f"velocities, energies within rtol 1e-5 / atol 1e-4 (largest |card - CPU| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"); forces {f_err:.3g} x max|ref| ({held}); lists, counters and key equal")
    return {"max_abs_err": worst, "forces_error": f_err, "forces_in_tolerance": f_ok}


def driver_numbers(out):
    """Every number in a driver's returned report (nested dicts, lists
    and trial tuples), as floats."""
    if isinstance(out, dict):
        return [x for v in out.values() for x in driver_numbers(v)]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in driver_numbers(v)]
    if isinstance(out, (int, float)) and not isinstance(out, bool):
        return [float(out)]
    return []


def plot_config(src, work):
    """A copy of the example config ``src`` under ``work`` with
    Visualization.create_plots on (the example file itself is only read)."""
    with open(src) as f:
        config = json.load(f)
    config["Visualization"] = {"create_plots": True}
    path = os.path.join(work, "plots_" + os.path.basename(src))
    with open(path, "w") as f:
        json.dump(config, f)
    return path


PLOT_FILES = {
    "qm9": ["error_hist_property.png", "global_analysis.png", "history.png", "num_nodes.png",
            "scatter_property.png", "task_history.png"],
    "md17": ["error_hist_energy.png", "error_hist_forces.png", "global_analysis.png",
             "history.png", "num_nodes.png", "parity_forces.png", "scatter_energy.png",
             "scatter_forces.png", "task_history.png"],
}


def driver_run(name, argv, plot_cfg):
    """One driver's main(argv) on the card (with ``--config plot_cfg``
    where given), its stdout sent to stderr, every entry-point call
    recorded and held to its predicted K1/K2 launches, each rollout held
    finite and one of its steps against the CPU's. Returns the run's
    report."""
    import importlib

    import numpy as np

    mod = importlib.import_module(f"hydragnn_tpu_torch.drivers.{name}")
    tag = (name + "".join("_" + a[2:] for a in argv if a in RUN_FLAGS)
           + ("_bf16" if "bf16" in argv else ""))
    extra = ["--config", plot_cfg] if plot_cfg else []
    t0 = time.perf_counter()
    with entry_point_calls() as calls, contextlib.redirect_stdout(sys.stderr):
        out = mod.main(list(argv) + extra + ["--device", "cuda"])
    seconds = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in driver_numbers(out)),
          f"[drivers] {tag}: non-finite results {out}")
    rows = []
    for c in calls:
        want = predicted_launches(c)
        row = {k: c[k] for k in ("call", "k1", "k2", "forwards", "train_steps")}
        row.update(model=c["cfg"].mpnn_type, per_pass=launches_per_pass(c["cfg"]),
                   force_passes=c.get("force_passes", 0),
                   descent_steps=c.get("descent_steps", 0), evaluations=c.get("evaluations", 0))
        check((c["k1"], c["k2"]) == want,
              f"[drivers] {tag} {c['call']}: K1 {c['k1']}, K2 {c['k2']}, predicted {want} "
              f"from {row}")
        rows.append(row)
    log(f"[drivers] {tag} {' '.join(argv)}: {seconds:.1f} s; "
        + "; ".join(f"{r['call']} ({r['model']}, {r['per_pass']} a pass) K1 {r['k1']} K2 "
                    f"{r['k2']} = predicted ({r['forwards']} forwards, {r['train_steps']} "
                    f"train steps, {r['force_passes']} force passes, {r['descent_steps']} "
                    f"descent steps, {r['evaluations']} energy evaluations)" for r in rows))
    run = {"driver": tag, "seconds": seconds, "calls": rows,
           "result": {k: v for k, v in out.items() if k != "trials"}}
    for c in calls:
        if c["call"] != "run_simulation":
            continue
        sim = out["simulation"]
        check(sim["finite"] and not c["events"],
              f"[drivers] {tag}: rollout {sim}, events {c['events']}")
        log(f"[drivers] {tag} rollout: {sim['steps']} steps at dt {sim['dt']} ({sim['atoms']} "
            f"atoms), {sim['rebuilds']} rebuilds, {sim['steps_per_sec']:.1f} steps/s, total "
            f"energy's largest departure {sim['energy_drift']:.3g}, every energy finite")
        run["step_held"] = driver_step_held(tag, c)
    for c in calls:
        if c["call"] == "relax":
            run["relax"] = relax_held(tag, c)
    if plot_cfg:
        log_name = next(c["log_name"] for c in calls if c["call"] == "run_training")
        pngs = sorted(f for f in os.listdir(os.path.join("logs", log_name))
                      if f.endswith(".png"))
        check(pngs == PLOT_FILES[name], f"[drivers] {tag}: logs/{log_name} holds {pngs}")
        log(f"[drivers] {tag} with create_plots: the hook wrote logs/{log_name}/"
            f"{{{', '.join(pngs)}}}")
        run["plots"] = pngs
    return run


# The last nine drivers' command lines in [drivers] (ROADMAP item 16c),
# each through its main() in this process: 2 epochs (the searches 1) on
# 60-100 samples a set; sc26_hpo's whole grid of 12 trials; the
# relaxation at tests/test_examples.py's sizes.
GFM_RUNS = (
    ("polymers", ["--chains", "100", "--epochs", "2"]),
    ("multidataset", ["--per_family", "60", "--epochs", "2"]),
    ("multidataset_hpo", ["--per_family", "60", "--trials", "2", "--epochs", "1"]),
    ("sc26_hpo", ["--frames", "64", "--trials", "12", "--epochs", "1"]),
    ("structure_optimization", ["--epochs", "2", "--frames", "64", "--blocks", "2",
                                "--steps", "20"]),
    ("uv_spectrum", ["--mols", "100", "--epochs", "2"]),
    ("ising", ["--configs", "100", "--epochs", "2"]),
)
# The multibranch drivers: (driver, arguments, ranks). Each main() starts
# its ranks as processes of the driver, sharing cuda:0 over gloo; every
# rank counts its own K1/K2 launches, forwards and train steps.
RANK_RUNS = (
    ("multibranch", ["--epochs", "2"], 3),
    ("multibranch", ["--epochs", "2", "--nosync", "2", "--sizes", "120", "48", "32"], 3),
    ("multibranch_hpo", ["--trials", "2", "--epochs", "1"], 2),
)
# The sha256 of those drivers' data at these sizes, as the CPU build
# makes them (tests/test_torch_drivers_gfm.py holds the generators equal
# to the reference scripts' and this table to the CPU build):
# gfm_digests() on the CPU.
GFM_DIGESTS = {
    "polymers": "c3832a4dd4e64edbb1f69a92ac217d7800bea4276a882c4c44d2ebf74aa6301c",
    "multibranch": "37428ddd124f6eb2dad3eb94ec1b998789877d09c0d9b6dc7924f6b419a306bc",
    "multibranch_nosync": "999fbafe7ba397e35c5d2e0d958630b04b08d8bc372f1b837fce05d802ca292f",
    "multibranch_hpo": "56f9f0c74b3d3a423a4250bdc47c2e219dfbb773f5552a3932d6214ba77bfb19",
    "multidataset": "6a9e69943937e911d07a89c4770f8755295efbbf47fb78549b9805185feae1d5",
    "multidataset_hpo": "d19a1dee93c635f3574ba5edc78252b8c3946c7fc02482d6889e358e486095dd",
    "sc26_frames": "643d8e7fc0bbfdfbfa6d05f1db5444822b6d9052a09c423767018bcf1a307caf",
    "uv_spectrum": "c3a3de5da53a155be717a0a187f32be7b19a96bc2c361aa84c7729515e98e793",
    "ising": "4f217fc971b0dfe0f03548584b8af9a636c16364826af6ff647ce1eec481c10c",
}


def gfm_digests():
    """{data set: sha256} of the item-16c drivers' data at GFM_RUNS' and
    RANK_RUNS' sizes: 100 polymer chains (seed 26), the multibranch branch
    sets at 300/120/80 and 120/48/32 and multibranch_hpo's at 160/80
    (split 0.75), the shuffled family mixes of multidataset (60 a family
    and six reaction paths) and multidataset_hpo (two families), sc26's
    and the relaxation's 64 frames, 100 spectra and 100 Ising lattices.
    Host code only (numpy and the native cell list)."""
    from hydragnn_tpu_torch.drivers import (
        ising,
        multibranch,
        multibranch_hpo,
        multidataset,
        polymers,
        uv_spectrum,
    )
    from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames

    sets = {
        "polymers": polymers.polymer_chains(100),
        "multibranch": [s for b in multibranch.branch_sets((300, 120, 80)) for s in b],
        "multibranch_nosync": [s for b in multibranch.branch_sets((120, 48, 32)) for s in b],
        "multibranch_hpo": [s for b in multibranch_hpo.branch_splits((160, 80))
                            for split in b for s in split],
        "multidataset": multidataset.mixed_samples(multidataset.families(60)),
        "multidataset_hpo": multidataset.mixed_samples(multidataset.families(60,
                                                                             reactions=False)),
        "sc26_frames": random_molecule_frames(64, seed=0),
        "uv_spectrum": uv_spectrum.synthetic_spectra(100),
        "ising": ising.synthetic_ising(100),
    }
    return {k: sample_digest(v) for k, v in sets.items()}


RELAX_TIMED = 20  # back-to-back steps (eager) or replays timed per reading
RELAX_PROFILED = 10  # replays under the profiler


def relax_step_timing(model, sample, pos0, lr, edge_budget=None):
    """One descent step at the first block's batch (padded to the sample,
    or to ``edge_budget`` edge slots): eager ms (RELAX_TIMED steps between
    CUDA events), the step's capture seconds, replayed ms (RELAX_TIMED
    replays), and a replay's split from the profiler (device ms, kernels,
    K1, K2, indexing_backward_kernel). Positions descend as it runs; the
    shape stays."""
    import numpy as np

    import dataclasses

    from hydragnn_tpu_torch.data.graph import PadSpec, collate
    from hydragnn_tpu_torch.drivers import structure_optimization as so
    from hydragnn_tpu_torch.train.capture import collector_paused

    moved = so.block_sample(sample, np.asarray(pos0, np.float32))
    pad = PadSpec.for_samples([moved])
    if edge_budget is not None:
        pad = dataclasses.replace(pad, num_edges=max(edge_budget, moved.num_edges))
    batch = collate([moved], pad, with_segment_plan=True).to("cuda")
    p = torch.as_tensor(np.asarray(pos0, np.float32), device="cuda").clone()
    was = model.training
    model.train(False)
    try:
        eager = eager_ms(lambda: so.descent_step(model, batch, p, lr), iters=RELAX_TIMED,
                         warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            so.descent_step(model, batch, p, lr)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        replay = eager_ms(graph.replay, iters=RELAX_TIMED, warmup=1)
        # a replay runs no wrapper: (0, 0) launches counted a call
        prof = device_profile(graph.replay, (0, 0), "[drivers] a replayed descent step",
                              n_prof=RELAX_PROFILED)
        graph.reset()
    finally:
        model.train(was)
    return {"n": batch.num_nodes, "e": batch.num_edges, "e_valid": int(batch.edge_mask.sum()),
            "eager_ms": eager, "capture_s": capture_s, "replay_ms": replay, **prof}


def relax_held(tag, call):
    """The driver's relaxation (its recorded ``relax`` call) held on the
    card: every energy finite and the last below the first; one block of
    its steps captured (the driver's path) equal to the same block run
    eagerly bit for bit (positions and energies); that block on the card
    within the f32 gradient tolerance (rtol 1e-4, atol 1e-3 x min(max|
    ref|, 1)) of the CPU plain path; and a step's eager, capture and
    replay times, padded to the sample as the driver pads and to a fixed
    edge budget (n x max_neighbours, a shape one capture could serve
    every block with)."""
    import numpy as np

    from hydragnn_tpu_torch.drivers import structure_optimization as so

    model, cfg, sample, pos0 = call["model"], call["cfg"], call["sample"], call["pos0"]
    st, res = call["settings"], call["result"]
    e = np.asarray(res["energies"])
    check(np.isfinite(e).all() and e[-1] < e[0], f"[drivers] {tag}: energies {e.tolist()}")
    one = dict(blocks=1, steps=st["steps"], lr=st["lr"])
    t0 = time.perf_counter()
    cap = so.relax(model, cfg, sample, pos0, device="cuda", capture=True, **one)
    cap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = so.relax(model, cfg, sample, pos0, device="cuda", capture=False, **one)
    eager_s = time.perf_counter() - t0
    check(cap["captures"] == 1 and cap["replays"] == st["steps"] - 1
          and eager["captures"] == 0, f"[drivers] {tag}: block counts {cap}, {eager}")
    check(np.array_equal(cap["pos"].view(np.int32), eager["pos"].view(np.int32))
          and np.array_equal(np.float32(cap["energies"]).view(np.int32),
                             np.float32(eager["energies"]).view(np.int32)),
          f"[drivers] {tag}: the captured block differs from the eager block")
    cpu = so.relax(copy.deepcopy(model).to("cpu"), cfg, sample, pos0, device="cpu", **one)
    pos_err, _ = assert_close_scaled(cap["pos"], cpu["pos"], VJP_TOL,
                                     f"[drivers] {tag}: a block's positions card vs CPU")
    e_err, _ = assert_close_scaled(np.asarray(cap["energies"]), np.asarray(cpu["energies"]),
                                   VJP_TOL, f"[drivers] {tag}: a block's energies card vs CPU")
    n_real = sample.num_nodes
    timing = {"own": relax_step_timing(model, sample, pos0, st["lr"]),
              "budget": relax_step_timing(model, sample, pos0, st["lr"],
                                          edge_budget=n_real * so.MAX_NEIGHBOURS)}
    log(f"[drivers] {tag} relaxation: energies {[round(x, 5) for x in e.tolist()]} (finite, "
        f"falling); one block of {st['steps']} steps captured == eager bit for bit (positions "
        f"and energies; {cap_s:.3f} s captured with its capture, {eager_s:.3f} s eager); card "
        f"vs CPU plain path: positions {pos_err:.3g}, energies {e_err:.3g} (within rtol 1e-4 "
        f"/ atol 1e-3)")
    for name, t in timing.items():
        share = (f"indexing_backward_kernel {t['indexing_backward_ms']:.4f} ms "
                 f"({100 * t['indexing_backward_ms'] / t['device_ms']:.1f}%) of "
                 f"{t['device_ms']:.4f} device ms, {t['kernels_per_call']} kernels, K1 "
                 f"{t['k1_ms']:.4f}, K2 {t['k2_ms']:.4f}" if t.get("device_ms")
                 else "device time not measured (the profiler recorded no kernels)")
        padded = "the sample" if name == "own" else "a fixed edge budget"
        log(f"[drivers] {tag} descent step padded to {padded} (n {t['n']}, e {t['e']}, "
            f"{t['e_valid']} valid): eager {t['eager_ms']:.3f} ms, capture "
            f"{t['capture_s'] * 1e3:.1f} ms, replay {t['replay_ms']:.3f} ms; a replay: "
            f"{share}; {card_line()}")
    return {"energies": e.tolist(), "captured_equals_eager": True, "pos_err": pos_err,
            "energy_err": e_err, "block_captured_s": cap_s, "block_eager_s": eager_s,
            "block_capture_s": cap["capture_seconds"], "timing": timing}


class _StdoutToStderr:
    """File descriptor 1 pointed at 2 while open, so that the processes a
    driver starts print to this script's standard error."""

    def __enter__(self):
        sys.stdout.flush()
        self.saved = os.dup(1)
        os.dup2(2, 1)

    def __exit__(self, *exc):
        sys.stdout.flush()
        os.dup2(self.saved, 1)
        os.close(self.saved)


def rank_driver_run(name, argv, ranks):
    """A multibranch driver's main(argv) on the card with ``ranks`` ranks
    (processes of the driver on cuda:0 over gloo): every rank's every
    count (a training loop's or a trial's K1/K2 against its own forwards
    and train steps) held to predicted_launches, every number finite;
    multibranch: the ranks' parameters equal bit for bit after each epoch,
    and with ``--nosync K`` moving only on every K-th step (else on every
    step); multibranch_hpo: every rank's trials and values equal."""
    import importlib
    import types

    import numpy as np

    mod = importlib.import_module(f"hydragnn_tpu_torch.drivers.{name}")
    nosync = int(argv[argv.index("--nosync") + 1]) if "--nosync" in argv else 0
    tag = name + ("_nosync" if nosync else "")
    t0 = time.perf_counter()
    with _StdoutToStderr(), contextlib.redirect_stdout(sys.stderr):
        out = mod.main(list(argv) + ["--ranks", str(ranks), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    outs = out["ranks"]
    check([o["rank"] for o in outs] == list(range(ranks)), f"[drivers] {tag}: ranks {outs}")
    check(all(np.isfinite(v) for v in driver_numbers(outs)),
          f"[drivers] {tag}: non-finite results {outs}")
    rows = []
    for o in outs:
        for c in o["calls"]:
            cfg = types.SimpleNamespace(mpnn_type=c["mpnn_type"],
                                        num_conv_layers=c["num_conv_layers"],
                                        enable_interatomic_potential=c["potential"])
            want = predicted_launches(dict(c, cfg=cfg))
            check((c["k1"], c["k2"]) == want,
                  f"[drivers] {tag} rank {o['rank']} {c['call']}: K1 {c['k1']}, K2 "
                  f"{c['k2']}, predicted {want} from {c}")
            rows.append(dict(c, rank=o["rank"], per_pass=launches_per_pass(cfg)))
    held = ""
    if name == "multibranch":
        for e in range(len(outs[0]["epoch_digests"])):
            check(len({o["epoch_digests"][e] for o in outs}) == 1,
                  f"[drivers] {tag}: the ranks' parameters differ after epoch {e}")
        for o in outs:
            d = o["step_digests"]
            moved = [a != b for a, b in zip(d, d[1:])]
            want = [nosync < 2 or (i + 1) % nosync == 0 for i in range(len(moved))]
            check(moved == want, f"[drivers] {tag} rank {o['rank']}: parameters moved "
                  f"{moved}, want {want}")
        held = (f"the ranks' parameters equal bit for bit after each of "
                f"{len(outs[0]['epoch_digests'])} epochs; they moved "
                + (f"on every {nosync}-th step only ({sum(moved)} of {len(moved)})" if nosync
                   else f"on every one of {len(moved)} steps"))
    else:
        check(all(o["trials"] == outs[0]["trials"] for o in outs),
              f"[drivers] {tag}: the ranks' trials differ")
        held = f"every rank ran the same {len(outs[0]['trials'])} trials with the same values"
    log(f"[drivers] {tag} {' '.join(argv)} on {ranks} ranks ({outs[0].get('backend', 'gloo')} "
        f"on cuda:0): {seconds:.1f} s; " + "; ".join(
            f"rank {r['rank']} {r['call']} ({r['mpnn_type']}, {r['per_pass']} a pass) K1 "
            f"{r['k1']} K2 {r['k2']} = predicted ({r['forwards']} forwards, "
            f"{r['train_steps']} train steps)" for r in rows) + f"; {held}")
    result = {k: v for k, v in outs[0].items() if k not in ("step_digests", "calls")}
    return {"driver": tag, "seconds": seconds, "ranks": ranks, "calls": rows,
            "result": result}


def abw_kernel_rows(tag, batch, f_in, f_out, seed, what):
    """K1 and K2 in SchNet's a,b,W flavour (f_in -> f_out) on ``batch``'s
    plan, in f32 and bf16: against their plain versions (same bits on two
    runs), the times beside the bound and the plain version (no library
    call computes this flavour)."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    dev = batch.seg_perm.device
    gen = torch.Generator().manual_seed(seed)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    n, e = batch.num_nodes, batch.num_edges
    e_valid = int(batch.edge_mask.sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    rows = []
    for dt, tol, vjp_tol in ((torch.float32, F32_TOL, VJP_TOL),
                             (torch.bfloat16, BF16_TOL, BF16_TOL)):
        a = torch.randn(e, f_in, generator=gen).to(dev, dt)
        b = torch.randn(e, f_in, generator=gen).to(dev, dt)
        w = (torch.randn(f_in, f_out, generator=gen) / f_in ** 0.5).to(dev, dt)
        g = torch.randn(n, f_out, generator=gen).to(dev, dt)
        args = (a, b, w, *plan, n)
        with torch.no_grad():
            got, again, ref = (edge_pipeline_planned(*args), edge_pipeline_planned(*args),
                               edge_pipeline_plain(*args))
        d, d_again, d_ref = (edge_pipeline_bwd_planned(g, *args),
                             edge_pipeline_bwd_planned(g, *args), edge_pipeline_bwd_plain(g, *args))
        torch.cuda.synchronize()
        name = mix_name(dt, dt)
        check(torch.equal(got, again) and all(torch.equal(x, y) for x, y in zip(d, d_again)),
              f"[{tag}] a,b,W {f_in} -> {f_out} {name}: two runs differ")
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        for x, y in zip(d, d_ref):
            torch.testing.assert_close(x.float(), y.float(), **vjp_tol)
        row = {"f_in": f_in, "f_out": f_out, "flavour": "abw", "dtype": name, "n": n, "e": e,
               "e_valid": e_valid,
               "k1_max_abs_err": float((got.float() - ref.float()).abs().max()),
               "k2_max_abs_err": max(float((x.float() - y.float()).abs().max())
                                     for x, y in zip(d, d_ref)),
               "k1_library_ms": None, "k2_library_ms": None}
        with torch.no_grad():
            row["k1_ms"] = time_ms(lambda: edge_pipeline_planned(*args))
            row["k1_plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
        row["k2_ms"] = time_ms(lambda: edge_pipeline_bwd_planned(g, *args))
        row["k2_plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(g, *args))
        nbytes, ops, out_dt = k1_work(e_valid, n, f_in, f_out, slots, blocks, dt, dt, True, True)
        row["k1_bound_ms"], row["k1_bound_by"] = bound(nbytes, ops, out_dt)
        nbytes, ops, g_dt = k2_work(e, e_valid, n, f_in, f_out, slots, blocks, dt, dt, True,
                                    True)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(nbytes, ops, g_dt)
        rows.append(row)
        log(f"[{tag}] {what}: a,b,W {f_in} -> {f_out} {name}: K1 max|err| "
            f"{row['k1_max_abs_err']:.3g}, {row['k1_ms'] * 1e3:.1f} us, plain "
            f"{row['k1_plain_ms'] * 1e3:.1f} us, bound {row['k1_bound_ms'] * 1e3:.2f} us "
            f"({row['k1_bound_by']}); K2 max|err| {row['k2_max_abs_err']:.3g}, "
            f"{row['k2_ms'] * 1e3:.1f} us, plain {row['k2_plain_ms'] * 1e3:.1f} us, bound "
            f"{row['k2_bound_ms'] * 1e3:.2f} us ({row['k2_bound_by']}); same bits on two runs")
    return rows


def gfm_kernel_rows():
    """K1 and K2 at the item-16c drivers' new widths, on the first train
    bin of sc26's 64 frames under its base config (SchNet hidden 16): the
    PAINN trials' reduce-only F = 16 (scalar) and 48 (vector; half a
    32-column slab and one and a half), and SchNet's a,b,W at F = 16
    (num_filters 16 -> hidden 16), f32 and bf16 against their plain
    versions."""
    from hydragnn_tpu_torch.drivers import common, sc26_hpo
    from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames

    trainset = common.split(random_molecule_frames(64, seed=0))[0]
    loader, budgets = train_loader(sc26_hpo.base_config(1, 8), trainset)
    batch = next(iter(loader)).to("cuda")
    what = (f"sc26's first {'packed ' if loader.packing else ''}train bin (budgets "
            f"{budget_keys(budgets)})")
    return {"painn": [r for f in (16, 48) for r in reduce_kernel_rows("drivers", batch, f,
                                                                       500 + f, what)],
            "schnet": abw_kernel_rows("drivers", batch, 16, 16, 516, what)}



def phase_drivers():
    """The port's example drivers run on the card through their main()
    (9c in the module docstring): DRIVER_RUNS' eight, the atomistic ones
    (ATOMISTIC_RUNS) and the last nine (GFM_RUNS in this process,
    RANK_RUNS on ranks of their own), then K1 and K2 at the new widths
    (driver_kernel_rows, gfm_kernel_rows). The counts start at 0 here;
    ``k1``/``k2`` are the first eight's launches, ``k1_atomistic``/
    ``k2_atomistic`` the atomistic drivers', ``k1_gfm``/``k2_gfm`` the
    last nine's (every rank's), the card-vs-CPU steps, the relaxation's
    checks and the kernel checks not counted."""
    import importlib
    import shutil
    import tempfile

    import numpy as np

    from hydragnn_tpu_torch.drivers import common, lj_data, md17, zinc
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    t_phase = time.perf_counter()
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    t0 = time.perf_counter()
    digests = driver_digests()
    atomistic = atomistic_digests()
    gfm = gfm_digests()
    gen_s = time.perf_counter() - t0
    for table, got in ((DRIVER_DIGESTS, digests), (ATOMISTIC_DIGESTS, atomistic),
                       (GFM_DIGESTS, gfm)):
        check(set(got) == set(table), f"[drivers] digests of {sorted(got)}, table of "
              f"{sorted(table)}")
        for name, want in table.items():
            check(got[name] == want, f"[drivers] {name}'s samples differ from the CPU build "
                  f"(sha256 {got[name][:16]} against {want[:16]})")
    check(sample_digest(md17.synthetic_md17(60)) == sample_digest(md17_frames(60)),
          "[drivers] md17's frames differ from [mlip]'s copy of the stand-in")
    check(sample_digest(zinc.synthetic_zinc(200)) == sample_digest(synthetic_zinc(200)),
          "[drivers] zinc's molecules differ from [zinc]'s copy of zinc.py's")
    check(np.array_equal(lj_data.configuration((3, 3, 3), np.random.default_rng(0)).pos,
                         lj_cluster().pos),
          "[drivers] LJ_data's 3x3x3 configuration differs from [md]'s cluster")
    alexandria_held = alexandria_targets_held()
    log(f"[drivers] generators ({gen_s:.2f} s on the host): every sample set equal to the "
        f"CPU build bit for bit (sha256 of its records: "
        + ", ".join(f"{k} {v[:12]}" for k, v in {**digests, **atomistic, **gfm}.items())
        + "); md17's and zinc's also equal [mlip]'s and [zinc]'s copies, LJ's 3x3x3 "
        "configuration [md]'s cluster")
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
        log("[drivers] matplotlib does not import here: the plot hook is held to raise its "
            "ImportError, and the runs below draw no plots")

    work = tempfile.mkdtemp(prefix="drivers_")
    runs, atomistic_runs, gfm_runs = [], [], []
    try:
        for name, argv in DRIVER_RUNS:
            plot_cfg = (plot_config(common.example_path(name, f"{name}.json"), work)
                        if name in PLOT_FILES else None)
            if plot_cfg and not have_mpl:
                mod = importlib.import_module(f"hydragnn_tpu_torch.drivers.{name}")
                try:
                    with contextlib.redirect_stdout(sys.stderr):
                        mod.main(list(argv) + ["--config", plot_cfg, "--device", "cuda"])
                except ImportError as e:
                    log(f"[drivers] {name} with create_plots: the hook raised ImportError "
                        f"({e})")
                else:
                    check(False, f"[drivers] {name}: create_plots without matplotlib did "
                          "not raise")
                plot_cfg = None
            run = driver_run(name, argv, plot_cfg)
            if name == "qm9_hpo":
                mib = run["result"]["device_mib"]
                check(len(mib) == 2 and abs(mib[-1] - mib[0]) < HPO_MEMORY_MIB,
                      f"[drivers] qm9_hpo: device memory after each trial {mib} MiB")
                log(f"[drivers] qm9_hpo: device memory allocated after each trial "
                    f"{[round(m, 2) for m in mib]} MiB (within {HPO_MEMORY_MIB} MiB)")
            runs.append(run)
        for name, argv in ATOMISTIC_RUNS:
            atomistic_runs.append(driver_run(name, argv, None))
        t_gfm = time.perf_counter()
        for name, argv in GFM_RUNS:
            gfm_runs.append(driver_run(name, argv, None))
        for name, argv, ranks in RANK_RUNS:
            gfm_runs.append(rank_driver_run(name, argv, ranks))
        gfm_s = time.perf_counter() - t_gfm
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k1, k2 = (sum(r[k] for run in runs for r in run["calls"]) for k in ("k1", "k2"))
    k1_at, k2_at = (sum(r[k] for run in atomistic_runs for r in run["calls"])
                    for k in ("k1", "k2"))
    k1_gfm, k2_gfm = (sum(r[k] for run in gfm_runs for r in run["calls"]) for k in ("k1", "k2"))
    check(k1 > 0 and k2 > 0 and k1_at > 0 and k2_at > 0 and k1_gfm > 0 and k2_gfm > 0,
          f"[drivers] K1 {k1} + {k1_at} + {k1_gfm}, K2 {k2} + {k2_at} + {k2_gfm}")
    runs_s = time.perf_counter() - t_phase
    log(f"[drivers] runs: {runs_s:.1f} s (the last nine drivers' {gfm_s:.1f} s); K1 {k1}, K2 "
        f"{k2} launched by the first eight drivers' counted runs, K1 {k1_at}, K2 {k2_at} by "
        f"the atomistic drivers', K1 {k1_gfm}, K2 {k2_gfm} by the last nine's (every rank's; "
        f"the card-vs-CPU steps, the relaxation's checks and the runs held to raise "
        f"ImportError not counted)")
    kernel_rows = dict(driver_kernel_rows(), **gfm_kernel_rows())
    seconds = time.perf_counter() - t_phase
    log(f"[drivers] phase: {seconds:.1f} s; {card_line()}")
    return {"k1": k1, "k2": k2, "k1_atomistic": k1_at, "k2_atomistic": k2_at,
            "k1_gfm": k1_gfm, "k2_gfm": k2_gfm, "seconds": seconds, "runs_seconds": runs_s,
            "gfm_seconds": gfm_s, "digests": {**digests, **atomistic, **gfm},
            "alexandria_targets": alexandria_held, "runs": runs,
            "atomistic_runs": atomistic_runs, "gfm_runs": gfm_runs, "kernel_rows": kernel_rows}


# ---------------------------------------------------------------- [zinc]

ZINC_LOGP = {6: 0.34, 7: -0.8, 8: -0.55, 9: 0.2, 16: 0.6}  # C N O F S
ZINC_WIDTH = 128  # PNA's moment pass: [h, h*h] at hidden 64


def synthetic_zinc(n_mols=400, seed=0):
    """examples/zinc/zinc.py's ZINC-like molecules (``synthetic_zinc``),
    from the same seeded generator in its order of draws, with the
    port's Laplacian and relative PE (pe_dim 8): a random tree of 12-32
    organic atoms plus ring closures, bond edges both ways, a
    penalized-logP-like target, random layout positions."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.pe import laplacian_pe, relative_pe

    rng = np.random.default_rng(seed)
    types = np.array(list(ZINC_LOGP))
    probs = np.array([0.6, 0.12, 0.16, 0.06, 0.06])
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(12, 33))
        z = rng.choice(types, n, p=probs)
        edges = [(i, int(rng.integers(0, i))) for i in range(1, n)]
        n_rings = int(rng.integers(0, 4))
        for _ in range(n_rings):
            a, b = rng.integers(0, n, 2)
            if a != b:
                edges.append((int(a), int(b)))
        snd = np.array([e[0] for e in edges] + [e[1] for e in edges])
        rcv = np.array([e[1] for e in edges] + [e[0] for e in edges])
        ei = np.stack([snd, rcv]).astype(np.int64)
        deg = np.bincount(snd, minlength=n)
        y = (sum(ZINC_LOGP[int(t)] for t in z) / n + 0.15 * n_rings
             - 0.1 * float((deg > 3).sum()))
        pos = rng.uniform(0, n ** (1 / 3), (n, 3)).astype(np.float32)
        pe = laplacian_pe(ei, n, 8)
        out.append(GraphSample(x=z.reshape(-1, 1).astype(np.float32), pos=pos,
                               edge_index=ei, pe=pe, rel_pe=relative_pe(ei, pe),
                               y_graph=np.array([y], np.float32)))
    return out


def zinc_data():
    """examples/zinc/zinc.json and zinc_bf16.json cut to 2 epochs, and
    zinc.py's 400 molecules (seed 0) split 0.8 as zinc.py's main() splits
    them."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "zinc")
    configs = {}
    for precision, name in (("fp32", "zinc.json"), ("bf16", "zinc_bf16.json")):
        with open(os.path.join(here, name)) as f:
            config = json.load(f)
        config["Verbosity"] = {"level": 0}
        config["NeuralNetwork"]["Training"]["num_epoch"] = 2
        configs[precision] = config
    t0 = time.perf_counter()
    samples = synthetic_zinc(400)
    splits = split_dataset(samples, 0.8)
    log(f"[zinc] zinc.json's PNAPlus + GPS (hidden 64, 3 layers, num_radial 5, GPS "
        f"multihead x4, pe_dim 8, num_nodes 40; graph head 2x64 + [64, 64]; AdamW 0.002, "
        f"batch 64, packing auto with 2 budgets), 2 epochs, f32 and bf16; zinc.py's 400 "
        f"molecules of 12-32 atoms (seed 0, Laplacian PE by eigh on the host), splits "
        f"{[len(x) for x in splits]}, made in {time.perf_counter() - t0:.2f} s")
    return configs, splits


def phase_zinc_kernels(batch):
    """K1 and K2 in the reduce-only flavour at PNA's moment-pass width
    (F = 128) on the first packed train bin's plan (``reduce_kernel_rows``)."""
    return reduce_kernel_rows("zinc-kernels", batch, ZINC_WIDTH, 11)


def reduce_kernel_rows(tag, batch, f, seed, what="first packed train bin"):
    """K1 and K2 in the reduce-only flavour at width ``f`` on ``batch``'s
    plan, in f32 and bf16: against their plain versions (same bits on two
    runs, K2 zero off the plan), the launch shape and shared memory per
    CTA, and the times beside the bound, the plain version and one
    library call (index_add_ for K1, index_select of g's rows for K2)."""
    from hydragnn_tpu_torch.ops.cuda_build import load_library
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    lib = load_library()
    dev = batch.seg_perm.device
    gen = torch.Generator().manual_seed(seed)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    n, e = batch.num_nodes, batch.num_edges
    e_valid = int(batch.edge_mask.sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    covered = torch.zeros(e, dtype=torch.bool, device=dev)
    covered[plan[0][plan[2]].long()] = True
    shapes = {k: launch_shape(lib, k, n, e, f, f, 32, has_b=False, has_w=False)
              for k in ("k1", "k2")}
    log(f"[{tag}] {what}: n {n}, e {e} ({e_valid} valid), "
        f"{batch.num_graphs} graph slots, plan {slots} slots in {blocks} blocks; F = {f}: "
        f"K1 {shapes['k1']}; K2 {shapes['k2']}")
    rows = []
    for dt, tol, vjp_tol in ((torch.float32, F32_TOL, VJP_TOL),
                             (torch.bfloat16, BF16_TOL, BF16_TOL)):
        a = torch.randn(e, f, generator=gen).to(dev, dt)
        g = torch.randn(n, f, generator=gen).to(dev, dt)
        args = (a, None, None, *plan, n)
        with torch.no_grad():
            got, again = edge_pipeline_planned(*args), edge_pipeline_planned(*args)
            ref = edge_pipeline_plain(*args)
        d_a, d_b, d_w = edge_pipeline_bwd_planned(g, *args)
        d_again = edge_pipeline_bwd_planned(g, *args)[0]
        d_ref = edge_pipeline_bwd_plain(g, *args)[0]
        torch.cuda.synchronize()
        name = mix_name(dt, dt)
        check(torch.equal(got, again) and torch.equal(d_a, d_again),
              f"F={f} {name}: two runs differ")
        check(got.dtype == dt and d_a.dtype == dt and d_b is None and d_w is None,
              f"F={f} {name}: output types")
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        torch.testing.assert_close(d_a.float(), d_ref.float(), **vjp_tol)
        check(not bool(d_a[~covered].any()), f"F={f} {name}: K2 nonzero off the plan")
        row = {"f": f, "dtype": name, "n": n, "e": e, "e_valid": e_valid,
               "k1_launch": shapes["k1"], "k2_launch": shapes["k2"],
               "k1_max_abs_err": float((got.float() - ref.float()).abs().max()),
               "k2_max_abs_err": float((d_a.float() - d_ref.float()).abs().max())}
        a_valid = a[batch.edge_mask]
        rcv_valid = batch.receivers[batch.edge_mask].long()
        out = torch.zeros(n, f, dtype=dt, device=dev)
        with torch.no_grad():
            row["k1_ms"] = time_ms(lambda: edge_pipeline_planned(*args))
            row["k1_plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
            row["k1_library_ms"] = time_ms(lambda: out.index_add_(0, rcv_valid, a_valid))
            row["k2_ms"] = time_ms(lambda: edge_pipeline_bwd_planned(g, *args))
            row["k2_plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(g, *args))
            row["k2_library_ms"] = time_ms(lambda: g.index_select(0, batch.receivers))
        nbytes, ops, out_dt = k1_work(e_valid, n, f, f, slots, blocks, dt, dt, False, False)
        row["k1_bound_ms"], row["k1_bound_by"] = bound(nbytes, ops, out_dt)
        nbytes, ops, g_dt = k2_work(e, e_valid, n, f, f, slots, blocks, dt, dt, False, False)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(nbytes, ops, g_dt)
        rows.append(row)
        log(f"[{tag}] F = {f} {name}: K1 max|err| {row['k1_max_abs_err']:.3g}, "
            f"{row['k1_ms'] * 1e3:.1f} us, plain {row['k1_plain_ms'] * 1e3:.1f} us, "
            f"index_add_ {row['k1_library_ms'] * 1e3:.1f} us, bound "
            f"{row['k1_bound_ms'] * 1e3:.2f} us ({row['k1_bound_by']}); K2 max|err| "
            f"{row['k2_max_abs_err']:.3g}, {row['k2_ms'] * 1e3:.1f} us, plain "
            f"{row['k2_plain_ms'] * 1e3:.1f} us, index_select "
            f"{row['k2_library_ms'] * 1e3:.1f} us, bound {row['k2_bound_ms'] * 1e3:.2f} us "
            f"({row['k2_bound_by']})")
    log(f"[{tag}] K1 and K2, reduce-only, F = {f} in f32 and bf16: 4 comparisons "
        f"passed (identical bits on two runs; K2 zero off the plan)")
    return rows


def zinc_step(model, cfg, training, batch, compute_dtype):
    """One AdamW step of ``model`` on ``batch`` in train mode: the loss,
    gradients, updated parameters and running statistics on the host,
    and the K1/K2 launches of the step."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    # copies: on the CPU .numpy() would share the parameters' memory
    before = {k: v.detach().float().cpu().numpy().copy() for k, v in model.named_parameters()}
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    loss, grads, params = one_step(model, cfg, training, batch, compute_dtype)
    launches = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
    stats = {k: v.float().cpu().numpy() for k, v in model.named_buffers()}
    return {"loss": loss, "grads": grads, "params": params, "stats": stats,
            "before": before, "launches": launches}


def hold_zinc_step(card, cpu, tol, lr, what):
    """The card's first step against the CPU's: the loss at ``tol`` (f32:
    F32_TOL), the gradients at ``tol`` with the atol scaled by the
    largest gradient over all parameters (a bias in front of a batch
    norm and the attention's key bias have a true gradient of zero, and
    both sides return rounding noise there), the updated parameters the
    same way except where the CPU's gradient is within the gradient
    tolerance of zero (AdamW's first step moves an entry by lr x sign(g),
    and a sign inside the tolerance is not determined: held to a move of
    at most lr plus decay), and the running statistics at ``tol``
    unscaled (a norm after a norm sees a batch mean of rounding noise).
    Returns the largest errors."""
    import numpy as np

    loss_tol = F32_TOL if tol is VJP_TOL else tol
    worst = {"loss": assert_close_scaled(np.asarray(card["loss"]), np.asarray(cpu["loss"]),
                                         loss_tol, f"{what} loss")[0]}
    g_scale = max(float(np.abs(g).max()) for g in cpu["grads"].values())
    p_scale = max(float(np.abs(p).max()) for p in cpu["params"].values())
    worst["grad"] = max(assert_close_scaled(card["grads"][k], cpu["grads"][k], tol,
                                            f"{what} grad {k}", scale=g_scale)[0]
                        for k in cpu["grads"])
    worst["param"] = 0.0
    for k, ref in cpu["params"].items():
        got, old = card["params"][k], cpu["before"][k]
        same = np.isclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * min(p_scale, 1.0))
        noise = np.abs(cpu["grads"][k]) <= tol["atol"] * min(g_scale, 1.0)
        small = np.abs(got - old) <= lr * (1.0 + 1e-4 * np.abs(old)) * 1.001
        bad = ~(same | (noise & small))
        if bad.any():
            i = np.unravel_index(np.argmax(np.where(bad, np.abs(got - ref), -1)), got.shape)
            check(False, f"{what} param {k}: {int(bad.sum())} entries off, the worst at {i}: "
                  f"card {got[i]:.6g}, CPU {ref[i]:.6g}, before {old[i]:.6g}; gradient card "
                  f"{card['grads'][k][i]:.6g}, CPU {cpu['grads'][k][i]:.6g}; largest |grad| "
                  f"{g_scale:.3g}")
        worst["param"] = max(worst["param"], float(np.abs(got - ref)[same].max(initial=0)))
    worst["stats"] = max((assert_close_scaled(card["stats"][k], cpu["stats"][k],
                                              F32_TOL if tol is VJP_TOL else tol,
                                              f"{what} stat {k}", scale=1.0)[0]
                          for k in cpu["stats"]), default=0.0)  # a model may have none
    worst["scales"] = (g_scale, p_scale)
    return worst


def zinc_run(config, splits, budgets):
    """run_training of a ZINC config on the card, then run_prediction:
    finite losses, every train batch a packed bin of the budgets, K1 and
    K2 launch counts (3 K1 per forward, 3 K2 per train step), finite
    predictions of the expected shape."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    precision = config["NeuralNetwork"]["Training"].get("precision", "fp32")
    with recorded_run() as rec:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, datasets=splits,
                                                          seed=0, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k1, k2, n_fwd = (edge_pipeline_planned.launches,
                         edge_pipeline_bwd_planned.launches, rec["forwards"])
        steps = torch.cat(rec["losses"]).double().cpu().numpy()
        shapes = list(rec["shapes"])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        rec["forwards"] = 0
        err, tasks, trues, preds = port.run_prediction(full, datasets=splits, state=state,
                                                       model=model, cfg=cfg)
        torch.cuda.synchronize()
        k1_pred, k2_pred, n_fwd_pred = (edge_pipeline_planned.launches,
                                        edge_pipeline_bwd_planned.launches, rec["forwards"])
    eager_s, _ = eager_seconds(lambda: port.run_training(config, datasets=splits, seed=0,
                                                         device="cuda"))
    graphs = graph_report(f"zinc] [{precision}", state, hist, train_s, eager_s)
    layers = cfg.num_conv_layers
    keys = set(budget_keys(budgets))
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [err]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"{precision}: non-finite loss in {losses} or in the steps {steps.tolist()}")
    check(len(steps) == state.step > 0 and set(shapes) <= keys,
          f"{precision}: train batches {sorted(set(shapes))} are not all packed bins {keys}")
    check(k1 == layers * n_fwd and k2 == layers * state.step,
          f"{precision} run_training: K1 {k1} in {n_fwd} forwards, K2 {k2} in "
          f"{state.step} train steps (want {layers} per forward and per step)")
    check(k1_pred == layers * n_fwd_pred and k2_pred == 0 and n_fwd_pred > 0,
          f"{precision} run_prediction: K1 {k1_pred}, K2 {k2_pred}, {n_fwd_pred} forwards")
    n_test = len(splits[2])
    check(preds[0].shape == trues[0].shape == (n_test, 1) and np.isfinite(preds[0]).all(),
          f"{precision} run_prediction wants finite [graphs, 1] predictions")
    fell = hist.train_loss[-1] < steps[0]
    log(f"[zinc] {precision}: run_training on the card ({train_s:.2f} s, {state.step} train "
        f"steps on packed bins {sorted(set(shapes))}, {n_fwd} forwards): train loss "
        f"{hist.train_loss}, val {hist.val_loss}, test {hist.test_loss}; the last epoch's "
        f"mean train loss is {'below' if fell else 'not below'} the first step's "
        f"{steps[0]:.6g}")
    log(f"[zinc] {precision}: per-step train loss {[float(f'{x:.4g}') for x in steps]}")
    log(f"[zinc] {precision}: K1 launches {k1} = {layers} x {n_fwd} forwards, K2 launches "
        f"{k2} = {layers} x {state.step} train steps; run_prediction error {err:.6g} over "
        f"{n_test} molecules, K1 {k1_pred} = {layers} x {n_fwd_pred} forwards, K2 0")
    return {"k1": k1 + k1_pred, "k2": k2, "steps": state.step, "forwards": n_fwd + n_fwd_pred,
            "step_losses": steps.tolist(), "train_loss": hist.train_loss,
            "val_loss": hist.val_loss, "test_loss": hist.test_loss,
            "prediction_error": err, "seconds": train_s, "graphs": graphs,
            "loss_fell": bool(fell), "bins": sorted(set(shapes))}


def log_feed(tag, config):
    """Log (and return) the feed ``config``'s run_training resolves on
    this host (``parallel/runtime.feed_line``: the collation workers by
    default on 4 or more CPUs), for phases whose runs happen in child
    processes."""
    from hydragnn_tpu_torch.parallel import runtime

    plan = runtime.plan_from_config(config, n_devices=1)
    line = runtime.feed_line(plan) if plan.scheme != "multibranch" else (
        f"multibranch: prefetch={plan.prefetch} (pipeline.workers "
        f"{plan.pipeline_workers} ignored)")
    log(f"[{tag}] feed: {line} (os.cpu_count() {os.cpu_count()})")
    return line


def install_feed_log():
    """From here on every run_training of this process logs the feed it
    resolved, as a "[feed]" line (the runner resolves it once a run,
    through ``parallel/runtime.feed_line``)."""
    from hydragnn_tpu_torch.parallel import runtime

    plain = runtime.feed_line

    def logged(plan):
        line = plain(plan)
        log(f"[feed] {plan.scheme}: {line} (os.cpu_count() {os.cpu_count()})")
        return line

    runtime.feed_line = logged


@contextlib.contextmanager
def captured_keys():
    """While open, every CUDA-graph capture of a step is recorded as
    (its key's kind, the epoch the run's compile observer is in)."""
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.utils import telemetry

    seen = []
    plain = StepGraphs.capture

    def capture(self, key, fn, batches):
        obs = telemetry.observer()
        seen.append((key[0], None if obs is None else obs.phase))
        return plain(self, key, fn, batches)

    StepGraphs.capture = capture
    try:
        yield seen
    finally:
        StepGraphs.capture = plain


def pipeline_run(tag, config, splits, feed, late_captures=False, phase="pipeline"):
    """One run_training of ``config`` on the card through ``feed`` (a
    ``Parallelism`` update), telemetry on, fed ``splits`` (the config's
    ``Dataset`` files where None). Returns what [pipeline] and [formats]
    compare and print. A train step captured at epoch 1 or later fails
    the run unless ``late_captures`` (a long epoch's packing can reach a
    budget at epoch 1 that epoch 0 never filled; the feeds must then
    agree on the captures per epoch, which ``pipeline_compare`` checks)."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    config = copy.deepcopy(config)
    config.setdefault("Dataset", {})["name"] = f"pipeline_{tag}"
    training = config["NeuralNetwork"]["Training"]
    training["Parallelism"] = dict(training.get("Parallelism", {}), **feed)
    training["Telemetry"] = {"enabled": True, "heartbeat_interval_s": 600}
    line = log_feed(f"{phase}] [{tag}", config)
    with recorded_run() as rec, captured_keys() as caps:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, datasets=splits, seed=0,
                                                          device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        steps = [x.clone() for x in rec["losses"]]
    with open(os.path.join("logs", full["_log_name"], "telemetry.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = rows[max(i for i, r in enumerate(rows) if r["t"] == "header"):]  # this run's
    epochs = len(hist.train_loss)
    wait = [[r["input_wait_ms"] for r in rows if r["t"] == "step" and r["region"] == "train"
             and r["epoch"] == e] for e in range(epochs)]
    pipe = [r for r in rows if r["t"] == "pipeline"]
    per_epoch = []
    if pipe:
        # one row per pass as each feed closes: train, val, test per epoch
        check(len(pipe) == 3 * epochs, f"{tag}: {len(pipe)} pipeline rows for {epochs} epochs")
        prev = {}
        for e in range(epochs):
            row = pipe[3 * e]  # cumulative: the train feed's totals after epoch e
            n = row["delivered_batches"] - prev.get("delivered_batches", 0)
            d = {k: row.get(k, 0) - prev.get(k, 0) for k in
                 ("collate_s_total", "h2d_s_total", "starved_steps", "delivered_batches")}
            per_epoch.append({"epoch": e, "chunks": n, "starved": d["starved_steps"],
                              "collate_ms_per_delivery": round(
                                  1e3 * d["collate_s_total"] / max(len(wait[e]), 1), 4),
                              "h2d_ms_per_delivery": round(
                                  1e3 * d["h2d_s_total"] / max(len(wait[e]), 1), 4),
                              "queue_depth_avg_cum": row.get("queue_depth_avg")})
            prev = row
    execs = [r for r in rows if r["t"] == "executable"]
    check(not [r for r in execs if "capture_error" in r],
          f"{tag}: capture_error rows {[r for r in execs if 'capture_error' in r]}")
    check(state.graphs is not None and state.graphs.replays > 0
          and state.graphs.captures == len(state.graphs.graphs),
          f"{tag}: the steps were not replayed once per key")
    late_train = [c for c in caps if c[0] == "train" and (c[1] or 0) >= 1]
    check(late_captures or not late_train,
          f"{tag}: train steps captured at epoch 1 or later: {late_train}")
    n_train = [len(w) for w in wait]
    return {"state": state, "hist": hist, "steps": steps, "k1": k1, "k2": k2,
            "seconds": seconds, "captures": [c for c in caps], "config": full,
            "report": {"feed": line, "cpus": os.cpu_count(),
                       "seconds": round(seconds, 4), "epoch_seconds": hist.epoch_seconds,
                       "epoch_captures": hist.epoch_captures,
                       "input_wait_ms_per_step": [round(float(np.mean(w)), 4) if w else None
                                                  for w in wait],
                       "train_dispatches": n_train,
                       "h2d_ms_per_batch": round(1e3 * state.graphs.h2d_seconds
                                                 / max(state.graphs.h2d_batches, 1), 4),
                       "pipeline_epochs": per_epoch, "k1": k1, "k2": k2}}


def assembly_times(tag, config, trainset, limit=None):
    """Host ms per batch of the three ways the feed can assemble a batch,
    over the train loader's epoch-0 plan (its first ``limit`` entries),
    in one thread so no sibling's GIL wait is in the clock: the loader's
    ``collate_entry`` (``graph.collate``: the feed with ``packed`` off),
    ``collate_packed`` (packed, no column store) and
    ``PackedStore.assemble`` (packed, the default), both packed ones into
    per-spec buffers reused as the card's recycling reuses them. Each is
    checked bit for bit against ``collate_entry`` on every entry, then
    timed as the best of two passes; the store's build is timed apart."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import PadSpec
    from hydragnn_tpu_torch.data.pipeline import PackedStore, collate_packed

    loader, _ = train_loader(config, trainset)
    plan = list(loader.epoch_plan(0))[:limit]
    ds = loader.dataset
    t0 = time.perf_counter()
    store = PackedStore.build(ds)
    build_ms = 1e3 * (time.perf_counter() - t0)
    check(store is not None, f"[pipeline] {tag}: the column store refused the train split")
    pools = {}

    def spec_of(idx, spec):
        if spec is not None:
            return spec
        return PadSpec.for_samples([ds[i] for i in idx], with_triplets=loader.with_triplets)

    def packed(idx, spec):
        spec = spec_of(idx, spec)
        return collate_packed([ds[i] for i in idx], spec,
                              with_segment_plan=loader.with_segment_plan,
                              out=pools.setdefault(("packed", spec), {})).to("cpu")

    def stored(idx, spec):
        spec = spec_of(idx, spec)
        return store.assemble(np.asarray(idx), spec, with_segment_plan=loader.with_segment_plan,
                              out=pools.setdefault(("store", spec), {})).to("cpu")

    ways = {"collate_entry": loader.collate_entry, "collate_packed": packed,
            "store_assemble": stored}
    for idx, spec in plan:
        ref = loader.collate_entry(idx, spec).arrays()
        for name in ("collate_packed", "store_assemble"):
            got = ways[name](idx, spec).arrays()
            check(got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref),
                  f"[pipeline] {tag}: {name} differs from collate_entry")
    ms = {}
    for name, fn in ways.items():
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            for idx, spec in plan:
                fn(idx, spec)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        ms[name] = round(1e3 * best / len(plan), 4)
    return {"batches": len(plan), "graphs_per_batch": round(
        float(np.mean([len(idx) for idx, _ in plan])), 2), "ms_per_batch": ms,
        "store_build_ms": round(build_ms, 3), "samples": len(ds)}


PIPELINE_LONG_MOLS = 16000  # [pipeline]'s real epoch: ~200 packed zinc train steps
PIPELINE_FEEDS = {
    "pipeline": {"pipeline": {"workers": 4, "depth": 4, "chunk": 4, "packed": True},
                 "prefetch": 2},
    "unpacked": {"pipeline": {"workers": 4, "depth": 4, "chunk": 4, "packed": False},
                 "prefetch": 2},
    "serial": {"pipeline": {"workers": 0}, "prefetch": 0},
    "prefetch": {"pipeline": {"workers": 0}, "prefetch": 2},
}


def runs_equal(what, got, want, ref):
    """Two ``pipeline_run`` results equal bit for bit: per-step losses,
    History (captures per epoch included), the final state (parameters,
    AdamW state) and K1/K2 launches, both above zero. ``what`` names
    ``got`` and ``ref`` names ``want`` in a failure's message."""
    import numpy as np

    check(len(got["steps"]) == len(want["steps"]) > 0
          and all(torch.equal(a, b) for a, b in zip(got["steps"], want["steps"])),
          f"{what}: per-step losses differ from {ref}'s")
    for field in ("train_loss", "val_loss", "test_loss", "lr", "epoch_captures"):
        check(getattr(got["hist"], field) == getattr(want["hist"], field),
              f"{what}: History.{field} {getattr(got['hist'], field)} != {ref}'s "
              f"{getattr(want['hist'], field)}")
    for field in ("train_tasks", "val_tasks", "test_tasks"):
        check(all(np.array_equal(a, b) for a, b in zip(getattr(got["hist"], field),
                                                       getattr(want["hist"], field))),
              f"{what}: History.{field} differs from {ref}'s")
    a, b = state_tensors(got["state"]), state_tensors(want["state"])
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          f"{what}: the final state differs from {ref}'s")
    check((got["k1"], got["k2"]) == (want["k1"], want["k2"]) and want["k1"] > 0
          and want["k2"] > 0,
          f"{what}: K1/K2 {got['k1']}/{got['k2']} vs {ref}'s {want['k1']}/{want['k2']}")


def pipeline_compare(name, runs):
    """Check every feed's run of ``name`` against the serial feed's, bit
    for bit, and log each feed's report; returns the K1/K2 launches."""
    card = card_line()
    ref = runs["serial"]
    for f, run in runs.items():
        if f != "serial":
            runs_equal(f"[pipeline] {name}: the {f} feed", run, ref, "the serial feed")
    for f, run in runs.items():
        log(f"[pipeline] {name} {f} ({card}): {json.dumps(run['report'])}")
    log(f"[pipeline] {name}: the {', '.join(f for f in runs if f != 'serial')} feeds equal "
        f"the serial feed bit for bit ({len(ref['steps'])} train dispatches: per-step "
        f"losses, History, final parameters and AdamW state), K1 {ref['k1']} and K2 "
        f"{ref['k2']} in every feed, captures per epoch {ref['hist'].epoch_captures} in "
        f"every feed, of a train step at epoch 1 or later "
        f"{[c for c in ref['captures'] if c[0] == 'train' and (c[1] or 0) >= 1]}; run seconds "
        + " / ".join(f"{f} {run['seconds']:.3f}" for f, run in runs.items()) + f" ({card})")
    return (sum(run["k1"] for run in runs.values()), sum(run["k2"] for run in runs.values()))


def phase_pipeline(mlip_cfg, mlip_splits, zinc_cfg, zinc_splits):
    """[pipeline]: the module docstring's phase 11a."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    t0 = time.perf_counter()
    out = {"cpus": os.cpu_count(), "card": card_line()}
    k1 = k2 = 0
    for name, config, splits in (("md17", mlip_cfg, mlip_splits),
                                 ("zinc", zinc_cfg, zinc_splits)):
        runs = {f: pipeline_run(f"{name}_{f}", config, splits, feed)
                for f, feed in PIPELINE_FEEDS.items()}
        a, b = pipeline_compare(name, runs)
        k1, k2 = k1 + a, k2 + b
        out[name] = {f: run["report"] for f, run in runs.items()}
        out[name]["assembly"] = assembly_times(name, config, splits[0])
        log(f"[pipeline] {name} assembly, one thread ({out['card']}): "
            f"{json.dumps(out[name]['assembly'])}")
    # A real epoch length: zinc.py's molecules at PIPELINE_LONG_MOLS, split
    # 0.8 as zinc.py splits them (about 200 packed train steps an epoch).
    t1 = time.perf_counter()
    long_splits = split_dataset(synthetic_zinc(PIPELINE_LONG_MOLS, seed=1), 0.8)
    log(f"[pipeline] zinc_long: zinc.py's molecules, {PIPELINE_LONG_MOLS} (seed 1), splits "
        f"{[len(x) for x in long_splits]}, made in {time.perf_counter() - t1:.2f} s")
    runs = {f: pipeline_run(f"zinc_long_{f}", zinc_cfg, long_splits, PIPELINE_FEEDS[f],
                            late_captures=True)
            for f in ("pipeline", "serial", "prefetch")}
    a, b = pipeline_compare("zinc_long", runs)
    k1, k2 = k1 + a, k2 + b
    out["zinc_long"] = {f: run["report"] for f, run in runs.items()}
    out["zinc_long"]["assembly"] = assembly_times("zinc_long", zinc_cfg, long_splits[0],
                                                  limit=40)
    log(f"[pipeline] zinc_long assembly, one thread, the first 40 batches ({out['card']}): "
        f"{json.dumps(out['zinc_long']['assembly'])}")
    out["k1"], out["k2"] = k1, k2
    out["seconds"] = time.perf_counter() - t0
    log(f"[pipeline] {out['seconds']:.1f} s for the phase's {4 * 2 + 3} runs")
    return out, long_splits


# ---------------------------------------------------------------- [formats]


def deliveries_equal(tag, got, want):
    """Every delivery of two feeds equal, bit for bit (each batch of a
    superstep group too); returns the batches compared. Pairs are compared
    as they come, before either feed's buffers can be recycled."""
    import itertools

    from hydragnn_tpu_torch.data.loader import MacroBatch

    n = 0
    for a, b in itertools.zip_longest(got, want):
        check(a is not None and b is not None, f"[formats] {tag}: the feeds' lengths differ")
        xs = a.batches if isinstance(a, MacroBatch) else [a]
        ys = b.batches if isinstance(b, MacroBatch) else [b]
        check(len(xs) == len(ys), f"[formats] {tag}: a delivery's group sizes differ")
        for x, y in zip(xs, ys):
            fx, fy = x.arrays(), y.arrays()
            check(fx.keys() == fy.keys() and x.seg_tile == y.seg_tile
                  and all(torch.equal(torch.as_tensor(fx[k]), torch.as_tensor(fy[k]))
                          for k in fx),
                  f"[formats] {tag}: batch {n} differs from the in-memory lists' batch")
            n += 1
    return n


def runner_batches_equal(tag, config, lazy, lists, feed):
    """The train, val and test feeds run_training builds for ``config``
    (``runner._single_loaders`` for the card, through ``feed``) over the
    lazy splits against the same over the in-memory lists: every delivery
    of two epochs bit for bit. Returns the batches compared."""
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.parallel import runtime

    config = copy.deepcopy(config)
    training = config["NeuralNetwork"]["Training"]
    training["Parallelism"] = dict(training.get("Parallelism", {}), **feed)
    config = update_config(config, *lists)
    plan = runtime.plan_from_config(config, n_devices=1)
    bs = int(config["NeuralNetwork"]["Training"]["batch_size"])
    dev = torch.device("cuda")
    feeds = [runner._single_loaders(config, plan, config["NeuralNetwork"]["Training"], ds, bs,
                                    0, False, True, 0, dev)[:3] for ds in (lazy, lists)]
    n = 0
    for epoch in (0, 1):
        for which, (a, b) in enumerate(zip(*feeds)):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            n += deliveries_equal(f"{tag} {('train', 'val', 'test')[which]} epoch {epoch}",
                                  a, b)
    return n


def read_ms_per_batch(loader, datasets):
    """Host ms to read one train batch's samples, by dataset name: the
    loader's epoch-0 plan read from each (best of two passes)."""
    plan = [idx for idx, _ in loader.epoch_plan(0)]
    out = {}
    for name, ds in datasets.items():
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            for idx in plan:
                [ds[int(i)] for i in idx]
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        out[name] = round(1e3 * best / max(len(plan), 1), 4)
    return out


def sample_digest(samples):
    """sha256 over every sample's store record (``pack_sample``)."""
    import hashlib

    from hydragnn_tpu_torch.data.diststore import pack_sample

    h = hashlib.sha256()
    for s in samples:
        h.update(pack_sample(s))
    return h.hexdigest()


def store_child(name):
    """A spawned process of [formats]: attach the shm store ``name`` and
    print the digest of every sample it unpacks, as one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hydragnn_tpu_torch.data.diststore import StoreDataset

    view = StoreDataset.attach(name)
    try:
        print(json.dumps({"samples": len(view), "digest": sample_digest(view),
                          "pid": os.getpid()}), flush=True)
    finally:
        view.close()


def edge_rows(ei, shifts=None, cell=None):
    """(s, r[, image]) rows in one canonical order; a shift becomes its
    integer image (shift @ inverse cell), so rows compare exactly."""
    import numpy as np

    cols = [np.asarray(ei[0], np.int64), np.asarray(ei[1], np.int64)]
    if shifts is not None:
        img = np.rint(np.asarray(shifts, np.float64) @ np.linalg.inv(cell)).astype(np.int64)
        check(np.allclose(img @ cell, shifts, atol=1e-6),
              "[formats] a periodic shift is not an integer image of the cell")
        cols += [img[:, 0], img[:, 1], img[:, 2]]
    rows = np.stack(cols, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def cpu_model():
    """The host CPU's model name from /proc/cpuinfo, else what the
    platform module knows, with the CPU count."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() in ("model name", "Model", "cpu model") and value.strip():
                    name = value.strip()
                    break
    except OSError:
        pass
    name = name or f"{platform.machine()} {platform.processor()}".strip()
    return f"{name}, {os.cpu_count()} CPUs"


def phase_native_cell_list(md17_frames_, slabs):
    """[formats] the native cell list on the host: built and loaded (a
    build failure fails the phase), taken by radius_graph and
    radius_graph_pbc, and equal to the numpy path's edge sets on the MD17
    stand-in's frames (open, radius 4.0, 24 neighbours) and oc20.py's slabs
    (periodic, cutoff 5.0); both paths' host ms."""
    from hydragnn_tpu_torch import native
    from hydragnn_tpu_torch.ops import neighbors

    check(native.available(), f"[formats] the native host library did not build: "
          f"{native.build_error}")
    check(not os.environ.get("HYDRAGNN_TPU_NO_NATIVE"),
          "[formats] HYDRAGNN_TPU_NO_NATIVE is set: the native cell list would not be used")
    calls = {"open": 0, "pbc": 0}
    plain = (native.radius_graph_native, native.radius_graph_pbc_native)

    def counted(kind, fn):
        def call(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return call

    def build_all():
        t0 = time.perf_counter()
        opened = [neighbors.radius_graph(f.pos, 4.0, max_neighbours=24) for f in md17_frames_]
        t1 = time.perf_counter()
        periodic = [neighbors.radius_graph_pbc(s.pos, s.cell, 5.0) for s in slabs]
        t2 = time.perf_counter()
        return opened, periodic, 1e3 * (t1 - t0), 1e3 * (t2 - t1)

    native.radius_graph_native = counted("open", plain[0])
    native.radius_graph_pbc_native = counted("pbc", plain[1])
    try:
        nat = build_all()
    finally:
        native.radius_graph_native, native.radius_graph_pbc_native = plain
    check(calls == {"open": len(md17_frames_), "pbc": len(slabs)},
          f"[formats] the native cell list took {calls} of {len(md17_frames_)} frames and "
          f"{len(slabs)} slabs")
    os.environ["HYDRAGNN_TPU_NO_NATIVE"] = "1"
    try:
        ref = build_all()
    finally:
        del os.environ["HYDRAGNN_TPU_NO_NATIVE"]
    edges = reordered = 0
    for a, b in zip(nat[0], ref[0]):
        check(a.shape == b.shape and (edge_rows(a) == edge_rows(b)).all(),
              "[formats] a native open radius graph differs from numpy's edge set")
        edges += a.shape[1]
        reordered += int(not (a == b).all())
    for (a, sa), (b, sb), s in zip(nat[1], ref[1], slabs):
        cell = s.cell.astype("float64")
        check(a.shape == b.shape and (edge_rows(a, sa, cell) == edge_rows(b, sb, cell)).all(),
              "[formats] a native periodic radius graph differs from numpy's edge set")
        edges += a.shape[1]
        reordered += int(not (a == b).all())
    out = {"available": True, "library": os.path.basename(native.library_path()),
           "cpu": cpu_model(), "frames": len(md17_frames_), "slabs": len(slabs),
           "edges": edges, "graphs_in_another_order": reordered,
           "open_ms": {"native": round(nat[2], 3), "numpy": round(ref[2], 3)},
           "periodic_ms": {"native": round(nat[3], 3), "numpy": round(ref[3], 3)}}
    log(f"[formats] native cell list ({out['library']}, built by g++ on the host): "
        f"{len(md17_frames_)} MD17 frames and {len(slabs)} oc20 slabs through it, {edges} "
        f"edges, the numpy path's edge sets on every graph ({reordered} of them in another "
        f"order); host ms open {out['open_ms']}, periodic {out['periodic_ms']} "
        f"(CPU {out['cpu']})")
    return out


def phase_formats(mlip_cfg, mlip_splits, md17_splits, zinc_cfg, zinc_splits, long_splits,
                  long_list_report):
    """[formats]: the module docstring's phase 11b."""
    import shutil
    import tempfile

    import numpy as np

    from hydragnn_tpu_torch.data.binformat import BinDataset, write_bin_dataset
    from hydragnn_tpu_torch.data.diststore import StoreDataset
    from hydragnn_tpu_torch.data.pickledataset import SimplePickleWriter
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    import hydragnn_tpu_torch as port

    t0 = time.perf_counter()
    card = card_line()
    work = tempfile.mkdtemp(prefix="formats_")
    names = ("train", "validate", "test")
    out = {"card": card, "files": {}, "read_ms_per_batch": {}, "runs": {}}
    k1 = k2 = 0
    try:
        out["native"] = phase_native_cell_list(md17_splits[0] + md17_splits[1],
                                               synthetic_oc20(200))
        # 1. md17.json's PaiNN on bench's molecules from three .hgb files
        paths = {}
        for split, samples in zip(names, mlip_splits):
            paths[split] = os.path.join(work, f"md17_{split}.hgb")
            write_bin_dataset(paths[split], samples)
            out["files"][f"md17_{split}.hgb"] = os.path.getsize(paths[split])
        lazy = tuple(BinDataset(paths[s]) for s in names)
        n_batches = sum(runner_batches_equal(f"md17 {feed}", mlip_cfg, lazy, mlip_splits,
                                             PIPELINE_FEEDS[feed])
                        for feed in ("serial", "pipeline"))
        log(f"[formats] md17: the run's feeds over the three .hgb files equal the in-memory "
            f"lists' feeds: {n_batches} batches of 2 epochs (train, val, test; serial and "
            f"through the workers) bit for bit")
        loader, _ = train_loader(mlip_cfg, mlip_splits[0])
        out["read_ms_per_batch"]["md17"] = read_ms_per_batch(
            loader, {"hgb": lazy[0], "list": mlip_splits[0]})
        bin_cfg = copy.deepcopy(mlip_cfg)
        bin_cfg["Dataset"] = {"format": "binary", "path": paths, "preload": False}
        md17 = {}
        for feed in ("serial", "pipeline"):
            md17[feed] = (
                pipeline_run(f"md17_hgb_{feed}", bin_cfg, None, PIPELINE_FEEDS[feed],
                             phase="formats"),
                pipeline_run(f"md17_list_{feed}", mlip_cfg, mlip_splits, PIPELINE_FEEDS[feed],
                             phase="formats"))
            runs_equal(f"[formats] md17 {feed}: the .hgb run", *md17[feed], "the list-fed run")
            for r in md17[feed]:
                k1, k2 = k1 + r["k1"], k2 + r["k2"]
        runs_equal("[formats] md17: the .hgb run through the workers", md17["pipeline"][0],
                   md17["serial"][0], "the serial feed")
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        pred = port.run_prediction(md17["serial"][0]["config"], device="cuda")
        pred_list = port.run_prediction(md17["serial"][1]["config"], datasets=mlip_splits,
                                        device="cuda")
        k1, k2 = k1 + edge_pipeline_planned.launches, k2 + edge_pipeline_bwd_planned.launches
        check(pred[0] == pred_list[0] and all(
            np.array_equal(a, b) for a, b in zip(pred[2] + pred[3], pred_list[2] + pred_list[3])),
              "[formats] md17: run_prediction(config) on the .hgb files differs from the "
              "list-fed run's")
        check(np.isfinite(pred[3][0]).all() and np.isfinite(pred[3][1]).all(),
              "[formats] md17: non-finite predictions")
        out["runs"]["md17"] = {f: {"hgb": r[0]["report"], "list": r[1]["report"]}
                               for f, r in md17.items()}
        log(f"[formats] md17: run_training on Dataset.format binary (preload false) equals "
            f"the run fed the lists bit for bit through the serial feed and the workers "
            f"(per-step losses, History, parameters and AdamW state; K1 "
            f"{md17['serial'][0]['k1']}, K2 {md17['serial'][0]['k2']} a run); "
            f"run_prediction(config) restores the checkpoint and predicts energies "
            f"{pred[3][0].shape} and forces {pred[3][1].shape} equal to the list-fed run's "
            f"bit for bit (error {pred[0]:.6g}); run seconds hgb/list serial "
            f"{md17['serial'][0]['seconds']:.3f}/{md17['serial'][1]['seconds']:.3f}, "
            f"workers {md17['pipeline'][0]['seconds']:.3f}/"
            f"{md17['pipeline'][1]['seconds']:.3f} ({card})")
        # 3. the shm sample store: a spawned child attaches; the run on it
        shm = f"/hgtpu_formats_{os.getpid()}"
        stores = []
        try:
            for split, samples in zip(names, mlip_splits):
                stores.append(StoreDataset.build(samples, shm_name=f"{shm}_{split}"))
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--store-child",
                                f"{shm}_train"], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, timeout=300)
            child = json.loads(p.stdout.strip().splitlines()[-1]) if p.returncode == 0 else {}
            digest = sample_digest(mlip_splits[0])
            check(p.returncode == 0 and child.get("digest") == digest
                  and child.get("samples") == len(mlip_splits[0]),
                  f"[formats] the store child (rc {p.returncode}) read {child} against the "
                  f"parent's {len(mlip_splits[0])} samples, digest {digest}:\n{p.stdout}")
            store_run = pipeline_run("md17_store", mlip_cfg, tuple(stores),
                                     PIPELINE_FEEDS["serial"], phase="formats")
            runs_equal("[formats] md17: the store-fed run", store_run, md17["serial"][0],
                       "the .hgb run")
            k1, k2 = k1 + store_run["k1"], k2 + store_run["k2"]
        finally:
            for st in stores:
                st.close()
        try:
            StoreDataset.attach(f"{shm}_train").close()
            attached = True
        except RuntimeError:
            attached = False
        check(not attached, "[formats] the store's name outlived its owner's close")
        out["store"] = {"child_pid": child["pid"], "samples": child["samples"],
                        "digest": digest[:16], "run_seconds": round(store_run["seconds"], 4)}
        log(f"[formats] sample store: md17's splits in POSIX shm ({shm}_*); a spawned process "
            f"attached the train split and unpacked {child['samples']} samples with the "
            f"parent's digest {digest[:16]}; run_training on the store views equals the "
            f".hgb-fed run bit for bit; the names are gone after close")
        # 2. zinc.json's PNAPlus + GPS from a pickle directory, pna_deg from the data
        dirs = {}
        for split, samples in zip(names, zinc_splits):
            dirs[split] = os.path.join(work, "zinc_pickle", split)
            SimplePickleWriter(samples, dirs[split])
        out["files"]["zinc_pickle"] = sum(
            os.path.getsize(os.path.join(r, f)) for r, _, fs in
            os.walk(os.path.join(work, "zinc_pickle")) for f in fs)
        pk_cfg = copy.deepcopy(zinc_cfg)
        pk_cfg["Dataset"] = {"format": "pickle", "path": dirs}
        zinc = (pipeline_run("zinc_pickle", pk_cfg, None, PIPELINE_FEEDS["pipeline"],
                             phase="formats"),
                pipeline_run("zinc_list", zinc_cfg, zinc_splits, PIPELINE_FEEDS["pipeline"],
                             phase="formats"))
        runs_equal("[formats] zinc: the pickle run", *zinc, "the list-fed run")
        deg = [r["config"]["NeuralNetwork"]["Architecture"]["pna_deg"] for r in zinc]
        check(deg[0] == deg[1] and sum(deg[0]) > 0,
              f"[formats] zinc: pna_deg from the pickle files {deg[0]} vs the lists' {deg[1]}")
        for r in zinc:
            k1, k2 = k1 + r["k1"], k2 + r["k2"]
        out["runs"]["zinc"] = {"pickle": zinc[0]["report"], "list": zinc[1]["report"],
                               "pna_deg": deg[0]}
        log(f"[formats] zinc: run_training on Dataset.format pickle (pna_deg {deg[0]} taken "
            f"from the data) equals the run fed the lists through the workers bit for bit "
            f"(K1 {zinc[0]['k1']}, K2 {zinc[0]['k2']}); run seconds "
            f"{zinc[0]['seconds']:.3f}/{zinc[1]['seconds']:.3f} ({card})")
        # zinc_long: 16,000 molecules in one .hgb container, one epoch
        long_path = os.path.join(work, "zinc_long.hgb")
        write_bin_dataset(long_path, [s for split in long_splits for s in split])
        out["files"]["zinc_long.hgb"] = os.path.getsize(long_path)
        bounds = np.cumsum([0] + [len(x) for x in long_splits])
        views = tuple(BinDataset(long_path, subset=range(bounds[i], bounds[i + 1]))
                      for i in range(3))
        loader, _ = train_loader(zinc_cfg, long_splits[0])
        out["read_ms_per_batch"]["zinc_long"] = read_ms_per_batch(
            loader, {"hgb": views[0], "list": long_splits[0]})
        one = copy.deepcopy(zinc_cfg)
        one["NeuralNetwork"]["Training"]["num_epoch"] = 1
        long_runs = (pipeline_run("zinc_long_hgb", one, views, PIPELINE_FEEDS["pipeline"],
                                  late_captures=True, phase="formats"),
                     pipeline_run("zinc_long_list", one, long_splits,
                                  PIPELINE_FEEDS["pipeline"], late_captures=True,
                                  phase="formats"))
        runs_equal("[formats] zinc_long: the .hgb run", *long_runs, "the list-fed run")
        for r in long_runs:
            k1, k2 = k1 + r["k1"], k2 + r["k2"]
        out["runs"]["zinc_long"] = {"hgb": long_runs[0]["report"],
                                    "list": long_runs[1]["report"],
                                    "pipeline_phase_list": long_list_report}
        rep = [r["report"] for r in long_runs]
        log(f"[formats] zinc_long: {len(long_splits[0])} train molecules from one .hgb "
            f"container ({out['files']['zinc_long.hgb']} bytes; subset views per split) "
            f"through the workers, one epoch, equal to the list-fed run bit for bit; epoch "
            f"seconds hgb {rep[0]['epoch_seconds']} / list {rep[1]['epoch_seconds']}, input "
            f"wait ms a dispatch {rep[0]['input_wait_ms_per_step']} / "
            f"{rep[1]['input_wait_ms_per_step']}; [pipeline]'s in-memory run: epoch seconds "
            f"{long_list_report['epoch_seconds']}, input wait "
            f"{long_list_report['input_wait_ms_per_step']}; one thread's read ms a batch "
            f"{out['read_ms_per_batch']['zinc_long']} ({card})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["k1"], out["k2"] = k1, k2
    out["seconds"] = round(time.perf_counter() - t0, 3)
    log(f"[formats] {out['seconds']:.1f} s; K1 {k1}, K2 {k2} launches in the phase")
    return out


def phase_zinc(configs, splits, loader, first_bin):
    """zinc.json and zinc_bf16.json trained by run_training on the card
    (2 epochs each), then run_prediction; the first train step on the
    card against the CPU plain path in f32 and bf16, running statistics
    included; the f32 step's eager and device time on the first packed
    bin."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    budgets = loader.pack_budgets
    stats = loader.packing_stats(0)
    log(f"[zinc] packing on ('auto' resolved as the JAX package resolves it): train "
        f"budgets {budget_keys(budgets)}; epoch 0 "
        f"packs {stats['batches']} bins, node fill {stats['node_fill']:.3f}, edge fill "
        f"{stats['edge_fill']:.3f}, pad ratio {stats['pad_ratio']:.3f}")
    runs = {p: zinc_run(c, splits, budgets) for p, c in configs.items()}

    full = update_config(configs["fp32"], *splits)
    training = full["NeuralNetwork"]["Training"]
    lr = float(training["Optimizer"]["learning_rate"])
    model0, cfg = create_model_config(full, "cuda", seed=0)
    layers = cfg.num_conv_layers
    parity = {}
    for precision, dtype, tol in (("fp32", torch.float32, VJP_TOL),
                                  ("bf16", torch.bfloat16, BF16_TOL)):
        card = zinc_step(copy.deepcopy(model0), cfg, training, first_bin.to("cuda"), dtype)
        cpu = zinc_step(copy.deepcopy(model0).to("cpu"), cfg, training, first_bin, dtype)
        check(card["launches"] == (layers, layers) and cpu["launches"] == (0, 0),
              f"{precision} ZINC step: K1/K2 launched {card['launches']} on the card (want "
              f"{layers} each), {cpu['launches']} on the CPU")
        worst = hold_zinc_step(card, cpu, tol, lr, f"zinc {precision}")
        parity[precision] = worst
        log(f"[zinc] first step on the first packed bin, card vs CPU plain path, "
            f"{precision}: loss {card['loss']:.6g} vs {cpu['loss']:.6g} (|err| "
            f"{worst['loss']:.3g}); worst |err| grads {worst['grad']:.3g} (largest |grad| "
            f"{worst['scales'][0]:.3g}), updated params {worst['param']:.3g}, running "
            f"statistics {worst['stats']:.3g}; rtol {tol['rtol']}, atol {tol['atol']} x "
            f"min(largest, 1); K1 {card['launches'][0]}, K2 {card['launches'][1]} in the step")

    batch = first_bin.to("cuda")
    timed = copy.deepcopy(model0)
    opt = select_optimizer(timed.parameters(), training)
    step = make_train_step(timed, opt, cfg)
    timed_state = TrainState(timed, opt)
    eager = eager_ms(lambda: step(timed_state, batch), iters=20, warmup=3)
    prof = device_profile(lambda: step(timed_state, batch), per_call=(layers, layers),
                          what="ZINC step")
    e_valid = int(batch.edge_mask.sum())
    log(f"[zinc] one f32 train step on the first packed bin ({int(batch.graph_mask.sum())} "
        f"molecules, {batch.num_nodes} nodes, {e_valid} edges; padded {batch.num_edges}): "
        f"{eager:.3f} ms issued eagerly, " + profile_note(prof, eager, "step"))
    return {"k1": sum(r["k1"] for r in runs.values()),
            "k2": sum(r["k2"] for r in runs.values()), "runs": runs,
            "parity": parity,
            "packing": dict(stats, budgets=budget_keys(budgets)),
            "step_timing": dict(prof, eager_ms=eager, nodes=batch.num_nodes,
                                edges=batch.num_edges, e_valid=e_valid),
            "step": (model0, cfg, training)}


# ---------------------------------------------------------------- [polymers]

POLYMER_WIDTHS = ((64, 64), (64, 1))  # the conv node head's K1/K2: [64, 64] + 1


def polymer_chain(rng):
    """examples/open_polymers_2026/train.py's ``polymer_chain``: the
    polymers driver's (drivers/polymers.py), from the same seeded
    generator in its order of draws."""
    from hydragnn_tpu_torch.drivers.polymers import polymer_chain as chain

    return chain(rng)


def example_config(*parts):
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", *parts)
    with open(here) as f:
        return json.load(f)


def polymer_data():
    """examples/open_polymers_2026/polymers.json cut to 3 epochs, and the
    example's 300 chains (seed 26) split 0.8 as its main() splits them."""
    import numpy as np

    from hydragnn_tpu_torch.data.loader import split_dataset

    config = example_config("open_polymers_2026", "polymers.json")
    config["Verbosity"] = {"level": 0}
    config["NeuralNetwork"]["Training"]["num_epoch"] = 3
    t0 = time.perf_counter()
    rng = np.random.default_rng(26)
    splits = split_dataset([polymer_chain(rng) for _ in range(300)], 0.8)
    log(f"[polymers] polymers.json's SAGE (hidden 64, 3 layers, mean pooling; graph head "
        f"1x64 + [64, 64], conv node head [64, 64] + 1; AdamW 0.0005, batch 32, packing "
        f"auto), 3 epochs; the example's 300 chains (seed 26), splits "
        f"{[len(x) for x in splits]}, made in {time.perf_counter() - t0:.2f} s")
    return config, splits


def phase_polymer_kernels(batch):
    """K1 and K2 in the conv node head's a,W flavour at (F_in, F_out) =
    (64, 64) and (64, 1), f32, on the plan of the first train bin
    polymers.json's run_training forms: against their plain versions
    (same bits on two runs, K2 zero off the plan), the launch shapes, and
    the times beside the bound and the plain version (no one PyTorch call
    computes the a,W flavour, so no library time)."""
    from hydragnn_tpu_torch.ops.cuda_build import load_library
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    t0 = time.perf_counter()
    lib = load_library()
    dev = batch.seg_perm.device
    gen = torch.Generator().manual_seed(13)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    n, e = batch.num_nodes, batch.num_edges
    e_valid = int(batch.edge_mask.sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    covered = torch.zeros(e, dtype=torch.bool, device=dev)
    covered[plan[0][plan[2]].long()] = True
    log(f"[polymer-kernels] first train bin: n {n}, e {e} ({e_valid} valid), "
        f"{batch.num_graphs} graph slots, plan {slots} slots in {blocks} blocks")
    rows = []
    dt = torch.float32
    for f_in, f_out in POLYMER_WIDTHS:
        a = torch.randn(e, f_in, generator=gen).to(dev)
        w = (torch.randn(f_in, f_out, generator=gen) / f_in ** 0.5).to(dev)
        g = torch.randn(n, f_out, generator=gen).to(dev)
        args = (a, None, w, *plan, n)
        with torch.no_grad():
            got, again = edge_pipeline_planned(*args), edge_pipeline_planned(*args)
            ref = edge_pipeline_plain(*args)
        d_a, d_b, d_w = edge_pipeline_bwd_planned(g, *args)
        da2, _, dw2 = edge_pipeline_bwd_planned(g, *args)
        ra, _, rw = edge_pipeline_bwd_plain(g, *args)
        torch.cuda.synchronize()
        what = f"a,W ({f_in}, {f_out}) f32"
        check(torch.equal(got, again) and torch.equal(d_a, da2) and torch.equal(d_w, dw2),
              f"{what}: two runs differ")
        check(got.shape == (n, f_out) and d_b is None and d_w.shape == (f_in, f_out),
              f"{what}: output shapes")
        torch.testing.assert_close(got, ref, **F32_TOL)
        torch.testing.assert_close(d_a, ra, **VJP_TOL)
        torch.testing.assert_close(d_w, rw, **VJP_TOL)
        check(not bool(d_a[~covered].any()), f"{what}: K2 nonzero off the plan")
        shapes = {k: launch_shape(lib, k, n, e, f_in, f_out, 32, has_b=False, has_w=True)
                  for k in ("k1", "k2")}
        row = {"f_in": f_in, "f_out": f_out, "dtype": "f32", "n": n, "e": e,
               "e_valid": e_valid, "k1_launch": shapes["k1"], "k2_launch": shapes["k2"],
               "k1_max_abs_err": float((got - ref).abs().max()),
               "k2_max_abs_err": max(float((d_a - ra).abs().max()),
                                     float((d_w - rw).abs().max()))}
        with torch.no_grad():
            row["k1_ms"] = time_ms(lambda: edge_pipeline_planned(*args))
            row["k1_plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
            row["k2_ms"] = time_ms(lambda: edge_pipeline_bwd_planned(g, *args))
            row["k2_plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(g, *args))
        row["k1_library_ms"] = row["k2_library_ms"] = None
        nbytes, ops, out_dt = k1_work(e_valid, n, f_in, f_out, slots, blocks, dt, dt,
                                      False, True)
        row["k1_bound_ms"], row["k1_bound_by"] = bound(nbytes, ops, out_dt)
        nbytes, ops, g_dt = k2_work(e, e_valid, n, f_in, f_out, slots, blocks, dt, dt,
                                    False, True)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(nbytes, ops, g_dt)
        rows.append(row)
        log(f"[polymer-kernels] {what}: K1 {shapes['k1']}, max|err| "
            f"{row['k1_max_abs_err']:.3g}, {row['k1_ms'] * 1e3:.1f} us, plain "
            f"{row['k1_plain_ms'] * 1e3:.1f} us, bound {row['k1_bound_ms'] * 1e3:.2f} us "
            f"({row['k1_bound_by']}); K2 {shapes['k2']}, max|err| "
            f"{row['k2_max_abs_err']:.3g}, {row['k2_ms'] * 1e3:.1f} us, plain "
            f"{row['k2_plain_ms'] * 1e3:.1f} us, bound {row['k2_bound_ms'] * 1e3:.2f} us "
            f"({row['k2_bound_by']})")
    log(f"[polymer-kernels] K1 and K2, a,W at (64, 64) and (64, 1), f32: 4 comparisons "
        f"passed (identical bits on two runs; K2 zero off the plan) in "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def state_tensors(state):
    """A TrainState's tensors by name: the model's state_dict (parameters
    and running statistics) and the optimizer's per-parameter state."""
    out = dict(state.model.state_dict())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    return out


def polymer_run(config, splits, budgets):
    """run_training of polymers.json on the card; then
    run_prediction(config) alone (no state, model or cfg: it builds the
    model on the card and restores the run's checkpoint) against the
    in-process run_prediction(..., state=...): the restored tensors equal
    the run's final ones bit for bit, and the predictions equal the
    in-process ones bit for bit, or else within the f32 forward
    tolerance (SAGE's mean aggregation is index_add_, whose float atomics
    can order the sums differently from run to run)."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.runner import restore_checkpoint_state

    with recorded_run() as rec:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, datasets=splits, seed=0,
                                                          device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k1, k2, n_fwd = (edge_pipeline_planned.launches,
                         edge_pipeline_bwd_planned.launches, rec["forwards"])
        steps = torch.cat(rec["losses"]).double().cpu().numpy()
        shapes = list(rec["shapes"])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        rec["forwards"] = 0
        t0 = time.perf_counter()
        alone = port.run_prediction(full, datasets=splits)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        k1_pred, k2_pred, n_fwd_pred = (edge_pipeline_planned.launches,
                                        edge_pipeline_bwd_planned.launches, rec["forwards"])
    inproc = port.run_prediction(full, datasets=splits, state=state, model=model, cfg=cfg)
    layers = len(cfg.node_branches[0].dim_headlayers[:cfg.node_branches[0].num_headlayers]) + 1
    keys = set(budget_keys(budgets))
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [alone[0]]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"polymers: non-finite loss in {losses} or in the steps {steps.tolist()}")
    check(len(steps) == state.step > 0 and set(shapes) <= keys,
          f"polymers: train batches {sorted(set(shapes))} are not all packed bins {keys}")
    check(layers == 3 and k1 == layers * n_fwd and k2 == layers * state.step,
          f"polymers run_training: K1 {k1} in {n_fwd} forwards, K2 {k2} in {state.step} "
          f"train steps (want {layers} per forward and per step, from the conv head)")
    check(k1_pred == layers * n_fwd_pred and k2_pred == 0 and n_fwd_pred > 0,
          f"polymers run_prediction(config): K1 {k1_pred}, K2 {k2_pred}, {n_fwd_pred} "
          f"forwards")
    fresh = create_model_config(full, "cuda", seed=7)[0]
    restored = state_tensors(restore_checkpoint_state(full, fresh))
    saved = state_tensors(state)
    check(set(restored) == set(saved) and all(torch.equal(restored[k], saved[k])
                                              for k in saved),
          "polymers: the restored checkpoint differs from the run's final state")
    n_test_nodes = sum(s.num_nodes for s in splits[2])
    check([p.shape for p in alone[3]] == [(len(splits[2]), 1), (n_test_nodes, 1)]
          and all(np.isfinite(p).all() for p in alone[3]),
          f"polymers run_prediction wants finite [graphs, 1] and [nodes, 1] predictions, "
          f"got {[p.shape for p in alone[3]]}")
    same = all(np.array_equal(a, b) for a, b in zip(alone[3], inproc[3]))
    worst = max(float(np.abs(a.astype(np.float64) - b).max())
                for a, b in zip(alone[3], inproc[3]))
    if not same:
        for a, b in zip(alone[3], inproc[3]):
            np.testing.assert_allclose(a, b, **F32_TOL)
    held = "bit for bit" if same else f"within rtol 1e-5 / atol 1e-4 (max |diff| {worst:.3g})"
    # after the checks on the run's checkpoint, which the eager twin overwrites
    eager_s, _ = eager_seconds(lambda: port.run_training(config, datasets=splits, seed=0,
                                                         device="cuda"))
    # Each key is eager on its first sight and captured on its second: the
    # train step within epoch 0 (8 bins of one budget), a validation or
    # test bin seen once an epoch in epoch 1; from epoch 2 on all replay.
    graphs = graph_report("polymers", state, hist, train_s, eager_s, steady=2)
    fell = hist.train_loss[-1] < steps[0]
    log(f"[polymers] run_training on the card ({train_s:.2f} s, {state.step} train steps "
        f"on packed bins {sorted(set(shapes))}, {n_fwd} forwards): train loss "
        f"{hist.train_loss}, val {hist.val_loss}, test {hist.test_loss}; per-task test "
        f"{np.asarray(hist.test_tasks[-1]).reshape(-1).tolist()}; the last epoch's mean "
        f"train loss is {'below' if fell else 'not below'} the first step's {steps[0]:.6g}")
    log(f"[polymers] K1 launches {k1} = {layers} x {n_fwd} forwards, K2 launches {k2} = "
        f"{layers} x {state.step} train steps (all from the conv node head)")
    log(f"[polymers] run_prediction(config) alone ({pred_s:.2f} s): restored the run's "
        f"checkpoint ({len(saved)} tensors equal bit for bit), error {alone[0]:.6g} over "
        f"{len(splits[2])} chains / {n_test_nodes} nodes, K1 {k1_pred} = {layers} x "
        f"{n_fwd_pred} forwards, K2 0; predictions equal the in-process "
        f"run_prediction(..., state=...) {held}")
    return {"k1": k1 + k1_pred, "k2": k2, "steps": state.step,
            "forwards": n_fwd + n_fwd_pred, "step_losses": steps.tolist(),
            "train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "test_loss": hist.test_loss, "prediction_error": alone[0],
            "predictions_bit_for_bit": same, "prediction_max_abs_diff": worst,
            "seconds": train_s, "prediction_seconds": pred_s, "graphs": graphs,
            "loss_fell": bool(fell), "bins": sorted(set(shapes))}


def phase_polymers(config, splits, loader, first_bin):
    """polymers.json trained by run_training on the card, then
    run_prediction(config) alone (polymer_run); the first train step on
    the first packed bin, card against the CPU plain path; the step's
    eager and device time."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    budgets = loader.pack_budgets
    stats = loader.packing_stats(0)
    log(f"[polymers] packing on ('auto' resolved as the JAX package resolves it): train "
        f"budgets {budget_keys(budgets)}; epoch 0 packs {stats['batches']} bins, node fill "
        f"{stats['node_fill']:.3f}, edge fill {stats['edge_fill']:.3f}, pad ratio "
        f"{stats['pad_ratio']:.3f}; the first bin holds {int(first_bin.graph_mask.sum())} "
        f"chains, {int(first_bin.node_mask.sum())} real nodes of {first_bin.num_nodes}, "
        f"{int(first_bin.edge_mask.sum())} valid edges of {first_bin.num_edges}")
    run = polymer_run(config, splits, budgets)

    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    lr = float(training["Optimizer"]["learning_rate"])
    model0, cfg = create_model_config(full, "cuda", seed=0)
    card = zinc_step(copy.deepcopy(model0), cfg, training, first_bin.to("cuda"),
                     torch.float32)
    cpu = zinc_step(copy.deepcopy(model0).to("cpu"), cfg, training, first_bin, torch.float32)
    check(card["launches"] == (3, 3) and cpu["launches"] == (0, 0),
          f"polymer step: K1/K2 launched {card['launches']} on the card (want 3 each), "
          f"{cpu['launches']} on the CPU")
    worst = hold_zinc_step(card, cpu, VJP_TOL, lr, "polymers f32")
    log(f"[polymers] first step on the first packed bin, card vs CPU plain path, f32: loss "
        f"{card['loss']:.6g} vs {cpu['loss']:.6g} (|err| {worst['loss']:.3g}); worst |err| "
        f"grads {worst['grad']:.3g} (largest |grad| {worst['scales'][0]:.3g}), updated "
        f"params {worst['param']:.3g}, running statistics {worst['stats']:.3g}; rtol "
        f"{VJP_TOL['rtol']}, atol {VJP_TOL['atol']} x min(largest, 1); K1 3, K2 3 in the step")

    batch = first_bin.to("cuda")
    timed = copy.deepcopy(model0)
    opt = select_optimizer(timed.parameters(), training)
    step = make_train_step(timed, opt, cfg)
    timed_state = TrainState(timed, opt)
    eager = eager_ms(lambda: step(timed_state, batch), iters=20, warmup=3)
    prof = device_profile(lambda: step(timed_state, batch), per_call=(3, 3),
                          what="polymer step")
    e_valid = int(batch.edge_mask.sum())
    log(f"[polymers] one f32 train step on the first packed bin "
        f"({int(batch.graph_mask.sum())} chains, {batch.num_nodes} nodes, {e_valid} edges; "
        f"padded {batch.num_edges}): {eager:.3f} ms issued eagerly, "
        + profile_note(prof, eager, "step"))
    seconds = time.perf_counter() - t0
    log(f"[polymers] phase took {seconds:.1f} s")
    return {"k1": run["k1"], "k2": run["k2"], "run": run, "parity": worst,
            "packing": dict(stats, budgets=budget_keys(budgets)), "seconds": seconds,
            "step_timing": dict(prof, eager_ms=eager, nodes=batch.num_nodes,
                                edges=batch.num_edges, e_valid=e_valid), "model0": model0,
            "cfg": cfg, "training": training}


# ---------------------------------------------------------------- [oc20]

MACE_WIDTH = 288  # MACE's receiver sum: 32 channels x (max_ell + 1)^2 = 9 components


def synthetic_oc20(n_systems=200, seed=0, cutoff=5.0):
    """examples/open_catalyst_2020/oc20.py's ``synthetic_oc20``: the oc20
    driver's (``drivers/oc20.py``), with the port's ``radius_graph_pbc``:
    2-3 x 2-3 x 2 simple-cubic Cu slabs (lattice 3.8, 8% vacancies, a
    cell three slabs tall) with a 1-3 atom H/C/O chain above a surface
    site, jittered by 0.05, with Lennard-Jones energies and forces under
    PBC."""
    from hydragnn_tpu_torch.drivers import oc20

    return oc20.synthetic_oc20(n_systems, seed=seed, cutoff=cutoff)


def random_crystals(n_structures, species, seed, lattice_constant=3.2, cells_range=(2, 4),
                    cutoff=5.0, jitter=0.06, vacancy_rate=0.04):
    """examples/common/crystals.py's ``random_crystals`` (total energies,
    normalized): the crystal drivers' (``drivers/crystals.py``), with the
    port's ``radius_graph_pbc``: simple-cubic cells of 2-3 lattice
    constants a side (6.4-9.6 at 3.2, against a 5.0 cutoff: one pair
    meets in several images), random species, 4% vacancies, thermal
    jitter redrawn while an atom sits in a repulsive core; energies
    centred and scaled over the set (forces scaled alike)."""
    from hydragnn_tpu_torch.drivers import crystals

    return crystals.random_crystals(n_structures, species=species, seed=seed,
                                    lattice_constant=lattice_constant, cells_range=cells_range,
                                    cutoff=cutoff, jitter=jitter, vacancy_rate=vacancy_rate)


def example_json(*parts, epochs=2):
    """An example config cut to ``epochs`` epochs in f32, verbosity 0."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                           *parts)) as f:
        config = json.load(f)
    config["Verbosity"] = {"level": 0}
    config["NeuralNetwork"]["Training"].update(num_epoch=epochs, precision="fp32")
    return config


def oc20_data():
    """examples/open_catalyst_2020/oc20.json cut to 2 epochs, and oc20.py's
    200 systems (seed 0) split 0.8 as its main() splits them."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    config = example_json("open_catalyst_2020", "oc20.json")
    t0 = time.perf_counter()
    splits = split_dataset(synthetic_oc20(200), 0.8)
    nodes = [s.num_nodes for s in splits[0]]
    edges = [s.num_edges for s in splits[0]]
    log(f"[oc20] oc20.json's MACE (hidden 32, 2 layers, max_ell 2, node_max_ell 2, "
        f"correlation 2, num_radial 8, radius 5.0; graph head 1x32 + [32, 32], add "
        f"pooling; energy weight 1, force weight 25; AdamW 0.002, batch 8), 2 epochs f32; "
        f"oc20.py's 200 periodic slab + adsorbate systems (seed 0), splits "
        f"{[len(x) for x in splits]}, train systems of {min(nodes)}-{max(nodes)} atoms and "
        f"{min(edges)}-{max(edges)} edges, made in {time.perf_counter() - t0:.2f} s")
    return config, splits


def egnn_data():
    """examples/mptrj/mptrj_forces.json cut to 2 epochs, and
    examples/mptrj/train.py's crystals (300 structures, species Ni, Nb, Al,
    Ti, seed 3) split 0.8."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    config = example_json("mptrj", "mptrj_forces.json")
    t0 = time.perf_counter()
    samples = random_crystals(300, species=(28, 41, 13, 22), seed=3)
    splits = split_dataset(samples, 0.8)
    self_pairs = sum(int((s.edge_index[0] == s.edge_index[1]).sum()) for s in samples)
    log(f"[egnn] mptrj_forces.json's EGNN (hidden 64, 3 layers, radius 5.0, equivariance "
        f"off; graph head 1x64 + [64, 64], add pooling; energy weight 1, force weight 10; "
        f"AdamW 0.001, batch 32), 2 epochs f32; train.py's 300 crystals (seed 3), splits "
        f"{[len(x) for x in splits]}, {self_pairs} self-image edges, made in "
        f"{time.perf_counter() - t0:.2f} s")
    return config, splits


def phase_mace_kernels(batch):
    """K1 and K2 in the reduce-only flavour at MACE's width (F = 288) on
    the first packed oc20 train bin's plan in f32 and bf16
    (``reduce_kernel_rows``), then K2's operator at F = 288 on the
    card against the CPU plain path."""
    rows = reduce_kernel_rows("mace-kernels", batch, MACE_WIDTH, 288)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    bwd_fn_card_vs_cpu("mace-kernels", plan, batch.num_nodes, batch.num_edges, MACE_WIDTH,
                       MACE_WIDTH, ("a",), torch.Generator().manual_seed(289))
    return rows


def phase_oc20(config, splits, loader, first_bin):
    """oc20.json's MACE trained by run_training on the card (f32, 2
    epochs, packing as the runner resolves it), then run_prediction; K1 =
    K2 = 2 x (forwards + train steps); the first train step on the first
    packed bin, card against the CPU plain path with 4 K1 and 4 K2
    launches (hold_mlip_step); the step's eager and device time."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config

    budgets = loader.pack_budgets
    stats = loader.packing_stats(0)
    log(f"[oc20] packing on ('auto' resolved as the JAX package resolves it): train "
        f"budgets {budget_keys(budgets)}; epoch 0 packs {stats['batches']} bins, node fill "
        f"{stats['node_fill']:.3f}, edge fill {stats['edge_fill']:.3f}")
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    layers = cfg.num_conv_layers
    log(f"[oc20] update_config: avg_num_neighbors {cfg.avg_num_neighbors:.6g}; "
        f"{sum(p.numel() for p in model0.parameters())} parameters")
    # one K1 per layer's receiver sum (F = 288), K2 as its backward; a
    # train step doubles both through the force pass's derivative
    run = mlip_run(config, splits, budgets, tag="oc20", data="OC20 slabs", per_fwd=layers)
    parity = hold_mlip_step("oc20", "OC20 slabs", config, splits[0], model0, cfg, training,
                            "fp32", torch.float32, VJP_TOL, (2 * layers, 2 * layers))
    timing = mlip_step_timing("oc20", model0, cfg, training, first_bin,
                              (2 * layers, 2 * layers))
    return {"k1": run["k1"], "k2": run["k2"], "run": run, "parity": parity,
            "packing": dict(stats, budgets=budget_keys(budgets)),
            "avg_num_neighbors": cfg.avg_num_neighbors, "step_timing": timing,
            "step": (model0, cfg, training)}


def phase_egnn(config, splits):
    """mptrj_forces.json's EGNN trained by run_training on the card (f32,
    2 epochs), then run_prediction: finite results, no K1/K2 launch (its
    sums run at the senders, through index_add_); the first train step,
    card against the CPU plain path (hold_mlip_step, the smallest error
    of ten card steps); the step's time."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config

    loader, budgets = train_loader(config, splits[0])
    log(f"[egnn] packing {'on, train budgets ' + str(budget_keys(budgets)) if budgets else 'off'}"
        f" ('auto' resolved as the JAX package resolves it)")
    run = mlip_run(config, splits, budgets, tag="egnn", data="crystals", per_fwd=0)
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    parity = hold_mlip_step("egnn", "crystals", config, splits[0], model0, cfg, training,
                            "fp32", torch.float32, VJP_TOL, (0, 0), card_runs=2 * N_FLOORS)
    timing = mlip_step_timing("egnn", model0, cfg, training, next(iter(loader)), (0, 0))
    return {"run": run, "parity": parity, "step_timing": timing}


# ---------------------------------------------------------------- [pnaeq]

# PNAEq's receiver sums: layer 0 runs at the input width 1 (the moment
# pass [h, h*h] at 2, the folded vector message at 3), layers 1-2 at
# hidden 64 (2F = 128, 3F = 192).
PNAEQ_WIDTHS = (2, 3, 128, 192)


def pnaeq_config(mlip_config):
    """examples/md17/md17.json with ``mpnn_type: "PNAEq"`` (what
    examples/md17/md17.py --mpnn_type PNAEq runs), cut as [mlip] cuts
    md17.json: 2 epochs in f32."""
    config = copy.deepcopy(mlip_config)
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "PNAEq"
    return config


def phase_pnaeq_kernels(batch):
    """K1 and K2 in the reduce-only flavour at PNAEq's widths on the first
    packed PNAEq train bin's plan in f32 and bf16 (``reduce_kernel_rows``),
    then K2's operator at F = 192 on the card against the CPU plain
    path."""
    rows = []
    for f in PNAEQ_WIDTHS:
        rows += reduce_kernel_rows("pnaeq-kernels", batch, f, 300 + f)
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
    bwd_fn_card_vs_cpu("pnaeq-kernels", plan, batch.num_nodes, batch.num_edges, 192, 192,
                       ("a",), torch.Generator().manual_seed(192))
    return rows


def phase_pnaeq(config, splits, loader, first_bin):
    """md17.json's PNAEq potential trained by run_training on the card
    (f32, 2 epochs, packing as the runner resolves it) on the MD17
    stand-in, then run_prediction; K1 = K2 = 6 x (forwards + train
    steps), so 6 of each per evaluation forward and 12 per train step;
    the first train step on the first packed bin, card against the CPU
    plain path (hold_mlip_step); one train step replayed against eager,
    with its eager, replayed and device time."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config

    t0 = time.perf_counter()
    budgets = loader.pack_budgets
    stats = loader.packing_stats(0)
    log(f"[pnaeq] md17.json with mpnn_type PNAEq (hidden 64, 3 layers, num_radial 20, "
        f"radius 4.0, graph head 1x64 + [64, 64], add pooling; energy weight 1, force "
        f"weight 10; AdamW 0.002, batch 32), 2 epochs f32 on the MD17 stand-in; packing on "
        f"('auto' resolved as the JAX package resolves it): train budgets "
        f"{budget_keys(budgets)}; epoch 0 packs {stats['batches']} bins, node fill "
        f"{stats['node_fill']:.3f}, edge fill {stats['edge_fill']:.3f}")
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    per_fwd = 2 * cfg.num_conv_layers
    log(f"[pnaeq] update_config: pna_deg {cfg.pna_deg}, max_neighbours "
        f"{cfg.max_neighbours}; {sum(p.numel() for p in model0.parameters())} parameters")
    # two receiver sums a layer (PNA's moment pass, the vector message),
    # each one K1 forward; K2 in the force pass; both again in the loss's
    # backward
    run = mlip_run(config, splits, budgets, tag="pnaeq", data="MD17 stand-in",
                   per_fwd=per_fwd)
    parity = hold_mlip_step("pnaeq", "MD17 stand-in", config, splits[0], model0, cfg,
                            training, "fp32", torch.float32, VJP_TOL,
                            (2 * per_fwd, 2 * per_fwd))
    step = replay_vs_eager("PNAEq first packed bin", model0, cfg, training, first_bin,
                           (2 * per_fwd, 2 * per_fwd), mlip=True)
    seconds = time.perf_counter() - t0
    log(f"[pnaeq] phase took {seconds:.1f} s")
    return {"k1": run["k1"], "k2": run["k2"], "run": run, "parity": parity,
            "packing": dict(stats, budgets=budget_keys(budgets)), "step": step,
            "pna_deg": list(cfg.pna_deg), "seconds": seconds}


# ---------------------------------------------------------------- [dimenet]

def qm7x_frames(n_frames=400, seed=7):
    """examples/qm7x/train.py's data: the qm7x driver's ``build_dataset``
    (``drivers/molecules.random_molecule_frames(frames, species=(1, 6, 7,
    8, 16), n_atoms_range=(4, 12), n_molecules=14, seed=7,
    feature="onehot")``), with the port's radius graph (4.0, 24
    neighbours): thermal frames (jitter 0.1) of 14 random HCNOS molecules
    of 4-11 atoms placed at least 1.0 apart, species-dependent Morse
    energies and forces, energies centred and scaled over the set
    (forces by the same factor)."""
    from hydragnn_tpu_torch.drivers import qm7x

    return qm7x.build_dataset(n_frames, seed=seed)


def qm7x_data():
    """examples/qm7x/qm7x.json cut to 2 epochs in f32, and
    examples/qm7x/train.py's 400 frames (``qm7x_frames``) split 0.8 as its
    main() splits them, with the config's input_node_features selected
    (the five one-hot columns) as run_training selects them, so batches
    made here are the run's."""
    from hydragnn_tpu_torch.data.graph import select_input_features
    from hydragnn_tpu_torch.data.loader import split_dataset

    config = example_json("qm7x", "qm7x.json")
    cols = config["NeuralNetwork"]["Variables_of_interest"]["input_node_features"]
    t0 = time.perf_counter()
    splits = tuple(select_input_features(x, cols)
                   for x in split_dataset(qm7x_frames(400), 0.8))
    nodes = [s.num_nodes for s in splits[0]]
    log(f"[dimenet] qm7x.json's DimeNet++ (hidden 64, 2 layers, radius 4.0, 24 neighbours, "
        f"num_radial 6, num_spherical 7, envelope 5, int_emb 64, basis_emb 8, out_emb 16, "
        f"1 residual layer before the skip and 2 after; graph head 1x64 + [64, 64], add "
        f"pooling; AdamW 0.001, batch 32), 2 epochs f32; train.py's 400 frames of 14 HCNOS "
        f"molecules of {min(nodes)}-{max(nodes)} atoms (seed 7), splits "
        f"{[len(x) for x in splits]}, made in {time.perf_counter() - t0:.2f} s")
    return config, splits


def triplet_shapes(loader):
    """Epoch 0 of a triplet loader, batch by batch: the real (nodes,
    edges, triplets), the padded shape the loader gives it (nodes, edges,
    graphs, triplets) and the shape the ladder would give it."""
    from hydragnn_tpu_torch.data.graph import PadSpec, count_triplets

    rows = []
    for idx, spec in loader.epoch_plan(0):
        samples = [loader.dataset[i] for i in idx]
        ladder = PadSpec.for_samples(samples, with_triplets=True)
        rows.append({
            "real": (sum(s.num_nodes for s in samples), sum(s.num_edges for s in samples),
                     sum(count_triplets(s) for s in samples)),
            "padded": (spec.num_nodes, spec.num_edges, spec.num_graphs, spec.num_triplets),
            "ladder": (ladder.num_nodes, ladder.num_edges, ladder.num_graphs,
                       ladder.num_triplets)})
    return rows


@contextlib.contextmanager
def indexed_gathers():
    """While open, DimeNet gathers rows with ``x[idx]`` (whose backward is
    a sorted, serial ``index_put_``) in place of ``index_select``: the
    gather the port had before, timed beside it (the port has no such
    switch)."""
    from hydragnn_tpu_torch.models import dimenet

    plain = dimenet.gather_rows
    dimenet.gather_rows = lambda x, idx: x[idx.long()]
    try:
        yield
    finally:
        dimenet.gather_rows = plain


def gather_step_times(model0, cfg, training, host_batch):
    """The DimeNet train step run eagerly with each gather, in turns
    (index_select, x[idx], x[idx], index_select): its eager time and,
    from the profiler, device time, kernels and indexing_backward_kernel
    time."""
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    batch = host_batch.to("cuda")
    out = {"index_select": [], "x[idx]": []}
    for name in ("index_select", "x[idx]", "x[idx]", "index_select"):
        with indexed_gathers() if name == "x[idx]" else contextlib.nullcontext():
            model = copy.deepcopy(model0)
            opt = select_optimizer(model.parameters(), training)
            step = make_train_step(model, opt, cfg)
            state = TrainState(model, opt)
            eager = eager_ms(lambda: step(state, batch), iters=20, warmup=3)
            prof = device_profile(lambda: step(state, batch), per_call=(0, 0),
                                  what=f"DimeNet step with {name}")
        out[name].append(dict(prof, eager_ms=eager))
    for name, runs in out.items():
        log(f"[dimenet] the train step with {name} gathers: " + "; ".join(
            f"{r['eager_ms']:.3f} ms eager, {r.get('device_ms', float('nan')):.3f} ms device "
            f"({r.get('kernels_per_call', 0)} kernels), indexing_backward_kernel "
            f"{r.get('indexing_backward_ms', float('nan')):.3f} ms "
            f"({r.get('indexing_backward_per_call', 0)} launches)" for r in runs))
    return out


def phase_dimenet(config, splits):
    """qm7x.json's DimeNet++ trained by run_training on the card (f32, 2
    epochs; triplets refuse packing, so the loaders keep one worst-case
    shape, as in the JAX package), then run_prediction: finite losses
    and predictions, one train shape, K1 = K2 = 0 (its sums are the plain
    segment_sum, as in the JAX package); the batches' real and padded
    triplet counts; the first train step, card against the CPU plain
    path ([train]'s tolerance, as hold_zinc_step holds it); one step
    replayed against eager, with its eager, replayed and device time;
    the step's time with index_select and with x[idx] gathers."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    t0 = time.perf_counter()
    loader, budgets = train_loader(config, splits[0])
    spec = loader.pad_spec
    check(not loader.packing and budgets is None and spec is not None
          and spec.num_triplets is not None,
          f"qm7x's train loader: packing {loader.packing}, pad {spec}")
    shapes = triplet_shapes(loader)
    real_t = [r["real"][2] for r in shapes]
    ladder = sorted({r["ladder"] for r in shapes})
    log(f"[dimenet] train loader: {len(shapes)} batches an epoch on one worst-case shape "
        f"(nodes, edges, graphs, triplets) {shapes[0]['padded']}; real nodes "
        f"{min(r['real'][0] for r in shapes)}-{max(r['real'][0] for r in shapes)}, edges "
        f"{min(r['real'][1] for r in shapes)}-{max(r['real'][1] for r in shapes)}, triplets "
        f"{min(real_t)}-{max(real_t)}, so {spec.num_triplets - max(real_t)}-"
        f"{spec.num_triplets - min(real_t)} padding triplets a batch, all on edge slot "
        f"{spec.num_edges - 1}; the ladder would pad them to {ladder}")

    with recorded_run() as rec:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t1 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, datasets=splits,
                                                          device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        k1, k2, n_fwd = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches,
                         rec["forwards"])
        steps = torch.cat(rec["losses"]).double().cpu().numpy()
        train_shapes = set(rec["shapes"])
        err, tasks, trues, preds = port.run_prediction(full, datasets=splits, state=state,
                                                       model=model, cfg=cfg)
        torch.cuda.synchronize()
        k1 += edge_pipeline_planned.launches
        k2 += edge_pipeline_bwd_planned.launches
    eager_s, _ = eager_seconds(lambda: port.run_training(config, datasets=splits,
                                                         device="cuda"))
    graphs = graph_report("dimenet", state, hist, train_s, eager_s)
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [err]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"non-finite loss in {losses} or in the steps {steps.tolist()}")
    want = (spec.num_nodes, spec.num_edges, loader.batch_size + 1)
    check(train_shapes == {want}, f"train shapes {sorted(train_shapes)}, want {want}")
    check(k1 == 0 and k2 == 0, f"K1 {k1}, K2 {k2} launches on DimeNet's path (want 0)")
    n_test = len(splits[2])
    check(len(preds) == 1 and preds[0].shape == trues[0].shape == (n_test, 1)
          and np.isfinite(preds[0]).all(),
          "run_prediction wants finite energies [graphs, 1]")
    log(f"[dimenet] run_training on the card ({train_s:.2f} s, {state.step} train steps on "
        f"{sorted(train_shapes)}, {n_fwd} forwards): train loss {hist.train_loss}, val "
        f"{hist.val_loss}, test {hist.test_loss}; per-step train loss "
        f"{[float(f'{x:.4g}') for x in steps]}; run_prediction error {err:.6g} over {n_test} "
        f"samples, finite; K1 {k1}, K2 {k2} launches on the path")

    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    host_batch = next(iter(loader))
    card = zinc_step(copy.deepcopy(model0), cfg, training, host_batch.to("cuda"),
                     torch.float32)
    cpu = zinc_step(copy.deepcopy(model0).to("cpu"), cfg, training, host_batch,
                    torch.float32)
    check(card["launches"] == (0, 0), f"the DimeNet step launched K1/K2 {card['launches']}")
    lr = float(training["Optimizer"]["learning_rate"])
    worst = hold_zinc_step(card, cpu, VJP_TOL, lr, "dimenet first step")
    log(f"[dimenet] first train step (batch {host_batch.num_nodes} nodes, "
        f"{host_batch.num_edges} edges, {host_batch.t_kj.shape[0]} triplet slots, "
        f"{int(host_batch.triplet_mask.sum())} real), card vs CPU plain path in f32: loss "
        f"{card['loss']:.6g} vs {cpu['loss']:.6g}, largest errors loss {worst['loss']:.3g}, "
        f"gradients {worst['grad']:.3g}, parameters {worst['param']:.3g} (rtol "
        f"{VJP_TOL['rtol']}, atol {VJP_TOL['atol']} x the largest gradient "
        f"{worst['scales'][0]:.3g}); all held")
    step = replay_vs_eager("DimeNet first train batch", model0, cfg, training, host_batch,
                           (0, 0))
    gathers = gather_step_times(model0, cfg, training, host_batch)
    seconds = time.perf_counter() - t0
    log(f"[dimenet] phase took {seconds:.1f} s")
    return {"run": {"seconds": train_s, "steps": state.step, "forwards": n_fwd,
                    "train_loss": hist.train_loss, "val_loss": hist.val_loss,
                    "test_loss": hist.test_loss, "prediction_error": err,
                    "step_losses": steps.tolist(), "graphs": graphs, "k1": k1, "k2": k2},
            "shapes": shapes, "parity": {k: v for k, v in worst.items()}, "step": step,
            "gathers": gathers, "seconds": seconds}


# ---------------------------------------------------------------- [capture]

def _host(t):
    return t.detach().float().cpu().numpy().copy()


def host_params(model):
    return {k: _host(p) for k, p in model.named_parameters()}


def host_state(model, before=None):
    """A model's gradients, parameters and buffers on the host."""
    return {"grads": {k: _host(p.grad) for k, p in model.named_parameters()},
            "params": host_params(model),
            "stats": {k: _host(v) for k, v in model.named_buffers()}, "before": before}


def graph_path(model0, cfg, training, mlip=False):
    """A copy of ``model0`` with its optimizer and the train loop's
    superstep over it, through a graph cache of its own."""
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    model = copy.deepcopy(model0)
    opt = select_optimizer(model.parameters(), training)
    cache = StepGraphs("cuda")
    fn = make_superstep_fn(model, opt, cfg, compute_grad_energy=mlip,
                           device=torch.device("cuda"), graphs=cache)
    return model, opt, fn, TrainState(model, opt, graphs=cache)


def replay_pair(model0, cfg, training, host_batch, mlip=False):
    """The train loop's superstep over a copy of ``model0`` through a
    graph cache, after its first (eager) step on ``host_batch``; and an
    eager twin holding the same parameters, buffers and optimizer state
    (so the next step of the two starts from the same bits). Returns
    (replay path, eager path), each (model, optimizer, superstep,
    state)."""
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    replay = graph_path(model0, cfg, training, mlip)
    replay[2](replay[3], None, [host_batch])
    model = copy.deepcopy(replay[0])
    opt = select_optimizer(model.parameters(), training)
    opt.load_state_dict(replay[1].state_dict())
    fn = make_superstep_fn(model, opt, cfg, compute_grad_energy=mlip,
                           device=torch.device("cuda"))
    return replay, (model, opt, fn, TrainState(model, opt, step=replay[3].step))


def same_bits(a, b):
    """Two models (with their optimizers) hold the same bits."""
    (ma, oa), (mb, ob) = a, b
    return (all(torch.equal(x, y) for x, y in zip(ma.state_dict().values(),
                                                  mb.state_dict().values()))
            and all(torch.equal(x, y) for sa, sb in zip(oa.state.values(), ob.state.values())
                    for x, y in zip(sa.values(), sb.values())))


def replay_vs_eager(tag, model0, cfg, training, host_batch, per_call, *, mlip=False,
                    exact=False, iters=20):
    """From the same state (``replay_pair``: one eager step through a
    graph cache, then a twin), one train step on ``host_batch`` through
    the graph cache (its capture and replay) and one eager: the replayed
    step against the eager one, bit for bit where ``exact``, else as
    [zinc] holds the card against the CPU (``hold_zinc_step``). Then each path's step time from
    ``iters`` back-to-back steps (CUDA events; both from the host batch,
    the replay's including its pack and copy), the graph's replays
    alone (the step's device time), and a profile of replayed steps
    (``per_call`` = K1 and K2 launches a step, counted from the
    replays): K1's and K2's device time inside the graph."""
    import numpy as np

    lr = float(training["Optimizer"]["learning_rate"])
    recs, paths = {}, {}
    paths["replay"], paths["eager"] = replay_pair(model0, cfg, training, host_batch, mlip)
    for mode in ("eager", "replay"):
        model, opt, fn, state = paths[mode]
        before = host_params(model)
        _, acc = fn(state, None, [host_batch])
        rec = host_state(model, before)
        rec["loss"] = float(acc[0] / acc[2])
        rec["acc"] = [t.clone() for t in acc]
        recs[mode] = rec
    graphs = paths["replay"][3].graphs
    check((graphs.eager_runs, graphs.captures, graphs.replays) == (1, 1, 1),
          f"{tag}: graph cache ran {graphs.eager_runs} eager, {graphs.captures} captures, "
          f"{graphs.replays} replays (want 1, 1, 1)")
    bitwise = (same_bits(paths["eager"][:2], paths["replay"][:2])
               and all(torch.equal(x, y) for x, y in zip(recs["eager"]["acc"],
                                                         recs["replay"]["acc"]))
               and all(np.array_equal(recs["eager"]["grads"][k], recs["replay"]["grads"][k])
                       for k in recs["eager"]["grads"]))
    if exact:
        check(bitwise, f"{tag}: the replayed step differs from the eager step")
        worst = None
    else:
        worst = hold_zinc_step(recs["replay"], recs["eager"], VJP_TOL, lr, f"{tag} replay")
    timing = {}
    for mode in ("eager", "replay"):
        _, _, fn, state = paths[mode]
        timing[f"{mode}_ms"] = eager_ms(lambda: fn(state, None, [host_batch]), iters=iters,
                                        warmup=2)
    graph = next(iter(graphs.graphs.values())).graph
    timing["graph_ms"] = eager_ms(graph.replay, iters=iters, warmup=2)
    _, _, fn, state = paths["replay"]
    prof = device_profile(lambda: fn(state, None, [host_batch]), per_call=per_call,
                          what=f"{tag} replayed step")
    held = ("bit for bit" if bitwise else
            f"within the card-vs-CPU tolerance (grads {worst['grad']:.3g}, params "
            f"{worst['param']:.3g}, loss {worst['loss']:.3g}; not bit for bit)")
    log(f"[capture] {tag} ({host_batch.num_nodes} nodes, {host_batch.num_edges} edges): one "
        f"train step {timing['eager_ms']:.3f} ms issued eagerly, {timing['replay_ms']:.3f} "
        f"ms replayed from its CUDA graph (host pack + one copy + replay), "
        f"{timing['graph_ms']:.3f} ms of device time (replays alone); the replayed step "
        f"equals the eager step {held}")
    if prof:
        busy = prof["device_ms"]
        log(f"[capture] {tag}, replayed steps under the profiler: {busy:.3f} ms of device "
            f"time, {prof['kernels_per_call']} kernels a step; K1 {prof['k1_ms']:.3f} ms "
            f"({100 * prof['k1_ms'] / busy:.1f}%), K2 {prof['k2_ms']:.3f} ms "
            f"({100 * prof['k2_ms'] / busy:.1f}%), per launch K1 "
            f"{1e3 * prof['k1_ms'] / max(per_call[0], 1):.1f} us, K2 "
            f"{1e3 * prof['k2_ms'] / max(per_call[1], 1):.1f} us; indexing_backward_kernel "
            f"{prof['indexing_backward_ms']:.3f} ms ({prof['indexing_backward_per_call']} "
            f"a step); the device idles "
            f"{100 * (1 - busy / timing['replay_ms']):.0f}% of the replayed step")
    else:
        log(f"[capture] {tag}: the profiler recorded no kernels of the replays; K1's and "
            f"K2's time inside the graph not measured")
    return dict(timing, bitwise=bitwise, nodes=host_batch.num_nodes,
                edges=host_batch.num_edges, replay_profile=prof,
                per_launch_us={"k1": 1e3 * prof["k1_ms"] / max(per_call[0], 1),
                               "k2": 1e3 * prof["k2_ms"] / max(per_call[1], 1)}
                if prof else None)


def k_replay_vs_singles(tag, model0, cfg, training, host_batch, k, *, exact):
    """Three groups of ``k`` steps on ``host_batch``: as K-step
    supersteps (eager, capture and replay, replay) and as single steps
    through a graph cache (eager, then replays). The last group is one
    K-step replay against k single replays: the same bits where
    ``exact`` (parameters, optimizer state, the group's loss sum), else
    the loss sums within rtol 1e-4."""
    out = {}
    for mode in ("singles", "k"):
        model, opt, fn, state = graph_path(model0, cfg, training)
        sums = []
        for _ in range(3):
            if mode == "k":
                _, acc = fn(state, None, [host_batch] * k)
            else:
                acc = None
                for _ in range(k):
                    _, acc = fn(state, acc, [host_batch])
            sums.append(acc[0].clone())
        check(state.step == 3 * k and state.graphs.captures == 1,
              f"{tag} {mode}: {state.step} steps, {state.graphs.captures} captures")
        out[mode] = (model, opt, torch.stack(sums))
    bitwise = (same_bits(out["singles"][:2], out["k"][:2])
               and torch.equal(out["singles"][2], out["k"][2]))
    if exact:
        check(bitwise, f"{tag}: one {k}-step replay differs from {k} single replays")
    else:
        torch.testing.assert_close(out["k"][2], out["singles"][2], rtol=1e-4, atol=0.0)
    rel = float(((out["k"][2] - out["singles"][2]).abs() / out["singles"][2].abs()).max())
    log(f"[capture] {tag}: one {k}-step replay against {k} single replays (after a "
        f"{k}-step eager warm-up and a {k}-step capture): "
        + ("bit for bit (parameters, optimizer state, loss sums)" if bitwise else
           f"loss sums within rtol 1e-4 (largest relative gap {rel:.3g}; not bit for bit)"))
    return {"k": k, "bitwise": bitwise, "largest_relative_gap": rel}


def optimizer_replays(model0, cfg, training, host_batch):
    """One replayed step per optimizer type on ``host_batch`` against an
    eager step from the same state (``replay_pair``; held as [zinc]
    holds the card against the CPU), every parameter finite; then SGD: a
    learning-rate change between replays reaches the replayed step (the
    parameters move by exactly -lr_new x the replay's gradient) with no
    recapture."""
    import numpy as np

    from hydragnn_tpu_torch.train.optimizer import set_learning_rate

    kinds = ("SGD", "Adam", "AdamW", "Adadelta", "Adagrad", "Adamax", "RMSprop", "LAMB",
             "FusedLAMB")
    lr = float(training["Optimizer"]["learning_rate"])
    rows = {}
    for kind in kinds:
        opt_training = {"Optimizer": {"type": kind, "learning_rate": lr}}
        recs, paths = {}, {}
        paths["replay"], paths["eager"] = replay_pair(model0, cfg, opt_training, host_batch)
        for mode in ("eager", "replay"):
            model, _, fn, state = paths[mode]
            before = host_params(model)
            _, acc = fn(state, None, [host_batch])
            recs[mode] = dict(host_state(model, before), loss=float(acc[0] / acc[2]))
            if mode == "replay":
                check(state.graphs.replays == 1, f"{kind}: the second step was not replayed")
        check(all(np.isfinite(v).all() for v in recs["replay"]["params"].values()),
              f"{kind}: non-finite parameters after the replayed step")
        worst = hold_zinc_step(recs["replay"], recs["eager"], VJP_TOL, lr, f"{kind} replay")
        moved = max(float(np.abs(recs["replay"]["params"][k] - recs["replay"]["before"][k]).max())
                    for k in recs["replay"]["params"])
        check(moved > 0, f"{kind}: the replayed step moved no parameter")
        rows[kind] = {"loss": recs["replay"]["loss"], "grad_err": worst["grad"],
                      "param_err": worst["param"], "largest_move": moved}
    log("[capture] one replayed step per optimizer on the polymer bin against an eager step "
        "from the same state (rtol 1e-4, atol 1e-3 x min(largest, 1); all finite): "
        + ", ".join(
            f"{k} loss {r['loss']:.6g} grads {r['grad_err']:.2g} params {r['param_err']:.2g} "
            f"moved {r['largest_move']:.2g}" for k, r in rows.items()))

    model, opt, fn, state = graph_path(model0, cfg, {"Optimizer": {"type": "SGD",
                                                                   "learning_rate": lr}})
    fn(state, None, [host_batch])
    fn(state, None, [host_batch])
    lr_t = opt.param_groups[0]["lr"]
    set_learning_rate(opt, lr / 4)
    check(opt.param_groups[0]["lr"] is lr_t, "set_learning_rate rebound the lr tensor")
    before = [p.detach().clone() for p in model.parameters()]
    fn(state, None, [host_batch])
    want = [b + p.grad * torch.neg(lr_t) for b, p in zip(before, model.parameters())]
    exact = all(torch.equal(p, w) for p, w in zip(model.parameters(), want))
    old = [b + p.grad * -lr for b, p in zip(before, model.parameters())]
    check(exact and state.graphs.captures == 1 and state.graphs.replays == 2
          and not all(torch.equal(p, o) for p, o in zip(model.parameters(), old)),
          "a learning-rate change did not reach the replayed SGD step")
    log(f"[capture] SGD: after set_learning_rate({lr / 4:g}) the next replay moved every "
        f"parameter by exactly -{lr / 4:g} x its gradient (no recapture: 1 capture, 2 replays)")
    return rows


def phase_capture(steps, poly, head_cpu):
    """Eager against replay at each path's step shape (``steps``: tag,
    model, cfg, training, host batch, mlip, exact), one K-step replay
    against K single replays (the SchNet headline step bit for bit, the
    polymer bin within tolerance), one replayed step per optimizer, a
    learning-rate change reaching a replayed step, and polymers.json
    trained with K-step supersteps through run_training."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.data.padschedule import superstep_groups
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    t0 = time.perf_counter()
    out = {"steps": {}}
    for tag, model0, cfg, training, batch, per_call, mlip, exact in steps:
        out["steps"][tag] = replay_vs_eager(tag, model0, cfg, training, batch, per_call,
                                            mlip=mlip, exact=exact)
    head_model, head_cfg, head_training = steps[0][1:4]
    out["k_headline"] = k_replay_vs_singles("SchNet headline step", head_model, head_cfg,
                                            head_training, head_cpu, 2, exact=True)
    out["k_polymer"] = k_replay_vs_singles("polymer bin", poly["model0"], poly["cfg"],
                                           poly["training"], poly["bin"], 4, exact=False)
    out["optimizers"] = optimizer_replays(poly["model0"], poly["cfg"], poly["training"],
                                          poly["bin"])

    # polymers.json trained with K = 4 supersteps: each epoch's 8 bins of
    # one budget make two groups; the plateau scheduler, told to cut the
    # rate every epoch, changes it between epochs with no recapture.
    k = 4
    config = copy.deepcopy(poly["config"])
    training = config["NeuralNetwork"]["Training"]
    training["Parallelism"] = dict(training.get("Parallelism", {}), superstep={"steps": k})
    training["ReduceLROnPlateau"] = {"factor": 0.5, "patience": 0, "threshold": 1.0}
    plan = list(poly["loader"].epoch_plan(0))
    groups = [len(g) for g in superstep_groups(plan, k)]
    check(groups.count(k) >= 1, f"K = {k} forms no full group in {groups}")
    with recorded_run() as rec:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t1 = time.perf_counter()
        state, model, cfg, hist, _ = port.run_training(config, datasets=poly["splits"],
                                                       seed=0, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    sizes = [len(x) for x in rec["losses"]]
    steps_losses = torch.cat(rec["losses"]).double().cpu().numpy()
    lr0 = float(training["Optimizer"]["learning_rate"])
    check(sizes.count(k) >= 1 and sum(sizes) == state.step and np.isfinite(steps_losses).all()
          and np.isfinite(hist.train_loss).all(),
          f"K = {k} run: dispatch sizes {sizes}, {state.step} steps")
    check(k1 == 3 * rec["forwards"] and k2 == 3 * state.step,
          f"K = {k} run: K1 {k1} in {rec['forwards']} forwards, K2 {k2} in {state.step} steps")
    check(np.allclose(hist.lr, [lr0 * 0.5 ** (e + 1) for e in range(len(hist.lr))], rtol=1e-6)
          and not any(hist.epoch_captures[2:]),
          f"K = {k} run: lr {hist.lr}, captures per epoch {hist.epoch_captures}")
    graphs = graph_report(f"capture] [polymers K={k}", state, hist, run_s,
                          poly["run_seconds"], steady=2)
    log(f"[capture] polymers.json with superstep steps {k}: epoch 0's plan of {len(plan)} "
        f"bins groups into {groups} (superstep_groups); the run dispatched {sizes} steps "
        f"per dispatch over {state.step} steps, K1 {k1} = 3 x {rec['forwards']} forwards, K2 "
        f"{k2} = 3 x {state.step} steps; the plateau scheduler cut the rate each epoch "
        f"({hist.lr}) with captures per epoch {hist.epoch_captures}; train loss "
        f"{hist.train_loss} ({run_s:.2f} s against {poly['run_seconds']:.2f} s for the K = 1 "
        f"run in [polymers])")
    out["superstep_run"] = {"k": k, "groups": groups, "dispatch_sizes": sizes,
                            "lr": hist.lr, "train_loss": hist.train_loss, "k1": k1, "k2": k2,
                            "graphs": graphs}
    out["seconds"] = time.perf_counter() - t0
    log(f"[capture] eager against replay per step, {card_line()}: " + "; ".join(
        f"{tag} {r['eager_ms']:.3f} -> {r['replay_ms']:.3f} ms (device {r['graph_ms']:.3f})"
        for tag, r in out["steps"].items()) + f"; phase took {out['seconds']:.1f} s")
    return out, k1, k2


def zoo_configs():
    """One config per remaining invariant stack at its example's widths:
    GAT at csce_gap.json's (hidden 60, 3 layers, graph head 1x60 + [60,
    60]; heads 6), with the polymers' three input features and graph
    target in place of csce's; GIN, MFC and CGCNN, which no example
    config names, at polymers.json's (hidden 64 — CGCNN keeps the input
    width —, 3 layers, both heads), MFC with max_neighbours 10 (PyG
    MFConv's default max_degree) and bn_recalibration off."""
    configs = {}
    for stack in ("GIN", "MFC", "CGCNN"):
        config = example_config("open_polymers_2026", "polymers.json")
        arch = config["NeuralNetwork"]["Architecture"]
        arch["mpnn_type"] = stack
        if stack == "MFC":
            arch["max_neighbours"] = 10
            config["NeuralNetwork"]["Training"]["bn_recalibration"] = 0
        configs[stack] = config
    gat = example_config("csce", "csce_gap.json")
    poly = example_config("open_polymers_2026", "polymers.json")
    voi = poly["NeuralNetwork"]["Variables_of_interest"]
    gat["NeuralNetwork"]["Variables_of_interest"] = {
        k: (v if k == "input_node_features" else v[:1]) for k, v in voi.items()}
    configs["GAT"] = gat
    return configs


def phase_zoo(splits, first_bin, poly_model, poly_cfg, trainset):
    """One train step each of GIN, MFC, CGCNN and GAT (zoo_configs) on
    the first packed polymer bin, card against the CPU plain path (loss,
    gradients, AdamW-updated parameters, running statistics, as
    hold_zinc_step holds them) with their K1/K2 launches (3 each from a
    conv node head, none without one); then one recalibrate_batch_stats
    pass of polymers.json's model over the first four unpacked train
    batches, card against CPU."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
    from hydragnn_tpu_torch.train.loop import TrainState, recalibrate_batch_stats
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    t0 = time.perf_counter()
    out = {}
    for stack, config in zoo_configs().items():
        full = update_config(config, *splits)
        training = full["NeuralNetwork"]["Training"]
        lr = float(training["Optimizer"]["learning_rate"])
        model0, cfg = create_model_config(full, "cuda", seed=0)
        want = (3, 3) if cfg.node_branches else (0, 0)
        card = zinc_step(copy.deepcopy(model0), cfg, training, first_bin.to("cuda"),
                         torch.float32)
        cpu = zinc_step(copy.deepcopy(model0).to("cpu"), cfg, training, first_bin,
                        torch.float32)
        check(card["launches"] == want and cpu["launches"] == (0, 0),
              f"zoo {stack}: K1/K2 launched {card['launches']} on the card (want {want}), "
              f"{cpu['launches']} on the CPU")
        worst = hold_zinc_step(card, cpu, VJP_TOL, lr, f"zoo {stack}")
        n_params = sum(p.numel() for p in model0.parameters())
        out[stack] = {k: v for k, v in worst.items() if k != "scales"}
        out[stack].update(launches=card["launches"], params=n_params)
        log(f"[zoo] {stack} (hidden {cfg.hidden_dim}, {cfg.num_conv_layers} layers, "
            f"{n_params} parameters, heads {[h.type for h in cfg.heads]}): first step card "
            f"vs CPU, loss {card['loss']:.6g} vs {cpu['loss']:.6g}; worst |err| grads "
            f"{worst['grad']:.3g} (largest |grad| {worst['scales'][0]:.3g}), params "
            f"{worst['param']:.3g}, statistics {worst['stats']:.3g}; K1/K2 {card['launches']}")
    loader = GraphLoader(trainset, 32, with_segment_plan=True)
    batches = [b for b, _ in zip(loader, range(4))]
    stats = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(poly_model).to(dev)
        state = TrainState(model, select_optimizer(model.parameters(), {}))
        recalibrate_batch_stats(model, state, batches, device=torch.device(dev))
        stats[dev] = {k: v.float().cpu().numpy() for k, v in model.named_buffers()}
    n_bn = sum(isinstance(m, MaskedBatchNorm) for m in poly_model.modules())
    recal = max(assert_close_scaled(stats["cuda"][k], stats["cpu"][k], F32_TOL,
                                    f"recalibrated {k}", scale=1.0)[0] for k in stats["cpu"])
    out["recalibration"] = {"max_abs_err": recal, "batch_norms": n_bn, "batches": 4}
    seconds = time.perf_counter() - t0
    log(f"[zoo] recalibrate_batch_stats of polymers.json's model over 4 unpacked train "
        f"batches ({n_bn} batch norms): card vs CPU worst |err| {recal:.3g} (rtol "
        f"{F32_TOL['rtol']}, atol {F32_TOL['atol']})")
    log(f"[zoo] phase took {seconds:.1f} s")
    out["seconds"] = seconds
    return out


def bcc_data():
    """The BCC set of tests/test_graphs.py (300 configurations, seed 7)
    written under dataset/ (gitignored), its config, and its stratified
    train/val/test split as the runner makes it."""
    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.data.raw import process_raw_samples, read_lsms_directory
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    path = os.path.join("dataset", "chip_smoke_bcc")
    t0 = time.perf_counter()
    deterministic_graph_data(path, number_configurations=300, seed=7)
    config = bcc_config(path)
    samples = process_raw_samples(read_lsms_directory(path, config["Dataset"]), config)
    splits = split_dataset(samples, 0.7, stratified=True)
    log(f"[train] BCC set: 300 configurations (seed 7), splits "
        f"{[len(x) for x in splits]}, in {time.perf_counter() - t0:.2f} s")
    return config, splits


def train_bins(trainset):
    """The first two batches of the BCC run's train loader (batch 32) on
    the card: the shapes K2 meets in phase train."""
    from hydragnn_tpu_torch.data.loader import GraphLoader

    loader = GraphLoader(trainset, 32, shuffle=True, seed=0, fixed_pad="auto")
    out = []
    for batch in loader:
        out.append((f"train_n{batch.num_nodes}_e{batch.num_edges}", batch.to("cuda")))
        if len(out) == 2:
            break
    return out


# ----------------------------------------------------------------------
# PR 10: data parallelism, ZeRO/FSDP2 and multibranch (ROADMAP item 11)
# ----------------------------------------------------------------------


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world_one():
    """A one-rank NCCL group through the port's own rendezvous
    (``HYDRAGNN_TPU_COORDINATOR=localhost:<free port>``), torn down on
    exit so the other phases run without one."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel import runtime

    env = {"HYDRAGNN_TPU_COORDINATOR": f"localhost:{free_port()}",
           "HYDRAGNN_TPU_NUM_PROCESSES": "1", "HYDRAGNN_TPU_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        check(runtime.maybe_initialize_distributed(), "no process group was made")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"backend {dist.get_backend()} at world {dist.get_world_size()}")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def dp_config(config, **par):
    """``config`` (an example's) with ``Training.Parallelism`` set to dp
    over ``data`` 1 and ``par``."""
    config = copy.deepcopy(config)
    config["NeuralNetwork"]["Training"]["Parallelism"] = dict({"scheme": "dp", "data": 1},
                                                              **par)
    return config


def dp_step_fn(model, opt, cfg, plan, graphs=None, mlip=True):
    """The dp train superstep over ``model`` (through ``graphs`` on the
    card where given)."""
    from hydragnn_tpu_torch.parallel.dp import make_dp_superstep_fn

    return make_dp_superstep_fn(model, opt, cfg, plan, compute_grad_energy=mlip,
                                device=torch.device("cuda"), graphs=graphs)


def full_state(model, opt):
    """A model's parameters, buffers and optimizer state as whole tensors
    (FSDP2's DTensors gathered)."""
    from hydragnn_tpu_torch.parallel.runtime import gather_to_host

    out = {k: gather_to_host(v) for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": gather_to_host(v) for k, v in st.items()})
    return out


def max_gap(a, b):
    """Largest |a - b| over two full states, scaled by the largest |b|."""
    gaps = [float((a[k].double() - b[k].double()).abs().max()) for k in b if b[k].numel()]
    top = max(float(b[k].double().abs().max()) for k in b if b[k].numel())
    return max(gaps) / max(top, 1e-30)


def flat_bytes(model):
    from hydragnn_tpu_torch.models.layers import MaskedBatchNorm

    n = sum(p.numel() for p in model.parameters()) + sum(
        2 * m.mean.numel() for m in model.modules() if isinstance(m, MaskedBatchNorm))
    return 4 * (n + 1 + 3)  # + the loss and the MLIP's 3 per-task terms


def phase_dp(config, splits, first_bin, budgets):
    """[dp] oc20.json's MACE under ``Parallelism: {"scheme": "dp", "data":
    1}`` over NCCL at world 1 (the port's rendezvous): the first dp step
    against the single scheme's on the first packed bin, bit for bit
    (loss, every parameter, the optimizer state), with 4 K1 and 4 K2
    launches; three dp steps through a graph cache (eager, capture +
    replay, replay) against three eager dp steps, bit for bit, the
    replay's kernels holding NCCL's all-reduce; the replayed dp and
    single steps timed in turns; the all-reduce of the flat gradient
    buffer alone, in a graph; then run_training 2 epochs and
    run_prediction through ``mlip_run``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.parallel import runtime
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    config = dp_config(config)
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    out = {}
    with nccl_world_one():
        plan = runtime.plan_from_config(full)
        check(plan.scheme == "dp" and plan.mesh.size == 1 and not plan.fsdp, f"plan {plan}")
        model0, cfg = create_model_config(full, "cuda", seed=0)
        log(f"[dp] NCCL group of world 1 through HYDRAGNN_TPU_COORDINATOR; plan {plan.scheme} "
            f"mesh {plan.mesh.shape}; the flat all-reduce buffer {flat_bytes(model0)} bytes "
            f"({sum(p.numel() for p in model0.parameters())} parameters + the loss terms)")

        def path(dp, graphs=None):
            model = copy.deepcopy(model0)
            opt = select_optimizer(model.parameters(), training)
            if dp:
                fn = dp_step_fn(model, opt, cfg, plan, graphs)
            else:
                fn = make_superstep_fn(model, opt, cfg, compute_grad_energy=True,
                                       device=torch.device("cuda"), graphs=graphs)
            return model, opt, fn, TrainState(model, opt, graphs=graphs)

        single, dp = path(False), path(True)
        _, acc_s = single[2](single[3], None, [first_bin])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        _, acc_d = dp[2](dp[3], None, [first_bin])
        torch.cuda.synchronize()
        launches = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
        check(launches == (4, 4), f"dp step K1/K2 launches {launches}, want (4, 4)")
        check(all(torch.equal(a, b) for a, b in zip(acc_s, acc_d))
              and same_bits(single[:2], dp[:2]),
              "the first dp step at world 1 is not the single step bit for bit")
        log(f"[dp] first dp step on the first packed bin ({first_bin.num_nodes} nodes) equals "
            f"the single step bit for bit: loss {float(acc_d[0]):.9g}, every parameter and "
            f"the AdamW state; K1 {launches[0]}, K2 {launches[1]} launches")
        # replay vs eager over three steps from the same state; the
        # collectives the dp step issues while it is being captured
        cache = StepGraphs("cuda")
        rep, eag = path(True, cache), path(True)
        issued = []
        plain_all_reduce = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            issued.append((torch.cuda.is_current_stream_capturing(), tensor.numel()))
            return plain_all_reduce(tensor, *args, **kwargs)

        dist.all_reduce = counted
        try:
            for _ in range(3):
                rep[2](rep[3], None, [first_bin])
                eag[2](eag[3], None, [first_bin])
        finally:
            dist.all_reduce = plain_all_reduce
        torch.cuda.synchronize()
        check((cache.eager_runs, cache.captures, cache.replays) == (1, 1, 2),
              f"cache {cache.eager_runs} eager, {cache.captures} captures, {cache.replays} "
              "replays")
        check(same_bits(rep[:2], eag[:2]), "replayed dp steps differ from eager ones")
        captured = [n for cap, n in issued if cap]
        check(len(captured) == 2 and captured[1] == flat_bytes(model0) // 4,
              f"all-reduces issued while capturing the dp step: {captured}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rep[2](rep[3], None, [first_bin])
            torch.cuda.synchronize()
        names = {e.name for e in device_kernels(prof)}
        nccl = sorted(n for n in names if "nccl" in n.lower())
        log(f"[dp] three dp steps through the graph cache (1 eager, 1 capture, 2 replays) "
            f"equal three eager dp steps bit for bit; the capture recorded {len(captured)} "
            f"NCCL all-reduces ({captured} elements: the graph count, then the flat buffer); "
            f"NCCL kernels in a replay's profile: {nccl or 'none (one rank: NCCL has '}"
            f"{'' if nccl else 'nothing to move)'}")
        # replayed dp step against the replayed single step, in turns
        cache_s = StepGraphs("cuda")
        rep_s = path(False, cache_s)
        for _ in range(3):
            rep_s[2](rep_s[3], None, [first_bin])

        def replayed_ms(p, iters=20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                p[2](p[3], None, [first_bin])
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        times = {"single": [], "dp": []}
        for _ in range(2):
            times["single"].append(replayed_ms(rep_s))
            times["dp"].append(replayed_ms(rep))
        n = flat_bytes(model0) // 4
        buf = torch.zeros(n, device="cuda")
        ar_ms = eager_ms(lambda: dist.all_reduce(buf))
        log(f"[dp] replayed step (host pack + copy + replay, 20 back to back, in turns): dp "
            f"{times['dp']} ms against single {times['single']} ms; the all-reduce of the "
            f"{4 * n}-byte flat buffer alone, issued eagerly back to back: "
            f"{1000 * ar_ms:.2f} us (captured at one rank it records no device work)")
        out.update(first_step="bit for bit", launches_per_step=launches,
                   replayed_ms=times, allreduce_us=1000 * ar_ms, allreduce_bytes=4 * n,
                   nccl_kernels=nccl, allreduces_captured=captured)
        keep = {}
        out["run"] = mlip_run(config, splits, budgets, tag="dp",
                              data="OC20 slabs (dp, world 1)", per_fwd=cfg.num_conv_layers,
                              keep=keep)
        check(keep["state"].graphs is not None and keep["state"].eager_reason is None,
              "the dp run's steps were not captured")
        check(("dp", "test") in keep["keys"], f"run_prediction under dp did not take the dp "
              f"test pass: step keys {sorted(keep['keys'])}")
        log(f"[dp] run_prediction took the dp test pass (its steps "
            f"{sorted(k for k in keep['keys'] if k[0] == 'dp')}; the slots gathered)")
        guarded = copy.deepcopy(config)
        guarded["NeuralNetwork"]["Training"]["Guard"] = {"enabled": True}
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        g_state, g_model, _, g_hist, _ = port.run_training(guarded, datasets=splits,
                                                           device="cuda")
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        out["guard"] = {"k1": edge_pipeline_planned.launches,
                        "k2": edge_pipeline_bwd_planned.launches, "seconds": g_s}
        run = out["run"]
        check([g_hist.train_loss, g_hist.val_loss, g_hist.test_loss]
              == [run["train_loss"], run["val_loss"], run["test_loss"]]
              and guard_same((g_model, g_state.optimizer),
                             (keep["model"], keep["state"].optimizer)),
              f"[dp] the guarded dp run differs from the unguarded one: train loss "
              f"{g_hist.train_loss} vs {run['train_loss']}")
        check(g_state.graphs is not None and g_state.graphs.replays > 0,
              "[dp] the guarded dp run's steps were not replayed")
        log(f"[dp] run_training again with Guard on ({g_s:.2f} s, {g_state.graphs.replays} "
            f"replays): losses, parameters and the AdamW state equal the guard-off run's "
            f"bit for bit; K1 {out['guard']['k1']}, K2 {out['guard']['k2']}")
    return out


def phase_fsdp(config, splits, first_bin, budgets):
    """[fsdp] the same MACE under ``"zero": true`` (FSDP2 over the one
    rank's data group, NCCL): the first step against dp's (within the
    f32 gradient tolerance; whether bit for bit printed); run_training
    (eager by the scheme's decision, printed on its graph_report line)
    and run_prediction through ``mlip_run``; the checkpoint's full
    tensors restored by ``run_prediction(config)`` alone, bit for bit
    against the run's gathered state, and its predictions against the
    in-process ones."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.parallel import runtime
    from hydragnn_tpu_torch.parallel.dp import replicate_state
    from hydragnn_tpu_torch.runner import restore_checkpoint_state
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    config = dp_config(config, zero=True)
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    out = {}
    with nccl_world_one():
        plan = runtime.plan_from_config(full)
        check(plan.fsdp and plan.fsdp_axis == "data", f"plan {plan}")
        model0, cfg = create_model_config(full, "cuda", seed=0)
        steps = {}
        for name, p in (("dp", runtime.plan_from_config(dp_config(config))), ("zero", plan)):
            model = replicate_state(copy.deepcopy(model0), p, "cuda")
            opt = select_optimizer(model.parameters(), training)
            state = TrainState(model, opt)
            fn = dp_step_fn(model, opt, cfg, p)
            _, acc = fn(state, None, [first_bin])
            torch.cuda.synchronize()
            first = (full_state(model, opt), float(acc[0]))
            # then the eager step's time (both paths eager here, in turns)
            steps[name] = first + (eager_ms(lambda: fn(state, None, [first_bin]), iters=10,
                                            warmup=2),)
        kinds = {type(p).__name__ for p in model.parameters()}
        check(kinds == {"DTensor"}, f"zero's parameters are {kinds}, not FSDP2 shards")
        gap = max_gap(steps["zero"][0], steps["dp"][0])
        exact = all(torch.equal(steps["zero"][0][k], v) for k, v in steps["dp"][0].items())
        check(gap <= VJP_TOL["atol"], f"zero's first step is {gap:.3g} of the largest off dp's")
        log(f"[fsdp] FSDP2 fully_shard over the data group (parameters {sorted(kinds)}); the "
            f"first step on the first packed bin against dp's: loss {steps['zero'][1]:.9g} vs "
            f"{steps['dp'][1]:.9g}, state within {gap:.3g} of the largest "
            f"({'bit for bit' if exact else 'not bit for bit'}); the eager step (10 back to "
            f"back, CUDA events): zero {steps['zero'][2]:.3f} ms, dp {steps['dp'][2]:.3f} ms")
        keep = {}
        # the sharded format: every epoch that improves and every 10 steps
        # through the writer, and the final save
        config["NeuralNetwork"]["Training"].update(
            checkpoint_format="orbax", Checkpoint={"enabled": True, "interval_steps": 10})
        out["run"] = mlip_run(config, splits, budgets, tag="fsdp", per_fwd=cfg.num_conv_layers,
                              data="OC20 slabs (zero, world 1)", eager_baseline=False,
                              keep=keep)
        state = keep["state"]
        check(state.graphs is None and state.eager_reason, "the zero run was not eager")
        check(("dp", "test") in keep["keys"], f"run_prediction under zero did not take the dp "
              f"test pass: step keys {sorted(keep['keys'])}")
        trained = {k: v for k, v in full_state(state.model, state.optimizer).items()}
        t0 = time.perf_counter()
        err, _, _, preds = port.run_prediction(keep["full"], datasets=splits)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        fresh, _ = create_model_config(keep["full"], "cuda")
        restored = restore_checkpoint_state(keep["full"], fresh)
        back = full_state(restored.model, restored.optimizer)
        check(set(back) == set(trained) and all(torch.equal(back[k], trained[k])
                                                for k in trained),
              "run_prediction(config) did not restore the zero run's full tensors bit for bit")
        gaps = [float(np.abs(a - b).max()) for a, b in zip(preds, keep["preds"])]
        check(all(np.isclose(a, b, **F32_TOL).all() for a, b in zip(preds, keep["preds"])),
              f"run_prediction(config) predictions off the in-process ones by {gaps}")
        log(f"[fsdp] run_prediction(config) alone ({pred_s:.2f} s) restored {len(trained)} "
            f"full tensors bit for bit from the sharded format (unsharded, in one process); "
            f"error {err:.6g} against {keep['err']:.6g} in process, predictions within "
            f"{max(gaps):.3g}")
        out["sharded"] = sharded_checks(keep["full"]["_log_name"], state, trained,
                                        lambda: create_model_config(keep["full"], "cuda")[0],
                                        training)
        out.update(first_step_gap=gap, first_step_exact=exact, eager=state.eager_reason,
                   eager_step_ms={k: v[2] for k, v in steps.items()})
    return out


def sharded_checks(log_name, state, trained, fresh_model, training):
    """[fsdp]'s sharded format (``checkpoint_format: "orbax"``) around the
    zero run's state: what the run wrote under ``orbax/``; a save with
    ``crash:orbax_between_replaces`` armed (the fault raised between the
    two renames, as a kill there would stop it) leaves ``final.old``,
    from which a fresh unsharded model restores the state bit for bit;
    and the writer's snapshot and write ms and bytes for this state in
    the sharded format against the .pt format (three saves each, in
    turns)."""
    import shutil

    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import checkpoint as ck
    from hydragnn_tpu_torch.utils import faults

    base = os.path.join("logs", log_name, "orbax")
    names = sorted(os.listdir(base))
    check({"LATEST", "RESUME", "final", "autosave"} <= set(names)
          and any(n.startswith("epoch_") for n in names),
          f"[fsdp] orbax/ holds {names}")
    files = sorted(os.listdir(os.path.join(base, "final")))
    check(files == ["manifest.json", "meta.json", "rank0.pt"], f"[fsdp] final/ holds {files}")

    def restored():
        model = fresh_model()
        return TrainState(model, select_optimizer(model.parameters(), training))

    faults.install("crash:orbax_between_replaces:1")
    try:
        ck.save_checkpoint_sharded(log_name, state)
        check(False, "[fsdp] crash:orbax_between_replaces did not fire")
    except faults.InjectedCrash:
        pass
    finally:
        faults.reset()
    left = sorted(os.listdir(base))
    check("final" not in left and "final.old" in left, f"[fsdp] after the crash: {left}")
    back = ck.load_checkpoint_sharded(log_name, restored())
    got = full_state(back.model, back.optimizer)
    check(set(got) == set(trained) and all(torch.equal(got[k], trained[k]) for k in trained),
          "[fsdp] the state restored from final.old differs from the run's")
    stats = {}
    for rep in range(2):
        for fmt in ("orbax", "pt"):
            name = f"{log_name}_writer_{fmt}"
            w = ck.CheckpointWriter(name, fmt=fmt)
            for step in range(3):
                w.save(state, kind="auto", epoch=9, step=step)
            w.close()
            stats.setdefault(fmt, []).append(w.stats())
            shutil.rmtree(os.path.join("logs", name), ignore_errors=True)
    ms = {fmt: {"snapshot_ms": [x for st in v for x in st["snapshot_ms"]],
                "write_ms": [x for st in v for x in st["write_ms"]],
                "bytes_per_save": v[0]["bytes"] // max(v[0]["saves"], 1)}
          for fmt, v in stats.items()}
    check(all(st["saves"] == 3 and st["last_error"] is None for v in stats.values()
              for st in v), f"[fsdp] writer stats {stats}")
    log(f"[fsdp] sharded format: orbax/ holds {names}, final/ {files}; a save with "
        f"crash:orbax_between_replaces left {left} and a fresh model restored "
        f"{len(trained)} tensors from final.old bit for bit")
    for fmt in ("orbax", "pt"):
        log(f"[fsdp] writer, {fmt} format, the zero state at world 1 (rank 0: "
            f"{ms[fmt]['bytes_per_save']} bytes a save): snapshot ms "
            f"{[round(x, 3) for x in ms[fmt]['snapshot_ms']]}, write ms "
            f"{[round(x, 3) for x in ms[fmt]['write_ms']]} (2 rounds of 3 saves, formats in "
            f"turns)")
    return {"dirs": names, "after_crash": left, "writer": ms}


MB_SIZES = (300, 120, 80)  # examples/multibranch/train.py --sizes
MB_RANKS = 3


def make_branch_dataset(n, scale, seed):
    """examples/multibranch/train.py's ``make_branch_dataset``: the
    multibranch driver's (drivers/multibranch.py), on the port's
    ``radius_graph``."""
    from hydragnn_tpu_torch.drivers.multibranch import make_branch_dataset as make

    return make(n, scale, seed)


def multibranch_config(epochs=2):
    """examples/multibranch/train.py's model as a run_training config:
    SchNet, hidden 32, 3 conv layers, radius 2.5, 16 Gaussians, 32
    filters, one graph head "y" on three branches (BranchSpec's
    defaults), batch 8, AdamW 2e-3, ``scheme: "multibranch"``."""
    branch = {"num_sharedlayers": 1, "dim_sharedlayers": 16, "num_headlayers": 1,
              "dim_headlayers": [16]}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "multibranch"},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet", "hidden_dim": 32, "num_conv_layers": 3,
                "radius": 2.5, "max_neighbours": 16, "num_gaussians": 16, "num_filters": 32,
                "output_heads": {"graph": [{"type": f"branch-{i}", "architecture": branch}
                                           for i in range(len(MB_SIZES))]},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["y"],
                                      "output_index": [0], "type": ["graph"],
                                      "output_dim": [1]},
            "Training": {"num_epoch": epochs, "batch_size": 8, "precision": "fp32",
                         "Optimizer": {"type": "AdamW", "learning_rate": 2e-3},
                         "Parallelism": {"scheme": "multibranch"}},
        },
    }


def multibranch_sets():
    """The three branches (seeds 0, 1, 2; scales 1, 2, 3), each split 0.8
    as the port's split_dataset splits."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    return [split_dataset(make_branch_dataset(n, 1.0 + bi, seed=bi), 0.8)
            for bi, n in enumerate(MB_SIZES)]


MB_POISON_STEP = 3  # [multibranch]: the train step whose branch-1 labels are NaN
MB_KILL = 13  # [multibranch]: the train step tick that kills the drill (epoch 1, step 5)


def mb_state(model, opt):
    """Every tensor a multibranch train step writes, on the host, by name:
    the model's, each parameter's optimizer state, each group's step
    count and rate."""
    name = {id(p): n for n, p in model.named_parameters()}
    out = {f"model/{k}": v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out.update({f"opt/{name[id(p)]}/{k}": v.detach().cpu().clone()
                for p, st in opt.state.items() for k, v in st.items()})
    out.update({f"group/{i}/{k}": g[k].detach().cpu().clone()
                for i, g in enumerate(opt.param_groups) for k in ("step", "lr")})
    return out


def mb_poisoned(batch):
    """``batch`` with its real graphs' targets NaN (a host-side label
    poison: only this slot's branch reads them)."""
    import dataclasses

    import numpy as np

    y = np.array(batch.y_graph, copy=True)
    y[np.asarray(batch.graph_mask)] = np.nan
    return dataclasses.replace(batch, y_graph=y)


def mb_training(rank, config, sets, *, snap_at=None, poison_rank=None, first=False):
    """run_training of ``config`` on this rank with every train step
    recorded: a digest of the parameters after each, the forwards and
    train steps, the K1/K2 launches (counted from 0 here); with
    ``snap_at`` the state before and after that train step (whose
    sub-batch is label-poisoned on ``poison_rank``); with ``first`` the
    first step's sub-batch, starting parameters and reduced gradients."""
    import hashlib

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.parallel import dp as dp_mod

    rec = {"digests": [], "train_steps": 0, "forwards": 0, "first": None, "snap": None,
           "oks": []}
    plain = dp_mod.make_dp_superstep_fn

    def recorded(model, optimizer, cfg, plan, *, train=True, **kw):
        fn = plain(model, optimizer, cfg, plan, train=train, **kw)

        def step(state, acc, batches, **probe):
            rec["forwards"] += len(batches)
            if not train:
                return fn(state, acc, batches, **probe)
            before = None
            if first and rec["first"] is None:
                before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            at = rec["train_steps"] == snap_at
            if at:
                snap_before = mb_state(model, optimizer)
                if rank == poison_rank:
                    batches = [mb_poisoned(batches[0])] + list(batches[1:])
            out = fn(state, acc, batches, **probe)
            rec["train_steps"] += len(batches)
            flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            rec["digests"].append(hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest())
            if len(out) == 4:
                rec["oks"].append(out[2].cpu().tolist())
            if at:
                rec["snap"] = {"before": snap_before, "after": mb_state(model, optimizer)}
            if before is not None:
                rec["first"] = {"params": before, "batch": batches[0],
                                "grads": {k: p.grad.detach().cpu().clone()
                                          for k, p in model.named_parameters()}}
            return out

        return step

    dp_mod.make_dp_superstep_fn = recorded
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    t0 = time.perf_counter()
    try:
        out = port.run_training(config, datasets=sets, device="cuda:0")
    finally:
        dp_mod.make_dp_superstep_fn = plain
    torch.cuda.synchronize()
    rec.update(k1=edge_pipeline_planned.launches, k2=edge_pipeline_bwd_planned.launches,
               seconds=time.perf_counter() - t0)
    return out, rec


def mb_drill_config(name, epochs=2, **training):
    config = multibranch_config(epochs)
    config["Dataset"]["name"] = name
    config["NeuralNetwork"]["Training"].update(training)
    return config


MB_DURABLE = {"Guard": {"enabled": True}, "Checkpoint": {"enabled": True, "interval_steps": 2}}


def multibranch_rank(rank, work, mode="run"):
    """One rank of [multibranch] (``chip_smoke.py --multibranch-rank R
    DIR [resume]``): a gloo group of three through a FileStore in DIR,
    every rank on cuda:0. ``run``: run_training under ``scheme:
    "multibranch"`` (``mb_training``: every step's digest, the first
    step's sub-batch, parameters and gradients, K1/K2 against forwards
    and train steps); run_prediction; ten more steps timed with CUDA
    events, unguarded and guarded; then the guard: the same run with
    ``Guard`` on and resume containers every 2 steps (``guard``), and a
    guarded epoch whose step ``MB_POISON_STEP`` has NaN labels on branch
    1's rank (``poison``: the state before and after it, the telemetry
    ``health`` row); writes DIR/rank<R>.pt; then the guarded run again
    with ``kill:train_step:MB_KILL`` armed, which ends the process by
    SIGKILL mid-epoch. ``resume``: ``continue`` of the killed run,
    written to DIR/resume<R>.pt."""
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.parallel import dp as dp_mod
    from hydragnn_tpu_torch.parallel.multibranch import (
        decoder_branch_of_name,
        decoder_grad_scales,
        guard_slots,
    )
    from hydragnn_tpu_torch.utils import faults
    from hydragnn_tpu_torch.utils.telemetry import shard_path

    store_dir = os.path.join(work, "store" if mode == "run" else "store_resume")
    dist.init_process_group("gloo", store=dist.FileStore(store_dir, MB_RANKS),
                            rank=rank, world_size=MB_RANKS)
    sets = multibranch_sets()
    drill = os.path.join(work, "drill")
    os.makedirs(drill, exist_ok=True)
    os.chdir(drill)
    if mode == "resume":
        (state, model, _, hist, _), rec = mb_training(
            rank, mb_drill_config("multibranch_drill", **MB_DURABLE, **{"continue": 1}), sets)
        run = [d for d in os.listdir("logs") if d.startswith("multibranch_drill")][0]
        manifest = torch.load(os.path.join("logs", run, "resume.pt"),
                              weights_only=True)["manifest"]
        torch.save({"rank": rank, "digests": rec["digests"], "k1": rec["k1"], "k2": rec["k2"],
                    "forwards": rec["forwards"], "train_steps": rec["train_steps"],
                    "hist": (hist.train_loss, hist.val_loss, hist.test_loss),
                    "steps": state.step, "seconds": rec["seconds"],
                    "params": {k: v.cpu() for k, v in model.state_dict().items()}},
                   os.path.join(work, f"resume{rank}.pt"))
        dist.destroy_process_group()
        return
    config = multibranch_config()
    config["NeuralNetwork"]["Training"]["Telemetry"] = {
        "enabled": True, "stream_path": os.path.join(work, "telemetry.jsonl"),
        "heartbeat_interval_s": 1.0}
    (state, model, cfg, hist, full), rec = mb_training(rank, config, sets, first=True)
    k1, k2, train_s = rec["k1"], rec["k2"], rec["seconds"]
    edge_pipeline_planned.launches = 0
    err, _, trues, preds = port.run_prediction(full, datasets=sets, state=state, model=model,
                                               cfg=cfg)
    torch.cuda.synchronize()
    k1_pred = edge_pipeline_planned.launches
    pred_rows = sum(len(t[0]) for t in trues)
    # ten more multibranch steps on the first batch, every rank in step,
    # unguarded and then guarded (the per-slot predicate and select)
    scales = decoder_grad_scales(model, cfg, 3, (1, 1, 1))
    plan = runtime_plan(full)
    batch = rec["first"]["batch"]
    step_ms = {}
    for guard in (False, True):
        fn = dp_mod.make_dp_superstep_fn(
            model, state.optimizer, cfg, plan, train=True, kind="multibranch",
            decoder_scales=scales, device=torch.device("cuda:0"), guard=guard,
            slots=guard_slots(model, cfg, 3) if guard else None)
        fn(state, None, [batch])
        torch.cuda.synchronize()
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(state, None, [batch])
        end.record()
        torch.cuda.synchronize()
        step_ms["guard" if guard else "plain"] = start.elapsed_time(end) / 10
    # the guard: the same run guarded (bit for bit), then a poisoned epoch
    (g_state, _, _, g_hist, _), g_rec = mb_training(
        rank, mb_drill_config("multibranch_guard", **MB_DURABLE), sets, snap_at=MB_POISON_STEP)
    os.makedirs(os.path.join(work, "poison"), exist_ok=True)
    tel = os.path.join(work, "poison", "telemetry.jsonl")
    (_, p_model, _, p_hist, _), p_rec = mb_training(
        rank, mb_drill_config("multibranch_poison", epochs=1, Guard={"enabled": True},
                              Telemetry={"enabled": True, "stream_path": tel}),
        sets, snap_at=MB_POISON_STEP, poison_rank=1)
    with open(shard_path(tel, rank)) as f:
        health = [r for r in map(json.loads, f) if r.get("t") == "health"]
    clean, bad = g_rec["snap"], p_rec["snap"]
    params = {n for n, _ in p_model.named_parameters()}

    def branch_of(k):
        """A state tensor's decoder branch (None: the encoder's slot)."""
        kind, rest = k.split("/", 1)
        name = rest.rsplit("/", 1)[0] if kind == "opt" else rest
        return decoder_branch_of_name(name, cfg) if name in params else None

    held, moved = [], 0
    for k, before in bad["before"].items():
        b = branch_of(k)
        after = bad["after"][k]
        if b in (0, 2):
            if not torch.equal(after, clean["after"][k]):
                held.append(f"{k} (branch {b}) != the clean step's")
            moved += not torch.equal(after, before)
        elif not torch.equal(after, before):
            held.append(f"{k} ({'encoder' if b is None else 'branch 1'}) moved")
    torch.save({"rank": rank, "digests": rec["digests"], "first": rec["first"],
                "train_steps": rec["train_steps"], "forwards": rec["forwards"], "k1": k1,
                "k2": k2, "k1_pred": k1_pred, "pred_rows": pred_rows,
                "pred_samples": [len(b[2]) for b in sets], "err": float(err),
                "hist": (hist.train_loss, hist.val_loss, hist.test_loss), "seconds": train_s,
                "step_ms": step_ms["plain"], "guard_step_ms": step_ms["guard"],
                "eager": state.eager_reason, "slot": plan.mesh.slot(), "config": full,
                "mem": torch.cuda.max_memory_allocated(),
                "guard": {"digests": g_rec["digests"], "oks": g_rec["oks"], "k1": g_rec["k1"],
                          "k2": g_rec["k2"], "forwards": g_rec["forwards"],
                          "train_steps": g_rec["train_steps"], "seconds": g_rec["seconds"],
                          "hist": (g_hist.train_loss, g_hist.val_loss, g_hist.test_loss),
                          "steps": g_state.step,
                          "params": {k: v.cpu() for k, v in g_state.model.state_dict().items()}},
                "poison": {"oks": p_rec["oks"], "held": held, "moved": moved,
                           "n_tensors": len(bad["before"]), "health": health,
                           "k1": p_rec["k1"], "k2": p_rec["k2"], "forwards": p_rec["forwards"],
                           "train_steps": p_rec["train_steps"], "seconds": p_rec["seconds"],
                           "train_loss": p_hist.train_loss,
                           "finite": bool(all(np.isfinite(p_hist.train_loss)) and all(
                               bool(torch.isfinite(v).all()) for v in
                               p_model.state_dict().values()))}},
               os.path.join(work, f"rank{rank}.pt"))
    # the preemption: the guarded run again, killed mid-epoch by SIGKILL
    dist.barrier()
    faults.install(f"kill:train_step:{MB_KILL}")
    mb_training(rank, mb_drill_config("multibranch_drill", **MB_DURABLE), sets)
    raise SystemExit(f"rank {rank}: kill:train_step:{MB_KILL} did not end the process")


def runtime_plan(full):
    import dataclasses

    from hydragnn_tpu_torch.parallel import runtime

    return dataclasses.replace(runtime.plan_from_config(full), devices_per_branch=(1, 1, 1))


def phase_multibranch():
    """[multibranch] examples/multibranch/train.py's configuration
    (``multibranch_config``, ``multibranch_sets``) through run_training on
    three ranks sharing the one card: three processes of this script
    (``multibranch_rank``), each on cuda:0, in a gloo group (NCCL refuses
    two ranks on one device). Checks: the split [1, 1, 1]; after every
    step the three ranks' parameters equal bit for bit; rank 0's first
    step's gradients within the f32 gradient tolerance of a one-process
    reference on the card (the equal mean of the three sub-batches'
    losses, then the D / D_b rescale); K1 = 3 x forwards and K2 = 3 x
    train steps on every rank; every rank's history equal; each rank's
    step time, unguarded and guarded. Then the guard and resume
    (``multibranch_drills``). A failing rank fails the phase."""
    import shutil
    import signal
    import tempfile

    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.parallel.multibranch import proportional_branch_split
    from hydragnn_tpu_torch.train.losses import multihead_loss

    split = proportional_branch_split([int(0.8 * n) for n in MB_SIZES], MB_RANKS)
    check(split == [1, 1, 1], f"proportional_branch_split gives {split}")
    log(f"[multibranch] examples/multibranch/train.py's SchNet (hidden 32, 3 layers, radius "
        f"2.5, 16 Gaussians, 32 filters; one graph head on branches branch-0..2; batch 8, "
        f"AdamW 2e-3), 2 epochs f32 on {MB_SIZES} molecules (seeds 0, 1, 2) split 0.8; "
        f"{MB_RANKS} ranks on cuda:0 in a gloo group (NCCL refuses two ranks on one "
        f"device); devices per branch {split}")
    log_feed("multibranch", multibranch_config())
    work = tempfile.mkdtemp(prefix="multibranch_")
    t0 = time.perf_counter()
    rcs, logs = mb_spawn(work)
    wall = time.perf_counter() - t0
    for r, (rc, text) in enumerate(zip(rcs, logs)):
        # each rank ends in the preemption drill, killed by SIGKILL
        check(rc == -signal.SIGKILL and os.path.exists(os.path.join(work, f"rank{r}.pt")),
              f"multibranch rank {r} exited {rc}, want {-signal.SIGKILL} after its "
              f"results:\n{text[-3000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(MB_RANKS)]
    drills = multibranch_drills(work, ranks)
    res = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools", "graftboard.py"), "fleet", work, "--json"],
        capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"graftboard fleet exited {res.returncode}: {res.stderr}")
    fleet = json.loads(res.stdout)
    check(fleet["present"] == list(range(MB_RANKS)) and not fleet["missing"]
          and sorted(fleet["processes"]) == [str(r) for r in range(MB_RANKS)]
          and all(p["clean_exit"] for p in fleet["processes"].values())
          and not fleet["heartbeats"]["dead"],
          f"graftboard fleet on the three shards: present {fleet['present']}, missing "
          f"{fleet['missing']}, warnings {fleet['warnings']}")
    log(f"[multibranch] telemetry on every rank: graftboard fleet exits 0 and names "
        f"processes {sorted(fleet['processes'])} (rows "
        f"{[fleet['processes'][str(r)]['rows'] for r in range(MB_RANKS)]}, clean exits, no "
        f"dead process; barrier sites {sorted(fleet['barrier_sites'])}); warnings "
        f"{fleet['warnings']}")
    steps = ranks[0]["train_steps"]
    check(steps > 0 and all(r["train_steps"] == steps for r in ranks),
          f"train steps per rank {[r['train_steps'] for r in ranks]}")
    check(all(r["digests"] == ranks[0]["digests"] for r in ranks),
          "the ranks' parameters differ after some step")
    check(all(r["hist"] == ranks[0]["hist"] for r in ranks), "the ranks' histories differ")
    for r in ranks:
        want_k1 = 3 * (r["forwards"])
        check(r["k1"] == want_k1 and r["k2"] == 3 * r["train_steps"],
              f"rank {r['rank']}: K1 {r['k1']}, K2 {r['k2']} for {r['forwards']} "
              f"dispatches and {r['train_steps']} train steps")
        check(r["k1_pred"] > 0 and r["pred_rows"] == sum(r["pred_samples"]),
              f"rank {r['rank']}: run_prediction returned {r['pred_rows']} rows")
        check(r["eager"] and "gloo" in r["eager"], f"rank {r['rank']}: eager {r['eager']}")
    # the one-process reference of rank 0's first step, on the card
    model, cfg = create_model_config(ranks[0]["config"], "cuda", seed=0)
    model.load_state_dict(ranks[0]["first"]["params"])
    model.train()
    total = None
    for r in ranks:
        b = r["first"]["batch"].to("cuda")
        tot, _ = multihead_loss(model(b), b, cfg)
        total = tot / MB_RANKS if total is None else total + tot / MB_RANKS
    total.backward()
    # D / D_b = 3 / 1 on every module of a branch's decoder, found here
    # from the config's branch names, apart from the port's own matcher
    heads = ranks[0]["config"]["NeuralNetwork"]["Architecture"]["output_heads"]["graph"]
    branches = [h["type"] for h in heads]

    def in_branch_decoder(name):
        keys = name.split(".")
        return keys[0].startswith("decoder") and any(
            k == f"graph_shared_{b}" or (k.startswith("head") and k.endswith(f"_{b}"))
            for k in keys[1:] for b in branches)

    scales = {p: float(MB_RANKS) for name, p in model.named_parameters()
              if in_branch_decoder(name)}
    check(len(scales) > 0 and len(scales) % len(branches) == 0,
          f"{len(scales)} decoder tensors over branches {branches}")
    got = ranks[0]["first"]["grads"]
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    worst = 0.0
    for name, p in model.named_parameters():
        ref = (p.grad * scales.get(p, 1.0)).cpu()
        gap = float((got[name] - ref).abs().max())
        worst = max(worst, gap / top)
        check(torch.allclose(got[name], ref, rtol=VJP_TOL["rtol"],
                             atol=VJP_TOL["atol"] * min(top, 1.0)),
              f"rank 0's first-step gradient {name} off the one-process reference by {gap:.3g}")
    n_dec = len(scales)
    log(f"[multibranch] {MB_RANKS} ranks ran {steps} train steps each ({wall:.1f} s for the "
        f"three processes, run_training {[round(r['seconds'], 2) for r in ranks]} s); the "
        f"ranks' parameters equal bit for bit after every step ({len(ranks[0]['digests'])} "
        f"digests); histories equal: train {ranks[0]['hist'][0]}")
    log(f"[multibranch] rank 0's first step against the one-process reference on the card "
        f"(the mean of the three sub-batches' losses, {n_dec} decoder tensors x 3 / 1): "
        f"gradients within {worst:.3g} of the largest ({top:.3g})")
    log(f"[multibranch] K1 launches {[r['k1'] for r in ranks]} = 3 x "
        f"{[r['forwards'] for r in ranks]} forwards, K2 {[r['k2'] for r in ranks]} = 3 x "
        f"{steps} train steps; steps eager ({ranks[0]['eager']}); step time per rank "
        f"{[round(r['step_ms'], 3) for r in ranks]} ms unguarded, "
        f"{[round(r['guard_step_ms'], 3) for r in ranks]} ms guarded (10 steps each, CUDA "
        f"events, the guard eager as the step); peak memory per rank "
        f"{[round(r['mem'] / 2**20, 1) for r in ranks]} MiB; run_prediction error "
        f"{ranks[0]['err']:.6g}")
    shutil.rmtree(work, ignore_errors=True)
    return {"k1": sum(r["k1"] + r["k1_pred"] for r in ranks) + drills["k1"],
            "k2": sum(r["k2"] for r in ranks) + drills["k2"], "steps": steps,
            "step_ms": [r["step_ms"] for r in ranks],
            "guard_step_ms": [r["guard_step_ms"] for r in ranks], "first_step_gap": worst,
            "seconds": [r["seconds"] for r in ranks], "wall_seconds": wall,
            "train_loss": ranks[0]["hist"][0], "drills": drills}


def mb_spawn(work, *extra):
    """The three ranks of ``multibranch_rank`` as processes of this
    script; returns their return codes and output."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multibranch-rank",
                               str(r), work, *extra], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(MB_RANKS)]
    try:
        logs = [p.communicate(timeout=420)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], logs


def multibranch_drills(work, ranks):
    """[multibranch]'s guard and preemption, from what the ranks wrote:
    the guarded run equals the unguarded one bit for bit on every rank
    (every step's digest, the history; every slot's predicate true);
    the epoch whose step MB_POISON_STEP had NaN labels on branch 1's rank
    read [branch-0 ok, branch-1 bad, branch-2 ok, encoder bad] there,
    left branch 1's decoder and the encoder as before the step and
    branches 0 and 2 as the clean step left them, bit for bit, with
    ``window_bad_by_branch`` {"branch-1": 1, "encoder": 1} in the epoch's
    ``health`` row; the killed drill's newest container is mid-epoch with
    per-branch cursors [s, s, s]; and three ``continue`` processes end
    equal to the guarded run bit for bit. K1 = 3 x forwards, K2 = 3 x
    train steps in every run."""
    drill = os.path.join(work, "drill", "logs")
    runs = [d for d in os.listdir(drill) if d.startswith("multibranch_drill")]
    check(len(runs) == 1, f"[multibranch] drill runs {runs}")
    manifest = torch.load(os.path.join(drill, runs[0], "resume.pt"),
                          weights_only=True)["manifest"]
    s = manifest["step"]
    check(manifest["epoch"] == 1 and s in (2, 4) and manifest["branch_steps"] == [s] * MB_RANKS,
          f"[multibranch] the killed drill's container: epoch {manifest['epoch']}, step {s}, "
          f"branch_steps {manifest['branch_steps']}")
    t0 = time.perf_counter()
    rcs, logs = mb_spawn(work, "resume")
    resume_s = time.perf_counter() - t0
    for r, (rc, text) in enumerate(zip(rcs, logs)):
        check(rc == 0, f"multibranch continue rank {r} exited {rc}:\n{text[-3000:]}")
    resumed = [torch.load(os.path.join(work, f"resume{r}.pt"), weights_only=False)
               for r in range(MB_RANKS)]
    k1 = k2 = 0
    for r, res in zip(ranks, resumed):
        g, p = r["guard"], r["poison"]
        check(g["digests"] == r["digests"] and g["hist"] == r["hist"],
              f"rank {r['rank']}: the guarded run differs from the unguarded one")
        check(g["oks"] == [[[True] * (MB_RANKS + 1)]] * g["train_steps"],
              f"rank {r['rank']}: guarded predicates {g['oks']}")
        bad = [[[True, False, True, False]]]
        check(p["oks"] == [[[True] * (MB_RANKS + 1)]] * MB_POISON_STEP + bad + [
            [[True] * (MB_RANKS + 1)]] * (p["train_steps"] - MB_POISON_STEP - 1),
            f"rank {r['rank']}: poisoned epoch's predicates {p['oks']}")
        check(not p["held"] and p["moved"] > 0 and p["finite"],
              f"rank {r['rank']}: containment {p['held'][:6]}, {p['moved']} branch-0/2 "
              f"tensors moved, finite {p['finite']}")
        rows = [h.get("window_bad_by_branch") for h in p["health"]]
        check(rows[-1:] == [{"branch-1": 1, "encoder": 1}],
              f"rank {r['rank']}: health rows' window_bad_by_branch {rows}")
        check(res["hist"] == g["hist"] and res["steps"] == g["steps"]
              and res["digests"] == g["digests"][-len(res["digests"]):] and all(
                  torch.equal(v, g["params"][k]) for k, v in res["params"].items()),
              f"rank {r['rank']}: the continued run differs from the uninterrupted one")
        for tag, run in (("guard", g), ("poison", p), ("continue", res)):
            check(run["k1"] == 3 * run["forwards"] and run["k2"] == 3 * run["train_steps"],
                  f"rank {r['rank']} {tag}: K1 {run['k1']}, K2 {run['k2']} for "
                  f"{run['forwards']} forwards, {run['train_steps']} train steps")
            k1, k2 = k1 + run["k1"], k2 + run["k2"]
    g0, p0 = ranks[0]["guard"], ranks[0]["poison"]
    log(f"[multibranch] Guard on with resume containers every 2 steps: every rank's "
        f"{g0['train_steps']} step digests and history equal the unguarded run's bit for bit, "
        f"every slot true (run_training {[round(r['guard']['seconds'], 2) for r in ranks]} s); "
        f"K1 {[r['guard']['k1'] for r in ranks]} = 3 x {g0['forwards']} forwards, K2 "
        f"{[r['guard']['k2'] for r in ranks]} = 3 x {g0['train_steps']} train steps")
    log(f"[multibranch] NaN labels on branch 1's rank at step {MB_POISON_STEP} (the dual "
        f"optimizer, no clip): predicates {p0['oks'][MB_POISON_STEP]} "
        f"(branch-0, branch-1, branch-2, encoder) on every rank; of the state's "
        f"{p0['n_tensors']} tensors, branch 1's decoder's and the encoder's as before the "
        f"step and branches 0's and 2's as the clean step left them ({p0['moved']} of these "
        f"moved), bit for bit; "
        f"the epoch's health row: window_bad_by_branch "
        f"{p0['health'][-1]['window_bad_by_branch']}; train loss {p0['train_loss']}")
    log(f"[multibranch] preemption: the guarded run with kill:train_step:{MB_KILL} died by "
        f"SIGKILL on every rank; newest container (epoch {manifest['epoch']}, step {s}, "
        f"branch_steps {manifest['branch_steps']}); three continue processes ({resume_s:.1f} "
        f"s) end equal to the uninterrupted guarded run bit for bit (history, "
        f"{len(resumed[0]['digests'])} step digests, every model tensor); K1 "
        f"{[x['k1'] for x in resumed]}, K2 {[x['k2'] for x in resumed]}")
    return {"k1": k1, "k2": k2, "cursor": [manifest["epoch"], s],
            "branch_steps": manifest["branch_steps"], "resume_seconds": resume_s,
            "poison_oks": p0["oks"][MB_POISON_STEP],
            "window_bad_by_branch": p0["health"][-1]["window_bad_by_branch"]}


# ----------------------------------------------------------------------
# Graph sharding (ROADMAP item 11b)
# ----------------------------------------------------------------------

GS_RANKS = 4  # one spawn: D = 4 over every rank, then D = 2 over ranks {0, 1}
GS_EPOCHS = 3
GS_BIG = (8000, 4)  # atoms (a 20^3 grid) and configurations of [graphshard]'s large structure
GS_STEPS = 3
GS_CLI = ("--ranks", "2", "--epochs", "2", "--halo")  # the driver's defaults otherwise
GS_SCHEMES = ("gather", "halo")
GS_E_RTOL = 2e-5  # tests/test_graphshard.py:151 (energy through ring attention)
GS_GRAD_TOL = dict(rtol=1e-3, atol=2e-5)  # tests/test_graphshard.py:174 (gradients through it)
GS_NOISE = 1e-4  # a zero gradient's rounding noise, relative to the largest


def gs_args(atoms=512, configs=24):
    """examples/giant_graph/giant.py's defaults, the driver's: hidden 32,
    2 attention heads, cutoff 3.2 (2 layers, 16 Gaussians)."""
    import argparse

    return argparse.Namespace(atoms=atoms, configs=configs, hidden=32, attn_heads=2,
                              cutoff=3.2)


def gs_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gs_digest(params):
    import hashlib

    from hydragnn_tpu_torch.parallel.graphshard import param_leaves

    h = hashlib.sha256()
    for t in param_leaves(params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gs_forward(scheme):
    from hydragnn_tpu_torch.drivers import giant_graph as gg

    return gg.forward_for(scheme == "halo")


def gs_first(scheme, params, shards, mesh, kw):
    """The energy, this rank's rows of -dE/dpos and the summed parameter
    gradients at ``params`` (cleared after)."""
    import dataclasses

    from hydragnn_tpu_torch.parallel import graphshard as gs

    pos = shards.pos.clone().requires_grad_()
    e = gs_forward(scheme)(params, dataclasses.replace(shards, pos=pos), mesh, **kw)
    e.backward()
    gs.sum_gradients_(params, mesh)
    out = {"e": float(e), "forces": -pos.grad.cpu().numpy(),
           "grads": {k: t.grad.cpu().numpy().copy() for k, t in gs.param_items(params)}}
    for t in gs.param_leaves(params):
        t.grad = None
    return out


def gs_data(args):
    import numpy as np

    from hydragnn_tpu_torch.drivers import giant_graph as gg

    configs, edge_cap = gg.build_configs(args.atoms, args.configs, args.cutoff, seed=0)
    energies = np.array([c[2] for c in configs], np.float32)
    return configs, edge_cap, float(energies.mean()), float(energies.std() + 1e-6)


def gs_training(mesh, dev, args):
    """[graphshard] (1) on this rank: the driver's configuration trained
    GS_EPOCHS epochs per scheme with the driver's step; the first step's
    energy, forces and gradients; every step's loss, energy and parameter
    digest; in the all-gather run's epoch 0 the halo forward's energy of
    each configuration at the same parameters."""
    from hydragnn_tpu_torch.drivers import giant_graph as gg
    from hydragnn_tpu_torch.parallel import graphshard as gs

    configs, edge_cap, e_mean, e_std = gs_data(args)
    kw = gg.model_kwargs(args)
    hosts = {s: gg.shard_configs(configs, edge_cap, mesh.size, halo=s == "halo")
             for s in GS_SCHEMES}
    locs = {s: [h.local(mesh, dev) for h in hosts[s]] for s in GS_SCHEMES}
    n_train = int(0.8 * len(configs))
    runs = {}
    for scheme in GS_SCHEMES:
        fwd = gs_forward(scheme)
        params = gg.make_params(args, dev)
        opt = gg.make_optimizer(params)
        rec = {"first": gs_first(scheme, params, locs[scheme][0], mesh, kw), "losses": [],
               "digests": [], "epochs": [], "twin": []}
        gs_sync(dev)
        t0 = time.perf_counter()
        for epoch in range(GS_EPOCHS):
            tot = 0.0
            for i in range(n_train):
                if scheme == "gather" and epoch == 0:
                    with torch.no_grad():
                        e_halo = float(gs.halo_mpnn_forward(params, locs["halo"][i], mesh, **kw))
                loss, e = gg.train_step(fwd, params, opt, locs[scheme][i], mesh, configs[i][2],
                                        e_mean, e_std, **kw)
                if scheme == "gather" and epoch == 0:
                    rec["twin"].append((float(e), e_halo))
                rec["losses"].append(float(loss))
                rec["digests"].append(gs_digest(params))
                tot += float(loss)
            val = 0.0
            with torch.no_grad():
                for i in range(n_train, len(configs)):
                    e = fwd(params, locs[scheme][i], mesh, **kw)
                    if scheme == "gather" and epoch == 0:
                        rec["twin"].append((float(e), float(gs.halo_mpnn_forward(
                            params, locs["halo"][i], mesh, **kw))))
                    val += float(gg.standardized_loss(e, configs[i][2], e_mean, e_std))
            rec["epochs"].append((tot / n_train, val / (len(configs) - n_train)))
        gs_sync(dev)
        rec["seconds"] = time.perf_counter() - t0
        order = (gg.z_sorted(*configs[0][:2]) if scheme == "halo" else configs[0][:2])
        rec["inputs"] = order
        runs[scheme] = rec
    return runs


def gs_large(mesh, dev):
    """[graphshard] (3) on this rank: GS_BIG's structure, GS_STEPS train
    steps per scheme: each step's wall ms (the device synchronized) and
    its collectives' calls and seconds by kind, this rank's peak memory
    (reset per scheme), the halo rows against N_pad."""
    from hydragnn_tpu_torch.drivers import giant_graph as gg

    args = gs_args(*GS_BIG)
    configs, edge_cap, e_mean, e_std = gs_data(args)
    kw = gg.model_kwargs(args)
    out = {"edges": [int(c[1].shape[1]) for c in configs]}
    for scheme in GS_SCHEMES:
        host = gg.shard_configs(configs, edge_cap, mesh.size, halo=scheme == "halo")
        locs = [h.local(mesh, dev) for h in host[:GS_STEPS]]
        params = gg.make_params(args, dev)
        opt = gg.make_optimizer(params)
        gs_sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        step_ms, losses, stats = [], [], []
        for i, loc in enumerate(locs):
            mesh.stats.clear()
            gs_sync(dev)
            t0 = time.perf_counter()
            loss, _ = gg.train_step(gs_forward(scheme), params, opt, loc, mesh, configs[i][2],
                                    e_mean, e_std, **kw)
            gs_sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            stats.append({k: list(v) for k, v in mesh.stats.items()})
        out[scheme] = {
            "step_ms": step_ms, "losses": losses, "stats": stats,
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if dev.type == "cuda" else None),
            "n_pad": host[0].num_nodes_padded,
            "rows": host[0].halo_rows if scheme == "halo" else host[0].num_nodes_padded,
            "layout": host[0].layout if scheme == "halo" else None}
    return out


def graphshard_rank(rank, world, work):
    """One rank of [graphshard] (``chip_smoke.py --graphshard-rank R D
    DIR``): on cuda:0 in a gloo group through a FileStore in DIR (NCCL
    refuses two ranks on one device). (2) on a graph axis over all D
    ranks, then (1) and (3) over ranks {0, 1}; K1/K2 counted from 0.
    Writes ``rank<R>.pt`` into DIR."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.distributed as dist

    from hydragnn_tpu_torch.drivers import giant_graph as gg
    from hydragnn_tpu_torch.ops import edge_pipeline as ep
    from hydragnn_tpu_torch.parallel import graphshard as gs
    from hydragnn_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    mesh_all = make_mesh({"graph": world})
    mesh2 = make_mesh({"graph": 2}, ranks=[0, 1])
    ep.edge_pipeline_planned.launches = 0
    ep.edge_pipeline_bwd_planned.launches = 0
    args = gs_args()
    configs, _, _, _ = gs_data(gs_args(configs=1))
    pos, ei = gg.z_sorted(*configs[0][:2])
    x0 = np.ones((args.atoms, 1), np.float32)
    out = {"rank": rank, "wide": {"inputs": (pos, ei)}}
    for scheme in GS_SCHEMES:
        build = gs.HaloShards.build if scheme == "halo" else gs.GraphShards.build
        host = build(x0, pos, ei, world)
        out["wide"][scheme] = gs_first(scheme, gg.make_params(args, dev),
                                       host.local(mesh_all, dev), mesh_all,
                                       gg.model_kwargs(args))
        if scheme == "halo":
            out["wide"]["layout"] = (host.hops, host.caps, host.halo_rows,
                                     host.num_nodes_padded)
    if mesh2.index >= 0:
        out["train"] = gs_training(mesh2, dev, args)
        out["large"] = gs_large(mesh2, dev)
        out["transport"] = {op: gs.transport(mesh2, op, dev)
                            for op in ("all_gather", "reduce_scatter", "ppermute", "all_reduce")}
    out["k1"] = ep.edge_pipeline_planned.launches
    out["k2"] = ep.edge_pipeline_bwd_planned.launches
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def gs_gap(got, want, rtol, atol):
    """The worst |got - want| over its allowance atol + rtol |want| (held
    when <= 1)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def gs_hold(tag, outs, inputs, args):
    """The ranks' energy, forces (their rows in axis order) and summed
    gradients against ``reference_mpnn_forward`` in this one process, on
    the card and on the CPU plain path (``GS_E_RTOL``, ``GS_GRAD_TOL``;
    the attention key biases, whose true gradient is 0, within
    ``GS_NOISE`` of the largest gradient). Returns the worst gap per
    device."""
    import numpy as np

    from hydragnn_tpu_torch.drivers import giant_graph as gg
    from hydragnn_tpu_torch.parallel import graphshard as gs

    pos, ei = inputs
    host = gs.GraphShards.build(np.ones((pos.shape[0], 1), np.float32), pos, ei, 1)
    forces = np.concatenate([o["forces"] for o in outs])[: pos.shape[0]]
    for o in outs[1:]:
        check(o["e"] == outs[0]["e"] and all(np.array_equal(o["grads"][k], g)
                                              for k, g in outs[0]["grads"].items()),
              f"{tag}: the ranks' energies or summed gradients differ")
    gaps = {}
    for device in ("cuda", "cpu"):
        params = gg.make_params(args, device)
        ref_pos = torch.tensor(host.pos, device=device, requires_grad=True)
        e = gs.reference_mpnn_forward(
            params, torch.as_tensor(host.x, device=device), ref_pos,
            torch.as_tensor(host.node_mask, device=device),
            torch.as_tensor(host.senders.astype(np.int64), device=device),
            torch.as_tensor(host.receivers.astype(np.int64), device=device),
            torch.as_tensor(host.edge_mask, device=device), **gg.model_kwargs(args))
        e.backward()
        ref = {k: t.grad.cpu().numpy() for k, t in gs.param_items(params)}
        top = max(float(np.abs(g).max()) for g in ref.values())
        gap = {"e": gs_gap(outs[0]["e"], float(e.detach()), GS_E_RTOL, 0.0),
               "forces": gs_gap(forces, -ref_pos.grad.cpu().numpy(), **GS_GRAD_TOL),
               "grads": max(gs_gap(g, ref[k], **GS_GRAD_TOL)
                            for k, g in outs[0]["grads"].items() if "/k/b" not in k),
               "key_bias_noise": max(float(np.abs(g).max()) / top
                                     for k, g in outs[0]["grads"].items() if "/k/b" in k)}
        check(max(gap["e"], gap["forces"], gap["grads"]) <= 1.0
              and gap["key_bias_noise"] <= GS_NOISE,
              f"{tag}: against the one-process reference on {device}: {gap}")
        gaps[device] = gap
    return gaps


def phase_graphshard():
    """[graphshard] graph-dimension sharding through the driver's
    pieces (``drivers/giant_graph``) on GS_RANKS processes of this script
    on cuda:0 in a gloo group: (2) D = GS_RANKS, one value_and_grad per
    scheme on the z-sorted 512-atom structure; (1) D = 2, the driver's
    configuration (512 atoms, 24 configurations, hidden 32, 2 layers, 16
    Gaussians, 2 heads, cutoff 3.2, Adam 3e-3) GS_EPOCHS epochs per scheme;
    (3) D = 2, GS_BIG's structure, GS_STEPS train steps per scheme. Checks:
    every rank exits 0; finite losses; the ranks' parameters equal bit for
    bit after every step; first steps and (2) within tolerance of the
    one-process reference on the card and on the CPU plain path; in epoch
    0 the halo energy of every configuration equal to the all-gather one
    (rtol GS_E_RTOL); no K1/K2 launch (the JAX package's graphshard path
    reaches no Pallas kernel)."""
    import shutil
    import statistics
    import tempfile

    import numpy as np

    work = tempfile.mkdtemp(prefix="graphshard_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--graphshard-rank",
                               str(r), str(GS_RANKS), work], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(GS_RANKS)]
    try:
        logs = [p.communicate(timeout=400)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"graphshard rank {r} exited {p.returncode}:\n{text[-3000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(GS_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    card = card_line()
    k1, k2 = sum(r["k1"] for r in ranks), sum(r["k2"] for r in ranks)
    check(k1 == 0 and k2 == 0, f"[graphshard] K1 {k1} / K2 {k2} launches, want none")
    args = gs_args()
    log(f"[graphshard] {GS_RANKS} processes on cuda:0 in a gloo group ({wall:.1f} s; NCCL "
        f"refuses two ranks on one device), steps eager (gloo's collectives cannot be "
        f"captured); transport per collective {ranks[0]['transport']} (gloo's send/receive "
        f"take no CUDA tensor); K1 {k1}, K2 {k2}; {card}")

    wide = [r["wide"] for r in ranks]
    hops, caps, rows, n_pad = wide[0]["layout"]
    wide_gaps = {s: gs_hold(f"[graphshard] D = {GS_RANKS} {s}", [w[s] for w in wide],
                            wide[0]["inputs"], args) for s in GS_SCHEMES}
    log(f"[graphshard] D = {GS_RANKS} on the z-sorted {args.atoms}-atom structure: halo hops "
        f"{list(hops)}, caps {list(caps)}, {rows} rows of N_pad {n_pad}; energy, forces and "
        f"summed gradients within tolerance of the one-process reference (worst gap over "
        f"its allowance, card / CPU): " + "; ".join(
            f"{s} e {g['cuda']['e']:.3g}/{g['cpu']['e']:.3g}, forces "
            f"{g['cuda']['forces']:.3g}/{g['cpu']['forces']:.3g}, grads "
            f"{g['cuda']['grads']:.3g}/{g['cpu']['grads']:.3g}" for s, g in wide_gaps.items()))

    train = [r["train"] for r in ranks[:2]]
    first_gaps = {}
    for s in GS_SCHEMES:
        a, b = train[0][s], train[1][s]
        check(all(np.isfinite(a["losses"])), f"[graphshard] {s}: a loss is not finite")
        check(a["digests"] == b["digests"] and a["losses"] == b["losses"],
              f"[graphshard] {s}: the ranks' parameters differ after some step")
        first_gaps[s] = gs_hold(f"[graphshard] D = 2 {s} first step",
                                [a["first"], b["first"]], a["inputs"], args)
        for epoch, (tr, va) in enumerate(a["epochs"]):
            log(f"[graphshard] {s} epoch {epoch:3d} | train {tr:.5f} | val {va:.5f}")
    twin = train[0]["gather"]["twin"]
    twin_gap = max(abs(g - h) / abs(g) for g, h in twin)
    check(len(twin) == args.configs and twin_gap <= GS_E_RTOL,
          f"[graphshard] halo against all-gather energies in epoch 0: {twin_gap:.3g}")
    log(f"[graphshard] D = 2, the driver's configuration, {GS_EPOCHS} epochs per scheme "
        f"({[round(t[s]['seconds'], 2) for t in train for s in GS_SCHEMES]} s): finite losses, "
        f"the ranks' parameters equal bit for bit after each of "
        f"{len(train[0]['gather']['digests'])} steps per scheme; the first step within "
        f"tolerance of the one-process reference on the card and the CPU ({first_gaps}); "
        f"the halo energy of all {len(twin)} configurations in epoch 0 within {twin_gap:.3g} "
        f"of the all-gather one (rtol {GS_E_RTOL})")

    # the driver itself, as a user runs it: it starts its two ranks on the card
    t1 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.drivers.giant_graph",
                          *GS_CLI], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t1
    lines = cli.stdout.splitlines()
    check(cli.returncode == 0 and "giant-graph training done" in lines
          and any(torch.cuda.get_device_name(0) in line for line in lines)
          and sum(line.startswith("epoch") for line in lines) == 2,
          f"the giant-graph driver {GS_CLI} exited {cli.returncode}:\n{cli.stdout[-2000:]}\n"
          f"{cli.stderr[-2000:]}")
    for line in lines:
        log(f"[graphshard] driver {' '.join(GS_CLI)} | {line}")
    log(f"[graphshard] the driver's two ranks took {cli_s:.1f} s")

    large = [r["large"] for r in ranks[:2]]
    report = {"wide": {"hops": list(hops), "caps": list(caps), "rows": rows, "n_pad": n_pad},
              "first_gaps": first_gaps, "wide_gaps": wide_gaps, "twin_gap": twin_gap,
              "transport": ranks[0]["transport"], "card": card, "wall_seconds": wall,
              "epochs": {s: train[0][s]["epochs"] for s in GS_SCHEMES}, "large": {},
              "k1": k1, "k2": k2, "driver_seconds": cli_s}
    for s in GS_SCHEMES:
        runs = [big[s] for big in large]
        check(all(np.isfinite(x["losses"]).all() for x in runs) and runs[0]["losses"] == runs[1][
            "losses"], f"[graphshard] {GS_BIG[0]} atoms {s}: losses {[x['losses'] for x in runs]}")
        med = [statistics.median(x["step_ms"]) for x in runs]
        # rank 0's collectives in its median step (the first step also
        # warms the collectives' buffers up)
        mid = sorted(range(GS_STEPS), key=runs[0]["step_ms"].__getitem__)[GS_STEPS // 2]
        per_kind = {k: (v[0], v[1] * 1e3) for k, v in sorted(runs[0]["stats"][mid].items())}
        report["large"][s] = {"median_step_ms": med, "step_ms": [x["step_ms"] for x in runs],
                              "collectives_in_median_step": per_kind,
                              "peak_mib": [x["peak_mib"] for x in runs], "rows": runs[0]["rows"],
                              "n_pad": runs[0]["n_pad"], "layout": runs[0]["layout"]}
        log(f"[graphshard] {GS_BIG[0]} atoms ({GS_BIG[1]} configurations, edges "
            f"{large[0]['edges']}), D = 2, {s}: {GS_STEPS} train steps, median step "
            f"{[round(m, 2) for m in med]} ms per rank (steps {[[round(t, 2) for t in x['step_ms']] for x in runs]}); "
            f"rank 0's collectives in its median step (calls, ms) "
            + ", ".join(f"{k} ({c:g}, {ms:.3f})" for k, (c, ms) in per_kind.items())
            + f"; peak memory {[round(x['peak_mib'], 1) for x in runs]} MiB per rank; "
            f"{runs[0]['rows']} feature rows of N_pad {runs[0]['n_pad']}"
            + (f" (halo layout {runs[0]['layout']})" if s == "halo" else "") + f"; {card}")
    return report


# ----------------------------------------------------------------------
# Durability (ROADMAP item 12): the divergence guard, the
# asynchronous checkpoint writer and continue
# ----------------------------------------------------------------------

GUARD_POISON = (3, 9)  # global steps: 3 in epoch 0's first group, 9 in a replayed K = 4 graph


def guard_same(a, b):
    """Two (model, optimizer) pairs hold the same bits, the optimizer's
    0-d step counts and learning rates included."""
    return same_bits(a, b) and all(
        torch.equal(ga[k], gb[k]) for ga, gb in zip(a[1].param_groups, b[1].param_groups)
        for k in ("step", "lr"))


def guard_run(model0, cfg, training, trainset, *, guard, k=1, spec=None, skip=(), epochs=2):
    """Two epochs of the BCC train split (batch 32, one worst-case shape,
    shuffled with seed 0) from a copy of ``model0`` through a graph cache
    of its own: the train loop's superstep, guarded or not, with the
    ``spec`` fault rules armed while it is built, over supersteps of
    ``k``; with ``skip``, single unguarded steps that never take those
    global steps (their counters still advance). Returns the epochs'
    losses, the (model, optimizer), the monitor and the cache."""
    from hydragnn_tpu_torch.data.loader import GraphLoader, SuperstepLoader
    from hydragnn_tpu_torch.train import guard as guard_mod
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import _fetch_epoch, _run_epoch, make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import faults

    model = copy.deepcopy(model0)
    opt = select_optimizer(model.parameters(), training)
    graphs = StepGraphs("cuda")
    state = TrainState(model, opt, graphs=graphs)
    if spec:
        faults.install(spec)
    try:
        step = make_superstep_fn(model, opt, cfg, device=torch.device("cuda"), graphs=graphs,
                                 guard=guard)
    finally:
        faults.reset()
    monitor = guard_mod.GuardMonitor(guard_mod.guard_settings({"Guard": True})) if guard \
        else None
    losses = []
    for ep in range(epochs):
        base = GraphLoader(trainset, 32, shuffle=True, seed=0, fixed_pad=True)
        base.set_epoch(ep)
        if skip:
            acc = None
            for batch in base:
                if state.step in skip:
                    state.step += 1
                    state.step_t += 1
                    continue
                state, acc = step(state, acc, [batch])
            losses.append(_fetch_epoch(*acc)[0])
            continue
        if monitor is not None:
            monitor.note_epoch(ep)
        state, loss, _ = _run_epoch(step, state, SuperstepLoader(base, k) if k > 1 else base,
                                    train=True, guard=monitor)
        losses.append(loss)
    torch.cuda.synchronize()
    return {"losses": losses, "pair": (model, opt), "monitor": monitor, "graphs": graphs,
            "steps": state.step}


def guard_step_cost(model0, cfg, training, host_batch, iters=20):
    """The replayed train step at bench.py's headline shape with the
    guard off and on (each its own graph cache; CUDA events over
    ``iters`` back-to-back steps from the host batch, in turns off, on,
    off, on), and each graph's pool bytes; K1 and K2 per replayed step."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    paths = {}
    for name, guard in (("off", False), ("on", True)):
        model = copy.deepcopy(model0)
        opt = select_optimizer(model.parameters(), training)
        cache = StepGraphs("cuda")
        fn = make_superstep_fn(model, opt, cfg, device=torch.device("cuda"), graphs=cache,
                               guard=guard)
        state = TrainState(model, opt, graphs=cache)
        for _ in range(3):  # eager, capture + replay, replay
            fn(state, None, [host_batch])
        paths[name] = (fn, state, cache)
    per = {}
    for name, (fn, state, _) in paths.items():
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        fn(state, None, [host_batch])
        per[name] = (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2)
        check(per[name] == (4, 4), f"guard {name}: K1/K2 per replayed step {per[name]}")
    times = {"off": [], "on": []}
    for _ in range(2):
        for name, (fn, state, _) in paths.items():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fn(state, None, [host_batch])
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    pools = {name: cache.memory()["pool_bytes"] for name, (_, _, cache) in paths.items()}
    return {"replayed_ms": times, "pool_bytes": pools, "k1_k2_per_step": per,
            "nodes": host_batch.num_nodes, "edges": host_batch.num_edges}


def phase_guard(config, splits, head_step, head_cpu):
    """[guard] the divergence guard on bench.py's headline SchNet (full
    width) on the BCC train split, every step through a graph cache
    (eager on a shape's first sight, captured on its second, replayed
    after), two epochs of 7 steps each:
    - healthy, guard on against off, single steps and supersteps of 4:
      losses, parameters and optimizer state bit for bit; K1 4 per
      forward and K2 4 per train step on the guarded run;
    - ``nan:loss@3;nan:loss@9`` and the same at the ``batch`` site,
      guarded, single steps and supersteps of 4 (step 9 inside a
      replayed 4-step graph) against the unguarded run that never takes
      steps 3 and 9, bit for bit; the monitor saw exactly those steps;
    - the unguarded control with ``nan:loss@3`` goes non-finite;
    - run_training with ``policy: "rollback"``, ``max_bad_steps: 1``,
      ``max_rollbacks: 1``, containers every 2 steps and
      ``nan:batch@3,4,10,11``: one rollback (epoch 0), then
      ``GuardHalt`` (epoch 1) with its report printed;
    - the guard's cost at the headline shape: the replayed step's ms and
      the graph pool's bytes, guard on against off."""
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.guard import GuardHalt
    from hydragnn_tpu_torch.utils import faults

    t0 = time.perf_counter()
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    model0, cfg = create_model_config(full, "cuda", seed=0)
    trainset = splits[0]
    out = {"k1": 0, "k2": 0}

    def counted(**kw):
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        res = guard_run(model0, cfg, training, trainset, **kw)
        out["k1"] += edge_pipeline_planned.launches
        out["k2"] += edge_pipeline_bwd_planned.launches
        res["launches"] = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
        return res

    healthy = {}
    for k in (1, 4):
        off, on = counted(guard=False, k=k), counted(guard=True, k=k)
        check(on["losses"] == off["losses"] and guard_same(on["pair"], off["pair"]),
              f"K = {k}: the healthy guarded run differs from the unguarded one: losses "
              f"{on['losses']} vs {off['losses']}")
        check(on["monitor"].skipped_total == 0, f"K = {k}: healthy run had bad steps")
        layers = cfg.num_conv_layers
        check(on["launches"] == (layers * on["steps"], layers * on["steps"]),
              f"K = {k}: guarded run K1/K2 {on['launches']} for {on['steps']} train steps")
        healthy[k] = {"losses": on["losses"], "steps": on["steps"],
                      "launches": on["launches"], "graphs": on["graphs"].captures,
                      "replays": on["graphs"].replays}
    log(f"[guard] healthy, guard on == off bit for bit (losses, parameters, AdamW state, "
        f"step counts, learning rates): single steps {healthy[1]['losses']} "
        f"({healthy[1]['steps']} steps, {healthy[1]['replays']} replays) and supersteps "
        f"of 4 ({healthy[4]['replays']} replays); K1 {healthy[1]['launches'][0]} = 4 x "
        f"{healthy[1]['steps']} forwards, K2 {healthy[1]['launches'][1]} = 4 x "
        f"{healthy[1]['steps']} train steps")
    per_epoch = healthy[1]["steps"] // 2
    spec_steps = [divmod(s, per_epoch) for s in GUARD_POISON]
    base = counted(guard=False, skip=GUARD_POISON)
    skips = {}
    for site in ("loss", "batch"):
        spec = ";".join(f"nan:{site}@{s}" for s in GUARD_POISON)
        for k in (1, 4):
            got = counted(guard=True, k=k, spec=spec)
            check(got["losses"] == base["losses"] and guard_same(got["pair"], base["pair"]),
                  f"{spec}, K = {k}: guarded run differs from the run skipping steps "
                  f"{GUARD_POISON}: losses {got['losses']} vs {base['losses']}")
            check(got["monitor"].bad_steps_all == spec_steps,
                  f"{spec}, K = {k}: the monitor saw {got['monitor'].bad_steps_all}")
            skips[f"{site}_k{k}"] = got["losses"]
    log(f"[guard] nan:loss@3;nan:loss@9 and nan:batch@3;nan:batch@9 guarded, single steps "
        f"and supersteps of 4 (step 9 inside a replayed 4-step graph), each equal bit for "
        f"bit to the run that never takes steps 3 and 9: losses {base['losses']}; bad steps "
        f"seen {spec_steps} (epoch, step)")
    ctrl = counted(guard=False, spec="nan:loss@3", epochs=1)
    check(not np.isfinite(ctrl["losses"][0]), f"unguarded control stayed finite: {ctrl}")
    log(f"[guard] the unguarded control with nan:loss@3: epoch loss {ctrl['losses'][0]}")

    # the ladder through run_training: a rollback, then a halt
    ladder = copy.deepcopy(config)
    ladder["Dataset"]["name"] = "chip_smoke_guard"
    ladder["NeuralNetwork"]["Training"].update(
        Guard={"enabled": True, "policy": "rollback", "max_bad_steps": 1, "max_rollbacks": 1},
        Checkpoint={"enabled": True, "interval_steps": 2})
    faults.install("nan:batch@3;nan:batch@4;nan:batch@10;nan:batch@11")
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    buf = []
    try:
        with contextlib.redirect_stdout(_Tee(buf)):
            port.run_training(ladder, datasets=splits, device="cuda")
        halted = None
    except GuardHalt as e:
        halted = str(e)
    finally:
        faults.reset()
    out["k1"] += edge_pipeline_planned.launches
    out["k2"] += edge_pipeline_bwd_planned.launches
    text = "".join(buf)
    check(halted is not None and "ROLLBACK #1" in text and text.count("ROLLBACK") == 1,
          f"the ladder did not roll back once and then halt (halt: {halted!r})")
    log(f"[guard] rollback policy (max_bad_steps 1, max_rollbacks 1, containers every 2 "
        f"steps), nan:batch@3,4,10,11 through run_training: "
        + " | ".join(line for line in text.splitlines() if line.startswith("[guard]")))
    log(f"[guard] GuardHalt raised: {halted}")
    cost = guard_step_cost(*head_step, head_cpu)
    off, on = (min(cost["replayed_ms"][k]) for k in ("off", "on"))
    log(f"[guard] the cost at the headline shape ({cost['nodes']} nodes, {cost['edges']} "
        f"edges; 20 back-to-back replayed steps from the host batch, in turns): guard off "
        f"{cost['replayed_ms']['off']} ms, on {cost['replayed_ms']['on']} ms "
        f"({100 * (on - off) / off:+.1f}% best against best); graph pool off "
        f"{cost['pool_bytes']['off']} bytes, on {cost['pool_bytes']['on']} bytes; K1/K2 "
        f"per replayed step {cost['k1_k2_per_step']}")
    out.update(healthy=healthy, skip_losses=base["losses"], skips=skips,
               control_loss=ctrl["losses"][0], halt=halted, cost=cost,
               seconds=time.perf_counter() - t0)
    log(f"[guard] {out['seconds']:.1f} s; K1 {out['k1']}, K2 {out['k2']} launches in the phase")
    return out


class _Tee:
    """A stdout that also keeps what it is written."""

    def __init__(self, buf):
        self.buf = buf
        self.out = sys.stdout

    def write(self, s):
        self.buf.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


# The 14th train step, the 7th (last) of epoch 2 (7 steps an epoch): its
# cursor-6 save waited for the cursor-3 write, so a mid-epoch container is
# durable when the kill lands.
PREEMPT_KILL = 14


def preempt_config(config, data_path):
    """The BCC run of [train] (2 epochs, batch 32, ladder batches) with
    the asynchronous writer saving a resume container every 3 steps."""
    config = copy.deepcopy(config)
    config["Dataset"]["path"] = {"total": os.path.abspath(data_path)}
    config["Dataset"]["name"] = "chip_smoke_preempt"
    config["NeuralNetwork"]["Training"]["Checkpoint"] = {
        "enabled": True, "async": True, "interval_steps": 3}
    return config


def preempt_child(work, mode):
    """One child of [preempt] on the card: run_training of
    ``work/config.json`` from ``work/<base|drill>`` (``continue`` when
    ``mode`` is ``resume``), then its parameters, optimizer state,
    history, writer counts and K1/K2 launches to ``work/<mode>.pt``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    with open(os.path.join(work, "config.json")) as f:
        config = json.load(f)
    if mode == "resume":
        config["NeuralNetwork"]["Training"]["continue"] = 1
    stats = []
    plain = runner.CheckpointWriter

    class Counted(plain):
        def close(self, barrier=True):
            super().close(barrier)
            stats.append(self.stats())

    runner.CheckpointWriter = Counted
    os.chdir(os.path.join(work, "base" if mode == "base" else "drill"))
    t0 = time.perf_counter()
    state, model, _, hist, _ = runner.run_training(config, device="cuda")
    torch.cuda.synchronize()
    torch.save({"params": {k: v.cpu() for k, v in model.state_dict().items()},
                "opt": [v.cpu() for s in state.optimizer.state.values() for v in s.values()],
                "hist": [hist.train_loss, hist.val_loss, hist.test_loss, hist.lr],
                "steps": state.step, "step_t": int(state.step_t), "writer": stats[0],
                "k1": edge_pipeline_planned.launches, "k2": edge_pipeline_bwd_planned.launches,
                "seconds": time.perf_counter() - t0},
               os.path.join(work, f"{mode}.pt"))


def phase_preempt(config):
    """[preempt] a real preemption on the card: three child processes of
    this script (``preempt_child``) run the BCC SchNet of [train] with
    resume containers every 3 steps: uninterrupted; the same run with
    ``HYDRAGNN_TPU_FAULTS=kill:train_step:14``, which must die by SIGKILL
    (return code -9) in epoch 2 with a mid-epoch container on disk; and
    ``continue`` of the killed run. The
    resumed run's parameters, AdamW state and train/val/test loss and
    learning-rate history equal the uninterrupted run's bit for bit.
    Prints the writer's snapshot ms, saves and bytes."""
    import shutil
    import signal
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="preempt_")
    for d in ("base", "drill"):
        os.makedirs(os.path.join(work, d))
    log_feed("preempt", preempt_config(config, config["Dataset"]["path"]["total"]))
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(preempt_config(config, config["Dataset"]["path"]["total"]), f)

    def child(mode, env=None):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--preempt-child", work,
                            mode], env=dict(os.environ, **(env or {})),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420)
        return p.returncode, p.stdout.decode(errors="replace")

    rc, text = child("base")
    check(rc == 0, f"[preempt] the uninterrupted child exited {rc}:\n{text[-3000:]}")
    rc, text = child("kill", {"HYDRAGNN_TPU_FAULTS": f"kill:train_step:{PREEMPT_KILL}"})
    check(rc == -signal.SIGKILL, f"[preempt] the killed child exited {rc}, want "
          f"{-signal.SIGKILL}:\n{text[-3000:]}")
    run = os.listdir(os.path.join(work, "drill", "logs"))[0]
    container = torch.load(os.path.join(work, "drill", "logs", run, "resume.pt"),
                           weights_only=True)["manifest"]
    check(container["epoch"] == 1 and container["step"] in (3, 6),
          f"[preempt] the killed run's newest container is at {container['epoch']}, "
          f"{container['step']}, not mid epoch 2")
    rc, text = child("resume")
    check(rc == 0, f"[preempt] the resumed child exited {rc}:\n{text[-3000:]}")
    base, res = (torch.load(os.path.join(work, f"{m}.pt"), weights_only=False)
                 for m in ("base", "resume"))
    shutil.rmtree(work, ignore_errors=True)
    check(base["hist"] == res["hist"], f"[preempt] history differs: {base['hist']} vs "
          f"{res['hist']}")
    check(set(base["params"]) == set(res["params"]) and all(
        torch.equal(v, res["params"][k]) for k, v in base["params"].items()),
        "[preempt] the resumed run's parameters differ from the uninterrupted run's")
    check(len(base["opt"]) == len(res["opt"]) and all(
        torch.equal(a, b) for a, b in zip(base["opt"], res["opt"])),
        "[preempt] the resumed run's AdamW state differs")
    check(base["steps"] == res["steps"] == res["step_t"], "[preempt] step counts differ")
    w = base["writer"]
    log(f"[preempt] uninterrupted child: {base['steps']} steps, train loss "
        f"{base['hist'][0]}, val {base['hist'][1]}, test {base['hist'][2]}; writer "
        f"{w['saves']} saves, {w['bytes']} bytes written, {w['retries']} retries, snapshot "
        f"ms {[round(x, 3) for x in w['snapshot_ms']]}, write ms "
        f"{[round(x, 3) for x in w['write_ms']]}")
    log(f"[preempt] the child armed with kill:train_step:{PREEMPT_KILL} died by SIGKILL "
        f"(rc {-signal.SIGKILL}); its newest durable container: cursor (epoch "
        f"{container['epoch']}, step {container['step']})")
    log(f"[preempt] continue of the killed run: parameters, AdamW state and the "
        f"train/val/test loss and lr history equal the uninterrupted run's bit for bit "
        f"({res['steps']} steps; the resumed child's writer {res['writer']['saves']} saves, "
        f"{res['writer']['bytes']} bytes); children's K1 {base['k1']} + {res['k1']}, K2 "
        f"{base['k2']} + {res['k2']}")
    out = {"k1": base["k1"] + res["k1"], "k2": base["k2"] + res["k2"],
           "cursor": [container["epoch"], container["step"]], "writer": w,
           "resume_writer": res["writer"], "hist": base["hist"],
           "seconds": time.perf_counter() - t0}
    log(f"[preempt] {out['seconds']:.1f} s for the three children")
    return out


# ----------------------------------------------------------------------
# Run observability (ROADMAP item 13)
# ----------------------------------------------------------------------


def telemetry_config(config, name, on):
    """The [train] BCC run (two epochs, ladder batches) with the guard and
    resume containers every 3 steps; with ``on`` the telemetry stream
    (a device fence every 5 dispatches, counted executables) and a
    profiler window on epoch 1's first 10 dispatches."""
    config = copy.deepcopy(config)
    config["Dataset"]["name"] = name
    training = config["NeuralNetwork"]["Training"]
    training.update(Guard={"enabled": True},
                    Checkpoint={"enabled": True, "interval_steps": 3})
    if on:
        training.update(
            Telemetry={"enabled": True, "sync_interval_steps": 5, "cost_analysis": True,
                       "heartbeat_interval_s": 2.0},
            Profiling={"epoch": 1, "steps": 10,
                       "trace_dir": os.path.join("logs", name, "trace")})
    return config


def trace_kernels_in_steps(path):
    """K1 and K2 kernel events of a chrome trace, and those inside a
    ``train_step`` range: on the card's timeline (a GPU annotation range
    holding the kernel) or through the launch (the kernel's runtime call,
    matched by its correlation id, inside the host's range)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cpu_ranges, gpu_ranges, launches = [], [], {}
    for e in events:
        if e.get("name") == "train_step" and "dur" in e:
            span = (e["ts"], e["ts"] + e["dur"])
            (gpu_ranges if e.get("cat") == "gpu_user_annotation" else cpu_ranges).append(span)
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]

    def inside(ts, ranges):
        return any(a <= ts <= b for a, b in ranges)

    out = {}
    for tag, name in (("k1", "edge_pipeline_kernel"), ("k2", "edge_pipeline_bwd_kernel")):
        kernels = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
        hits = 0
        for e in kernels:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if inside(e["ts"], gpu_ranges) or (launch is not None
                                                and inside(launch, cpu_ranges)):
                hits += 1
        out[tag] = {"events": len(kernels), "in_train_step": hits}
    out["train_step_ranges"] = len(cpu_ranges)
    return out


def counted_kernels_match(row, cfg, dtype=torch.float32):
    """The executable row's K1/K2 counts against ``k1_work``/``k2_work``
    at the plan sizes the row recorded and the model's own widths (a
    CFConv's K1 is the a*b@W flavour, F_in = filters, F_out = hidden):
    (K1 flops, want), (K2 flops, want)."""
    layers = cfg.num_conv_layers
    f_in, f_out = cfg.num_filters or cfg.hidden_dim, cfg.hidden_dim
    k1 = row["kernels"]["hydragnn::edge_pipeline"]
    check(k1["calls"] == layers and (k1["f_in"], k1["f_out"]) == (f_in, f_out),
          f"{row['spec']}: K1 counted {k1}")
    args = (k1["n"], f_in, f_out, k1["slots"], k1["blocks"], dtype, dtype, True, True)
    want1 = layers * k1_work(k1["e_valid"], *args)[1]
    check(k1["flops"] == want1, f"{row['spec']}: K1 flops {k1['flops']} != {want1}")
    if row["region"] != "train":
        check("hydragnn::edge_pipeline_bwd" not in row["kernels"],
              f"{row['spec']}: K2 counted in an eval step")
        return (k1["flops"], want1), None
    k2 = row["kernels"]["hydragnn::edge_pipeline_bwd"]
    check(k2["calls"] == layers, f"{row['spec']}: K2 counted {k2}")
    want2 = layers * k2_work(k2["e"], k2["e_valid"], *args)[1]
    check(k2["flops"] == want2, f"{row['spec']}: K2 flops {k2['flops']} != {want2}")
    return (k1["flops"], want1), (k2["flops"], want2)


def telemetry_step_cost(model0, cfg, training, host_batch, work, iters=20):
    """The replayed train step at bench.py's headline shape with the step
    clock off and on (each its own graph cache; on: a stream to
    ``work``, the clock's probe and record around every dispatch, its
    finish after the timed run), CUDA events over ``iters`` back-to-back
    steps from the host batch, in turns off, on, off, on. The first
    dispatch of the on path is counted: its K1/K2 counts are held to
    ``k1_work``/``k2_work`` at the headline batch."""
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import telemetry

    stream = telemetry.TelemetryStream(os.path.join(work, "telemetry.jsonl"),
                                       device=torch.device("cuda"))
    telemetry.install(stream)
    try:
        clock = telemetry.StepClock(stream, region="train", model_cfg=cfg)
        paths = {}
        for name in ("off", "on"):
            model = copy.deepcopy(model0)
            opt = select_optimizer(model.parameters(), training)
            cache = StepGraphs("cuda")
            fn = make_superstep_fn(model, opt, cfg, device=torch.device("cuda"), graphs=cache)
            paths[name] = (fn, TrainState(model, opt, graphs=cache))
        step_no = [0]

        def on_step(fn, state):
            probe = clock.probe(host_batch, 1)
            t0 = time.perf_counter()
            state, acc = fn(state, None, [host_batch], probe=probe)
            t1 = time.perf_counter()
            step_no[0] += 1
            clock.record(probe, step=step_no[0], k=1, batch=host_batch, is_macro=False,
                         t_fetch_start=t0, t_fetch_end=t0, t_dispatch_start=t0,
                         t_dispatch_end=t1, acc=acc)

        for _ in range(3):  # eager (counted), capture + replay, replay
            paths["off"][0](paths["off"][1], None, [host_batch])
            on_step(*paths["on"])
        clock.finish()
        times = {"off": [], "on": []}
        finish_ms = []
        for _ in range(2):
            for name, (fn, state) in paths.items():
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(iters):
                    if name == "on":
                        on_step(fn, state)
                    else:
                        fn(state, None, [host_batch])
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / iters)
                if name == "on":
                    t0 = time.perf_counter()
                    clock.finish()
                    finish_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        telemetry.install(None)
        stream.close()
    with open(os.path.join(work, "telemetry.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    execs = [r for r in rows if r["t"] == "executable"]
    check(len(execs) == 1 and "capture_error" not in execs[0],
          f"headline step: executable rows {execs}")
    k1, k2 = counted_kernels_match(execs[0], cfg)
    e_valid = int(host_batch.edge_mask.sum())
    check(execs[0]["kernels"]["hydragnn::edge_pipeline"]["e_valid"] == e_valid,
          "headline step: the counted plan's valid slots differ from the batch's valid edges")
    return {"replayed_ms": times, "finish_ms": finish_ms, "k1_flops": k1, "k2_flops": k2,
            "hw_flops": execs[0]["flops"], "bytes_accessed": execs[0]["bytes_accessed"],
            "temp_bytes": execs[0].get("temp_bytes"),
            "nodes": host_batch.num_nodes, "edges": host_batch.num_edges}


SYNC_WARNING = "synchronizing CUDA operation"
LINT_EPOCHS = 4  # [lint] watches the last train epoch: every step a replay


@contextlib.contextmanager
def sync_sites():
    """While open, torch's sync debug mode warns on every synchronizing
    CUDA call, and each warning's innermost frame in the port's package
    (outside analysis/) is counted: ``sites[(relpath, line)]``. Other
    warnings pass through as they would."""
    import collections
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "hydragnn_tpu_torch") + os.sep
    skip = os.path.join(pkg, "analysis") + os.sep
    sites = collections.Counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        plain = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return plain(message, category, filename, lineno, file, line)
            frame = sys._getframe(1)
            while frame is not None:
                path = os.path.abspath(frame.f_code.co_filename)
                if path.startswith(pkg) and not path.startswith(skip):
                    sites[(os.path.relpath(path, root).replace(os.sep, "/"),
                           frame.f_lineno)] += 1
                    return None
                frame = frame.f_back
            sites[("<outside the port>", 0)] += 1
            return None

        warnings.showwarning = show
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(before)


def phase_lint(config, splits, samples, budgets, settings):
    """[lint]: the CLI's gate on this host, then the host-sync rule held to
    the card's synchronizing calls (the docstring's 7c)."""
    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.analysis.engine import collect_files
    from hydragnn_tpu_torch.analysis.rules.host_sync import site_verdict
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import ServingEngine
    from hydragnn_tpu_torch.train import loop

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.analysis", "--check",
                           "--json"], capture_output=True, text=True, cwd=root, timeout=600)
    lint_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[lint] graftlint --check exited {proc.returncode}:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    doc = json.loads(proc.stdout)
    per_rule = {r: [c["new"], c["baselined"], c["suppressed"]]
                for r, c in sorted(doc["per_rule"].items())}
    log(f"[lint] python -m hydragnn_tpu_torch.analysis --check --json: exit 0 in "
        f"{lint_s:.2f} s against torch {doc['torch_version']}; {doc['new']} new, "
        f"{doc['baselined']} baselined, {doc['suppressed']} suppressed; per rule "
        f"[new, baselined, suppressed]: {json.dumps(per_rule)}")
    out = {"seconds": round(lint_s, 3), "torch": doc["torch_version"], "per_rule": per_rule,
           "new": doc["new"], "baselined": doc["baselined"], "suppressed": doc["suppressed"]}

    # the train path: the last of LINT_EPOCHS epochs watched
    cfg_run = copy.deepcopy(config)
    cfg_run["NeuralNetwork"]["Training"]["num_epoch"] = LINT_EPOCHS
    plain = loop._run_epoch
    seen = {"train": 0, "steps": 0, "captures": None}
    watched = {}

    def run_epoch(superstep, state, loader, *, train, **kw):
        if not train:
            return plain(superstep, state, loader, train=train, **kw)
        seen["train"] += 1
        if seen["train"] < LINT_EPOCHS:
            return plain(superstep, state, loader, train=train, **kw)
        graphs = state.graphs
        caps, step0 = graphs.captures, state.step
        with sync_sites() as sites:
            res = plain(superstep, state, loader, train=train, **kw)
        seen["steps"], seen["captures"] = state.step - step0, graphs.captures - caps
        watched.update(sites)
        return res

    loop._run_epoch = run_epoch
    try:
        with recorded_run() as rec:
            edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
            state, model, cfg, hist, _ = port.run_training(cfg_run, device="cuda")
            torch.cuda.synchronize()
            k1, k2, n_fwd = (edge_pipeline_planned.launches,
                             edge_pipeline_bwd_planned.launches, rec["forwards"])
    finally:
        loop._run_epoch = plain
    layers = cfg.num_conv_layers
    check(k1 == layers * n_fwd and k2 == layers * state.step,
          f"[lint] K1 {k1}, K2 {k2} for {n_fwd} forwards and {state.step} train steps "
          f"(want {layers} each)")
    check(seen["steps"] > 0 and seen["captures"] == 0,
          f"[lint] the watched epoch ran {seen['steps']} steps with {seen['captures']} "
          "captures (want replays only)")

    # the serving path: one bin of [slice]'s engine after its warm-up
    engine = ServingEngine(create_model(full_width_config(), device="cuda", seed=0),
                           full_width_config(), None, budgets, example=samples[0],
                           settings=settings, device="cuda")
    try:
        batcher = DynamicBatcher(budgets, deadline_ms=settings.deadline_ms,
                                 max_open_bins=settings.max_open_bins)
        reqs = [batcher.submit(x) for x in samples[:4]]
        batcher.close()
        edge_pipeline_planned.launches = 0
        with sync_sites() as served:
            records = engine.process(batcher)
        torch.cuda.synchronize()
        k1_serve = edge_pipeline_planned.launches
    finally:
        engine.close()
    check(len(records) == 1 and all(r.result is not None for r in reqs),
          f"[lint] {len(records)} bins for 4 requests (want one, every request served)")
    check(k1_serve == layers, f"[lint] K1 launched {k1_serve} times for the served bin")

    ctx = collect_files(root, ["hydragnn_tpu_torch"])
    rows = []
    for where, sites, per in (("train", watched, seen["steps"]), ("serve", served, 1)):
        verdict = site_verdict(ctx, [s for s in sites if s[1]])
        for site, n in sorted(sites.items()):
            v = verdict.get(site, "outside the port")
            rows.append({"path": where, "site": f"{site[0]}:{site[1]}", "calls": n,
                         "per_step": round(n / per, 4), "verdict": v})
            log(f"[lint] {where}: {site[0]}:{site[1]} {n} synchronizing call(s), "
                f"{n / per:.3g} per {'step' if where == 'train' else 'bin'}: {v}")
    missed = [r for r in rows if r["verdict"] not in ("flagged", "out of scope")]
    check(not missed, f"[lint] synchronizing sites the host-sync rule does not see: {missed}")
    log(f"[lint] {seen['steps']} replayed train steps (epoch {LINT_EPOCHS}, 0 captures) and "
        f"one served bin: {len(rows)} synchronizing site(s), every one flagged by host-sync "
        f"or outside its scope; K1 {k1} = {layers} x {n_fwd} forwards, K2 {k2} = {layers} "
        f"x {state.step} train steps, the bin's K1 {k1_serve}")
    out.update({"train_steps": seen["steps"], "sites": rows, "k1": k1 + k1_serve, "k2": k2})
    return out


def phase_telemetry(config, splits, head_step, head_cpu):
    """[telemetry] run_training of [train]'s full-width SchNet on the BCC
    split (``telemetry_config``: guard on, containers every 3 steps)
    with the telemetry stream and a profiler window, against the same
    run with both off. Fails unless: the header names the card with
    ``peak_basis`` "device"; every ``spec_rollup`` has 0 < mfu <= 1,
    reproduced from its own fields to 1e-9; every (region, spec, k) has
    an executable row with flops and bytes and none has a
    ``capture_error``; the counted K1/K2 flops equal ``k1_work``/
    ``k2_work`` at the counted batch; the ``epoch`` rows equal History
    bit for bit; ``health``, ``checkpoint``, ``compile`` and ``memory``
    rows are there; the run equals the off run bit for bit (history,
    parameters, optimizer state) with K1 4 per forward and K2 4 per
    train step in both; graftboard's report and roofline exit 0 on the
    stream; the chrome trace holds K1 and K2 kernels inside
    ``train_step`` ranges. Then the clock's cost on the replayed
    headline step."""
    import tempfile

    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.utils.flops import model_flops_per_graph

    t0 = time.perf_counter()
    runs = {}
    for name, on in (("on", True), ("off", False)):
        cfg_run = telemetry_config(config, f"chip_smoke_telemetry_{name}", on)
        with recorded_run() as rec:
            edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
            state, model, cfg, hist, full = port.run_training(cfg_run, datasets=splits,
                                                              device="cuda")
            torch.cuda.synchronize()
            k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        runs[name] = {"state": state, "cfg": cfg, "hist": hist, "full": full, "k1": k1,
                      "k2": k2, "forwards": rec["forwards"], "steps": state.step,
                      "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                      "opt": [v.detach().clone() if isinstance(v, torch.Tensor) else v
                              for st in state.optimizer.state.values() for v in st.values()]}
    on, off = runs["on"], runs["off"]
    layers = on["cfg"].num_conv_layers
    for name, r in runs.items():
        check(r["k1"] == layers * r["forwards"] and r["k2"] == layers * r["steps"]
              and r["steps"] > 0,
              f"telemetry {name}: K1 {r['k1']} for {r['forwards']} forwards, K2 {r['k2']} "
              f"for {r['steps']} train steps")
    same_hist = all(getattr(on["hist"], f) == getattr(off["hist"], f)
                    for f in ("train_loss", "val_loss", "test_loss", "lr"))
    same_params = all(torch.equal(on["params"][k], off["params"][k]) for k in off["params"])
    same_opt = len(on["opt"]) == len(off["opt"]) > 0 and all(
        (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
        for a, b in zip(on["opt"], off["opt"]))
    check(same_hist and same_params and same_opt,
          f"telemetry on differs from off: history {same_hist}, parameters {same_params}, "
          f"optimizer state {same_opt}; train loss {on['hist'].train_loss} vs "
          f"{off['hist'].train_loss}")
    log(f"[telemetry] run_training with the stream, the profiler window, the guard and "
        f"containers every 3 steps == the same run without the stream and window, bit for "
        f"bit (history, parameters, AdamW state): train loss {on['hist'].train_loss}; K1 "
        f"{on['k1']} = {layers} x {on['forwards']} forwards, K2 {on['k2']} = {layers} x "
        f"{on['steps']} train steps (off: {off['k1']}, {off['k2']})")

    log_dir = os.path.join("logs", on["full"]["_log_name"])
    stream_path = os.path.join(log_dir, "telemetry.jsonl")
    with open(stream_path) as f:
        rows = [json.loads(line) for line in f]
    by_type = {}
    for r in rows:
        by_type.setdefault(r["t"], []).append(r)
    header = rows[0]
    kind = torch.cuda.get_device_name(0)
    check(header["t"] == "header" and header.get("device_kind") == kind
          and header.get("peak_basis") == "device" and header.get("platform") == "gpu",
          f"header {header}")
    cfg = on["cfg"]
    rollups = by_type.get("spec_rollup", [])
    check(rollups, "no spec_rollup rows")
    mfus = []
    for r in rollups:
        mf = model_flops_per_graph(cfg, r["mean_nodes"], r["mean_edges"])
        want = mf * r["graphs"] / (r["wall_ms"] / 1e3) / r["peak_flops"]
        check(0 < r["mfu"] <= 1 and abs(r["mfu"] - want) <= 1e-9 * want,
              f"{r['region']} {r['spec']} epoch {r['epoch']}: mfu {r['mfu']} (from the "
              f"row's fields {want})")
        check("hw_mfu" in r and "intensity" in r, f"{r['spec']}: no counted side {r}")
        mfus.append({"region": r["region"], "epoch": r["epoch"], "spec": r["spec"],
                     "dispatches": r["dispatches"], "mfu": r["mfu"], "hw_mfu": r["hw_mfu"],
                     "intensity": r["intensity"],
                     "hw_over_model_flops": r["hw_over_model_flops"],
                     "wall_ms": r["wall_ms"]})
    execs = by_type.get("executable", [])
    check(not [r for r in execs if "capture_error" in r],
          f"capture_error rows: {[r for r in execs if 'capture_error' in r]}")
    exec_keys = {(r["region"], r["spec"], r["k"]) for r in execs}
    step_keys = {(r["region"], r["spec"], r["k"]) for r in by_type["step"]}
    check(step_keys == exec_keys and all(r["flops"] > 0 and r["bytes_accessed"] > 0
                                         for r in execs),
          f"executables {sorted(exec_keys)} for steps {sorted(step_keys)}")
    counted = [counted_kernels_match(r, cfg) for r in execs]
    epochs = by_type.get("epoch", [])
    check([r["train_loss"] for r in epochs] == on["hist"].train_loss
          and [r["val_loss"] for r in epochs] == on["hist"].val_loss
          and [r["test_loss"] for r in epochs] == on["hist"].test_loss
          and [r["lr"] for r in epochs] == on["hist"].lr
          and [r["seconds"] for r in epochs] == on["hist"].epoch_seconds,
          f"epoch rows {epochs} differ from History {on['hist']}")
    check(len(by_type.get("health", [])) == 2 and
          {"save", "write"} <= {r["event"] for r in by_type.get("checkpoint", [])},
          f"health {by_type.get('health')}, checkpoint events "
          f"{[r['event'] for r in by_type.get('checkpoint', [])]}")
    mem = by_type.get("memory", [])
    check(mem and all("bytes_in_use" in r for r in mem)
          and {"run_start", "epoch", "compile"} <= {r["tag"] for r in mem},
          f"memory rows {mem}")
    compiles = by_type.get("compile", [])
    check(len(compiles) == on["state"].graphs.captures,
          f"{len(compiles)} compile rows for {on['state'].graphs.captures} captures")
    summary = by_type.get("compile_summary", [{}])[0]
    log(f"[telemetry] header: {header['device_kind']}, peak {header['peak_flops']:.4g} "
        f"FLOP/s ({header['peak_basis']}), HBM {header['peak_hbm_bytes_per_sec']:.4g} B/s; "
        f"rows {{{', '.join(f'{t}: {len(v)}' for t, v in sorted(by_type.items()))}}}; "
        f"{len(compiles)} captures ({sum(r['retrace_leak'] for r in compiles)} at epoch >= "
        f"1), summary {summary}")
    for m in mfus:
        log(f"[telemetry] {m['region']} epoch {m['epoch']} {m['spec']} ({m['dispatches']} "
            f"dispatches, {m['wall_ms']:.3f} ms): mfu {m['mfu']:.4g}, hw_mfu "
            f"{m['hw_mfu']:.4g}, intensity {m['intensity']:.4g} flop/B, hw/model "
            f"{m['hw_over_model_flops']:.4g}")
    log(f"[telemetry] counted K1/K2 flops == k1_work/k2_work at each counted batch "
        f"({len(execs)} executables): "
        + "; ".join(f"{r['region']} {r['spec']} K1 {c[0][0]:.6g}"
                    + (f" K2 {c[1][0]:.6g}" if c[1] else "") for r, c in zip(execs, counted)))
    reports = {}
    for cmd in ("report", "roofline"):
        res = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                           "graftboard.py"),
                              cmd, log_dir, "--json"], capture_output=True, text=True,
                             timeout=120)
        check(res.returncode == 0, f"graftboard {cmd} exited {res.returncode}: {res.stderr}")
        reports[cmd] = json.loads(res.stdout)
    verdicts = [(s["region"], s["spec"], s["verdict"]) for s in reports["roofline"]["specs"]]
    log(f"[telemetry] graftboard report and roofline exit 0 on the stream; roofline "
        f"verdicts {verdicts}")
    prof = by_type.get("profile", [])
    check([r["event"] for r in prof] == ["start", "stop"], f"profile rows {prof}")
    trace_file = os.path.join(prof[0]["trace_dir"], "trace.p0.json")
    trace = trace_kernels_in_steps(trace_file)
    check(trace["k1"]["in_train_step"] > 0 and trace["k2"]["in_train_step"] > 0,
          f"the profiler trace has no K1/K2 kernel inside a train_step range: {trace}")
    log(f"[telemetry] profiler window ({prof[1].get('reason')}): {trace_file}, "
        f"{os.path.getsize(trace_file)} bytes; {trace['train_step_ranges']} train_step "
        f"ranges; K1 kernels {trace['k1']['events']} ({trace['k1']['in_train_step']} inside "
        f"train_step), K2 {trace['k2']['events']} ({trace['k2']['in_train_step']} inside)")
    work = tempfile.mkdtemp(prefix="telemetry_cost_")
    cost = telemetry_step_cost(*head_step, head_cpu, work)
    best_off, best_on = (min(cost["replayed_ms"][k]) for k in ("off", "on"))
    log(f"[telemetry] the clock's cost at the headline shape ({cost['nodes']} nodes, "
        f"{cost['edges']} edges; 20 back-to-back replayed steps from the host batch, in "
        f"turns): off {cost['replayed_ms']['off']} ms, on {cost['replayed_ms']['on']} ms "
        f"({100 * (best_on - best_off) / best_off:+.2f}% best against best); the epoch-end "
        f"finish of 20 rows {cost['finish_ms']} ms; the headline step counted {cost['hw_flops']:.6g} "
        f"flops, {cost['bytes_accessed']:.6g} bytes (K1 {cost['k1_flops'][0]:.6g} == "
        f"k1_work x 4, K2 {cost['k2_flops'][0]:.6g} == k2_work x 4), graph pool "
        f"{cost['temp_bytes']} bytes")
    out = {"k1": on["k1"] + off["k1"], "k2": on["k2"] + off["k2"],
           "train_loss": on["hist"].train_loss, "mfu": mfus, "cost": cost,
           "trace": trace, "rows": {t: len(v) for t, v in by_type.items()},
           "captures": len(compiles), "seconds": time.perf_counter() - t0}
    check(np.isfinite(on["hist"].train_loss).all(), "non-finite train loss")
    log(f"[telemetry] {out['seconds']:.1f} s; K1 {out['k1']}, K2 {out['k2']} launches in "
        f"the phase")
    return out


def main():
    if sys.argv[1:2] == ["--multibranch-rank"]:
        multibranch_rank(int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
        return
    if sys.argv[1:2] == ["--graphshard-rank"]:
        graphshard_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if sys.argv[1:2] == ["--preempt-child"]:
        preempt_child(sys.argv[2], sys.argv[3])
        return
    if sys.argv[1:2] == ["--store-child"]:
        store_child(sys.argv[2])
        return
    card = phase_device()
    # The port lives next to this script; a copy of the script alone
    # fails here with ModuleNotFoundError.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.loadgen import synthetic_request_samples

    install_feed_log()
    prior_path = phase_build()
    samples = synthetic_request_samples("qm9", N_REQUESTS, seed=0)
    settings = ServingSettings(enabled=True)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), settings)
    head_cpu = headline_batch()
    head = (f"headline_n{head_cpu.num_nodes}_e{head_cpu.num_edges}", head_cpu.to("cuda"))
    main_row, rows = phase_kernel(samples, budgets, head)
    config, splits = bcc_data()
    bins = train_bins(splits[0])
    bwd_row, bwd_rows = phase_kernel_bwd(bins + [head])
    served = served_batches(samples, budgets)
    shape_rows = phase_shapes([max(served, key=lambda kb: kb[1].num_nodes), bins[0], head],
                              prior_path)
    launches, n_bins, served_bin = phase_slice(samples, budgets, settings)
    export = phase_export(samples, budgets, settings)
    loadbench = phase_loadbench(samples)
    fleet = phase_fleet()
    train = phase_train(config, splits)
    headline, head_step = phase_train_timing(head_cpu)
    guard = phase_guard(config, splits, head_step, head_cpu)
    preempt = phase_preempt(config)
    tele = phase_telemetry(config, splits, head_step, head_cpu)
    lint = phase_lint(config, splits, samples, budgets, settings)
    mlip_cfg, mlip_splits, md17_splits = mlip_data()
    mlip_loader, mlip_budgets = train_loader(mlip_cfg, mlip_splits[0])
    check(mlip_loader.packing, "md17.json's packing 'auto' did not pack bench's molecules")
    mlip_batch = next(iter(mlip_loader))
    log(f"[mlip] packing on ('auto' resolved as the JAX package resolves it): train "
        f"budgets {budget_keys(mlip_budgets)}; the first packed bin holds "
        f"{int(mlip_batch.graph_mask.sum())} molecules, {mlip_batch.num_nodes} nodes, "
        f"{int(mlip_batch.edge_mask.sum())} edges (padded {mlip_batch.num_edges})")
    mlip_rows = phase_mlip_kernels(mlip_batch.to("cuda"))
    mlip = phase_mlip(mlip_cfg, mlip_splits, md17_splits, mlip_budgets, mlip_batch)
    serve_forces = phase_serve_forces(mlip_cfg, md17_splits)
    md = phase_md(mlip_cfg, md17_splits)
    drivers = phase_drivers()
    driver_rows = [r for rows_ in drivers["kernel_rows"].values() for r in rows_]
    widths = [r for r in mlip_rows if "k1_ms" in r]
    zinc_cfgs, zinc_splits = zinc_data()
    zinc_loader, _ = train_loader(zinc_cfgs["fp32"], zinc_splits[0])
    check(zinc_loader.packing, "zinc.json's packing 'auto' did not pack zinc.py's set")
    zinc_bin = next(iter(zinc_loader))
    zinc_rows = phase_zinc_kernels(zinc_bin.to("cuda"))
    zinc = phase_zinc(zinc_cfgs, zinc_splits, zinc_loader, zinc_bin)
    pipeline, long_splits = phase_pipeline(mlip_cfg, mlip_splits, zinc_cfgs["fp32"],
                                           zinc_splits)
    formats = phase_formats(mlip_cfg, mlip_splits, md17_splits, zinc_cfgs["fp32"], zinc_splits,
                            long_splits, pipeline["zinc_long"]["pipeline"])
    poly_cfg, poly_splits = polymer_data()
    poly_loader, _ = train_loader(poly_cfg, poly_splits[0])
    check(poly_loader.packing, "polymers.json's packing 'auto' did not pack the chains")
    poly_bin = next(iter(poly_loader))
    poly_rows = phase_polymer_kernels(poly_bin.to("cuda"))
    polymers = phase_polymers(poly_cfg, poly_splits, poly_loader, poly_bin)
    poly = {"model0": polymers.pop("model0"), "cfg": polymers.pop("cfg"),
            "training": polymers.pop("training"), "bin": poly_bin, "config": poly_cfg,
            "splits": poly_splits, "loader": poly_loader,
            "run_seconds": polymers["run"]["seconds"]}
    zoo = phase_zoo(poly_splits, poly_bin, poly["model0"], poly["cfg"], poly_splits[0])
    oc20_cfg, oc20_splits = oc20_data()
    oc20_loader, _ = train_loader(oc20_cfg, oc20_splits[0])
    check(oc20_loader.packing, "oc20.json's packing 'auto' did not pack the OC20 slabs")
    oc20_bin = next(iter(oc20_loader))
    mace_rows = phase_mace_kernels(oc20_bin.to("cuda"))
    oc20 = phase_oc20(oc20_cfg, oc20_splits, oc20_loader, oc20_bin)
    dp = phase_dp(oc20_cfg, oc20_splits, oc20_bin, oc20_loader.pack_budgets)
    fsdp = phase_fsdp(oc20_cfg, oc20_splits, oc20_bin, oc20_loader.pack_budgets)
    egnn = phase_egnn(*egnn_data())
    pnaeq_cfg = pnaeq_config(mlip_cfg)
    pnaeq_loader, _ = train_loader(pnaeq_cfg, md17_splits[0])
    check(pnaeq_loader.packing, "md17.json's packing 'auto' did not pack the MD17 stand-in "
          "for PNAEq")
    pnaeq_bin = next(iter(pnaeq_loader))
    pnaeq_rows = phase_pnaeq_kernels(pnaeq_bin.to("cuda"))
    pnaeq = phase_pnaeq(pnaeq_cfg, md17_splits, pnaeq_loader, pnaeq_bin)
    dimenet = phase_dimenet(*qm7x_data())
    multibranch = phase_multibranch()
    graphshard = phase_graphshard()
    capture, cap_k1, cap_k2 = phase_capture([
        ("SchNet headline step", *head_step, head_cpu, (4, 4), False, True),
        ("MLIP first packed bin", *mlip.pop("step"), mlip_batch, (12, 12), True, True),
        ("ZINC first packed bin", *zinc.pop("step"), zinc_bin, (3, 3), False, False),
        ("polymer first packed bin", poly["model0"], poly["cfg"], poly["training"],
         poly_bin, (3, 3), False, False),
        ("MACE first packed oc20 bin", *oc20.pop("step"), oc20_bin, (4, 4), True, False),
    ], poly, head_cpu)

    kernels = [{
        "name": "edge_pipeline",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/csrc/edge_pipeline.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:337",
        "launches": (launches + train["k1"] + mlip["k1"] + zinc["k1"] + polymers["k1"]
                     + oc20["k1"] + pnaeq["k1"] + cap_k1 + dp["run"]["k1"]
                     + fsdp["run"]["k1"] + multibranch["k1"] + export["k1"]
                     + loadbench["k1"] + fleet["k1"] + serve_forces["k1"] + guard["k1"]
                     + preempt["k1"] + dp["guard"]["k1"] + tele["k1"] + pipeline["k1"]
                     + formats["k1"] + graphshard["k1"] + md["k1"] + drivers["k1"]
                     + drivers["k1_atomistic"] + drivers["k1_gfm"] + lint["k1"]),
        "launches_by_path": {"serve": launches, "export": export["k1"],
                             "loadbench": loadbench["k1"], "fleet": fleet["k1"],
                             "serve_forces": serve_forces["k1"],
                             "train": train["k1"], "mlip": mlip["k1"],
                             "zinc": zinc["k1"], "polymers": polymers["k1"],
                             "oc20": oc20["k1"], "egnn": 0, "pnaeq": pnaeq["k1"],
                             "dimenet": dimenet["run"]["k1"],
                             "polymers_superstep": cap_k1, "dp": dp["run"]["k1"],
                             "fsdp": fsdp["run"]["k1"], "multibranch": multibranch["k1"],
                             "guard": guard["k1"], "preempt": preempt["k1"],
                             "dp_guard": dp["guard"]["k1"], "telemetry": tele["k1"],
                             "pipeline": pipeline["k1"], "formats": formats["k1"],
                             "graphshard": graphshard["k1"], "md": md["k1"],
                             "drivers": drivers["k1"],
                             "drivers_atomistic": drivers["k1_atomistic"],
                             "drivers_gfm": drivers["k1_gfm"], "lint": lint["k1"]},
        "max_abs_err": max([r["max_abs_err"] for r in rows if r["dtype"] == "f32"]
                           + [r["k1_max_abs_err"] for r in mlip_rows + zinc_rows + poly_rows
                              + mace_rows + pnaeq_rows + md["kernel_rows"] + driver_rows
                              if r["dtype"] == "f32"]
                           + [md["lj"]["kernel_row"]["k1_max_abs_err"]]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "bins": n_bins,
        "by_shape": [dict(r["k1"], shape=r["shape"], n=r["n"], e_valid=r["e_valid"])
                     for r in shape_rows],
        "flavours": [r for r in rows if "ms" in r],
        "mlip_widths": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                        for r in widths],
        "zinc_width": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                       for r in zinc_rows],
        "polymer_widths": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                           for r in poly_rows],
        "mace_width": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                       for r in mace_rows],
        "pnaeq_widths": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                         for r in pnaeq_rows],
        "md_widths": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                      for r in md["kernel_rows"]],
        "md_lj": {k.replace("k1_", ""): v for k, v in md["lj"]["kernel_row"].items()
                  if "k2" not in k},
        "oc25_widths": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                        for r in drivers["kernel_rows"]["oc25"]],
        "qcml_width": [{k.replace("k1_", ""): v for k, v in r.items() if "k2" not in k}
                       for r in drivers["kernel_rows"]["qcml"]],
        "sc26_painn_widths": [{k.replace("k1_", ""): v for k, v in r.items()
                               if "k2" not in k}
                              for r in drivers["kernel_rows"]["painn"]],
        "sc26_schnet_width": [{k.replace("k1_", ""): v for k, v in r.items()
                               if "k2" not in k}
                              for r in drivers["kernel_rows"]["schnet"]],
    }, {
        "name": "edge_pipeline_bwd",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/csrc/edge_pipeline_bwd.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:490",
        "launches": (train["k2"] + mlip["k2"] + zinc["k2"] + polymers["k2"] + oc20["k2"]
                     + pnaeq["k2"] + cap_k2 + dp["run"]["k2"] + fsdp["run"]["k2"]
                     + multibranch["k2"] + serve_forces["k2"] + guard["k2"] + preempt["k2"]
                     + dp["guard"]["k2"] + tele["k2"] + pipeline["k2"] + formats["k2"]
                     + graphshard["k2"] + md["k2"] + drivers["k2"]
                     + drivers["k2_atomistic"] + drivers["k2_gfm"] + lint["k2"]),
        "launches_by_path": {"serve": 0, "export": 0, "loadbench": 0, "fleet": 0,
                             "serve_forces": serve_forces["k2"],
                             "train": train["k2"], "mlip": mlip["k2"],
                             "zinc": zinc["k2"], "polymers": polymers["k2"],
                             "oc20": oc20["k2"], "egnn": 0, "pnaeq": pnaeq["k2"],
                             "dimenet": dimenet["run"]["k2"],
                             "polymers_superstep": cap_k2, "dp": dp["run"]["k2"],
                             "fsdp": fsdp["run"]["k2"], "multibranch": multibranch["k2"],
                             "guard": guard["k2"], "preempt": preempt["k2"],
                             "dp_guard": dp["guard"]["k2"], "telemetry": tele["k2"],
                             "pipeline": pipeline["k2"], "formats": formats["k2"],
                             "graphshard": graphshard["k2"], "md": md["k2"],
                             "drivers": drivers["k2"],
                             "drivers_atomistic": drivers["k2_atomistic"],
                             "drivers_gfm": drivers["k2_gfm"], "lint": lint["k2"]},
        "max_abs_err": max([r["max_abs_err"] for r in bwd_rows if r["dtype"] == "f32"]
                           + [r["k2_max_abs_err"] for r in mlip_rows + zinc_rows + poly_rows
                              + mace_rows + pnaeq_rows + md["kernel_rows"] + driver_rows
                              if r["dtype"] == "f32"]
                           + [md["lj"]["kernel_row"]["k2_max_abs_err"]]),
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": None,
        "shape": bwd_row["shape"],
        "by_shape": [dict(r["k2"], shape=r["shape"], n=r["n"], e_valid=r["e_valid"])
                     for r in shape_rows],
        "flavours": [r for r in bwd_rows if "ms" in r],
        "mlip_widths": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                        for r in widths],
        "zinc_width": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                       for r in zinc_rows],
        "polymer_widths": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                           for r in poly_rows],
        "mace_width": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                       for r in mace_rows],
        "pnaeq_widths": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                         for r in pnaeq_rows],
        "md_widths": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                      for r in md["kernel_rows"]],
        "md_lj": {k.replace("k2_", ""): v for k, v in md["lj"]["kernel_row"].items()
                  if "k1" not in k},
        "oc25_widths": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                        for r in drivers["kernel_rows"]["oc25"]],
        "qcml_width": [{k.replace("k2_", ""): v for k, v in r.items() if "k1" not in k}
                       for r in drivers["kernel_rows"]["qcml"]],
        "sc26_painn_widths": [{k.replace("k2_", ""): v for k, v in r.items()
                               if "k1" not in k}
                              for r in drivers["kernel_rows"]["painn"]],
        "sc26_schnet_width": [{k.replace("k2_", ""): v for k, v in r.items()
                               if "k1" not in k}
                              for r in drivers["kernel_rows"]["schnet"]],
    }]
    log(f"[report] export: {json.dumps(export)}")
    log(f"[report] loadbench: {json.dumps(loadbench)}")
    log(f"[report] fleet: {json.dumps(fleet)}")
    log(f"[report] serve-forces: {json.dumps(serve_forces)}")
    log(f"[report] md: {json.dumps({k: v for k, v in md.items() if k != 'kernel_rows'})}")
    log(f"[report] drivers: {json.dumps(drivers)}")
    log(f"[report] train: {json.dumps({k: v for k, v in train.items() if k != 'parity'})}")
    log(f"[report] headline train step: {json.dumps(headline)}")
    log(f"[report] guard: {json.dumps({k: v for k, v in guard.items() if k != 'halt'})}")
    log(f"[report] preempt: {json.dumps(preempt)}")
    log(f"[report] telemetry: {json.dumps(tele)}")
    log(f"[report] lint: {json.dumps(lint)}")
    log(f"[report] mlip: {json.dumps(mlip)}")
    log(f"[report] zinc: {json.dumps(zinc)}")
    log(f"[report] pipeline: {json.dumps(pipeline)}")
    log(f"[report] formats: {json.dumps(formats)}")
    log(f"[report] polymers: {json.dumps(polymers)}")
    log(f"[report] zoo: {json.dumps(zoo)}")
    log(f"[report] oc20: {json.dumps(oc20)}")
    log(f"[report] egnn: {json.dumps(egnn)}")
    log(f"[report] pnaeq: {json.dumps(pnaeq)}")
    log(f"[report] dimenet: {json.dumps(dimenet)}")
    log(f"[report] dp: {json.dumps(dp)}")
    log(f"[report] fsdp: {json.dumps(fsdp)}")
    log(f"[report] multibranch: {json.dumps(multibranch)}")
    log(f"[report] graphshard: {json.dumps(graphshard)}")
    log(f"[report] capture: {json.dumps(dict(capture, served_bin=served_bin))}")
    log(f"[report] card: {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
