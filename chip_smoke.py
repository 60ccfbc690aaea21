#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inferd_tpu_torch) end to end on one NVIDIA card.

Phases, one or more lines each; any failure raises and the exit code is 1:

  gpu         the card's name and power limit (nvidia-smi), torch and CUDA
              versions; TF32 off for every comparison
  build       build every CUDA kernel from the sources in this checkout, all
              at once (one nvcc each), with ptxas's registers and spills, and
              beside them the wire's native codec (csrc/wirecodec.cpp, the host
              C++ compiler); in the full run the split and every prestarted
              node process start meanwhile, each node waiting on a library's
              build lock (ops/build) before it loads it
  sim         the fleet simulator (inferd_tpu_torch.sim) replays the
              committed fixtures of tests/data/sim/ (the two slow 1000-node
              sweeps skipped) through the port's control plane, on the
              host's CPU: a line per fixture (PASS or FAIL, goodput or event
              count, wall ms) and the total; any FAIL fails the run. No
              process started, no card memory used; in the full run it runs
              while the prestarted node processes start (its wall times
              then share the host's CPU with them)
  codec       the native wire codec against the pure-Python one in this
              process, in interleaved rounds: pack and unpack of a decode
              envelope (a bf16 hidden row), a coalesced window of 8 rows and
              the last stage's logits reply (~600 KB); equal bytes
  kernels     every kernel against its plain PyTorch version on the card, at
              the main path's shapes (Qwen3-0.6B: bf16, Nq 16, Nkv 8, D 128)
              and feature cases, and at the Llama-3 heads (Nq 32, Nkv 8, D 64
              and D 128: the decode main case, the lanes' chunk, the route
              boundary at 4 and 5 positions; paged's main case at D 64) and
              at Qwen3-30B-A3B's (Nq 32, Nkv 4, D 128, a group of 8: the
              same cases, the boundary at 2 and 3 positions; paged's main
              case); each boundary case asserts its predicted route;
              the per-row error against a stated
              tolerance, beside the readings of planted faults that it must
              catch; kernel / plain / library (or yardstick) times from CUDA
              events, and the bound for the work. flash_gqa's cases (each
              asserts the route flash_plan picks moved its launch counter:
              split-KV or tensor cores), then paged_decode_gqa's (each
              asserts its launch and split counters moved as
              ops.attention.paged_plan cuts the chain, and prints the plan),
              all timed with inputs cold in L2; every kernel case checks
              that two calls give the same bits
  qmatmul     the same for the decode GEMVs (w8a16_matmul, w4a16_matvec
              under both int4 schemes) at Qwen3-0.6B's projection and head
              shapes at 1, 8 and 64 rows, plus f32, ragged-N and odd-K cases,
              timed with every input cold in L2; the library call is
              torch._weight_int8pack_mm / torch._weight_int4pack_mm on the
              same quantized weight, and a yardstick torch.matmul against
              the dequantized bf16 weight. Each case asserts the route
              counter that ops.qmatmul.qgemv_plan names (mma or simt) and
              that two calls give the same bits; planted faults include a
              cluster rank's partial dropped or added twice. Then one line
              per kernel with a stage step's sums at 1 and 8 rows (14
              layers x the seven projections) beside the yardstick's and
              the library call's
  serve       split Qwen3-0.6B (seeded random weights, full width, 28 layers)
              into 2 stages with tools/split_model, start two tools/run_node
              --device cuda processes on loopback, drive 4 greedy requests
              one after another through the port's ChainClient, and check:
              every request completes; each node's flash_gqa launches = 14 x
              its forward passes, of which 14 x its decode passes took the
              split-KV route and 14 x its prefill passes the tensor cores;
              every decode step a graph capture or replay (/stats
              executor.graphs: captures + replays = decode steps); the
              streams equal the same two stage executors driven in-process
              with their graphs off (eager); a stage graph whose fill is
              frozen at capture (planted) breaks that equality; one 14-layer
              stage step's host and device time, graphed and eager; over
              teacher-forced prefill and decode steps the kernel path's
              hidden states and logits are near the plain attention
              path's, and planted attention faults are not
  serve_lanes the same parts behind two run_node --stage-lanes 8 --paged-kv 32
              processes (their decode dispatches graphed); 8 ChainClient
              sessions run CONCURRENTLY, greedy.
              Checks: every stream completes; per node, paged_decode_gqa
              launches = 14 x its decode dispatches, of which split ones =
              14 x the dispatches whose table width (/stats
              executor.decode_widths) paged_plan splits, flash_gqa launches =
              14 x its prefill dispatches (all on the tensor cores), and the
              mean co-batch is above 1; every decode dispatch a graph
              capture or replay; the streams equal two in-process eager
              lane executors' over the same parts; the planted frozen-fill
              fault breaks that on graphed paged lane executors;
              teacher-forced, the kernel path stays near the plain
              attention path on the paged and on the dense lane layout, and
              planted paged-attention faults do not; TTFT and tok/s
  serve_swarm the relay topology on the serve parts: run_node processes that
              join by gossip (--gossip-port, --bootstrap): a stage-0 seed and
              two stage-1 replicas A and B (one-session, graphed), driven by
              the port's SwarmClient through the seed, which relays each chunk
              to a replica it picks (session affinity, else min load) and
              unwinds the logits. Checks: the serve prompts one after another
              and then all at once, token-exact against the serve phase's
              chain streams; each session's stage-1 passes on one replica,
              both replicas serving the concurrent ones; flash_gqa routes
              exact and every decode step a capture or replay on each node;
              a stage-1 envelope posted to the seed is relayed and answered;
              eight sessions at once, four routed by their clients to each
              replica, grow to the top KV bucket and each node's idle
              buffers stay within the pool's byte bound, every node
              releasing some (/stats executor.buffers beside the device
              memory reserved); replica B
              killed with no tombstone: two new sessions complete on A,
              token-exact, with one dead hop counted, and B's record leaves
              the seed's view within the TTL; a relay-mode --stage-lanes pair,
              started from a manifest written by the port's to_yaml
              (--manifest, --name) and bootstrapped to a tools/seed process
              whose view must list both, serves the serve_lanes traffic
              token-exact with every launch accounted for per node, its
              stage 0 relaying each window's decode steps as one coalesced
              POST (hop.coalesced >= 1, stage 1's multi envelopes and frames
              equal to stage 0's coalesced POSTs and sessions, no fallback,
              POSTs per session decode step printed), then the cli phase's
              tools/send --entry through it; every node's wire codec
              native; a 3-stage --backend counter swarm answers state 3,
              trace [0, 1, 2]; the per-token latency of relay against chain
              on the seed and A, in interleaved pairs of 8- and 32-token runs
              (utils.profiling.paired_delta_stats)
  serve_overload
              the relay's overload plane on the serve parts: stage-0 entries
              E0, E1 and E2 (--chaos delay_ms=400), stage-1 replicas R1 (a
              paged lane node whose small pool two resident sessions put
              under its --admission-reserve) and R2 (--capacity 1), and four
              counter stages (a seed hedging with --hedge-mode any, a sound
              and a stalled --chaos stall_p=1 stage-1 replica). Checks: a
              spent deadline answers 408 at E0's entry, no node computing;
              one that expires in E2's compute answers 408 post-compute,
              nothing relayed; R1's residents' decode steps are served while
              its record gossips shed: 1; the serve prompts at once through
              E0: R1 sheds new sessions (503 busy, retry_after in (0.05, 5])
              and the client's restarts land them on R2, every stream the
              serve phase's chain stream; a session that fails over from E0
              to E1 is rescued chunk by chunk to E0 through its gossiped
              `sess` (each an E0 graph replay), token-exact; E0 killed
              mid-session: E1's rescue fails, 409, one restart, token-exact,
              within 15 s of the kill (E1's rescue.bounce_ms printed);
              the relay per token with a deadline on every envelope against
              without (paired_delta_stats); on the counter stages, hedges win
              over the stall within the 5% budget, then a 300 ms deadline
              toward it answers 408 in time; no model node hedges; launches
              exact per node for the steps each served, every decode step a
              capture or a replay
  serve_elastic
              rebalancing and drain on the serve parts: four one-session
              graphed nodes, A0 and A1 on stage 0, B and C on stage 1, each
              with --rebalance-period 2 (its balancer live) and --capacity 16
              (four sessions at once never reach the balancer's imbalance
              threshold, so only the phase's own moves happen). Checks: the
              serve prompts through A0 in turn and at once, token-exact, B
              and C both serving; POST /drain to C after 3 tokens of a
              session through A0 routed to C: ok, draining, resident 1,
              handed_off 1 (C's drain.handed_off, B's sessions.imported), C
              served the passes before the drain and B, through C's rescue,
              the rest, token-exact with no client restart; a new session's
              envelope to C answers 503
              "draining" with Retry-After; A0's view shows C draining: 1;
              four new sessions through A0 all go to B; C stops (a
              tombstone); after a chain session through A1 and B, and 3
              tokens of a session entering A1 (stage 0, routed to B), POST
              /reassign {"stage": 1} to A1, which hands
              the session to A0 (A0 serves the rest, token-exact, no client
              restart): stage 1, migrations 1, one
              reshard.ms_to_serving (load, warm-up and release times and the
              allocator's bytes before the load, after the warm-up and after
              the release printed), the release freed at least 0.9 x its old
              stage's weights and its allocated bytes less its KV buffers
              are within ELASTIC_MEMORY_MARGIN of B's; A0's view shows stage
              1 = {B, A1}; a session pinned to A1 through A0, token-exact
              (its svc_ms then a stage-1 time); four sessions at once through
              A0 token-exact on B and A1, A1's decode steps (and its warm-up's) captures or
              replays; A0 killed (SIGKILL): once its record leaves B's and
              A1's views, the serve prompts through the smaller id of the two
              as stage-0 envelopes: exactly that node adopts stage 0 (its
              balancer's tick or the relay's empty-stage hook; stage.adopt.*
              printed), the other stays on stage 1, token-exact; the seconds
              from the kill to the adoption and to the first token; every
              node's flash_gqa launches = 14 x (its forward passes + 2 per
              migration, the warm-up's first chunk and decode step)
  serve_quant_int8, serve_quant_int4
              the serve prompts of 16 and 700 tokens (ENGINE_PROMPT_LENS:
              the 16-row prefill takes the GEMVs' tensor-core route), 32
              greedy tokens each, on two run_node --quant int8 (then int4)
              processes: streams equal in-process quantized executors'; the
              GEMV kernels' launches exact on both nodes (7 per layer on
              every pass of at most 64 rows, plus the head on the last
              stage), per route as qgemv_plan routes each; teacher-forced,
              the kernel path near the plain-GEMV path and planted GEMV
              faults not; TTFT and tok/s beside serve's
  serve_lanes_quant
              the serve_lanes traffic on --quant int8 lane nodes (every
              decode GEMV at 8 rows), with the same checks on the paged
              lanes
  lora        the fused LoRA lane delta (fused_lane_delta, csrc/lora_delta.cu)
              against its plain version at Qwen3-0.6B's seven projections:
              decode (8 lanes on slots 1,2,3,0,1,2,3,0) at ranks 16 and 64,
              prefill (1 lane, S 256 and 1000) on gate and down, f32, ranks
              1 and 33, and every lane on the base slot (exact zeros); five
              planted faults every case; each line prints ops.lora.lora_plan;
              timed with inputs cold in L2 beside a gather + torch.bmm
              yardstick and the bound. Then the y= mode (the residual add in
              the epilogue) at decode and prefill, bf16: bit-identical to
              (y.float() + delta).to(y.dtype), in place too, base lanes equal
              to y, one launch; timed in place beside the four-launch
              sequence it replaces
  serve_lanes_lora
              three synthetic peft tenants at full width (written from a
              seed by ops.lora.save_adapter) behind two --stage-lanes 8
              --paged-kv 32 --adapters nodes; the serve_lanes traffic with
              the 8 sessions bound round-robin to t0, t1, t2 and the base
              model. Checks: streams equal in-process executors with the
              same registries; tenants' streams differ from the base's and
              base sessions' equal serve_lanes'; teacher-forced, the kernel
              path near the plain-delta path and planted delta faults not;
              base lanes of mixed windows bit-identical to an executor
              without a registry; exact launch counts (98 per dispatch that
              carries a tenant lane, none for all-base dispatches; paged split
              launches as in serve_lanes); 3 loads per node
  serve_tenant_routes
              the adapter plane across nodes: 3 fresh --stage-lanes 8
              --paged-kv 32 --adapters t0,t1,t2 processes (a stage-0 entry,
              stage-1 replicas A and B) bootstrapped to a tools/seed
              process. t0 is warmed on B through a fixed chain (entry, B),
              one session on each t0 prompt (and up to 3 more while B's
              gossiped svc_ms, a fresh process's graph captures in its
              EWMA, still outweighs the affinity bonus); once the entry's
              gossip shows B's `ada` holding t0 and A's `[]`, and a t0
              plan's first-stage cost is lower at B, 4 new t0 sessions run one after another through a
              SwarmClient at the entry, each planned by the entry with t0's
              AdapterAffinity. Checks: every such route (the entry's /stats
              routes) names B; A loads no adapter and launches no
              fused_lane_delta, B and the entry do; the t0 streams equal
              serve_lanes_lora's t0 streams on the same prompts; a base
              session after them is planned by cost alone (to A, whose
              record carries no svc_ms) and its stream equals serve_lanes';
              exact launch counts per node as in serve_lanes_lora
  serve_sessions
              sessions that move, on fresh processes after
              serve_tenant_routes' stop: a swarm of one-session graphed nodes
              S0 (stage 0, the seed, the default hedge mode), S1a and S1b (stage
              1), and two
              whole-model --batch-lanes 8 --paged-kv 32 nodes P and Q.
              Checks: four prompts extending a 300-token prefix pinned by a
              SwarmClient fork on both stages (fork.ok 4 on S0 and S1a) and
              prefill only their suffix, token-exact against the same
              prompts unpinned (the time to the first token of both
              printed); after the pin's /end_session a fork misses
              (fork.miss 1), the pin drops and the prompt prefills in full,
              token-exact; generate_ids_disaggregated through S1a hands the
              session's stage-1 KV to S1b (/export_session), which decodes
              on token-exact (handoff.bytes and handoff.ms printed); POST
              /generate on S0 with pin_prefix_len 300, plain and streamed,
              and tools/send --server-side --pin-prefix-ids (a subprocess,
              exit 0) give the same streams, forked on the node's one pin;
              S1b stopped (SIGTERM) after 4 tokens of a session it holds
              hands it to S1a, token-exact with no client restart; on P, a
              288-token pinned prefix and four forks prefill only the pin
              and the suffixes, token-exact against Q's unforked streams; a
              fork of a P session with a partial tail block, stepped in
              lockstep with its parent, gives bit-equal logits (its tail's
              copy lands before its first graphed step); a session prefilled
              on P and exported to Q decodes on Q token-exact. Every node's
              flash_gqa launches (split: its decode steps, mma: its prompt
              chunks, x 14 layers on the swarm, x 28 on P and Q) and
              paged_decode_gqa launches (28 x its decode dispatches, the
              split ones by paged_plan) exact; every decode step a capture
              or a replay
  serve_standby
              crash-tolerant sessions, on fresh processes after
              serve_sessions' stop: one-session graphed nodes S0 (stage 0)
              and R1a, R1b, R1c (stage 1), all run_node --standby-repl
              --repl-interval 0.05 (three stage-1 replicas: each case kills
              one, and a standby must outlive both). The 300-token serve
              prompt, 32 greedy tokens through a SwarmClient into S0 with
              stage 1 routed to a chosen replica: unkilled on R1a (the
              reference), 4 tokens on R1b and on R1c (a standby has served
              before, as a live replica has), then (a) routed to R1a, SIGKILLed after 8 tokens once its
              standby's shadow (/stats repl.shadows) reaches the committed
              slots: token-exact, 0 restarts, the standby's repl.promotions
              1 and repl.resumed_tokens the frontier, no offer; (b) routed
              to another replica, SIGSTOPped at each token from the 8th on
              until its standby's frontier F lags the committed pos, then
              SIGKILLed: the step at pos answers 409 with resume_from F, the
              client re-sends the pos - F tokens once and goes on (the steps
              after the kill checked), repl.offers 1, repl.tail_tokens pos -
              F, one promotion, 0 restarts, the logits after the kill within
              5% of max |logit| of the reference's and the stream
              token-exact but where the reference's top-2 gap is inside that
              tolerance (the least gap printed). Between the cases, in this
              process, two paged --batch-lanes executors (bs 32, eager): the
              deltas ship full blocks only, realign a foreign frontier, and
              concatenate to export_sessions' payload bit for bit; the
              StandbyStore's payload imported into the second continues 8
              lockstep steps bit-equal to the unmoved lane, paged_decode_gqa
              launches exact. Printed: kill to the next token beside
              serve_overload's kill to the restart's first token, the
              holder's repl.ships and repl.bytes, its first ship's bytes and
              ms, repl.lock_ms (the session lock held per delta export) and
              repl.export_ms (the export with its lock wait), decode
              ms/token before the kill.
              Every node's flash_gqa launches exact per route (from the
              steps it computed), every decode step a capture or a replay
  generate    the whole model in this process (the serve checkpoints joined,
              bf16) through core.generate.Engine, whose decode steps and
              K-step windows replay captured CUDA graphs: on the serve
              prompts of 16 and 700 tokens (ENGINE_PROMPT_LENS; 32 new
              tokens), generate at chunk 1 and at chunk 8 and
              generate_scan give the same tokens, greedy and under the
              default sampling config (0.6/20/0.95) with one seed, and equal
              the eager step function's (no graph, the same kv bounds) bit
              for bit; flash_gqa launches exact per route, counted per
              replay (28 tensor-core launches per prefill, 28 split-KV per
              decode step); each engine's graph_stats, replays at least 4
              per capture; a planted fault (a fused window's later steps
              write their K/V one slot early) breaks the chunk equality;
              teacher-forced prefill + 8 decode steps within 5% of max
              |logit| of plain attention; the greedy stream's shared prefix
              with serve's chain stream (printed); bench.py's headline regime
              (64-token prompt, 50 and 150 steps in interleaved pairs via
              utils.profiling) for generate_scan, generate(chunk=1) and
              generate(chunk=8): steady ms/token, e2e tok/s, fixed overhead,
              the roofline share of the steady ms/token (perf.roofline, the
              h100 row); one decode step's device time against its host time
              (torch.profiler), graphed and eager, and the sampler's device
              time per call
  generate_quant
              the same engine on --quant int8 weights (the same two
              prompts): chunk 8 equals chunk 1,
              greedy; w8a16 launches exact per route (7 x 28 + 1 per decode
              step, all simt); the headline regime's generate_scan
  generate_batched
              core.batch.BatchedEngine, 8 lanes of the whole model in this
              process (max_len 2048), on twelve prompts (the serve four and
              the serve_lanes eight, 16-1000 tokens, so lanes refill), 32
              tokens each, greedy and sampled (0.6/20/0.95) at chunk 1 and 8:
              chunk 8 gives chunk 1's tokens; greedy sequences equal the solo
              Engine's (seed + index), and every sequence equals itself
              decoded alone in the batched engine (the sampled ones' shared
              prefix with the solo engine's is printed); flash_gqa launches
              exact per route, counted per replay; every window a capture
              or a replay, at least 4 replays per capture; aggregate tok/s,
              and one co-batched step's host and device time beside the solo
              engine's step (device_share); then python -m
              inferd_tpu_torch.tools.generate --engine batched --lanes 4
  serve_batch whole-model lane nodes on a one-stage checkpoint of the same
              weights: run_node --batch-lanes 8 (dense) and --batch-lanes 8
              --paged-kv 32 --prefill-chunk 256 take the serve_lanes traffic
              (8 concurrent greedy ChainClient sessions): streams equal
              generate_batched's, mean co-batch above 1, every decode
              dispatch a capture or a replay, launches exact per route
              (paged: paged_decode_gqa per replay and its split launches);
              then decode_steps 8 windows of the serve prompts at once on
              both and on a whole-model --stage-lanes 8 --paged-kv 32 node,
              equal to one token per step; a --batch-lanes 4 --adapters
              t0,t1,t2 node, whose tenant streams leave the base model's and
              whose graphed tenant K-step windows equal an eager in-process
              executor's; a planted frozen-fill fault in graphed paged
              K-step windows must leave the eager stream
  serve_kstep one run_node --device cuda process serving a one-stage split of
              the same model, driven by raw /forward payloads: a prefill, then
              decode_steps 8 windows up to 32 tokens, greedy and sampled, eos
              set to the free run's token 5 (a window stops mid-way); tokens,
              real_len, decode_steps and key of the node's graphed windows
              equal the in-process eager executor's; /stats launches exact,
              every window a capture or a replay; stage 0 of the two-stage
              chain answers
              decode_steps with 409 session_state ("single-stage")
  serve_fp8   one greedy request (the 300-token serve prompt, 32 tokens) to a
              one-stage run_node --kv-dtype float8_e4m3fn node: token-exact
              against the same executor in this process with fp8 KV and its
              graphs off; flash_gqa launches exact per route, every decode
              step a capture or a replay
  anatomy     perf.anatomy.profile_step on the whole model at the headline
              regime's context: bf16, --quant int8 and paged (bs 32): each
              phase's device ms (short and long loops of it captured as
              graphs, replayed in interleaved pairs), bytes and bound, the
              graphed whole step, the unattributed residual and dispatch
              (the eager host-driven step minus the graphed one); each
              case's kernels must launch
  profile     the serve split behind two run_node --enable-profiling
              processes: after a warm-up request, one node at a time, POST
              /profile window on it and one greedy request (a prefill and 8
              decode steps) inside it (two processes tracing the card at
              once leave the first trace empty); each node's
              torch.profiler trace must hold the requests
              and the card's kernels, and its host time is split
              (utils.profiling.host_time_split): HTTP, wire pack/unpack,
              the compute lock, the executor, the layers (and their Python
              alone), the kernel wrappers' checks and launch, the graph
              replays, the results' .cpu(); each node replayed its graphs
  serve_llama the Llama-3 family from an HF checkpoint, after cli (no other
              node process up; the card's free memory printed): Llama-3.2-1B
              (full width, 16 layers, tied head) drawn from a seed on the
              card and written with HF's names, [out, in], bf16, in two
              safetensors shards under an HF cache layout (snapshots/<rev>,
              refs/main; bytes and seconds printed); tools/split_model
              --weights <snapshot> --device cuda, whose stage files must equal
              an in-process split of the drawn params byte for byte; the serve
              checks on its two run_node --device cuda stages (8 + 8 layers):
              the serve prompts of 100 and 700 tokens, 32 greedy tokens each,
              flash_gqa launches exact per node and route,
              every decode step a capture or a replay, the streams equal the
              in-process eager executors', teacher-forced within HIDDEN_TOL and
              LOGIT_TOL of plain attention with E2E_FAULTS caught, TTFT,
              tok/s and a stage step's host and device ms; tools/generate
              --model llama3.2-1b without --random-init (HF_HOME the cache),
              its ids equal an Engine over load_params of the snapshot (its
              shared prefix with the chain's stream printed); then
              Llama-3.1-8B's width (hidden 4096, 32 / 8 heads, intermediate
              14336, untied head) cut to 4 layers: its checkpoint loaded to the
              card equals the drawn params, the graphed Engine's greedy stream
              of the 100-token prompt equals the eager one with flash_gqa
              launches exact, and teacher-forced it holds the same gates
  serve_moe   mixture-of-experts models, after serve_llama (no other node
              process up): Qwen3-30B-A3B at its published width (hidden
              2048, 32 / 4 heads x 128, 128 experts top-8 x 768, vocab
              151936, untied head) cut to 6 of its 48 layers, drawn from a
              seed on the card and written with Qwen3-MoE's names
              (mlp.gate, mlp.experts.{e}.{gate,up,down}_proj), bf16, in 4
              safetensors shards under an HF cache layout (parameters and
              bytes printed); one MoE layer's graphed time at a decode row
              beside its roofline bound (the router and the 8 active
              experts) and the bytes dense dispatch reads (every expert);
              tools/split_model --weights --num-layers 6: both stage files
              (3 + 3 layers, each expert stack 1.2 GB, flax's chunked form)
              equal the in-process split byte for byte; the serve checks on
              two run_node --device cuda stages with prompts of 100 and 700
              tokens and 16 greedy tokens each (launches exact per node and
              route, every decode step a capture or a replay, streams equal
              the eager executors', teacher-forced within HIDDEN_TOL and
              LOGIT_TOL of plain attention with E2E_FAULTS caught);
              tools/generate --num-layers 6 without --random-init gives the
              chain's ids; in process at 3 layers: paged lane executors
              (bs 32) serve four co-batched sessions graphed equal to eager
              with paged and flash launches exact, teacher-forced against
              plain attention with LANE_E2E_FAULTS caught, and --quant int8
              and int4 Engines (GEMV launches exact per route) teacher-forced
              against the explicitly dequantized Engine; then Mixtral-8x7B's
              width (hidden 4096, 32 / 8 x 128, 8 experts top-2 x 14336,
              vocab 32000) cut to 2 layers, drawn on the card: its MoE layer
              timed, and a 300-token prompt's graphed stream equal to eager
  cli         python -m inferd_tpu_torch.tools.generate --model qwen3-0.6b
              --random-init --prompt-ids ... --max-new-tokens 16 --chunk 8 as a
              subprocess, on the card by default: exit 0, 16 ids; and (inside
              serve_swarm, while its lane pair serves) python -m
              inferd_tpu_torch.tools.send --entry against it: exit 0 and the
              pair's greedy stream

Balancers: every node runs one (run_node's default --rebalance-period 10).
The swarms with a stage of two or more replicas, serve_swarm's one-session
swarm, serve_overload's two, serve_sessions' and serve_standby's, take
--rebalance-period 3600, longer than their phase: a tick that read a transient load skew (an entry's in-flight
requests gossiped before its replicas') could move a replica mid-phase and
break the phase's per-node pass counts. The other phases' layouts cannot
move: one replica per stage (a balancer never leaves its stage's last
replica), and the two-node chains of the serve, lane, quant, profile and
whole-model phases do not even share a gossip view. Every phase's nodes but
serve_elastic's read `migrations` 0 in /stats when the phase stops them.

Then a `wire` line (the codec's times and the lane pair's coalesced
relay counts as JSON), one JSON line listing every kernel, the nvidia-smi
line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run from the root of a checkout: python3 chip_smoke.py
Exits non-zero without a CUDA device, and outside a checkout.
`--only paged,lora` (any of flash, paged, qmm, lora, codec, sim, and on a fresh
split serve, serve_quant, serve_lanes, serve_lanes_quant, serve_lanes_lora,
serve_tenant_routes, serve_sessions, serve_standby,
serve_swarm, serve_overload, serve_elastic, generate, generate_batched,
serve_batch, serve_kstep, serve_fp8, anatomy, profile, serve_llama, serve_moe: serve_quant
runs int8 and int4, serve_lanes_lora runs serve_lanes first, serve_tenant_routes runs
serve_lanes and serve_lanes_lora first, serve_swarm runs serve and
serve_lanes first, serve_overload and serve_elastic run serve first, generate
runs the generate and generate_quant phases, serve_batch runs
generate_batched first, serve_llama and serve_moe write their own
checkpoints and need no Qwen split) builds the kernels and runs those phases alone, with no result
lines.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import random
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # main() runs only on the card
MODEL = "qwen3-0.6b"

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_FLUSH_BYTES = 128 << 20  # read before each cold timed call: > 2x the H100's 50 MB L2

# flash_gqa against its plain version, on the same inputs. The error of a
# case is read per output row (one query head at one position: D values),
# scaled by that row's RMS in the plain version, and the worst row counts:
# max |kernel - plain| / rms(plain row). An attention row shrinks as
# 1/sqrt(slots attended) (RMS ~0.009 over 32768 slots of N(0, 1) values),
# so one absolute limit would be loose on long rows and tight on short
# ones; this holds each row to its own size. A row the plain version
# leaves at exactly zero (nothing to attend) must be exactly zero. The
# limit sits between the sound kernel's readings and those of planted
# faults (FAULTS), which every run measures beside it (PERF.md has both).
ATTN_TOL = {"bfloat16": 0.05, "float32": 1e-4}
TILE = 64  # the planted fault's skipped kv block (the tensor-core route's tile, kMmaTile)
# Planted faults: the kernel run on inputs that reproduce what a wrong
# kernel would compute. A case lists under `blind` the faults that cannot
# change its answer beyond bf16 noise, with the reason beside the case.
FAULTS = ("zeros", "kv_heads_rolled", "last_tile_skipped", "causal_off_by_one")
CASES: List[Dict[str, Any]] = [
    dict(name="prefill_512", s=512, t=512, q_start=0, kv_len=512, stream=False),
    dict(name="chunk_188_at_512", s=188, t=1024, q_start=512, kv_len=700, stream=False),
    # decode: kv_len = q_start + 1 already ends the row, so a causal
    # frontier one slot late changes nothing
    dict(name="decode_T4096", s=1, t=4096, q_start=4095, kv_len=4096, stream=False,
         blind=("causal_off_by_one",)),
    dict(name="main_decode_T1024", s=1, t=1024, q_start=731, kv_len=732, stream=False,
         blind=("causal_off_by_one",)),
    dict(name="long_decode_T32768", s=1, t=32768, q_start=32767, kv_len=32768, stream=True,
         blind=("causal_off_by_one",)),
    dict(name="long_chunk_256_T32768", s=256, t=32768, q_start=32512, kv_len=32768,
         stream=True),
    dict(name="window_256", s=128, t=1024, q_start=512, kv_len=640, window=256, stream=False),
    dict(name="softcap_scale", s=64, t=512, q_start=200, kv_len=264, softcap=50.0,
         scale=1.0 / 16.0, stream=False),
    dict(name="sinks", s=64, t=512, q_start=200, kv_len=264, sinks=True, stream=True),
    dict(name="fp8_kv", s=64, t=512, q_start=200, kv_len=264, fp8=True, stream=False),
    dict(name="ragged_b4", b=4, s=16, t=256, q_start=[0, 50, 100, 200],
         kv_len=[16, 0, 116, 216], stream=False),
    dict(name="f32", s=64, t=256, q_start=100, kv_len=164, dtype="float32", stream=False),
    # the route boundary: 8 positions x 2 heads = 16 packed rows is the
    # split-KV route's row tile; 9 positions (18 rows) take the tensor cores
    dict(name="route_rows_16", s=8, t=1024, q_start=700, kv_len=708, stream=False),
    dict(name="route_rows_18", s=9, t=1024, q_start=700, kv_len=709, stream=False),
    # decode over many splits: sinks fold once, after the splits merge (this
    # and the next two decode cases are blind to causal_off_by_one as above:
    # each row's kv_len already ends at its query)
    dict(name="decode_sinks_split", s=1, t=4096, q_start=4095, kv_len=4096, sinks=True,
         stream=False, blind=("causal_off_by_one",)),
    # the window floor (slot 2000) falls inside a split
    dict(name="decode_window_split", s=1, t=4096, q_start=2999, kv_len=3000, window=1000,
         stream=False, blind=("causal_off_by_one",)),
    # a dense-lane decode step: per-lane spans from device meta, one lane empty
    dict(name="dense_lanes_decode_b8_T4096", b=8, s=1, t=4096,
         q_start=[16, 0, 229, 700, 999, 2047, 3099, 3999],
         kv_len=[17, 0, 230, 701, 1000, 2048, 3100, 4000], stream=False,
         blind=("causal_off_by_one",)),
    # the lanes' real prefill dispatch: 256 positions over the gathered T 1024
    # view, spans from device meta
    dict(name="lanes_chunk_256_T1024", s=256, t=1024, q_start=[444], kv_len=[700], stream=False),
    # the one-session path's first 512-token chunk in its T 1024 buffer
    dict(name="session_chunk_512_T1024", s=512, t=1024, q_start=0, kv_len=512, stream=False),
]
QWEN_HEADS = (16, 8, 128)  # (Nq, Nkv, D) of Qwen3-0.6B: every case above
# The Llama-3 heads (serve_llama): Llama-3.2-1B's (32, 8, 64) and
# Llama-3.1-8B's (32, 8, 128), a GQA group of 4. Per head shape: the decode
# main case, the lanes' chunk, and the route boundary, which moves with the
# group: 4 positions x 4 heads = 16 packed rows still split KV, 5 (20 rows)
# take the tensor cores.
LLAMA_HEADS = {"d64g4": (32, 8, 64), "d128g4": (32, 8, 128)}
CASES += [dict(c, name=f"{c['name']}_{tag}", heads=heads)
          for tag, heads in LLAMA_HEADS.items() for c in (
              dict(name="main_decode_T1024", s=1, t=1024, q_start=731, kv_len=732,
                   stream=False, blind=("causal_off_by_one",)),
              dict(name="lanes_chunk_256_T1024", s=256, t=1024, q_start=[444], kv_len=[700],
                   stream=False),
              dict(name="route_rows_16", s=4, t=1024, q_start=700, kv_len=704, stream=False),
              dict(name="route_rows_20", s=5, t=1024, q_start=700, kv_len=705, stream=False))]
# Qwen3-30B-A3B's heads (serve_moe): 32 q / 4 kv x 128, a GQA group of 8,
# the first run of G 8 on the card. The decode step packs 8 rows per kv
# head into the split route's tile; the route boundary: 2 positions x 8
# heads = 16 packed rows split KV, 3 (24 rows) take the tensor cores.
MOE_HEADS = {"d128g8": (32, 4, 128)}
CASES += [dict(c, name=f"{c['name']}_{tag}", heads=heads)
          for tag, heads in MOE_HEADS.items() for c in (
              dict(name="main_decode_T1024", s=1, t=1024, q_start=731, kv_len=732,
                   stream=False, blind=("causal_off_by_one",)),
              dict(name="lanes_chunk_256_T1024", s=256, t=1024, q_start=[444], kv_len=[700],
                   stream=False),
              dict(name="route_rows_16", s=2, t=1024, q_start=700, kv_len=702, stream=False),
              dict(name="route_rows_24", s=3, t=1024, q_start=700, kv_len=703, stream=False))]
# the route each head shape's boundary cases must take (flash_plan's)
ROUTE_CASES = {"route_rows_16": "split", "route_rows_18": "mma", "route_rows_20": "mma",
               "route_rows_24": "mma"}
OTHER_HEADS = dict(LLAMA_HEADS, **MOE_HEADS)  # beside Qwen3-0.6B's, on the kernels line
MAIN_CASE = "main_decode_T1024"  # the serve phase's decode step: T = 1024 bucket
LANES_CHUNK_CASE = "lanes_chunk_256_T1024"  # a lane node's prefill dispatch (tensor cores)

PROMPT_LENS = (16, 100, 300, 700)
NEW_TOKENS = 32
MAX_LEN = 4096
# The kernel path against the plain-attention path (attn_impl="xla"), both
# teacher-forced over the same tokens: every prompt chunk, then the first
# DECODE_CHECKED decode steps of each served stream. Read at each step: the
# last stage's hidden state on every real row (row_rel_err over the hidden
# width) and the last real token's logits (max |diff| / max |plain logit|).
# 28 bf16 layers compound the kernel's other bf16 rounding of p, so a sound
# kernel reads well above the kernel phase's single-call noise; the limits
# sit between those readings and the planted faults' (E2E_FAULTS, measured
# every run beside them; PERF.md has both).
DECODE_CHECKED = 8
HIDDEN_TOL, LOGIT_TOL = 0.5, 0.05
E2E_FAULTS = ("kv_heads_rolled", "last_tile_skipped", "causal_off_by_one")

# paged_decode_gqa against its plain version: the same per-row rule and
# limits as flash_gqa (ATTN_TOL). Pools [NB, 32, 8, 128] with each lane's
# chain shuffled through them, garbage in the scratch block 0, the table
# stamped at the chain_clamp width (the power-of-two bucket of the longest
# chain), and each lane's query at position kv_len - 1 (a decode step).
# Planted faults, each the kernel run on inputs that reproduce what a wrong
# kernel would compute: the table read one chain slot late, the walk run
# one block past the chain into the scratch block, the last chain block
# skipped, K/V of the wrong kv head.
PAGED_FAULTS = ("table_shifted", "scratch_scored", "last_block_skipped", "kv_heads_rolled")
PAGED_BS = 32
PAGED_CASES: List[Dict[str, Any]] = [
    dict(name="paged_main_b8_bs32", kv_len=[17, 60, 101, 230, 301, 480, 701, 1000], nb=1025),
    # the chain fills the whole table, so there is no block past it to score
    dict(name="paged_long_b1_4096", kv_len=[4096], nb=129, blind=("scratch_scored",)),
    dict(name="paged_zero_lane", kv_len=[0, 300], nb=64),
    dict(name="paged_window_128", kv_len=[230, 701], window=128, nb=64),
    dict(name="paged_softcap_scale", kv_len=[230, 701], softcap=50.0, scale=1.0 / 16.0, nb=64),
    dict(name="paged_sinks", kv_len=[230, 701], sinks=True, nb=64),
    dict(name="paged_fp8", kv_len=[230, 701], fp8=True, nb=64),
    dict(name="paged_f32", kv_len=[230, 701], dtype="float32", nb=64),
    # one long session among short ones: the imbalance a split chain removes
    dict(name="paged_b8_one_long", kv_len=[4096, 17, 60, 101, 150, 230, 260, 300], nb=200),
    # the main case at Llama-3.2-1B's heads (D 64, a group of 4)
    dict(name="paged_main_b8_bs32_d64g4", kv_len=[17, 60, 101, 230, 301, 480, 701, 1000],
         nb=1025, heads=LLAMA_HEADS["d64g4"]),
    # and at Qwen3-30B-A3B's (D 128, a group of 8: the wrapper's largest)
    dict(name="paged_main_b8_bs32_d128g8", kv_len=[17, 60, 101, 230, 301, 480, 701, 1000],
         nb=1025, heads=MOE_HEADS["d128g8"]),
]
PAGED_MAIN_CASE = "paged_main_b8_bs32"

# serve_lanes: 8 concurrent sessions through two --stage-lanes nodes
LANES = 8
LANE_PROMPT_LENS = (16, 60, 100, 200, 300, 450, 700, 1000)
LANE_PREFILL_CHUNK = 256  # server-side chunks of the client's 512-token chunks
LANE_NODE_ARGS = ["--stage-lanes", str(LANES), "--paged-kv", str(PAGED_BS),
                  "--prefill-chunk", str(LANE_PREFILL_CHUNK), "--window-ms", "2"]
DENSE_LANE_PROMPTS = (16, 100, 300, 700)  # the dense-lane layout's teacher-forced prompts
LANE_E2E_FAULTS = ("table_shifted", "last_block_skipped")

# The decode GEMVs (csrc/qmatmul.cu) against their plain versions: the same
# per-row rule as attention (row_rel_err over an output row of N values),
# with the same limits. Cases: Qwen3-0.6B's projections [K, N] at the main
# path's row counts (1: one session; 8: the lanes; 64: the largest that
# takes the kernel), the tied head's shadow at 1 and 8 rows, an f32 case, a
# ragged N (a partial last tile; and N % 8 != 0, the single-byte loads) and
# an odd K (int4 one value per byte). Each case runs w8a16 and w4a16 under
# both schemes. Planted faults, each what a wrong kernel would compute:
# the scale of the neighbouring column, the nibbles of each byte swapped
# (packed int4 only), the weight bytes zero-extended instead of sign-
# extended, the last ring stage of the last rank (the plan's stage_k
# values) skipped, the last column tile (the plan's block_n columns)
# skipped, the group index one too high (int4 with more than one group),
# and in the cluster's reduction rank 1's partial dropped or the last
# rank's partial added twice (split K only). The stage, tile and ranks come
# from ops.qmatmul.qgemv_plan, so each fault is one a kernel of this design
# could make. A fault that cannot apply to a case reads null.
QMM_TOL = ATTN_TOL
QMM_FAULTS = ("scale_neighbour_column", "nibbles_swapped", "zero_extended",
              "last_k_chunk_skipped", "n_tail_skipped", "group_off_by_one",
              "rank_dropped", "rank_doubled")
# a stage step of one Qwen3-0.6B stage: 14 layers x the seven projections
QMM_STAGE_LAYERS = 14
QMM_PER_LAYER = {"q_proj": 1, "k_v_proj": 2, "o_proj": 1, "gate_up_proj": 2, "down_proj": 1}
QMM_SHAPES = {  # Qwen3-0.6B, hidden 1024, q 2048, kv 1024, intermediate 3072
    "q_proj": (1024, 2048), "k_v_proj": (1024, 1024), "o_proj": (2048, 1024),
    "gate_up_proj": (1024, 3072), "down_proj": (3072, 1024), "lm_head_q": (1024, 151936),
}
QMM_KERNELS = ("w8a16", "w4a16_grouped", "w4a16_dequant")
QMM_CASES: List[Dict[str, Any]] = (
    [dict(name=f"{s}_m{m}", shape=s, m=m) for s in QMM_SHAPES if s != "lm_head_q"
     for m in (1, 8, 64)]
    + [dict(name=f"lm_head_q_m{m}", shape="lm_head_q", m=m) for m in (1, 8)]
    + [dict(name="gate_up_proj_m8_f32", shape="gate_up_proj", m=8, dtype="float32"),
       dict(name="ragged_n1000_m8", k=1024, n=1000, m=8),
       dict(name="ragged_n333_m3", k=1024, n=333, m=3),
       dict(name="odd_k1023_m8", k=1023, n=1024, m=8)]
)
QMM_MAIN_CASE, QMM_LANE_CASE = "lm_head_q_m1", "gate_up_proj_m8"
# The quantized serve phases: the kernel path against the plain-GEMV path
# (the same executors with each GEMV wrapper's plain version), by the
# HIDDEN_TOL / LOGIT_TOL rule, and planted GEMV faults that must break it.
QUANT_E2E_FAULTS = ("last_k_chunk_skipped", "scale_neighbour_column")

# The fused LoRA lane delta (csrc/lora_delta.cu) against its plain version:
# the output is f32 and both sum the same f32 products in another order, so
# the per-row rule (row_rel_err over an output row of `out` values) holds it
# to 1e-4; rows of base-slot lanes must be exactly zero. Pools of LORA_SLOTS
# slots x LORA_LAYERS layers (a 14-layer stage) in the case's dtype, slot 0
# zero, N(0, 0.05) elsewhere; x N(0, 1). Planted faults, each the kernel run
# on inputs that reproduce what a wrong kernel would compute: each lane reads
# the next slot, the layer one too high, the scale skipped (read as 1), the
# last rank column skipped, the last S tile (LORA_S_TILE rows) skipped.
LORA_TOL = 1e-4
LORA_SLOTS, LORA_LAYERS, LORA_LAYER = 4, 14, 5
LORA_SCALES = (0.0, 2.0, 0.5, 1.25)  # slot 0 is the base adapter
LORA_S_TILE = 16  # kRows in csrc/lora_delta.cu
LORA_FAULTS = ("neighbour_slot", "layer_off_by_one", "scale_skipped",
               "last_rank_column_skipped", "last_s_tile_skipped")
LORA_SHAPES = {  # Qwen3-0.6B's projections [in, out]
    "q_proj": (1024, 2048), "k_proj": (1024, 1024), "v_proj": (1024, 1024),
    "o_proj": (2048, 1024), "gate_proj": (1024, 3072), "up_proj": (1024, 3072),
    "down_proj": (3072, 1024),
}
LORA_DECODE_IDS = [1, 2, 3, 0, 1, 2, 3, 0]
LORA_CASES: List[Dict[str, Any]] = (
    [dict(name=f"decode_{t}_r{r}", target=t, r=r, s=1, ids=LORA_DECODE_IDS)
     for r in (16, 64) for t in LORA_SHAPES]
    + [dict(name=f"prefill_s{s}_{t}_r16", target=t, r=16, s=s, ids=[1])
       for s in (256, 1000) for t in ("gate_proj", "down_proj")]
    + [dict(name="decode_gate_proj_r16_f32", target="gate_proj", r=16, s=1, ids=LORA_DECODE_IDS,
            dtype="float32"),
       dict(name="decode_q_proj_r1", target="q_proj", r=1, s=1, ids=LORA_DECODE_IDS),
       dict(name="decode_q_proj_r33", target="q_proj", r=33, s=1, ids=LORA_DECODE_IDS),
       # every lane on the base slot: exact zeros, so only a fault that
       # reads another slot can show
       dict(name="decode_gate_proj_all_base", target="gate_proj", r=16, s=1, ids=[0] * 8,
            blind=LORA_FAULTS[1:])]
)
LORA_MAIN_CASE, LORA_PREFILL_CASE = "decode_gate_proj_r16", "prefill_s256_gate_proj_r16"
# The y= mode (the residual add in the kernel's epilogue) at decode and at
# prefill, bf16: its output must equal the unfused (y.float() + delta).to(y.dtype)
# bit for bit, base lanes must equal y exactly, and it is held to the plain
# version's sum by the bf16 row rule (ATTN_TOL, its output being bf16); timed
# in place beside the four-launch sequence it replaces (delta, cast, add, cast).
LORA_Y_CASES: List[Dict[str, Any]] = [
    dict(name="y_decode_gate_proj_r16", target="gate_proj", r=16, s=1, ids=LORA_DECODE_IDS),
    dict(name="y_prefill_s256_gate_proj_r16", target="gate_proj", r=16, s=256, ids=[1]),
]
LORA_Y_MAIN_CASE = "y_decode_gate_proj_r16"
# serve_lanes_lora: three tenants over all 28 layers, (name, rank, targets),
# bound round-robin with the base model to the serve_lanes sessions
LORA_TENANTS = (("t0", 16, ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                            "down_proj")),
                ("t1", 8, ("q_proj", "v_proj")),
                ("t2", 32, ("gate_proj", "up_proj", "down_proj")))
LORA_TENANT_B_SD = 0.125  # B ~ N(0, (LORA_TENANT_B_SD / sqrt(r))^2), alpha = 2r (write_tenants)
LORA_E2E_FAULTS = ("neighbour_slot", "layer_off_by_one")


_T0 = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of the log: the phase, the seconds since the script started."""
    print(f"[{phase} {time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- timing -------------------------------------------------------------------


def time_ms(fn: Callable[[], Any], iters: int = 20, cold: bool = False) -> float:
    """Median device time of one call, from CUDA events around each call.
    The calls are enqueued behind a sleep kernel long enough to cover the
    host's enqueue time, so the device runs them back to back and the
    events bracket device work, not host launch gaps. With `cold`, a read
    of L2_FLUSH_BYTES runs before each call, outside its events, so the
    call finds none of its inputs in L2."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold else None

    def evict():
        if flush is not None:
            flush.sum()

    evict()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evict()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * max(0.02, 3 * per_call * iters)))
    for a, b in zip(starts, ends):
        evict()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


# -- kernels phase --------------------------------------------------------------


def row_rel_err(got, ref, width: int) -> float:
    """Worst row of max |got - ref| / rms(ref row), the outputs cut into
    rows of `width` values. A row that ref leaves at exactly zero reads 0
    if got is zero there too, else inf."""
    import torch

    g = got.float().reshape(-1, width)
    r = ref.float().reshape(-1, width)
    diff = (g - r).abs().amax(dim=1)
    rms = r.pow(2).mean(dim=1).sqrt()
    zero = rms == 0
    rel = torch.where(zero, torch.where(diff == 0, 0.0, math.inf), diff / torch.where(zero, 1.0, rms))
    return rel.max().item()


def _per_row(x, b):
    return list(x) if isinstance(x, (list, tuple)) else [x] * b


def roofline_kv_read(ctx: int, nkv: int, d: int, kv_item: int) -> int:
    """perf/roofline's KV read of ONE layer and one sequence at ctx cached
    tokens (decode_step_cost on a one-layer config with these heads)."""
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.perf import roofline as rl

    cfg = dataclasses.replace(get_config(MODEL), num_layers=1, num_kv_heads=nkv, head_dim=d)
    kv_dtype = {1: "float8_e4m3fn", 2: "bfloat16", 4: "float32"}[kv_item]
    return rl.decode_step_cost(cfg, kv_dtype=kv_dtype, ctx=ctx).kv_read_bytes


def work_of(case: Dict[str, Any], nq: int, nkv: int, d: int) -> Dict[str, float]:
    """Bytes and flops the case's data needs: Q read, O written, each K/V
    slot that some query attends read once; 4 * D flops per unmasked
    (query head, kv slot) pair (q.k and p.v). A decode row without a window
    attends its whole span, the roofline's KV read at ctx = that span, and
    takes its count from perf/roofline; a chunk's rows attend a causal
    triangle and a window a band, which the roofline does not model."""
    import torch

    b, s, t = case.get("b", 1), case["s"], case["t"]
    qs, kl = _per_row(case["q_start"], b), _per_row(case["kv_len"], b)
    win = case.get("window") or 0
    q_item = 4 if case.get("dtype") == "float32" else 2
    kv_item = 1 if case.get("fp8") else q_item
    kv_bytes = pairs = 0
    for r in range(b):
        qpos = qs[r] + torch.arange(s)[:, None]
        kpos = torch.arange(t)[None, :]  # kv_start 0 in every case
        m = (kpos < kl[r]) & (kpos <= qpos)
        if win > 0:
            m &= kpos > qpos - win
        pairs += int(m.sum())
        slots = int(m.any(dim=0).sum())
        if s == 1 and win == 0:
            kv_bytes += roofline_kv_read(slots, nkv, d, kv_item)
        else:
            kv_bytes += 2 * slots * nkv * d * kv_item
    nbytes = 2 * b * s * nq * d * q_item + kv_bytes
    flops = 4.0 * d * nq * pairs
    return {"bytes": nbytes, "flops": flops}


def plant_fault(fault: str, k, v, q_start, kv_len):
    """(k, v, q_start, kv_len) on which the sound kernel computes what a
    kernel with `fault` computes on the given ones: K/V of the wrong kv
    head, the kv tile holding the last valid slot skipped, or a causal
    frontier one slot late."""
    import torch

    if fault == "kv_heads_rolled":  # kv head h reads kv head h - 1's K/V
        k, v = (x.view(torch.uint8).roll(1, dims=2).view(x.dtype) for x in (k, v))
    elif fault == "last_tile_skipped":
        kv_len = (kv_len - 1) // TILE * TILE
        kv_len = kv_len.clamp(min=0) if torch.is_tensor(kv_len) else max(kv_len, 0)
    elif fault == "causal_off_by_one":
        q_start = q_start + 1
    else:
        raise ValueError(f"unknown fault {fault}")
    return k, v, q_start, kv_len


def run_kernel_cases() -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from inferd_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    results, failures = [], []
    for c in CASES:
        nq, nkv, d = c.get("heads", QWEN_HEADS)
        b = c.get("b", 1)
        dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16

        def rnd(*shape, dtype=dt):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q = rnd(b, c["s"], nq, d)
        k = rnd(b, c["t"], nkv, d)
        v = rnd(b, c["t"], nkv, d)
        if c.get("fp8"):
            k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
        sinks = rnd(nq, dtype=torch.float32) * 2.0 if c.get("sinks") else None
        q_start, kv_len = c["q_start"], c["kv_len"]
        if isinstance(q_start, list):
            q_start = torch.tensor(q_start, device=dev)
            kv_len = torch.tensor(kv_len, device=dev)
        kw = dict(stream=c["stream"], scale=c.get("scale"), softcap=c.get("softcap", 0.0),
                  window=c.get("window"), sinks=sinks)

        def kernel():
            return A.flash_gqa(q, k, v, q_start, kv_len, **kw)

        def plain():
            return A.flash_gqa_reference(q, k, v, q_start, kv_len, **kw)

        plan = A.flash_plan(b, c["s"], c["t"], nq, nkv, dt, q_start, kv_len, c.get("window"))
        counts = (A.flash_gqa.split_launches, A.flash_gqa.mma_launches)
        got = kernel()
        moved = {"split": A.flash_gqa.split_launches - counts[0],
                 "mma": A.flash_gqa.mma_launches - counts[1]}
        again, ref = kernel(), plain()
        torch.cuda.synchronize()
        if moved != {r: int(r == plan.route) for r in moved}:
            raise AssertionError(f"{c['name']}: route counts moved {moved}, plan {plan.route}")
        predicted = ROUTE_CASES.get(c["name"].rsplit("_d", 1)[0] if "heads" in c else c["name"])
        if predicted is not None and plan.route != predicted:
            raise AssertionError(f"{c['name']}: flash_plan routes it {plan.route}, predicted "
                                 f"{predicted}")
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
        err = (got.float() - ref.float()).abs().max().item()
        rel = row_rel_err(got, ref, d)
        tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]

        def planted(fault):
            if fault == "zeros":
                return torch.zeros_like(ref)
            return A.flash_gqa(q, *plant_fault(fault, k, v, q_start, kv_len), **kw)

        faults = {f: row_rel_err(planted(f), ref, d) for f in FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")

        library_ms = None
        if sinks is None and not c.get("softcap"):
            # SDPA on the same inputs with the kv heads expanded, as a yardstick
            g = nq // nkv
            qh = q.transpose(1, 2)
            kh = k.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
            vh = v.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
            qs_r = torch.as_tensor(c["q_start"], device=dev).reshape(-1, 1, 1)
            kl_r = torch.as_tensor(c["kv_len"], device=dev).reshape(-1, 1, 1)
            qpos = qs_r + torch.arange(c["s"], device=dev)[None, :, None]
            kpos = torch.arange(c["t"], device=dev)[None, None, :]
            mask = (kpos < kl_r) & (kpos <= qpos)
            if c.get("window"):
                mask &= kpos > qpos - c["window"]
            mask = mask[:, None]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=c.get("scale")), cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        w = work_of(c, nq, nkv, d)
        peak = PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
        t_bytes, t_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / peak
        row = {
            "case": c["name"], "stream": c["stream"], "B": b, "S": c["s"], "T": c["t"],
            "Nq": nq, "Nkv": nkv, "D": d, "route": plan.route, "splits": plan.splits,
            "ctas": plan.splits * plan.row_tiles * b * nkv,
            "dtype": str(dt).replace("torch.", "") + ("/fp8-kv" if c.get("fp8") else ""),
            "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("kernels", json.dumps(row))
        results.append(row)
    if failures:
        raise AssertionError("kernel cases failed:\n  " + "\n  ".join(failures))
    return results


def paged_work(kv_len, window: int, b: int, nq: int, nkv: int, d: int, q_item: int,
               kv_item: int) -> Dict[str, float]:
    """Bytes and flops one paged decode step needs: Q read and O written,
    each K/V row a query attends read once; 4 * D flops per (query head,
    attended slot). Each lane's query sits at kv_len - 1. Its own count:
    perf/roofline.paged_attn_step_bytes models the kernel's reads (whole
    blocks and one scratch block per lane, at one ctx for every lane), more
    than these lanes' data needs."""
    slots = 0
    for n in kv_len:
        qpos = max(n - 1, 0)
        lo = max(qpos - window + 1, 0) if window > 0 else 0
        slots += max(min(n, qpos + 1) - lo, 0)
    return {"bytes": 2 * b * nq * d * q_item + 2 * slots * nkv * d * kv_item,
            "flops": 4.0 * d * nq * slots}


def plant_paged_fault(fault: str, k_pool, v_pool, table, q_positions, kv_len):
    """(pools, table, q_positions, kv_len) on which the sound kernel computes
    what a kernel with `fault` computes on the given ones (PAGED_FAULTS)."""
    import torch

    bs, mb = k_pool.shape[1], table.shape[1]
    kv_len = torch.as_tensor(kv_len, device=table.device).expand(table.shape[0])
    if fault == "table_shifted":  # chain slot j read from table slot j + 1
        table = torch.cat([table[:, 1:], torch.zeros_like(table[:, :1])], dim=1).contiguous()
    elif fault == "scratch_scored":  # one block past the chain, masks open to its end
        nblk = (kv_len + bs - 1) // bs
        room = nblk < mb
        kv_len = torch.where(room, (nblk + 1) * bs, kv_len)
        q_positions = torch.where(room[:, None], kv_len[:, None] - 1, q_positions)
    elif fault == "last_block_skipped":
        kv_len = ((kv_len - 1).div(bs, rounding_mode="floor") * bs).clamp(min=0)
    elif fault == "kv_heads_rolled":  # kv head h reads kv head h - 1's K/V
        k_pool, v_pool = (x.view(torch.uint8).roll(1, dims=2).view(x.dtype).contiguous()
                          for x in (k_pool, v_pool))
    else:
        raise ValueError(f"unknown fault {fault}")
    return k_pool, v_pool, table, q_positions, kv_len


def paged_inputs(c: Dict[str, Any], nq: int, nkv: int, d: int, gen, dev):
    """One paged case's inputs: pools with garbage in the scratch block 0,
    chains shuffled through the pool, the table stamped at the chain_clamp
    width, each lane's query at kv_len - 1."""
    import torch

    dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
    kv_len = c["kv_len"]
    b, nb = len(kv_len), c["nb"]
    chains = [-(-n // PAGED_BS) for n in kv_len]
    mb = 1
    while mb < max(chains):
        mb <<= 1
    perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for lane, n in enumerate(chains):
        table[lane, :n] = perm[used:used + n]
        used += n
    k_pool = torch.randn((nb, PAGED_BS, nkv, d), generator=gen, device=dev)
    v_pool = torch.randn((nb, PAGED_BS, nkv, d), generator=gen, device=dev)
    k_pool[0] = k_pool[0] * 4.0 + 3.0  # scratch garbage: visible if ever scored
    v_pool[0] = v_pool[0] * 4.0 - 3.0
    pool_dt = torch.float8_e4m3fn if c.get("fp8") else dt
    k_pool, v_pool = k_pool.to(pool_dt), v_pool.to(pool_dt)
    q = torch.randn((b, 1, nq, d), generator=gen, device=dev).to(dt)
    kl = torch.tensor(kv_len, device=dev)
    qpos = (kl - 1).clamp(min=0)[:, None]
    sinks = torch.randn((nq,), generator=gen, device=dev) * 2.0 if c.get("sinks") else None
    kw = dict(scale=c.get("scale"), softcap=c.get("softcap", 0.0), window=c.get("window"),
              sinks=sinks)
    return q, k_pool, v_pool, table, qpos, kl, kw


def run_paged_cases() -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from inferd_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    results, failures = [], []
    for c in PAGED_CASES:
        nq, nkv, d = c.get("heads", QWEN_HEADS)
        q, k_pool, v_pool, table, qpos, kl, kw = paged_inputs(c, nq, nkv, d, gen, dev)
        dt = q.dtype

        def kernel():
            return A.paged_decode_gqa(q, k_pool, v_pool, table, qpos, kl, **kw)

        def plain():
            return A.paged_decode_gqa_reference(q, k_pool, v_pool, table, qpos, kl, **kw)

        plan = A.paged_plan(len(c["kv_len"]), nkv, table.shape[1], PAGED_BS, dt)
        counts = (A.paged_decode_gqa.launches, A.paged_decode_gqa.split_launches)
        got = kernel()
        moved = (A.paged_decode_gqa.launches - counts[0],
                 A.paged_decode_gqa.split_launches - counts[1])
        again, ref = kernel(), plain()
        torch.cuda.synchronize()
        if moved != (1, int(plan.splits > 1)):
            raise AssertionError(f"{c['name']}: launch counts moved {moved}, plan {plan}")
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
        err = (got.float() - ref.float()).abs().max().item()
        rel = row_rel_err(got, ref, d)
        tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]
        faults = {f: row_rel_err(A.paged_decode_gqa(
            q, *plant_paged_fault(f, k_pool, v_pool, table, qpos, kl), **kw), ref, d)
            for f in PAGED_FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")

        yardstick_ms = None
        if kw["sinks"] is None and not kw["softcap"]:
            # gather + SDPA with the kv heads expanded: a yardstick only, no
            # single PyTorch call computes paged attention
            g = nq // nkv
            t = table.shape[1] * PAGED_BS
            kpos = torch.arange(t, device=dev)[None, None, None, :]
            mask = (kpos < kl[:, None, None, None]) & (kpos <= qpos[:, :, None, None])
            if kw["window"]:
                mask &= kpos > qpos[:, :, None, None] - kw["window"]
            qh = q.transpose(1, 2)

            def yardstick():
                kd, vd = A.gather_block_kv(k_pool, v_pool, table)
                kh = kd.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
                vh = vd.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      scale=kw["scale"])

            yardstick_ms = time_ms(yardstick, cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        q_item = 4 if dt == torch.float32 else 2
        w = paged_work(c["kv_len"], c.get("window") or 0, len(c["kv_len"]), nq, nkv, d, q_item,
                       k_pool.element_size())
        peak = PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
        t_bytes, t_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / peak
        row = {
            "case": c["name"], "B": len(c["kv_len"]), "MB": table.shape[1], "bs": PAGED_BS,
            "Nq": nq, "Nkv": nkv, "D": d,
            "kv_len": c["kv_len"], "plan": plan._asdict(),
            "ctas": plan.splits * nkv * len(c["kv_len"]),
            "dtype": str(dt).replace("torch.", "") + ("/fp8-pools" if c.get("fp8") else ""),
            "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "gather_sdpa_yardstick_ms": yardstick_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("kernels", json.dumps(row))
        results.append(row)
    if failures:
        raise AssertionError("paged kernel cases failed:\n  " + "\n  ".join(failures))
    return results


# -- decode GEMV cases ------------------------------------------------------------


def qmm_call(kernel: str, x, q8, q4):
    """One GEMV wrapper call: the kernel on CUDA tensors."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.w8a16_matmul(x, q8.q, q8.scale)
    return Q.w4a16_matvec(x, q4, kernel.split("_")[1])


def qmm_plain(kernel: str, x, q8, q4):
    """The same call's plain version."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.w8a16_matmul_reference(x, q8.q, q8.scale)
    return Q.w4a16_matvec_reference(x, q4, kernel.split("_")[1])


def qmm_plan(kernel: str, x, q8, q4):
    """ops.qmatmul.qgemv_plan of the case's launch."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.qgemv_plan(x.shape[0], x.shape[1], q8.q.shape[1], 1, "int8", "grouped", x.dtype)
    k, n = q4.shape
    return Q.qgemv_plan(x.shape[0], k, n, q4.scale.shape[0], "int4" if q4.packed else "int4_bytes",
                        kernel.split("_")[1], x.dtype)


QMM_INPUT_FAULTS = ("scale_neighbour_column", "last_k_chunk_skipped", "rank_dropped",
                    "rank_doubled")


def qmm_fault_inputs(fault: str, x, scale, k: int, plan):
    """(x, scale) on which the sound kernel computes what a kernel with
    `fault` computes, for the faults that live in the inputs (under the
    launch's plan): the scale of the neighbouring column, the last stage of
    the last rank skipped, a rank's partial dropped or added twice (x zero
    or doubled over that rank's K range: exact). None where the plan has no
    such rank (one rank: no reduction)."""
    if fault == "scale_neighbour_column":
        return x, scale.roll(1, dims=-1).contiguous()
    ranges = plan.rank_ranges(k)
    if fault == "last_k_chunk_skipped":
        lo, hi = ranges[-1]
        lo = plan.stage_starts(lo, hi)[-1]
    elif fault in ("rank_dropped", "rank_doubled"):
        if plan.cluster == 1:
            return None
        lo, hi = ranges[1] if fault == "rank_dropped" else ranges[-1]
    else:
        raise ValueError(f"unknown fault {fault}")
    x = x.clone()
    x[:, lo:hi] *= 2 if fault == "rank_doubled" else 0
    return x, scale


def qmm_fault(fault: str, kernel: str, x, q8, q4):
    """What a GEMV kernel with `fault` computes on the case (QMM_FAULTS),
    or None where the fault cannot apply."""
    import torch

    from inferd_tpu_torch.ops import quant

    int4 = kernel != "w8a16"
    k = x.shape[1]
    plan = qmm_plan(kernel, x, q8, q4)
    if fault in QMM_INPUT_FAULTS:
        inputs = qmm_fault_inputs(fault, x, q4.scale if int4 else q8.scale, k, plan)
        if inputs is None:
            return None
        xf, sf = inputs
        if int4:
            return qmm_call(kernel, xf, q8, dataclasses.replace(q4, scale=sf))
        return qmm_call(kernel, xf, quant.QuantWeight(q8.q, sf), q4)
    if fault == "nibbles_swapped":
        if not (int4 and q4.packed):
            return None
        b = q4.q.view(torch.uint8)
        return qmm_call(kernel, x, q8, dataclasses.replace(q4, q=((b << 4) | (b >> 4)).view(torch.int8)))
    if fault == "zero_extended":  # each byte read as 0..255, each nibble as 0..15
        if not int4:
            return qmm_plain(kernel, x, quant.QuantWeight(q8.q.view(torch.uint8).float(), q8.scale), q4)
        b = q4.q.view(torch.uint8).int()
        if q4.packed:
            vals = torch.stack([b & 0xF, b >> 4], dim=1).reshape(-1, b.shape[1])
        else:
            vals = b
        return qmm_plain(kernel, x, q8, quant.Int4Weight(vals.float(), q4.scale, packed=False))
    if fault == "n_tail_skipped":
        out = qmm_call(kernel, x, q8, q4).clone()
        out[:, (out.shape[1] - 1) // plan.block_n * plan.block_n:] = 0
        return out
    if fault == "group_off_by_one":
        if not int4 or q4.scale.shape[0] < 2:
            return None
        return qmm_call(kernel, x, q8,
                        dataclasses.replace(q4, scale=q4.scale.roll(-1, dims=0).contiguous()))
    raise ValueError(f"unknown fault {fault}")


def qmm_library(kernel: str, x, q8, q4):
    """One PyTorch call that computes the case's product from the same
    quantized weight, its repacking done here, outside any timing: for
    w8a16 torch._weight_int8pack_mm (int8 [N, K], scales in x's dtype), for
    w4a16 torch._weight_int4pack_mm (bf16 only, groups of 32-256; the
    values biased to 0..15, two per byte with the even K index in the high
    nibble, repacked by torch._convert_weight_to_int4pack; scale and a zero
    point of 0 per group). Returns (call, None), or (None, why) where this
    torch has no such call for the case. Timed beside the kernel only: the
    port never calls either."""
    import torch

    try:
        if kernel == "w8a16":
            wt, s = q8.q.t().contiguous(), q8.scale.to(x.dtype)
            call = lambda: torch._weight_int8pack_mm(x, wt, s)  # noqa: E731
        else:
            k, n = q4.shape
            gs = k // q4.scale.shape[0]
            if x.dtype != torch.bfloat16 or gs not in (32, 64, 128, 256) or n % 8 or k % 128:
                return None, f"_weight_int4pack_mm takes bf16, groups of 32-256, N % 8 == 0 " \
                             f"and K % 128 == 0 (here {x.dtype}, group {gs}, N {n}, K {k})"
            u = (q4.unpacked().int() + 8).t()  # [N, K] in 0..15
            wp = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
            sz = torch.stack([q4.scale, torch.zeros_like(q4.scale)], dim=-1).to(
                torch.bfloat16).contiguous()  # [G, N, 2]
            call = lambda: torch._weight_int4pack_mm(x, wp, gs, sz)  # noqa: E731
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def qmm_work(m: int, k: int, n: int, x_item: int, scheme: str, stored: int) -> Dict[str, float]:
    """Bytes and flops of one GEMV: the weight as stored and its f32 scales
    read once (perf/roofline.quant_matvec_bytes, held equal to the
    `stored` bytes of the case's weight), x read once, the output written
    once; 2*M*K*N flops."""
    from inferd_tpu_torch.perf import roofline as rl

    weight = rl.quant_matvec_bytes(k, n, scheme)["kernel"]
    if weight != stored:
        raise AssertionError(f"roofline counts {weight} weight bytes of [{k}, {n}] {scheme}, "
                             f"the weight stores {stored}")
    return {"bytes": weight + (m * k + m * n) * x_item, "flops": 2.0 * m * k * n}


def qmm_wrapper(kernel: str):
    from inferd_tpu_torch.ops import qmatmul as Q

    return Q.w8a16_matmul if kernel == "w8a16" else Q.w4a16_matvec


def qmm_stage_sums(rows: List[Dict[str, Any]], kernel: str, m: int) -> Dict[str, Any]:
    """Device ms of one stage step's GEMVs at m rows (QMM_STAGE_LAYERS x the
    seven projections, k_v and gate_up twice) by the kernel, the bf16
    yardstick and the library call, summed from the cases; None where a
    case has no time."""
    by = {r["case"]: r for r in rows if r["kernel"] == kernel}

    def total(key):
        vals = [by[f"{s}_m{m}"][key] for s in QMM_PER_LAYER]
        if any(v is None for v in vals):
            return None
        return QMM_STAGE_LAYERS * sum(n * v for n, v in zip(QMM_PER_LAYER.values(), vals))

    return {"kernel": kernel, "M": m, "ms": total("ms"),
            "dequant_matmul_yardstick_ms": total("dequant_matmul_yardstick_ms"),
            "library_ms": total("library_ms"), "bound_ms": total("bound_ms")}


def run_qmm_cases() -> List[Dict[str, Any]]:
    import torch

    from inferd_tpu_torch.ops import quant

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    results, failures = [], []
    for c in QMM_CASES:
        k, n = QMM_SHAPES[c["shape"]] if "shape" in c else (c["k"], c["n"])
        dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
        # N(0, 0.02) weights as the seeded init draws them, quantized as a
        # node quantizes at load
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(dt)
        q8, q4 = quant.quantize(w), quant.quantize_int4(w)
        del w
        x = torch.randn((c["m"], k), generator=gen, device=dev).to(dt)
        tol = QMM_TOL["float32" if dt == torch.float32 else "bfloat16"]
        for kernel in QMM_KERNELS:
            plan = qmm_plan(kernel, x, q8, q4)
            wrapper = qmm_wrapper(kernel)
            before = {r: getattr(wrapper, f"{r}_launches") for r in ("mma", "simt")}
            got, ref = qmm_call(kernel, x, q8, q4), qmm_plain(kernel, x, q8, q4)
            again = qmm_call(kernel, x, q8, q4)
            torch.cuda.synchronize()
            name = f"{c['name']}/{kernel}"
            moved = {r: getattr(wrapper, f"{r}_launches") - v for r, v in before.items()}
            if moved != {r: 2 if r == plan.route else 0 for r in moved}:
                raise AssertionError(f"{name}: route counters moved {moved}, want 2 on "
                                     f"{plan.route} ({plan})")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls on the same inputs differ")
            if not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"{name}: kernel output is not finite")
            err = (got.float() - ref.float()).abs().max().item()
            rel = row_rel_err(got, ref, n)
            faults = {}
            for f in QMM_FAULTS:
                out = qmm_fault(f, kernel, x, q8, q4)
                faults[f] = None if out is None else row_rel_err(out, ref, n)
            if not rel <= tol:
                failures.append(f"{name}: row error {rel} > tol {tol}")
            for f, reading in faults.items():
                if reading is not None and not reading > tol:
                    failures.append(f"{name}: planted fault {f} reads {reading} <= tol {tol}")
            wq = q8 if kernel == "w8a16" else q4
            w_deq = wq.dequantize(dt)  # what --quant none reads: a yardstick
            yardstick_ms = time_ms(lambda: torch.matmul(x, w_deq), cold=True)
            del w_deq
            lib, lib_note = qmm_library(kernel, x, q8, q4)
            library_ms = library_err = None
            if lib is not None:
                library_ms = time_ms(lib, cold=True)
                library_err = row_rel_err(lib(), ref, n)
            del lib
            ms = time_ms(lambda: qmm_call(kernel, x, q8, q4), cold=True)
            plain_ms = time_ms(lambda: qmm_plain(kernel, x, q8, q4), iters=10, cold=True)
            groups = 1 if kernel == "w8a16" else q4.scale.shape[0]
            w_ = qmm_work(c["m"], k, n, x.element_size(), "int8" if kernel == "w8a16" else "int4",
                          wq.q.numel() + 4 * n * groups)
            t_bytes = w_["bytes"] / HBM_BYTES_PER_S
            t_ops = w_["flops"] / PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
            row = {
                "case": c["name"], "kernel": kernel, "M": c["m"], "K": k, "N": n,
                "route": plan.route, "cluster": plan.cluster, "k_per_rank": plan.k_per_rank,
                "stage_k": plan.stage_k, "depth": plan.depth, "ctas": plan.ctas,
                "bitwise_repeat": True,
                "dtype": str(dt).replace("torch.", ""),
                "int4_layout": None if kernel == "w8a16" else ("packed" if q4.packed else "bytes"),
                "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library_call": "torch._weight_int8pack_mm" if kernel == "w8a16"
                else "torch._weight_int4pack_mm",
                "library_row_err": library_err, "library_note": lib_note,
                "dequant_matmul_yardstick_ms": yardstick_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": w_["bytes"], "flops": w_["flops"],
            }
            say("qmatmul", json.dumps(row))
            results.append(row)
        del q8, q4, x
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("qmatmul cases failed:\n  " + "\n  ".join(failures))
    for kernel in QMM_KERNELS:
        for m in (1, 8):
            say("qmatmul", "stage step " + json.dumps(qmm_stage_sums(results, kernel, m)))
    return results


# -- LoRA lane-delta cases ---------------------------------------------------------


def lora_inputs(c: Dict[str, Any], gen, dev):
    """One LoRA case's inputs: x [B, S, in], pools [LORA_SLOTS, LORA_LAYERS,
    in, r] / [.., r, out] (slot 0 zero), scales, ids int32 [B]."""
    import torch

    din, dout = LORA_SHAPES[c["target"]]
    dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
    r, b = c["r"], len(c["ids"])
    a_pool = torch.randn((LORA_SLOTS, LORA_LAYERS, din, r), generator=gen, device=dev) * 0.05
    b_pool = torch.randn((LORA_SLOTS, LORA_LAYERS, r, dout), generator=gen, device=dev) * 0.05
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    x = torch.randn((b, c["s"], din), generator=gen, device=dev).to(dt)
    scale = torch.tensor(LORA_SCALES[:LORA_SLOTS], device=dev)
    ids = torch.tensor(c["ids"], dtype=torch.int32, device=dev)
    return x, a_pool.to(dt), b_pool.to(dt), scale, ids


def lora_fault_inputs(fault: str, x, a_pool, b_pool, scale_pool, ids, layer):
    """Inputs on which the sound kernel computes what a kernel with `fault`
    computes on the given ones (LORA_FAULTS)."""
    import torch

    if fault == "neighbour_slot":
        ids = ((ids + 1) % a_pool.shape[0]).to(torch.int32)
    elif fault == "layer_off_by_one":
        layer = (layer + 1) % a_pool.shape[1]
    elif fault == "scale_skipped":
        scale_pool = torch.ones_like(scale_pool)
    elif fault == "last_rank_column_skipped":
        a_pool = a_pool.clone()
        a_pool[..., -1] = 0
    elif fault == "last_s_tile_skipped":
        x = x.clone()
        x[:, (x.shape[1] - 1) // LORA_S_TILE * LORA_S_TILE:] = 0
    else:
        raise ValueError(f"unknown fault {fault}")
    return x, a_pool, b_pool, scale_pool, ids, layer


def lora_work(x, a_pool, b_pool, ids) -> Dict[str, float]:
    """Bytes and flops one lane-delta launch needs: each distinct tenant
    slot's A and B slices read once (perf/roofline.lora_delta_step_bytes
    over the distinct slots: lanes that share a slot share its read, and
    base-slot lanes need none, slot 0 being zero by contract), x read once,
    the f32 output written once; 2 * S * r * (in + out) flops per tenant
    lane."""
    from inferd_tpu_torch.perf import roofline as rl

    b, s, din = x.shape
    r, dout = a_pool.shape[-1], b_pool.shape[-1]
    tenants = [i for i in ids.tolist() if i]
    slices = rl.lora_delta_step_bytes(len(set(tenants)), din, r, dout,
                                      a_pool.element_size())["kernel"]
    return {"bytes": slices + x.numel() * x.element_size() + 4 * b * s * dout,
            "flops": 2.0 * len(tenants) * s * r * (din + dout)}


def run_lora_cases() -> List[Dict[str, Any]]:
    import torch

    from inferd_tpu_torch.ops import lora as L

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    results, failures = [], []
    for c in LORA_CASES:
        x, a_pool, b_pool, scale, ids = lora_inputs(c, gen, dev)
        layer, dout = LORA_LAYER, b_pool.shape[-1]

        def kernel(args=(x, a_pool, b_pool, scale, ids, layer)):
            return L.fused_lane_delta(*args)

        def plain():
            return L.fused_lane_delta_reference(x, a_pool, b_pool, scale, ids, layer)

        plan = L.lora_plan(len(c["ids"]), c["s"], x.shape[-1], dout, c["r"], x.dtype,
                           a_pool.dtype)
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
        err = (got - ref).abs().max().item()
        rel = row_rel_err(got, ref, dout)
        faults = {f: row_rel_err(kernel(lora_fault_inputs(f, x, a_pool, b_pool, scale, ids,
                                                          layer)), ref, dout)
                  for f in LORA_FAULTS}
        if not rel <= LORA_TOL:
            failures.append(f"{c['name']}: row error {rel} > tol {LORA_TOL}")
        if not any(c["ids"]) and not torch.equal(got, torch.zeros_like(got)):
            failures.append(f"{c['name']}: base-slot lanes are not exactly zero")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > LORA_TOL:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {LORA_TOL}")
        il = ids.long()

        def yardstick():
            # gather, then two bmm in the pools' dtype: a yardstick only, no
            # single PyTorch call computes the per-lane delta
            xa = torch.bmm(x, a_pool[il, layer])
            return torch.bmm(xa, b_pool[il, layer]).float() * scale[il][:, None, None]

        yardstick_ms = time_ms(yardstick, cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        w = lora_work(x, a_pool, b_pool, ids)
        t_bytes = w["bytes"] / HBM_BYTES_PER_S
        t_ops = w["flops"] / PEAK_FLOPS[str(a_pool.dtype).replace("torch.", "")]
        row = {
            "case": c["name"], "target": c["target"], "B": len(c["ids"]), "S": c["s"],
            "in": x.shape[-1], "out": dout, "r": c["r"], "ids": c["ids"],
            "dtype": str(x.dtype).replace("torch.", ""), "plan": dataclasses.asdict(plan),
            "max_abs_err": err, "row_err": rel, "tol": LORA_TOL, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "gather_bmm_yardstick_ms": yardstick_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("lora", json.dumps(row))
        results.append(row)
        del x, a_pool, b_pool
    results += run_lora_y_cases(gen, failures)
    if failures:
        raise AssertionError("lora cases failed:\n  " + "\n  ".join(failures))
    return results


def run_lora_y_cases(gen, failures: List[str]) -> List[Dict[str, Any]]:
    """LORA_Y_CASES: fused_lane_delta(..., y=y) against the unfused add of
    its own delta (bit for bit) and of the plain version's (row rule)."""
    import torch

    from inferd_tpu_torch.ops import lora as L

    dev = torch.device(DEVICE)
    results = []
    for c in LORA_Y_CASES:
        x, a_pool, b_pool, scale, ids = lora_inputs(c, gen, dev)
        layer, dout = LORA_LAYER, b_pool.shape[-1]
        y = torch.randn((x.shape[0], x.shape[1], dout), generator=gen, device=dev).to(x.dtype)

        def fused(args=(x, a_pool, b_pool, scale, ids, layer), y=y):
            return L.fused_lane_delta(*args, y=y)

        def unfused():
            return (y.float() + L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer)
                    ).to(y.dtype)

        plan = L.lora_plan(len(c["ids"]), c["s"], x.shape[-1], dout, c["r"], x.dtype,
                           a_pool.dtype)
        before = L.fused_lane_delta.launches
        got = fused()
        launched = L.fused_lane_delta.launches - before
        again, sep = fused(), unfused()
        y_in = y.clone()
        in_place = L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer, y=y_in, inplace=True)
        ref = (y.float() + L.fused_lane_delta_reference(x, a_pool, b_pool, scale, ids, layer)
               ).to(y.dtype)
        torch.cuda.synchronize()
        base = (ids == 0).nonzero().flatten()
        checks = {
            "one launch": launched == 1,
            "equal to the unfused add": torch.equal(got, sep),
            "the same bits on two calls": torch.equal(got, again),
            "in place into y": in_place is y_in and torch.equal(y_in, got),
            "base lanes equal y": torch.equal(got[base], y[base]),
        }
        for what, ok in checks.items():
            if not ok:
                failures.append(f"{c['name']}: not {what}")
        tol = ATTN_TOL["bfloat16"]
        rel = row_rel_err(got, ref, dout)
        faults = {f: row_rel_err(fused(lora_fault_inputs(f, x, a_pool, b_pool, scale, ids,
                                                         layer)), ref, dout)
                  for f in LORA_FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")
        scratch = y.clone()
        ms = time_ms(lambda: L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer,
                                                y=scratch, inplace=True), cold=True)
        unfused_ms = time_ms(unfused, cold=True)
        plain_ms = time_ms(lambda: (y.float() + L.fused_lane_delta_reference(
            x, a_pool, b_pool, scale, ids, layer)).to(y.dtype), iters=10, cold=True)
        w = lora_work(x, a_pool, b_pool, ids)
        # y read once and written once in place of the f32 delta's write
        nbytes = w["bytes"] - 4 * y.numel() + 2 * y.numel() * y.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = w["flops"] / PEAK_FLOPS[str(a_pool.dtype).replace("torch.", "")]
        row = {
            "case": c["name"], "target": c["target"], "B": len(c["ids"]), "S": c["s"],
            "in": x.shape[-1], "out": dout, "r": c["r"], "ids": c["ids"],
            "dtype": str(x.dtype).replace("torch.", ""), "plan": dataclasses.asdict(plan),
            "checks": {k: bool(v) for k, v in checks.items()},
            "max_abs_err": (got.float() - ref.float()).abs().max().item(), "row_err": rel,
            "tol": tol, "faults": faults, "blind": [], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "unfused_ms": unfused_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": w["flops"],
        }
        say("lora", json.dumps(row))
        results.append(row)
    return results


# -- serve phase ----------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get_json(url: str, timeout: float = 10.0) -> Dict[str, Any]:
    import http.client

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("GET", u.path)
        r = conn.getresponse()
        body = r.read()
        if r.status != 200:
            raise RuntimeError(f"GET {url}: HTTP {r.status}")
        return json.loads(body)
    finally:
        conn.close()


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_node(stage: int, log_name: str, args, identity=None) -> Dict[str, Any]:
    """One run_node process for `stage` on a free port, on DEVICE, its
    gossip on an ephemeral UDP port unless `args` names one; `identity`
    (e.g. --manifest M --name N) in place of --stage."""
    port = free_port()
    log = open(log_name, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "inferd_tpu_torch.tools.run_node",
         *(identity or ["--stage", str(stage)]),
         "--port", str(port), "--device", DEVICE, "--gossip-port", "0", *args],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    return {"proc": proc, "port": port, "log": log, "stage": stage}


def launch_seed(log_name: str) -> Dict[str, Any]:
    """One tools/seed process (a bare gossip peer) on a free UDP port; its
    stdout (the ready line, then a line per change of its view) in the log."""
    port = free_udp_port()
    log = open(log_name, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "inferd_tpu_torch.tools.seed", "--port", str(port), "--host",
         "127.0.0.1"], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    return {"proc": proc, "port": port, "log": log, "stage": "seed"}


def seed_lines(seed: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The JSON lines a tools/seed process printed so far."""
    out = []
    with open(seed["log"].name, errors="replace") as f:
        for ln in f:
            if ln.startswith("{"):
                out.append(json.loads(ln))
    return out


def start_node(parts: str, stage: int, log_dir: str, extra=(), tag: str = "") -> Dict[str, Any]:
    return launch_node(stage, os.path.join(log_dir, f"node{stage}{tag or '_'.join(extra)}.log"),
                       ["--parts", parts, "--max-len", str(MAX_LEN), *extra])


# node processes started ahead of their phase: (parts, extra, tag) -> nodes
_PRESTARTED: Dict[tuple, List[Dict[str, Any]]] = {}


def prestart_nodes(parts: str, work: str, specs, swarms=(), singles=(),
                   meanwhile: Callable[[], Any] = lambda: None) -> Any:
    """Start the two stage processes of each (extra, tag) in `specs`, the
    swarms that `swarm_nodes` describes for each (parts, tag) in `swarms`,
    and one whole-model process for each (one-stage parts, extra, tag) in
    `singles`, now, all at once, run `meanwhile` in this process (work on
    the host that needs no node), and wait until every one answers: its
    phase then takes them fresh and idle (start_nodes, take_swarm,
    start_single) instead of waiting ~8 s for its own, and no process is
    still starting while a phase measures. Returns what `meanwhile` did."""
    t0 = time.perf_counter()
    for extra, tag in specs:
        _PRESTARTED[(parts, tuple(extra), tag)] = [start_node(parts, s, work, extra, tag)
                                                   for s in range(2)]
    for parts1, extra, tag in singles:
        _PRESTARTED[(parts1, tuple(extra), tag)] = [start_node(parts1, 0, work, extra, tag)]
    for swarm_parts, tag in swarms:
        _PRESTARTED[("swarm", tag)] = swarm_nodes(swarm_parts, work, tag)
    done = meanwhile()
    for nodes in _PRESTARTED.values():
        for n in nodes:
            wait_ready(n)
    count = sum(len(v) for v in _PRESTARTED.values())
    say("nodes", f"{count} run_node processes of {len(specs) + len(swarms) + len(singles)} node "
                 "sets started "
                 f"at once, ready in {time.perf_counter() - t0:.1f}s")
    return done


def start_nodes(parts: str, work: str, extra=(), tag: str = "") -> List[Dict[str, Any]]:
    """Stages 0 and 1 behind these flags: the processes prestart_nodes
    started for them, else two started now."""
    nodes = _PRESTARTED.pop((parts, tuple(extra), tag), None)
    return nodes if nodes is not None else [start_node(parts, s, work, extra, tag)
                                            for s in range(2)]


def start_single(parts1: str, work: str, extra=(), tag: str = "") -> Dict[str, Any]:
    """One whole-model process behind these flags (one-stage parts): the one
    prestart_nodes started for them, else one started now."""
    nodes = _PRESTARTED.pop((parts1, tuple(extra), tag), None)
    return nodes[0] if nodes is not None else start_node(parts1, 0, work, extra, tag)


def take_swarm(parts: str, work: str, tag: str) -> List[Dict[str, Any]]:
    """The swarm `tag`: the processes prestart_nodes started, else new ones."""
    nodes = _PRESTARTED.pop(("swarm", tag), None)
    return nodes if nodes is not None else swarm_nodes(parts, work, tag)


def stop_prestarted() -> None:
    """Stop every prestarted process no phase took (a run that failed)."""
    while _PRESTARTED:
        stop_nodes(_PRESTARTED.popitem()[1])


def wait_ready(node: Dict[str, Any], timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if node["proc"].poll() is not None:
            raise RuntimeError(f"node {node['stage']} exited with {node['proc'].returncode}")
        if node["stage"] == "seed":  # no HTTP: its ready line
            if any(d.get("ready") for d in seed_lines(node)):
                return
            time.sleep(0.2)
            continue
        try:
            http_get_json(f"http://127.0.0.1:{node['port']}/health", timeout=2.0)
            return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"node {node['stage']} not ready after {timeout_s}s")


def stop_nodes(nodes: List[Dict[str, Any]], show_logs: bool = False) -> None:
    """Stop the node processes; with show_logs, print each log's tail (the
    run failed and the work directory holding the logs is about to go).
    Otherwise every live node but serve_elastic's must first read
    `migrations` 0 in its /stats: no balancer moved it in its phase."""
    moved = {}
    checked = 0
    for n in nodes:
        if show_logs or n["stage"] == "seed" or n.get("elastic") or n["proc"].poll() is not None:
            continue
        try:
            counters = http_get_json(f"http://127.0.0.1:{n['port']}/stats")["metrics"]["counters"]
        except (OSError, RuntimeError, ValueError) as e:  # stopped below all the same
            moved[n["port"]] = f"/stats failed: {e}"
            continue
        checked += 1
        if counters.get("migrations", 0):
            moved[n["port"]] = counters
    for n in nodes:
        if n["proc"].poll() is None:
            n["proc"].terminate()
    for n in nodes:
        try:
            n["proc"].wait(timeout=30)
        except subprocess.TimeoutExpired:
            n["proc"].kill()
            n["proc"].wait(timeout=30)
        n["log"].close()
        if show_logs:
            with open(n["log"].name, errors="replace") as f:
                tail = f.read()[-4000:]
            print(f"--- node {n['stage']} log tail ---\n{tail}", file=sys.stderr)
    if moved:
        raise AssertionError(f"nodes that migrated outside serve_elastic, or did not answer: "
                             f"{moved}")
    if checked:
        say("nodes", f"{checked} node processes stopped, each with migrations 0")


def make_local_client(executors, sampling, adapter=None, prefill_chunk: int = 512):
    """A GenerationClient whose transport is the stage executors in this
    process: the same generation loop and chunking as the ChainClient, and
    its `adapter` stamp on every stage of a session's first chunk."""
    from inferd_tpu_torch.client.base import GenerationClient

    class LocalChain(GenerationClient):
        def _step_sync(self, session_id, tokens, start_pos):
            import numpy as np

            stamp = {"adapter": self.adapter} if self.adapter and start_pos == 0 else {}
            payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
                       "real_len": len(tokens), **stamp}
            for ex in executors:
                out = ex.process(session_id, payload)
                if "logits" in out:
                    return out["logits"].numpy()[0]
                payload = {"hidden": out["hidden"], "start_pos": out["start_pos"],
                           "real_len": out["real_len"], **stamp}
            raise RuntimeError("no logits")

        async def _step(self, session_id, tokens, start_pos):
            return await asyncio.to_thread(self._step_sync, session_id, tokens, start_pos)

        async def _end_session(self, session_id):
            for ex in executors:
                ex.end_session(session_id)

    return LocalChain(sampling=sampling, prefill_chunk=prefill_chunk, adapter=adapter)


def _last_stage_probe_class():
    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    class LastStageProbe(Qwen3StageExecutor):
        """The last stage's executor, returning its hidden state on every
        real row beside the last real token's logits; its token steps run
        stage_step as a node's do (eagerly: its graphs are None). A stage
        that is also the first embeds its tokens (a one-stage model)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.graphs = None

        def _run(self, x, start_pos, cache, real_len):
            if self.spec.is_first:
                x = qwen3.embed(self.params, x, self.cfg)
            hidden, _ = qwen3.forward_layers_cached(
                self.params["layers"], self.cfg, x, start_pos, cache, start_pos)
            last = hidden[:, real_len - 1:real_len]
            return {"hidden": hidden[:, :real_len],
                    "logits": qwen3.unembed(self.params, self.cfg, last)[:, 0]}

        def _token_step(self, x, pos, cache):
            import torch

            x = x.to(self.device)  # the executor hands a token step's row over on the host
            fill = torch.full((1,), pos, dtype=torch.int64, device=self.device)
            hidden = qwen3.stage_step(self.params, self.cfg, x, cache.k, cache.v, fill,
                                      first=self.spec.is_first, last=False,
                                      kv_bound=qwen3.kv_bucket(pos + 1, cache.max_len))
            return {"hidden": hidden, "logits": qwen3.unembed(self.params, self.cfg, hidden)[:, 0]}

    return LastStageProbe


def eager(executors):
    """The executors with their graphs off: the same steps run eagerly, the
    reference a graphed node is held to, and the only form a planted kernel
    fault can reach after a capture."""
    for ex in executors:
        getattr(ex, "ex", ex).graphs = None
    return executors


def check_node_graphs(phase: str, st: Dict[str, Any], decode_steps: int) -> Dict[str, int]:
    """A node's /stats executor.graphs: every one of its `decode_steps`
    decode steps (token steps, co-batched dispatches or decode_steps
    windows) was a capture or a replay, none ran eagerly; at least one
    capture and one replay; the resident graphs within max_graphs."""
    g = st["executor"]["graphs"]
    say(phase, f"node stage {st['stage']}: graphs {g} over {decode_steps} decode steps "
               f"({g['replays'] / max(g['captures'], 1):.1f} replays per capture)")
    if (g["captures"] < 1 or g["replays"] < 1 or g["captures"] + g["replays"] != decode_steps
            or g["resident"] > g["max_graphs"]):
        raise AssertionError(f"{phase} stage {st['stage']}: graphs {g} for {decode_steps} "
                             "decode steps (want captures + replays == steps, captures >= 1, "
                             "replays >= 1)")
    return g


@contextlib.contextmanager
def planted_frozen_fill():
    """Until the block ends, a stage step or a K-step window
    (models/qwen3.decode_window) captured into a graph runs with each row's
    fill (its position and write slot) frozen at its value in the warm-up
    just before the capture: a host value baked into the graph, the fault a
    graph's token-exactness against the eager step must catch. Eager steps
    stay right; a graph captured before the block does not hold the fault,
    so the check runs on executors made inside it."""
    import torch

    from inferd_tpu_torch.models import qwen3 as Q

    real_step, real_window = Q.stage_step, Q.decode_window
    seen = {}

    def frozen(fill):
        key = fill.data_ptr()  # the graph's static fill buffer
        if torch.cuda.is_current_stream_capturing():
            return seen[key]  # the warm-up's copy, which no later step updates
        seen[key] = fill.clone()
        return fill

    def faulty_step(params, cfg, x, k_cache, v_cache, fill, **kw):
        return real_step(params, cfg, x, k_cache, v_cache, frozen(fill), **kw)

    def faulty_window(params, cfg, k_cache, v_cache, tok, fill, *rest):
        return real_window(params, cfg, k_cache, v_cache, tok, frozen(fill), *rest)

    Q.stage_step, Q.decode_window = faulty_step, faulty_window
    try:
        yield
    finally:
        Q.stage_step, Q.decode_window = real_step, real_window


# Tokens of each planted frozen-fill stream: the fault shows within the
# first few (token 2 on the one-session chain, token 5 on the paged lanes,
# in earlier runs), and every token of the eager reference costs a
# Python-dispatched step per stage.
FROZEN_FILL_TOKENS = 12


def check_frozen_fill_caught(phase: str, what: str, make_executors, prompt) -> None:
    """Graphed executors made under planted_frozen_fill give a stream of
    `prompt` that leaves the eager executors' (fresh ones from
    `make_executors`, their graphs off), sampled with the default config
    0.6/20/0.95 and one seed, whose draws follow every logit (the random
    model's greedy streams barely move under the fault); the same graphed
    executors without the fault give the eager stream. FROZEN_FILL_TOKENS
    tokens each."""
    from inferd_tpu_torch.config import SamplingConfig

    def run(executors):
        return asyncio.run(make_local_client(executors, SamplingConfig()).generate_ids(
            prompt, max_new_tokens=FROZEN_FILL_TOKENS, seed=GEN_SEED))

    want = run(eager(make_executors()))
    sound = run(make_executors())
    with planted_frozen_fill():
        got = run(make_executors())
    say(phase, f"planted fault frozen_fill on graphed {what}, prompt {len(prompt)}, sampled: "
               f"the stream leaves the eager one at token {first_divergence(got, want)} of "
               f"{FROZEN_FILL_TOKENS}; without the fault, graphed equals eager: {sound == want}")
    if sound != want:
        raise AssertionError(f"{phase}: graphed {what} leave the eager stream: {sound} {want}")
    if got == want:
        raise AssertionError(f"{phase}: planted fault frozen_fill passes on {what}")


def stage_step_share(phase: str, card: str, loaded, prompt, cfg,
                     capture: bool = True) -> Dict[str, Any]:
    """One decode step of stage 0 (its layers, 1 token) on an in-process
    one-session executor, graphed and eager in this call: the host clock
    per step and the device's busy time (device_share), the step replayed
    at one fill (the upload, the replay or the eager layers, the .cpu());
    with `capture`, what one more graph costs (capture_cost)."""
    import numpy as np

    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    params, spec, _ = loaded[0]
    out = {}
    for name, graphed in (("graphed", True), ("eager", False)):
        ex = Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
        if not graphed:
            ex.graphs = None
        ex.process("share", {"tokens": np.asarray([prompt], np.int32), "start_pos": 0,
                             "real_len": len(prompt)})
        step = {"tokens": [[prompt[-1]]], "start_pos": len(prompt), "real_len": 1}
        out[name] = device_share(phase, card, f"stage 0 decode step ({spec.num_layers} "
                                 f"layers, fill {len(prompt)}), {name}",
                                 lambda ex=ex: ex.process("share", step), 1)
        out[name]["graphs"] = ex.stats()["graphs"]
        if graphed and capture:
            out["capture"] = capture_cost(phase, card, ex, prompt, n=CAPTURE_SESSIONS)
        del ex
    return out


CAPTURE_SESSIONS = 8  # capture_cost's new sessions, a graph each


def capture_cost(phase: str, card: str, ex, prompt, n: int = 3) -> Dict[str, Any]:
    """What one more token-step graph costs a one-session executor: `n`
    more sessions live at once, each prefilled into a buffer of its own,
    then per session the host clock of its first token step (the graph's
    warm-up and capture, and the .cpu()) and of its second (a replay at
    the same kv bound), and the device memory the n captures leave
    allocated (torch.cuda.memory_allocated: the graphs' static buffers and
    what their warm-ups keep; memory_reserved also moves with the
    allocator's cache, so it does not count a graph) and the host memory
    this process grew by (its resident set: the instantiated graphs, and
    whatever else the steps left on the host)."""
    import numpy as np
    import torch

    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    sids = [f"capture{i}" for i in range(n)]
    for sid in sids:
        ex.process(sid, {"tokens": np.asarray([prompt], np.int32), "start_pos": 0,
                         "real_len": len(prompt)})
    torch.cuda.synchronize()
    allocated0, captures0 = torch.cuda.memory_allocated(), ex.stats()["graphs"]["captures"]
    rss0 = rss()
    first, second = [], []
    for sid in sids:
        for times, pos in ((first, len(prompt)), (second, len(prompt) + 1)):
            t0 = time.perf_counter()
            ex.process(sid, {"tokens": [[prompt[-1]]], "start_pos": pos, "real_len": 1})
            times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    mib = (torch.cuda.memory_allocated() - allocated0) / n / 2**20
    host_mib = (rss() - rss0) / n / 2**20
    captures = ex.stats()["graphs"]["captures"] - captures0
    for sid in sids:
        ex.end_session(sid)
    out = {"capture_ms": statistics.median(first), "replay_ms": statistics.median(second),
           "allocated_mib_per_graph": mib, "host_mib_per_graph": host_mib, "sessions": n,
           "max_graphs": ex.graphs.max_graphs}
    say(phase, f"a token-step graph of stage 0 ({n} sessions live at once, each its own "
               f"buffer): first step (warm-up + capture) {out['capture_ms']:.2f} ms, second "
               f"(a replay) {out['replay_ms']:.2f} ms on the host clock (medians); "
               f"{mib:.3f} MiB of device memory left allocated per capture, the process's "
               f"resident host memory {host_mib:.3f} MiB more per capture (x max_graphs "
               f"{ex.graphs.max_graphs}: {host_mib * ex.graphs.max_graphs:.0f} MiB) ({card})")
    if captures != n:
        raise AssertionError(f"{phase}: {captures} captures for {n} new buffers")
    return out


# The serve prompts driven again, all at once, on the same graphed
# one-session nodes, in this many waves: the first allocates buffers (and
# captures graphs) for the sessions live together; later waves reuse the
# buffers, and capture only the (buffer, kv bound) pairs a buffer had not
# met yet (which session takes which free buffer follows arrival order).
CONCURRENT_WAVES = 2


def concurrent_waves(phase: str, card: str, nodes, prompts, streams, sampling) -> List[Any]:
    """The serve prompts on the serve nodes, CONCURRENTLY, CONCURRENT_WAVES
    times: every stream equals the sequential run's, every decode step of a
    wave is a capture or a replay on each node, and at the end no node
    ever evicted or captured a graph twice (captures == resident,
    evictions 0), and its captures stay within a graph per kv bound per
    buffer it allocated: they grow with the sessions live at once, never
    with the sessions served. Prints each wave's aggregate rate, and per
    node its captures per session and its buffers allocated and reused."""
    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.models.qwen3 import KV_BUCKET_MIN

    addrs = [("127.0.0.1", n["port"]) for n in nodes]

    def executors():
        return [http_get_json(f"http://127.0.0.1:{n['port']}/stats")["executor"] for n in nodes]

    async def drive():
        async with ChainClient(addrs, sampling=sampling, prefill_chunk=512) as client:
            return await asyncio.gather(*(client.generate_ids(p, max_new_tokens=NEW_TOKENS)
                                          for p in prompts))

    steps = len(prompts) * (NEW_TOKENS - 1)
    waves = []
    for w in range(CONCURRENT_WAVES):
        ex0 = executors()
        t0 = time.perf_counter()
        got = asyncio.run(drive())
        wall = time.perf_counter() - t0
        ex1 = executors()
        if got != streams:
            raise AssertionError(f"{phase}: concurrent wave {w + 1}'s streams differ from the "
                                 "sequential run's")
        per_node = []
        for stage, (a, b) in enumerate(zip(ex0, ex1)):
            d = {k: b["graphs"][k] - a["graphs"][k] for k in ("captures", "replays", "evictions")}
            d.update({k: b["buffers"][k] - a["buffers"][k]
                      for k in ("allocated", "reused", "released")})
            per_node.append(d)
            if d["captures"] + d["replays"] != steps:
                raise AssertionError(f"{phase}: wave {w + 1}, stage {stage}: {d} for {steps} "
                                     "decode steps")
        waves.append({"wall_s": wall, "tok_s": len(prompts) * NEW_TOKENS / wall,
                      "nodes": per_node})
        say(phase, f"concurrent wave {w + 1}: {len(prompts)} sessions at once, "
                   f"{len(prompts) * NEW_TOKENS} tokens in {wall:.2f} s = "
                   f"{waves[-1]['tok_s']:.1f} tok/s aggregate ({card}); per node "
                   + "; ".join(f"stage {i}: {d['captures']} captures "
                               f"({d['captures'] / len(prompts):.2f} per session), "
                               f"{d['replays']} replays, buffers {d['allocated']} allocated, "
                               f"{d['reused']} reused, {d['released']} released"
                               for i, d in enumerate(per_node))
                   + "; streams equal the sequential run's")
    bounds = int(math.log2(MAX_LEN // KV_BUCKET_MIN)) + 1  # kv bounds 64 .. MAX_LEN
    for stage, ex in enumerate(executors()):
        g, b = ex["graphs"], ex["buffers"]
        say(phase, f"node stage {stage} after the waves: graphs {g}, buffers {b}")
        if (g["evictions"] or g["captures"] != g["resident"]
                or g["captures"] > b["allocated"] * bounds):
            raise AssertionError(f"{phase}: stage {stage}: graphs {g} over buffers {b}: a graph "
                                 f"evicted or captured twice, or more than {bounds} per buffer")
    return waves


def teacher_forced(executors, prompts, streams) -> List[Any]:
    """(last-stage hidden of the real rows, last logits) per step: each
    prompt's 512-token chunks, then its stream's first DECODE_CHECKED
    tokens one at a time, through the stage executors in this process."""
    import numpy as np

    steps = []
    for i, (p, ids) in enumerate(zip(prompts, streams)):
        feed = [(p[c:c + 512], c) for c in range(0, len(p), 512)]
        feed += [([tok], len(p) + j) for j, tok in enumerate(ids[:DECODE_CHECKED])]
        for toks, pos in feed:
            out = {"tokens": np.asarray([toks], np.int32), "start_pos": pos, "real_len": len(toks)}
            for ex in executors:
                out = ex.process(f"forced-{i}", out)
            steps.append((out["hidden"].float(), out["logits"].float()))
        for ex in executors:
            ex.end_session(f"forced-{i}")
    return steps


def compare_steps(got, ref, hidden_size: int):
    """(worst hidden row error, worst logits error as a share of max |logit|)."""
    h_err = max(row_rel_err(g[0], r[0], hidden_size) for g, r in zip(got, ref))
    l_err = max((g[1] - r[1]).abs().max().item() / r[1].abs().max().item()
                for g, r in zip(got, ref))
    return h_err, l_err


@contextlib.contextmanager
def planted_attention_fault(fault: str):
    """Every flash_gqa kernel launch runs on inputs that reproduce `fault`
    (see plant_fault), until the block ends."""
    from inferd_tpu_torch.ops import attention as A

    launch = A._launch

    def faulty(q, k, v, q_start, kv_len, *rest):
        k, v, q_start, kv_len = plant_fault(fault, k, v, q_start, kv_len)
        return launch(q, k, v, q_start, kv_len, *rest)

    A._launch = faulty
    try:
        yield
    finally:
        A._launch = launch


def paged_splits(phase: str, st: Dict[str, Any], cfg) -> tuple:
    """(paged_decode_gqa.split_launches of a lane node, the count its decode
    dispatches want): every dispatch of table width MB launches one paged
    call per layer, split when ops.attention.paged_plan(LANES, Nkv, MB, ...)
    cuts the chain."""
    from inferd_tpu_torch.ops.attention import paged_plan

    layers = st["end_layer"] - st["start_layer"] + 1
    widths = {int(w): n for w, n in st["executor"]["decode_widths"].items()}
    plans = {w: paged_plan(LANES, cfg.num_kv_heads, w, PAGED_BS, cfg.torch_dtype).splits
             for w in widths}
    want = layers * sum(n for w, n in widths.items() if plans[w] > 1)
    got = st["kernels"]["paged_decode_gqa"]["split_launches"]
    say(phase, f"node stage {st['stage']}: decode dispatches by table width {widths}, splits "
               f"{plans}; paged split launches {got} (want {want}: {got == want})")
    return got, want


def flash_routes(stats: Dict[str, Any]) -> Dict[str, int]:
    """A node's flash_gqa launches by route, from its /stats."""
    fl = stats["kernels"]["flash_gqa"]
    return {"split": fl["split_launches"], "mma": fl["mma_launches"]}


def split_parts(work: str) -> str:
    """Qwen3-0.6B at full width from a seeded random init, split into two
    14-layer stage files by tools/split_model; returns the parts directory."""
    import torch

    from inferd_tpu_torch.tools import split_model

    parts = os.path.join(work, "parts")
    t0 = time.perf_counter()
    split_model.main(["--model", MODEL, "--stages", "2", "--random-init", "--seed", "0",
                      "--out", parts, "--device", DEVICE])
    torch.cuda.empty_cache()
    say("serve", f"split {MODEL} into 2 stages (seeded random init) in "
                 f"{time.perf_counter() - t0:.1f}s")
    return parts


@contextlib.contextmanager
def plain_gemvs():
    """Every decode-GEMV wrapper call runs its plain version, until the
    block ends: the plain-GEMV path the quantized phases hold the kernel
    path to."""
    from inferd_tpu_torch.ops import qmatmul as Q

    saved = Q.w8a16_matmul, Q.w4a16_matvec
    Q.w8a16_matmul, Q.w4a16_matvec = Q.w8a16_matmul_reference, Q.w4a16_matvec_reference
    try:
        yield
    finally:
        Q.w8a16_matmul, Q.w4a16_matvec = saved


@contextlib.contextmanager
def planted_gemv_fault(fault: str):
    """Every decode-GEMV kernel launch runs on inputs that reproduce `fault`
    (see qmm_fault_inputs), until the block ends."""
    from inferd_tpu_torch.ops import qmatmul as Q

    launch = Q._launch

    def faulty(x, q, scale, k, n, kind, groups, scheme, name):
        plan = Q.qgemv_plan(x.shape[0], k, n, groups, kind, scheme, x.dtype)
        x, scale = qmm_fault_inputs(fault, x, scale, k, plan)
        return launch(x, q, scale, k, n, kind, groups, scheme, name)

    Q._launch = faulty
    try:
        yield
    finally:
        Q._launch = launch


@contextlib.contextmanager
def plain_lora():
    """Every lane-delta wrapper call runs its plain version, until the block
    ends: the plain-delta path the LoRA phase holds the kernel path to."""
    from inferd_tpu_torch.ops import lora as L

    saved = L.fused_lane_delta
    L.fused_lane_delta = L.fused_lane_delta_reference
    try:
        yield
    finally:
        L.fused_lane_delta = saved


@contextlib.contextmanager
def planted_lora_fault(fault: str):
    """Every lane-delta kernel launch runs on inputs that reproduce `fault`
    (see lora_fault_inputs), until the block ends."""
    from inferd_tpu_torch.ops import lora as L

    launch = L._launch

    def faulty(*args):  # (x, pools, scale, ids, layer) and y, inplace as they come
        return launch(*lora_fault_inputs(fault, *args[:6]), *args[6:])

    L._launch = faulty
    try:
        yield
    finally:
        L._launch = launch


QMM_KERNEL_OF = {"int8": "w8a16_matmul", "int4": "w4a16_matvec"}  # --quant -> its kernel
GEMVS_PER_LAYER = 7  # q, k, v, o, gate, up, down


def gemv_launches(layers: int, last: bool, small_dispatches: int, dispatches: int) -> int:
    """GEMV kernel launches of one quantized stage: 7 per layer on every
    dispatch of at most MAX_KERNEL_ROWS rows, and on the last stage one for
    the head on every dispatch (its logits are one row per lane)."""
    return GEMVS_PER_LAYER * layers * small_dispatches + (dispatches if last else 0)


def gemv_projections(cfg) -> List[tuple]:
    """[K, N] of the per-layer projections that contract through a GEMV
    (the seven of a dense layer; an MoE layer's four attention ones: its
    expert stacks contract in ops.quant.qeinsum), and the head's [K, N]."""
    h, q, kv = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    mlp = [] if cfg.is_moe else [(h, i), (h, i), (i, h)]
    return [(h, q), (h, kv), (h, kv), (q, h)] + mlp, (h, cfg.vocab_size)


def gemv_route_launches(cfg, quant_flag, layers: int, last: bool, small_rows: List[int],
                        head_rows: List[int]) -> Dict[str, int]:
    """Launches per route (qgemv_plan's) of --quant quant_flag's GEMV wrapper
    on one stage: the seven projections of each layer on every dispatch
    whose row count is in small_rows (those of at most MAX_KERNEL_ROWS), and
    on the last stage the head on every dispatch (head_rows: its rows per
    dispatch), each weight quantized as the node quantizes it."""
    import torch

    from inferd_tpu_torch.ops import qmatmul as Q
    from inferd_tpu_torch.ops import quant

    def route(m, k, n):
        if quant_flag == "int8":
            return Q.qgemv_plan(m, k, n, 1, "int8", "grouped", torch.bfloat16).route
        return Q.qgemv_plan(m, k, n, k // quant._group_size(k, 128),
                            "int4" if k % 2 == 0 else "int4_bytes", quant.INT4_MODE,
                            torch.bfloat16).route

    counts = {"mma": 0, "simt": 0}
    projections, head = gemv_projections(cfg)
    for m in small_rows:
        for k, n in projections:
            counts[route(m, k, n)] += layers
    for m in head_rows if last else ():
        counts[route(m, *head)] += 1
    return counts


def gemv_routes(stats: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """A node's GEMV launches by wrapper and route, from its /stats."""
    return {name: {r: stats["kernels"][name][f"{r}_launches"] for r in ("mma", "simt")}
            for name in ("w8a16_matmul", "w4a16_matvec")}


def quantize_loaded(loaded, quant_flag):
    """The stage checkpoints as a --quant node holds them."""
    if quant_flag is None:
        return loaded
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import quant

    cfg = get_config(MODEL)
    return [(quant.apply_quant_mode(quant_flag, params, cfg.tie_word_embeddings, spec.is_last),
             spec, name) for params, spec, name in loaded]


def check_kernel_path(phase: str, cfg, probe, plain_probe, prompts, streams, plain_ctx, plant,
                      faults, what: str) -> Dict[str, Any]:
    """Teacher-forced, the `probe` executors (the kernel path) against
    `plain_probe` run inside `plain_ctx`: the hidden rows within
    HIDDEN_TOL and the logits within LOGIT_TOL, and each planted fault
    (`plant(f)`) outside one of them; every reading printed beside its
    limit."""
    with plain_ctx():
        plain_steps = teacher_forced(plain_probe, prompts, streams)
    readings = {"sound": compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                       cfg.hidden_size)}
    for f in faults:
        with plant(f):
            readings[f] = compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                        cfg.hidden_size)
    for name, (h_err, l_err) in readings.items():
        say(phase, f"kernel path {'' if name == 'sound' else 'with fault ' + name + ' '}vs "
                   f"{what} over {len(plain_steps)} teacher-forced steps: hidden "
                   f"row error {h_err:.4g} (tol {HIDDEN_TOL}), logits {l_err:.4%} of max "
                   f"|logit| (tol {LOGIT_TOL:.0%})")
    h_err, l_err = readings["sound"]
    if not (h_err <= HIDDEN_TOL and l_err <= LOGIT_TOL):
        raise AssertionError(f"{phase}: kernel path vs {what}: hidden {h_err}, logits {l_err}")
    for f in faults:
        h_f, l_f = readings[f]
        if not (h_f > HIDDEN_TOL or l_f > LOGIT_TOL):
            raise AssertionError(f"{phase}: planted fault {f} passes the checks: hidden {h_f}, "
                                 f"logits {l_f}")
    return readings


def run_serve(card: str, parts: str, work: str, quant_flag=None, baseline=None,
              model: str = MODEL, phase: Optional[str] = None, cfg=None,
              prompt_lens=PROMPT_LENS, new_tokens: int = NEW_TOKENS) -> Dict[str, Any]:
    """The `serve` phase, or with quant_flag its `serve_quant` run on
    --quant nodes (the GEMV kernel path then held to the plain-GEMV path,
    and `baseline`'s bf16 rates printed beside its own), or with another
    `model` and `phase` (serve_llama, serve_moe) the serve checks on that
    model's parts (`cfg` when its depth is cut; `prompt_lens` and
    `new_tokens` its traffic), without the concurrent waves, the
    frozen-fill fault and the capture cost, which the serve phase
    measures once."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    LastStageProbe = _last_stage_probe_class()

    phase = phase or ("serve" if quant_flag is None else f"serve_quant_{quant_flag}")
    extra = [] if quant_flag is None else ["--quant", quant_flag]
    cfg = cfg or get_config(model)
    full = quant_flag is None and model == MODEL  # the serve phase itself
    greedy = SamplingConfig(temperature=0.0)
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = start_nodes(parts, work, extra, tag="" if model == MODEL else f"_{model}")
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(extra)} processes ready in "
                   f"{time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"nodes did work before the main path: {before}")
            if st["quant"] != (quant_flag or "none"):
                raise AssertionError(f"node serves quant {st['quant']}, want {quant_flag}")
        prompts = serve_prompts(cfg.vocab_size, prompt_lens)
        streams, timing = [], []

        async def drive():
            async with ChainClient([("127.0.0.1", n["port"]) for n in nodes],
                                   sampling=greedy, prefill_chunk=512) as client:
                for p in prompts:
                    stamps: List[float] = []
                    t_req = time.perf_counter()
                    ids = await client.generate_ids(
                        p, max_new_tokens=new_tokens,
                        on_token=lambda _tok: stamps.append(time.perf_counter()))
                    streams.append(ids)
                    timing.append((t_req, stamps))

        asyncio.run(drive())
        after = stats()
        rates = []
        for i, (p, ids, (t_req, stamps)) in enumerate(zip(prompts, streams, timing)):
            if len(ids) != new_tokens:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {new_tokens}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            rates.append((ttft, tps))
            beside = ""
            if baseline is not None:
                b_ttft, b_tps = baseline["rates"][PROMPT_LENS.index(len(p))]
                beside = f"; bf16 serve in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s"
            say(phase, f"prompt {len(p)} tokens: TTFT {ttft:.1f} ms, decode "
                       f"{tps:.1f} tok/s over {len(stamps) - 1} steps ({card}){beside}")

        # every forward pass of a prompt chunk pads to its bucket; decode is 1 row
        rows = [bucket_len(len(p[c:c + 512])) for p in prompts for c in range(0, len(p), 512)]
        decode_passes = len(prompts) * (new_tokens - 1)
        rows += [1] * decode_passes
        expected_passes = len(rows)
        route_launches = {"split": 0, "mma": 0}
        small = sum(r <= MAX_KERNEL_ROWS for r in rows)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        gemv_total = {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()}
        node_graphs = []
        for a_ in after:
            passes = a_["forward_passes"]
            kern = {name: k["launches"] for name, k in a_["kernels"].items()}
            layers = a_["end_layer"] - a_["start_layer"] + 1
            last = a_["stage"] == a_["num_stages"] - 1
            want = {"flash_gqa": layers * passes, "paged_decode_gqa": 0,
                    "w8a16_matmul": 0, "w4a16_matvec": 0, "fused_lane_delta": 0}
            if quant_flag is not None:
                want[QMM_KERNEL_OF[quant_flag]] = gemv_launches(layers, last, small, passes)
            say(phase, f"node stage {a_['stage']} on {a_['device']} (quant {a_['quant']}, "
                       f"{a_['quantized_bytes']} parameter bytes): {passes} forward passes "
                       f"({small} of at most {MAX_KERNEL_ROWS} rows); launches {kern} "
                       f"(want {want}: {kern == want})")
            # decode steps take the split-KV route, prompt chunks the tensor cores
            routes = flash_routes(a_)
            want_routes = {"split": layers * decode_passes,
                           "mma": layers * (expected_passes - decode_passes)}
            say(phase, f"node stage {a_['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            # the GEMVs by route: every dispatch of at most 64 rows, the head on 1 row
            g_routes = gemv_routes(a_)
            want_g = {name: {"mma": 0, "simt": 0} for name in g_routes}
            if quant_flag is not None:
                want_g[QMM_KERNEL_OF[quant_flag]] = gemv_route_launches(
                    cfg, quant_flag, layers, last, [r for r in rows if r <= MAX_KERNEL_ROWS],
                    [1] * passes)
                say(phase, f"node stage {a_['stage']}: GEMV routes {g_routes} (want {want_g}: "
                           f"{g_routes == want_g})")
            node_graphs.append(check_node_graphs(phase, a_, decode_passes))
            if (passes != expected_passes or kern != want or kern["flash_gqa"] == 0
                    or routes != want_routes or g_routes != want_g):
                raise AssertionError(f"stage {a_['stage']}: {passes} passes (want "
                                     f"{expected_passes}), launches {kern} (want {want}), "
                                     f"flash_gqa routes {routes} (want {want_routes}), "
                                     f"GEMV routes {g_routes} (want {want_g})")
            for name, per in g_routes.items():
                for r, v in per.items():
                    gemv_total[name][r] += v
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        extra_out: Dict[str, Any] = {}
        if full:
            extra_out["concurrent"] = concurrent_waves(phase, card, nodes, prompts, streams,
                                                       greedy)
        stop_nodes(nodes)
        nodes = []

        # the same stage executors in this process, over the same parts,
        # eager: the graphed nodes' streams must be theirs, token for token
        loaded = quantize_loaded([load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                        device=DEVICE) for s in range(2)],
                                 quant_flag)
        kernel_ex = eager([Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
                           for params, spec, _ in loaded])

        async def local(executors):
            client = make_local_client(executors, greedy)
            return [await client.generate_ids(p, max_new_tokens=new_tokens) for p in prompts]

        local_streams = asyncio.run(local(kernel_ex))
        for p, a_, b_ in zip(prompts, streams, local_streams):
            if a_ != b_:
                diverge = first_divergence(a_, b_)
                raise AssertionError(f"prompt {len(p)}: served stream != in-process eager "
                                     f"executors' stream from token {diverge}")
        say(phase, "served streams (graphed decode steps) equal the in-process eager "
                   f"executors' streams, token for token ({len(prompts)} requests x "
                   f"{new_tokens} tokens)")
        if full:
            check_frozen_fill_caught(
                phase, "one-session executors",
                lambda: [Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
                         for params, spec, _ in loaded], prompts[1])
        if quant_flag is None:
            # the longest prompt but one (the serve phase's 300 tokens)
            extra_out["step_share"] = stage_step_share(phase, card, loaded, prompts[-2], cfg,
                                                       capture=full)

        probe = [kernel_ex[0], LastStageProbe(cfg, loaded[1][1], loaded[1][0], max_len=MAX_LEN)]
        if quant_flag is None:  # the kernel path against plain attention
            plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
            plain_probe = eager([Qwen3StageExecutor(plain_cfg, loaded[0][1], loaded[0][0],
                                                    max_len=MAX_LEN),
                                 LastStageProbe(plain_cfg, loaded[1][1], loaded[1][0],
                                                max_len=MAX_LEN)])
            plain_ctx, plant, faults, what = contextlib.nullcontext, planted_attention_fault, \
                E2E_FAULTS, "plain attention"
        else:  # the GEMV kernels against their plain versions
            plain_probe, plain_ctx, plant, faults, what = probe, plain_gemvs, planted_gemv_fault, \
                QUANT_E2E_FAULTS, "plain GEMVs"
        check_kernel_path(phase, cfg, probe, plain_probe, prompts, streams, plain_ctx, plant,
                          faults, what)
        del kernel_ex, probe, plain_probe, loaded
        torch.cuda.empty_cache()
        return dict({"launches": launches, "flash_routes": route_launches,
                     "gemv_routes": gemv_total, "passes": expected_passes,
                     "rates": rates, "streams": streams, "graphs": node_graphs}, **extra_out)
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


@contextlib.contextmanager
def planted_paged_fault(fault: str):
    """Every paged_decode_gqa kernel launch runs on inputs that reproduce
    `fault` (see plant_paged_fault), until the block ends."""
    from inferd_tpu_torch.ops import attention as A

    launch = A._paged_launch

    def faulty(q, k_pool, v_pool, table, q_positions, kv_len, *rest):
        return launch(q, *plant_paged_fault(fault, k_pool, v_pool, table, q_positions, kv_len),
                      *rest)

    A._paged_launch = faulty
    try:
        yield
    finally:
        A._paged_launch = launch


class LaneProbe:
    """The last stage's lane executor, run as an inner stage so that it
    returns its hidden state on every real row; the last real token's
    logits are computed beside it from the same stage params."""

    def __init__(self, cfg, spec, params, **kw):
        from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

        inner = dataclasses.replace(spec, num_stages=spec.num_stages + 1)
        self.ex = BatchedStageExecutor(cfg, inner, params, **kw)
        self.cfg, self.params = cfg, params

    def process(self, session_id, payload):
        import torch

        from inferd_tpu_torch.models import qwen3

        out = self.ex.process(session_id, payload)
        last = out["hidden"][:, -1:].to(self.ex.device)
        with torch.no_grad():
            out["logits"] = qwen3.unembed(self.params, self.cfg, last)[:, 0].cpu()
        return out

    def process_batch(self, items):
        import torch

        from inferd_tpu_torch.models import qwen3

        outs = self.ex.process_batch(items)
        for out in outs:
            if isinstance(out, Exception):
                raise out
            with torch.no_grad():
                out["logits"] = qwen3.unembed(self.params, self.cfg,
                                              out["hidden"][:, -1:].to(self.ex.device))[:, 0].cpu()
        return outs

    def end_session(self, session_id):
        self.ex.end_session(session_id)


def teacher_forced_lanes(executors, prompts, streams, names=None) -> List[List[Any]]:
    """Per prompt, (last-stage hidden of the real rows, last logits) per
    step through the lane executors in this process: each prompt's
    512-token chunks one session at a time (prefill), then the first
    DECODE_CHECKED decode steps of EVERY stream co-batched, one
    process_batch per stage per step, so each step runs all sessions'
    lanes live at their ragged lengths. `names` binds session i to adapter
    names[i] (None: the base model), stamped on every stage of its first
    chunk as the chain client stamps it."""
    import numpy as np

    steps: List[List[Any]] = [[] for _ in prompts]
    sids = [f"forced-{i}" for i in range(len(prompts))]
    for i, p in enumerate(prompts):
        for c in range(0, len(p), 512):
            stamp = {"adapter": names[i]} if names and names[i] and c == 0 else {}
            out = {"tokens": np.asarray([p[c:c + 512]], np.int32), "start_pos": c,
                   "real_len": len(p[c:c + 512])}
            for ex in executors:
                out = ex.process(sids[i], {**out, **stamp})
            steps[i].append((out["hidden"].float(), out["logits"].float()))
    for j in range(DECODE_CHECKED):
        items = [(sid, {"tokens": [[ids[j]]], "start_pos": len(p) + j, "real_len": 1})
                 for sid, p, ids in zip(sids, prompts, streams)]
        for ex in executors:
            outs = ex.process_batch(items)
            for o in outs:
                if isinstance(o, Exception):
                    raise o
            items = [(sid, {"hidden": o["hidden"], "start_pos": o["start_pos"],
                            "real_len": o["real_len"]}) for (sid, _), o in zip(items, outs)]
        for i, o in enumerate(outs):
            steps[i].append((o["hidden"].float(), o["logits"].float()))
    for ex in executors:
        for sid in sids:
            ex.end_session(sid)
    return steps


def lane_executors(cfg, loaded, block_size: int, probe: bool, adapters=None):
    """The two stages' lane executors as the serve_lanes nodes build them;
    with `probe` the last one is a LaneProbe; with `adapters` (a list of
    adapter directories) each serves its stage's slice of that catalog, as
    a run_node --adapters node does."""
    from inferd_tpu_torch.runtime.adapters import AdapterRegistry
    from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

    kw = dict(lanes=LANES, max_len=MAX_LEN, block_size=block_size,
              prefill_chunk=LANE_PREFILL_CHUNK)

    def reg(spec):
        if adapters is None:
            return None
        return AdapterRegistry(cfg, adapters, start_layer=spec.start_layer,
                               end_layer=spec.end_layer + 1, device=DEVICE)

    (p0, s0, _), (p1, s1, _) = loaded
    last = (LaneProbe(cfg, s1, p1, adapters=reg(s1), **kw) if probe
            else BatchedStageExecutor(cfg, s1, p1, adapters=reg(s1), **kw))
    return [BatchedStageExecutor(cfg, s0, p0, adapters=reg(s0), **kw), last]


def eager_lanes(*args, **kw):
    """lane_executors with their graphs off (eager)."""
    return eager(lane_executors(*args, **kw))


def check_teacher_forced(phase: str, tag: str, cfg, loaded, block_size: int, prompts, streams,
                         faults=(), gemv: bool = False, lora=None) -> Dict[str, Any]:
    """The lane executors' kernel path against their plain path, teacher-
    forced over every prompt chunk and the first DECODE_CHECKED co-batched
    decode steps of the streams, held to HIDDEN_TOL and LOGIT_TOL on every
    prompt. The plain path is plain attention (attn_impl="xla"), with
    `gemv` the plain GEMVs, or with `lora` = (adapter directories, the
    sessions' adapter names) the plain lane delta, on executors serving
    that catalog. Each planted fault (paged-attention, GEMV or lane-delta
    faults) must break one of the limits on some lane; a paged fault only
    on lanes whose chain spans more than one block (a one-block lane under
    either fault reads only the zeroed scratch block or nothing, so its
    attention is exactly zero and shows nothing of a multi-block walk), a
    lane-delta fault only on tenant lanes. With `lora`, the base sessions'
    steps must also be bit-identical to those of executors without a
    registry. The per-prompt readings are printed."""
    import torch

    dirs, names = lora if lora is not None else (None, None)
    if lora is not None:
        plain_cfg, plain_ctx, plant, what = cfg, plain_lora, planted_lora_fault, "plain lane delta"
    elif gemv:
        plain_cfg, plain_ctx, plant, what = cfg, plain_gemvs, planted_gemv_fault, "plain GEMVs"
    else:
        plain_cfg, plain_ctx, plant, what = (dataclasses.replace(cfg, attn_impl="xla"),
                                             contextlib.nullcontext, planted_paged_fault,
                                             "plain attention")
    with plain_ctx():
        plain = teacher_forced_lanes(eager_lanes(plain_cfg, loaded, block_size, True, dirs),
                                     prompts, streams, names)
    torch.cuda.empty_cache()
    kernel_ex = eager_lanes(cfg, loaded, block_size, True, dirs)

    def per_prompt():
        got = teacher_forced_lanes(kernel_ex, prompts, streams, names)
        return got, [compare_steps(g, r, cfg.hidden_size) for g, r in zip(got, plain)]

    t0 = time.perf_counter()
    sound, readings = per_prompt()
    torch.cuda.synchronize()
    sound_s = time.perf_counter() - t0
    readings = {"sound": readings}
    for f in faults:
        with plant(f):
            readings[f] = per_prompt()[1]
    del kernel_ex
    torch.cuda.empty_cache()
    if lora is not None:
        bare_ex = eager_lanes(cfg, loaded, block_size, True)
        t0 = time.perf_counter()
        bare = teacher_forced_lanes(bare_ex, prompts, streams)
        torch.cuda.synchronize()
        say(phase, f"{tag}: one teacher-forced pass (every prompt chunk, then {DECODE_CHECKED} "
                   f"co-batched decode windows) took {sound_s:.3f} s on the host clock with the "
                   f"registry, {time.perf_counter() - t0:.3f} s on executors without one")
        del bare_ex
        base = [i for i, n in enumerate(names) if n is None]
        same = all(torch.equal(g[0], b[0]) and torch.equal(g[1], b[1])
                   for i in base for g, b in zip(sound[i], bare[i]))
        say(phase, f"{tag}: base sessions' hidden rows and logits over {len(sound[base[0]])} "
                   f"steps each ({DECODE_CHECKED} in windows mixed with tenants) bit-identical to "
                   f"executors without a registry: {same}")
        if not same:
            raise AssertionError(f"{tag}: base lanes differ from executors without a registry")
        del bare
        torch.cuda.empty_cache()
    bs = block_size or PAGED_BS
    if lora is not None:
        trip_lanes, kind = [i for i, n in enumerate(names) if n is not None], "tenant "
    else:
        trip_lanes = [i for i, p in enumerate(prompts) if gemv or len(p) + DECODE_CHECKED > bs]
        kind = "" if gemv else "multi-block "
    n_steps = sum(len(r) for r in plain)
    for name, per in readings.items():
        rows = ", ".join(f"{len(p)}: {h:.4g} / {l:.3%}" for p, (h, l) in zip(prompts, per))
        say(phase, f"{tag}: kernel path {'' if name == 'sound' else 'with fault ' + name + ' '}"
                   f"vs {what} over {n_steps} teacher-forced steps "
                   f"({DECODE_CHECKED} co-batched decode steps of {len(prompts)} lanes); "
                   f"per prompt, hidden row error / logits share of max |logit| (tol "
                   f"{HIDDEN_TOL} / {LOGIT_TOL:.0%}): {rows}")
    h_err = max(h for h, _ in readings["sound"])
    l_err = max(l for _, l in readings["sound"])
    if not (h_err <= HIDDEN_TOL and l_err <= LOGIT_TOL):
        raise AssertionError(f"{tag}: kernel path vs {what}: hidden {h_err}, logits {l_err}")
    for f in faults:
        tripped = [i for i in trip_lanes
                   if readings[f][i][0] > HIDDEN_TOL or readings[f][i][1] > LOGIT_TOL]
        say(phase, f"{tag}: fault {f} exceeds the limits on {len(tripped)} of "
                   f"{len(trip_lanes)} {kind}lanes")
        if not tripped:
            raise AssertionError(f"{tag}: planted fault {f} passes the checks on every lane it "
                                 f"can reach: {readings[f]}")
    return {name: [list(r) for r in per] for name, per in readings.items()}


def run_serve_lanes(card: str, parts: str, work: str, quant_flag=None,
                    baseline=None) -> Dict[str, Any]:
    """The `serve_lanes` phase, or with quant_flag `serve_lanes_quant` on
    --quant lane nodes (every decode GEMV then runs at M = LANES rows;
    `baseline`'s bf16 rates are printed beside its own)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    phase = "serve_lanes" if quant_flag is None else "serve_lanes_quant"
    node_args = LANE_NODE_ARGS + ([] if quant_flag is None else ["--quant", quant_flag])
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = start_nodes(parts, work, node_args)
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(node_args)} processes "
                   f"ready in {time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            ex = st["executor"]
            if (any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]
                    or ex["batched_steps"] or ex["prefill_steps"]):
                raise AssertionError(f"nodes did work before the main path: {before}")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LANE_PROMPT_LENS]

        async def drive():
            async with ChainClient([("127.0.0.1", n["port"]) for n in nodes],
                                   sampling=greedy, prefill_chunk=512) as client:
                async def one(p):
                    stamps: List[float] = []
                    t_req = time.perf_counter()
                    ids = await client.generate_ids(
                        p, max_new_tokens=NEW_TOKENS,
                        on_token=lambda _tok: stamps.append(time.perf_counter()))
                    return ids, t_req, stamps

                return await asyncio.gather(*(one(p) for p in prompts))

        t_all = time.perf_counter()
        served = asyncio.run(drive())
        wall = time.perf_counter() - t_all
        after = stats()
        streams = [ids for ids, _, _ in served]
        rates = []
        for i, (p, (ids, t_req, stamps)) in enumerate(zip(prompts, served)):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            rates.append((ttft, tps))
            beside = ""
            if baseline is not None:
                b_ttft, b_tps = baseline["rates"][i]
                beside = f"; bf16 serve_lanes in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s"
            say(phase, f"session, prompt {len(p)} tokens: TTFT {ttft:.1f} ms, decode "
                       f"{tps:.1f} tok/s over {len(stamps) - 1} steps ({card}){beside}")
        total = sum(len(ids) for ids in streams)
        beside = ("" if baseline is None else
                  f"; bf16 serve_lanes in this run: {baseline['tokens_per_s']:.1f} tok/s")
        say(phase, f"aggregate: {total} tokens from {len(prompts)} concurrent sessions in "
                   f"{wall:.2f} s = {total / wall:.1f} tok/s ({card}){beside}")

        # prefill dispatches: the client's 512-token chunks, each split into
        # LANE_PREFILL_CHUNK-token dispatches on the node, padded to a bucket
        pieces = [len(c[j:j + LANE_PREFILL_CHUNK]) for p in prompts
                  for c in (p[i:i + 512] for i in range(0, len(p), 512))
                  for j in range(0, len(c), LANE_PREFILL_CHUNK)]
        want_prefill = len(pieces)
        small_prefill = sum(bucket_len(n) <= MAX_KERNEL_ROWS for n in pieces)
        want_decode_tokens = len(prompts) * (NEW_TOKENS - 1)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        route_launches = {"split": 0, "mma": 0}
        gemv_total = {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()}
        mean_batches = []
        paged_split = 0
        node_graphs = []
        for st in after:
            ex = st["executor"]
            layers = st["end_layer"] - st["start_layer"] + 1
            last = st["stage"] == st["num_stages"] - 1
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            mean = toks / steps if steps else 0.0
            mean_batches.append(mean)
            want = {"flash_gqa": layers * ex["prefill_steps"], "paged_decode_gqa": layers * steps,
                    "w8a16_matmul": 0, "w4a16_matvec": 0, "fused_lane_delta": 0}
            if quant_flag is not None:
                # decode dispatches run LANES rows: every one takes the kernels
                want[QMM_KERNEL_OF[quant_flag]] = gemv_launches(
                    layers, last, steps + small_prefill, steps + ex["prefill_steps"])
            say(phase, f"node stage {st['stage']} on {st['device']} (quant {st['quant']}, "
                       f"{st['quantized_bytes']} parameter bytes): {steps} decode dispatches "
                       f"serving {toks} session steps (mean co-batch {mean:.3f}), "
                       f"{ex['prefill_steps']} prefill dispatches ({small_prefill} of at most "
                       f"{MAX_KERNEL_ROWS} rows); launches {kern} (want {want}: {kern == want}); "
                       f"blocks {ex['paged']['blocks_used']} used after the run")
            routes = flash_routes(st)  # prefill chunks only, on the tensor cores
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            say(phase, f"node stage {st['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            split, want_split = paged_splits(phase, st, cfg)
            paged_split += split
            node_graphs.append(check_node_graphs(phase, st, steps))
            # the GEMVs by route: decode at LANES rows (the head too), prefill
            # pieces at their bucket (the head on their last row)
            g_routes = gemv_routes(st)
            want_g = {name: {"mma": 0, "simt": 0} for name in g_routes}
            if quant_flag is not None:
                want_g[QMM_KERNEL_OF[quant_flag]] = gemv_route_launches(
                    cfg, quant_flag, layers, last,
                    [LANES] * steps + [bucket_len(n) for n in pieces
                                       if bucket_len(n) <= MAX_KERNEL_ROWS],
                    [LANES] * steps + [1] * ex["prefill_steps"])
                say(phase, f"node stage {st['stage']}: GEMV routes {g_routes} (want {want_g}: "
                           f"{g_routes == want_g})")
            for name, per in g_routes.items():
                for r, v in per.items():
                    gemv_total[name][r] += v
            if (kern != want or kern["paged_decode_gqa"] == 0 or toks != want_decode_tokens
                    or ex["prefill_steps"] != want_prefill or not mean > 1.0 or st["errors"]
                    or routes != want_routes or g_routes != want_g or split != want_split):
                raise AssertionError(
                    f"stage {st['stage']}: launches {kern} (want {want}), flash_gqa routes "
                    f"{routes} (want {want_routes}), GEMV routes {g_routes} (want {want_g}), "
                    f"paged split launches {split} (want {want_split}), "
                    f"{steps} decode "
                    f"dispatches for {toks} steps (want {want_decode_tokens}), "
                    f"{ex['prefill_steps']} prefill dispatches (want {want_prefill}), "
                    f"mean co-batch {mean}, {st['errors']} errors")
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        stop_nodes(nodes)
        nodes = []

        loaded = quantize_loaded([load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                        device=DEVICE) for s in range(2)],
                                 quant_flag)

        async def local(executors):
            client = make_local_client(executors, greedy)
            return [await client.generate_ids(p, max_new_tokens=NEW_TOKENS) for p in prompts]

        local_streams = asyncio.run(local(eager(lane_executors(cfg, loaded, PAGED_BS, False))))
        torch.cuda.empty_cache()
        for p, a_, b_ in zip(prompts, streams, local_streams):
            if a_ != b_:
                diverge = first_divergence(a_, b_)
                raise AssertionError(f"prompt {len(p)}: served stream != in-process eager lane "
                                     f"executors' stream from token {diverge}")
        say(phase, "served streams (graphed co-batched decode steps) equal the in-process eager "
                   f"lane executors' streams (sessions one at a time), token for token "
                   f"({len(prompts)} x {NEW_TOKENS} tokens)")
        if quant_flag is None:
            check_frozen_fill_caught(phase, "paged lane executors",
                                     lambda: lane_executors(cfg, loaded, PAGED_BS, False),
                                     prompts[2])
            torch.cuda.empty_cache()

        out = {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
               "paged_split": paged_split, "mean_batch": mean_batches,
               "rates": rates, "tokens_per_s": total / wall, "prompts": prompts,
               "streams": streams, "graphs": node_graphs}
        if quant_flag is not None:
            out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                    prompts, streams, QUANT_E2E_FAULTS, gemv=True)
            return out
        out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                prompts, streams, LANE_E2E_FAULTS)
        pick = [LANE_PROMPT_LENS.index(n) for n in DENSE_LANE_PROMPTS]
        out["dense_e2e"] = check_teacher_forced(
            phase, "dense lanes", cfg, loaded, 0, [prompts[i] for i in pick],
            [streams[i] for i in pick])
        return out
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def write_tenants(work: str) -> List[str]:
    """LORA_TENANTS as peft adapter directories at Qwen3-0.6B's full width
    over all its layers, written from a seed by ops.lora.save_adapter: A
    N(0, 1/in), B N(0, LORA_TENANT_B_SD^2/r), alpha = 2r, so each delta's
    RMS is about a quarter of its input's, some 40% of the base
    projection's (N(0, 0.02^2) weights over 1024 inputs), and the tenants'
    greedy streams leave the base's."""
    import numpy as np

    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import lora as L

    cfg = get_config(MODEL)
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}
    rng = np.random.default_rng(4)
    dirs = []
    for name, r, targets in LORA_TENANTS:
        layers = {}
        for t in targets:
            din, dout = dims[t]
            a = rng.standard_normal((cfg.num_layers, din, r), dtype=np.float32) / np.sqrt(din)
            b = rng.standard_normal((cfg.num_layers, r, dout), dtype=np.float32) * (
                LORA_TENANT_B_SD / np.sqrt(r))
            layers[t] = (a, b)
        dirs.append(L.save_adapter(os.path.join(work, "adapters", name), layers, alpha=2 * r, r=r))
    return dirs


def run_serve_lanes_lora(card: str, parts: str, work: str, baseline) -> Dict[str, Any]:
    """The `serve_lanes_lora` phase: serve_lanes' prompts on --adapters lane
    nodes, session i bound to t0, t1, t2 or the base model in turn;
    `baseline` is serve_lanes' result from this run (its streams are the
    base model's on the same prompts, its rates printed beside these)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    phase = "serve_lanes_lora"
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    t0 = time.perf_counter()
    dirs = write_tenants(work)
    kinds = ", ".join(f"{n}: r {r}, {len(t)} targets" for n, r, t in LORA_TENANTS)
    say(phase, f"wrote {len(dirs)} peft tenants ({kinds}) over {cfg.num_layers} layers in "
               f"{time.perf_counter() - t0:.1f}s")
    names = [LORA_TENANTS[i % 4][0] if i % 4 < 3 else None for i in range(LANES)]
    prompts, base_streams = baseline["prompts"], baseline["streams"]
    n_targets = len(set().union(*(t for _, _, t in LORA_TENANTS)))
    node_args = LANE_NODE_ARGS + ["--adapters", ",".join(dirs)]
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts, s, work, node_args, tag="_lora") for s in range(2)]
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(LANE_NODE_ARGS)} --adapters "
                   f"t0,t1,t2 processes ready in {time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            ex = st["executor"]
            if (any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]
                    or ex["batched_steps"] or ex["prefill_steps"] or ex["adapters"]["loads"]):
                raise AssertionError(f"nodes did work before the main path: {before}")

        async def drive():
            addrs = [("127.0.0.1", n["port"]) for n in nodes]
            clients = {nm: ChainClient(addrs, sampling=greedy, prefill_chunk=512, adapter=nm)
                       for nm in set(names)}

            async def one(p, nm):
                stamps: List[float] = []
                t_req = time.perf_counter()
                ids = await clients[nm].generate_ids(
                    p, max_new_tokens=NEW_TOKENS,
                    on_token=lambda _tok: stamps.append(time.perf_counter()))
                return ids, t_req, stamps

            return await asyncio.gather(*(one(p, nm) for p, nm in zip(prompts, names)))

        t_all = time.perf_counter()
        served = asyncio.run(drive())
        wall = time.perf_counter() - t_all
        after = stats()
        streams = [ids for ids, _, _ in served]
        for i, (p, nm, (ids, t_req, stamps)) in enumerate(zip(prompts, names, served)):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            b_ttft, b_tps = baseline["rates"][i]
            say(phase, f"session {i} ({nm or 'base'}), prompt {len(p)} tokens: TTFT {ttft:.1f} ms, "
                       f"decode {tps:.1f} tok/s over {len(stamps) - 1} steps ({card}); "
                       f"serve_lanes in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s")
        total = sum(len(ids) for ids in streams)
        say(phase, f"aggregate: {total} tokens from {len(prompts)} concurrent sessions in "
                   f"{wall:.2f} s = {total / wall:.1f} tok/s ({card}); serve_lanes in this run: "
                   f"{baseline['tokens_per_s']:.1f} tok/s")
        for i, (nm, a_, b_) in enumerate(zip(names, streams, base_streams)):
            if (nm is None) != (a_ == b_):
                how = "differs from" if nm is None else "equals"
                raise AssertionError(f"session {i} ({nm or 'base'}): stream {how} the base "
                                     "model's on the same prompt (serve_lanes)")
        say(phase, "tenant streams differ from the base model's on the same prompts, and the "
                   "base sessions' equal serve_lanes', token for token")

        def pieces(idx):
            return [len(c[j:j + LANE_PREFILL_CHUNK]) for i in idx
                    for c in (prompts[i][k:k + 512] for k in range(0, len(prompts[i]), 512))
                    for j in range(0, len(c), LANE_PREFILL_CHUNK)]

        want_prefill = len(pieces(range(len(prompts))))
        want_tenant_prefill = len(pieces([i for i, nm in enumerate(names) if nm]))
        want_decode_tokens = len(prompts) * (NEW_TOKENS - 1)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        route_launches = {"split": 0, "mma": 0}
        mean_batches = []
        paged_split = 0
        node_graphs = []
        for st in after:
            ex = st["executor"]
            layers = st["end_layer"] - st["start_layer"] + 1
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            a_dec, a_pre = ex["adapter_steps"], ex["adapter_prefill_steps"]
            mean = toks / steps if steps else 0.0
            mean_batches.append(mean)
            want = {"flash_gqa": layers * ex["prefill_steps"], "paged_decode_gqa": layers * steps,
                    "w8a16_matmul": 0, "w4a16_matvec": 0,
                    "fused_lane_delta": layers * n_targets * (a_dec + a_pre)}
            say(phase, f"node stage {st['stage']} on {st['device']}: {steps} decode dispatches "
                       f"({a_dec} with a tenant lane, {steps - a_dec} all-base) serving {toks} "
                       f"session steps (mean co-batch {mean:.3f}; serve_lanes in this run "
                       f"{baseline['mean_batch'][st['stage']]:.3f}), {ex['prefill_steps']} prefill "
                       f"dispatches ({a_pre} of tenant sessions); launches {kern} (want {want}: "
                       f"{kern == want}); registry {ex['adapters']}")
            routes = flash_routes(st)
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            say(phase, f"node stage {st['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            split, want_split = paged_splits(phase, st, cfg)
            paged_split += split
            node_graphs.append(check_node_graphs(phase, st, steps))
            if (kern != want or kern["fused_lane_delta"] == 0 or a_pre != want_tenant_prefill
                    or routes != want_routes or split != want_split
                    or not 0 < a_dec <= steps or toks != want_decode_tokens
                    or ex["prefill_steps"] != want_prefill or ex["adapters"]["loads"] != 3
                    or st["errors"]):
                raise AssertionError(
                    f"stage {st['stage']}: launches {kern} (want {want}), {a_pre} tenant prefill "
                    f"dispatches (want {want_tenant_prefill}), {a_dec} of {steps} decode "
                    f"dispatches with a tenant, {toks} steps (want {want_decode_tokens}), "
                    f"{ex['prefill_steps']} prefill dispatches (want {want_prefill}), registry "
                    f"{ex['adapters']} (want 3 loads), {st['errors']} errors, flash_gqa "
                    f"routes {routes} (want {want_routes}), paged split launches {split} "
                    f"(want {want_split})")
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        stop_nodes(nodes)
        nodes = []

        loaded = [load_stage_checkpoint(stage_checkpoint_path(parts, s), device=DEVICE)
                  for s in range(2)]
        local_ex = eager_lanes(cfg, loaded, PAGED_BS, False, dirs)

        async def local():
            out = []
            for p, nm in zip(prompts, names):
                client = make_local_client(local_ex, greedy, adapter=nm)
                out.append(await client.generate_ids(p, max_new_tokens=NEW_TOKENS))
            return out

        local_streams = asyncio.run(local())
        del local_ex
        torch.cuda.empty_cache()
        for p, nm, a_, b_ in zip(prompts, names, streams, local_streams):
            if a_ != b_:
                diverge = next(i for i, (x, y) in enumerate(zip(a_, b_)) if x != y)
                raise AssertionError(f"prompt {len(p)} ({nm or 'base'}): served stream != "
                                     f"in-process lane executors' stream from token {diverge}")
        say(phase, "served streams (graphed co-batched decode steps) equal the in-process "
                   "eager lane executors' with the same registries (sessions one at a time), "
                   f"token for token ({len(prompts)} x {NEW_TOKENS} tokens)")
        gemv_total = {name: {r: sum(gemv_routes(st)[name][r] for st in after)
                             for r in ("mma", "simt")} for name in QMM_KERNEL_OF.values()}
        out = {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
               "paged_split": paged_split, "mean_batch": mean_batches,
               "tokens_per_s": total / wall, "graphs": node_graphs, "names": names,
               "streams": streams, "dirs": dirs}
        out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                prompts, streams, LORA_E2E_FAULTS,
                                                lora=(dirs, names))
        return out
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


# serve_tenant_routes: the t0 prompts of serve_lanes_lora (LANE_PROMPT_LENS
# 16 and 300), in the order the planned sessions run, and the base session's
TENANT_ROUTE_PROMPTS = (0, 4, 0, 4)
TENANT_BASE_PROMPT = 1
# more warm sessions on B while its gossiped svc_ms still outweighs the
# affinity bonus (a fresh process's graph captures ride its svc_ms EWMA for
# a few dozen forwards, ~113 ms once on a card shared with 39 processes)
TENANT_EXTRA_WARM = 3


def wait_view(phase: str, entry_port: int, want: Callable[[Dict[str, Any]], bool], what: str,
              timeout_s: float = 15.0) -> Dict[str, Any]:
    """The entry's gossip view of stage 1 ({node_id: record}, its /stats)
    once `want` holds of it."""
    deadline = time.monotonic() + timeout_s
    while True:
        view = http_get_json(f"http://127.0.0.1:{entry_port}/stats")["dht"].get("1", {})
        if want(view):
            return view
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: {what}: the entry's stage-1 view {view}")
        time.sleep(0.05)


def run_serve_tenant_routes(card: str, parts: str, work: str, lanes, lanes_lora) -> Dict[str, Any]:
    """The `serve_tenant_routes` phase: tenant sessions planned to the
    stage-1 replica whose gossiped `ada` holds their adapter. `lanes` and
    `lanes_lora` are serve_lanes' and serve_lanes_lora's results from this
    run: the base and the tenant streams the served ones are held to."""
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.client.swarm_client import SwarmClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.control.dstar import node_cost
    from inferd_tpu_torch.runtime.adapters import AdapterAffinity

    phase = "serve_tenant_routes"
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    t_phase = time.perf_counter()
    prompts, names = lanes["prompts"], lanes_lora["names"]
    if any(names[i] != "t0" for i in TENANT_ROUTE_PROMPTS) or names[TENANT_BASE_PROMPT] == "t0":
        raise AssertionError(f"{phase}: serve_lanes_lora's bindings {names}")
    n_targets = len(set().union(*(t for _, _, t in LORA_TENANTS)))
    node_args = LANE_NODE_ARGS + ["--adapters", ",".join(lanes_lora["dirs"]), "--max-len",
                                  str(MAX_LEN), "--parts", parts, "--rebalance-period",
                                  str(STILL_REBALANCE_S)]
    nodes: List[Dict[str, Any]] = []
    try:
        seed = launch_seed(os.path.join(work, "tenant_seed.log"))
        nodes.append(seed)
        nodes += [launch_node(stage, os.path.join(work, f"tenant{i}.log"),
                              node_args + ["--bootstrap", f"127.0.0.1:{seed['port']}"])
                  for i, stage in enumerate((0, 1, 1))]
        entry, a, b = nodes[1:]
        for n in nodes:
            wait_ready(n)
        ids = {"A": f"127.0.0.1:{a['port']}", "B": f"127.0.0.1:{b['port']}"}
        label = {v: k for k, v in ids.items()}
        gossip_s = wait_gossip(phase, [entry, a, b])
        say(phase, f"3 run_node --device {DEVICE} {' '.join(LANE_NODE_ARGS)} --adapters t0,t1,t2 "
                   f"processes and a tools/seed ready in {time.perf_counter() - t_phase:.1f}s, "
                   f"gossip full {gossip_s:.2f}s later")

        def stats():
            return {k: http_get_json(f"http://127.0.0.1:{n['port']}/stats")
                    for k, n in (("entry", entry), ("A", a), ("B", b))}

        before = stats()  # fresh processes: every count starts at 0
        for st in before.values():
            ex = st["executor"]
            if (any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]
                    or ex["adapters"]["loads"]):
                raise AssertionError(f"{phase}: nodes did work before the main path: {before}")
        view = wait_view(phase, entry["port"], lambda v: all(
            v.get(nid, {}).get("ada") == [] for nid in ids.values()), "no empty ada")

        def serve(client, p):
            async def go():
                async with client as c:
                    return await c.generate_ids(p, max_new_tokens=NEW_TOKENS)

            return asyncio.run(go())

        def idle(v):
            return all(v.get(nid, {}).get("load") == 0 for nid in ids.values())

        chain = [("127.0.0.1", entry["port"]), ("127.0.0.1", b["port"])]
        aff = AdapterAffinity("t0")

        def warm_view():
            return wait_view(phase, entry["port"], lambda v: idle(v) and "t0" in v.get(
                ids["B"], {}).get("ada", ()) and v.get(ids["A"], {}).get("ada") == [],
                "t0 not gossiped resident on B alone")

        def costs(view):
            return {k: round(node_cost(view[nid], affinity=aff), 4) for k, nid in ids.items()}

        # t0 warmed on B through a fixed chain, on both prompts, so every
        # table width the planned sessions meet has its graph captured
        warm_idx = sorted(set(TENANT_ROUTE_PROMPTS))
        warm = [serve(ChainClient(chain, sampling=greedy, prefill_chunk=512, adapter="t0"),
                      prompts[i]) for i in warm_idx]
        view = warm_view()
        for _ in range(TENANT_EXTRA_WARM):
            if costs(view)["B"] < costs(view)["A"]:
                break
            say(phase, f"B's svc_ms {view[ids['B']].get('svc_ms')} still outweighs the affinity "
                       f"bonus (tenant costs {costs(view)}): one more warm session on B")
            warm_idx.append(TENANT_ROUTE_PROMPTS[0])
            warm.append(serve(ChainClient(chain, sampling=greedy, prefill_chunk=512,
                                          adapter="t0"), prompts[warm_idx[-1]]))
            view = warm_view()
        say(phase, f"t0 warmed on B through the fixed chain (entry, B), {len(warm)} sessions; the "
                   f"entry's view: B ada {view[ids['B']]['ada']} svc_ms "
                   f"{view[ids['B']].get('svc_ms')}, A ada {view[ids['A']]['ada']} svc_ms "
                   f"{view[ids['A']].get('svc_ms')}; a t0 plan's first-stage costs {costs(view)}")
        if not costs(view)["B"] < costs(view)["A"]:
            raise AssertionError(f"{phase}: B's svc_ms outweighs the affinity bonus after "
                                 f"{len(warm)} warm sessions: costs {costs(view)}")
        got, t_sessions = [], time.perf_counter()
        for i in TENANT_ROUTE_PROMPTS:
            view = wait_view(phase, entry["port"], idle, "replicas not idle")
            say(phase, f"before the t0 session on prompt {len(prompts[i])}: the entry's "
                       f"first-stage costs {costs(view)}")
            got.append(serve(SwarmClient([chain[0]], sampling=greedy, prefill_chunk=512,
                                         adapter="t0"), prompts[i]))
        tenant_s = time.perf_counter() - t_sessions
        routes = [r["route"] for r in http_get_json(
            f"http://127.0.0.1:{entry['port']}/stats")["routes"]["recent"]]
        say(phase, f"{len(got)} t0 sessions through a SwarmClient at the entry in {tenant_s:.2f}s; "
                   f"planned stage-1 replicas {[label.get(r.get('1'), r) for r in routes]}")
        if routes != [{"1": ids["B"]}] * len(TENANT_ROUTE_PROMPTS):
            raise AssertionError(f"{phase}: tenant routes {routes}, want B ({ids['B']}) each")
        for i, s_ in zip(warm_idx + list(TENANT_ROUTE_PROMPTS), warm + got):
            if s_ != lanes_lora["streams"][i]:
                raise AssertionError(f"{phase}: t0 stream of prompt {len(prompts[i])} != "
                                     f"serve_lanes_lora's from token "
                                     f"{first_divergence(s_, lanes_lora['streams'][i])}")
        say(phase, f"the {len(warm) + len(got)} t0 streams equal serve_lanes_lora's t0 streams on "
                   "the same prompts, token for token")
        wait_view(phase, entry["port"], idle, "replicas not idle")
        base = serve(SwarmClient([chain[0]], sampling=greedy, prefill_chunk=512),
                     prompts[TENANT_BASE_PROMPT])
        base_route = http_get_json(
            f"http://127.0.0.1:{entry['port']}/stats")["routes"]["recent"][-1]["route"]
        if base_route != {"1": ids["A"]} or base != lanes["streams"][TENANT_BASE_PROMPT]:
            raise AssertionError(f"{phase}: the base session's route {base_route} (want A, "
                                 f"{ids['A']}: no svc_ms), its stream equal to serve_lanes': "
                                 f"{base == lanes['streams'][TENANT_BASE_PROMPT]}")
        say(phase, "a base session after them is planned by cost alone, to A (no svc_ms in its "
                   "record), and its stream equals serve_lanes' on the same prompt")
        after = stats()

        def pieces(idx):
            return [len(c[j:j + LANE_PREFILL_CHUNK]) for i in idx
                    for c in (prompts[i][k:k + 512] for k in range(0, len(prompts[i]), 512))
                    for j in range(0, len(c), LANE_PREFILL_CHUNK)]

        tenant_idx = tuple(warm_idx) + TENANT_ROUTE_PROMPTS
        served_by = {"entry": (tenant_idx, (TENANT_BASE_PROMPT,)), "B": (tenant_idx, ()),
                     "A": ((), (TENANT_BASE_PROMPT,))}
        launches = dict.fromkeys(after["entry"]["kernels"], 0)
        route_launches = {"split": 0, "mma": 0}
        paged_split = 0
        for key, st in after.items():
            ex = st["executor"]
            layers = st["end_layer"] - st["start_layer"] + 1
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            a_dec, a_pre = ex["adapter_steps"], ex["adapter_prefill_steps"]
            tenants, bases = served_by[key]
            want = {"flash_gqa": layers * ex["prefill_steps"], "paged_decode_gqa": layers * steps,
                    "w8a16_matmul": 0, "w4a16_matvec": 0,
                    "fused_lane_delta": layers * n_targets * (a_dec + a_pre)}
            routes_k = flash_routes(st)
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            split, want_split = paged_splits(phase, st, cfg)
            check_node_graphs(phase, st, steps)
            say(phase, f"node {key} (stage {st['stage']}): {steps} decode dispatches ({a_dec} with "
                       f"t0), {ex['prefill_steps']} prefill dispatches ({a_pre} of t0); launches "
                       f"{kern} (want {want}: {kern == want}); registry {ex['adapters']}")
            loads = 1 if tenants else 0
            if (kern != want or (kern["fused_lane_delta"] > 0) != bool(tenants)
                    or ex["prefill_steps"] != len(pieces(tenants + bases))
                    or a_pre != len(pieces(tenants))
                    or toks != (len(tenants) + len(bases)) * (NEW_TOKENS - 1)
                    or ex["adapters"]["loads"] != loads or routes_k != want_routes
                    or split != want_split or st["errors"]):
                raise AssertionError(
                    f"{phase}: node {key}: launches {kern} (want {want}), prefill dispatches "
                    f"{ex['prefill_steps']} ({a_pre} of t0), {toks} decode steps, registry "
                    f"{ex['adapters']} (want {loads} loads), flash routes {routes_k}, paged "
                    f"split {split} (want {want_split}), {st['errors']} errors")
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes_k.items():
                route_launches[r] += v
            paged_split += split
        lane_delta = {k: st["kernels"]["fused_lane_delta"]["launches"] for k, st in after.items()}
        devices = {k: st["device"] for k, st in after.items()}
        say(phase, f"fused_lane_delta launches {lane_delta}: on the holder B and the entry, none "
                   f"on A; every count the kernels' own (none fell back); nodes on {devices}")
        if set(devices.values()) != {torch.cuda.get_device_name(0)}:
            raise AssertionError(f"{phase}: a node off the card: {devices}")
        gemv_total = {name: {r: sum(gemv_routes(st)[name][r] for st in after.values())
                             for r in ("mma", "simt")} for name in QMM_KERNEL_OF.values()}
        stop_nodes(nodes)
        nodes = []
        return {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
                "paged_split": paged_split, "routes": routes,
                "wall_s": time.perf_counter() - t_phase}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


# -- serve_swarm: the relay topology -------------------------------------------------

SWARM_TTL_S = 15.0  # a gossip record's liveness TTL (run_node's default)
SWARM_GROW_SESSIONS = 8  # sessions at once that grow into the top bucket
SWARM_GROW_PROMPT = 2100  # tokens: past 2048, so every buffer reaches bucket_len(MAX_LEN)
SWARM_TIMING_PROMPT = 100
SWARM_TIMING_STEPS = (8, 32)  # relay against chain: new tokens of the short and long runs
SWARM_TIMING_PAIRS = 3


# serve_overload's nodes. R1, a paged lane replica of stage 1 whose pool of
# OVERLOAD_KV_BLOCKS blocks (one the scratch) two resident serve sessions
# (300 and 700 tokens: 10 + 22 blocks, 10 + 23 after their decode steps)
# put under its admission reserve (int(0.6 x 65) = 39 free: 32 free then,
# 31 after, 41 or 54 with either alone); its long window makes its shed's
# Retry-After (window x (1 + inflight/cap)) outlast the shed wave's sessions
# on R2, whose capacity 1 makes new sessions leave it for R1 once it holds
# three at once (a new session's plan charges R1 ADMISSION_PENALTY, two of
# R2's sessions, and its svc_ms / 100 ms).
OVERLOAD_KV_BLOCKS = 65
OVERLOAD_RESERVE = 0.6
OVERLOAD_WINDOW_MS = 3000
OVERLOAD_R1_ARGS = ["--stage-lanes", str(LANES), "--paged-kv", str(PAGED_BS), "--prefill-chunk",
                    str(LANE_PREFILL_CHUNK), "--window-ms", str(OVERLOAD_WINDOW_MS),
                    "--kv-blocks", str(OVERLOAD_KV_BLOCKS), "--admission-reserve",
                    str(OVERLOAD_RESERVE)]
# decode steps of each resident on R1, co-batched: enough that R1's svc_ms
# (an EWMA, 0.8 old) has shed its first forwards' start-up time and shows its
# steady cost when the shed wave is planned
OVERLOAD_RESIDENT_STEPS = 12
OVERLOAD_SHED_RETRIES = 4  # the shed wave's session restarts at most
OVERLOAD_RESCUE_AFTER = 8  # tokens before the client fails over to E1
OVERLOAD_POST_COMPUTE_DEADLINE_S = 0.15  # ahead of E2's 400 ms chaos delay
OVERLOAD_STALL_DEADLINE_S = 0.3  # toward the stalled counter replica
OVERLOAD_HEDGE_MS = 50
# E0's kill to the client's restart: ~8x the 1.76-1.86 s the runs measured
# (the rescue's bounces, E1's 409 and the client's backoff); one run's 64.8 s
# had nothing to bound it (ROADMAP C5)
OVERLOAD_RESTART_BOUND_S = 15.0
# serve_elastic's nodes: A0 and A1 on stage 0, B and C on stage 1, one-session
# and graphed, their balancers every 2 s (jittered). A capacity of 16 keeps a
# stage's load/cap at most 4/16 under the phase's four sessions at once, under
# the balancer's 0.5 imbalance threshold, so only the phase's /reassign and the
# adoption of the emptied stage 0 move a node
ELASTIC_REBALANCE_S = 2
ELASTIC_ARGS = ["--rebalance-period", str(ELASTIC_REBALANCE_S), "--capacity", "16"]
ELASTIC_DRAIN_AFTER = 3  # tokens of C's resident session before the drain
# the reassigned node's allocated bytes less its KV buffers, against a node
# started on stage 1 (B) in the same state: within this margin, so the old
# stage's weights, KV buffers and graphs are not still held (its weights
# alone are ~0.7 GiB)
ELASTIC_MEMORY_MARGIN = 64 * 2**20
# serve_sessions: a shared prefix and the suffixes of the prompts that extend
# it (every chunk >= 16 rows: the tensor cores' route); the swarm's client
# prefills in chunks of the prefix, so a pinned and an unpinned session
# compute the same chunks; the paged pair's prefix is block-aligned, so a
# prefix-index hit recomputes exactly the chunk the pin's prefill ran last
SESS_PREFIX = 300
SESS_PAGED_PREFIX = 288
SESS_SUFFIXES = (16, 40, 100, 200)
SESS_STOP_AFTER = 4  # tokens of a session before its stage-1 holder stops
SESS_TAIL_STEPS = 2  # the paged parent's decode steps before its tail fork
SESS_TAIL_ROUNDS = 4  # lockstep steps of the parent and the tail child
# serve_standby: every node replicates its sessions every 50 ms; the serve
# prompt of 300 tokens, the holder killed after 8 tokens (case (b): the
# first token from there on whose standby lags); the paged pair's session
# grows from 300 slots to 320 (10 full blocks of 32) before it moves, then
# 8 lockstep steps
STANDBY_ARGS = ["--standby-repl", "--repl-interval", "0.05"]
STANDBY_PROMPT = 2
STANDBY_KILL_AFTER = 8
STANDBY_WARM_TOKENS = 4  # each other stage-1 replica's first generation, before the cases
STANDBY_PAGED_STEPS = 20
STANDBY_PAGED_TAIL = 8
# the balancer's period of the swarms whose layout it could move (a stage
# with two replicas): longer than their phase (chip_smoke's docstring)
STILL_REBALANCE_S = 3600
# swarms started from a manifest and a tools/seed process (swarm_nodes)
MANIFEST_SWARMS = ("swarm_lanes",)
# (common args, [(stage, args)]) of each swarm, the first node its gossip seed
SWARM_LAYOUTS = {
    "swarm": ("model", [(0, []), (1, []), (1, [])]),
    "swarm_lanes": ("model", [(0, LANE_NODE_ARGS), (1, LANE_NODE_ARGS)]),
    "swarm_counter": ("counter", [(0, []), (1, []), (2, [])]),
    # serve_overload: entries E0, E1 and E2 (its forwards 400 ms late), R1, R2
    "overload": ("model", [(0, []), (0, []), (0, ["--chaos", "delay_ms=400"]),
                           (1, OVERLOAD_R1_ARGS), (1, ["--capacity", "1"])]),
    # serve_overload's counter stages: a hedging seed, a sound and a stalled
    # stage-1 replica (whose capacity makes fresh picks favour it), stage 2
    "overload_counter": ("counter", [
        (0, ["--hedge-mode", "any", "--hedge-delay-ms", str(OVERLOAD_HEDGE_MS),
             "--hop-timeout", "5"]),
        (1, []), (1, ["--chaos", "stall_p=1", "--capacity", "100"]), (2, [])]),
    # serve_elastic: A0, A1, B, C
    "elastic": ("model", [(0, ELASTIC_ARGS), (0, ELASTIC_ARGS), (1, ELASTIC_ARGS),
                          (1, ELASTIC_ARGS)]),
    # serve_sessions: S0, S1a, S1b, on the default hedge mode (advertised):
    # after a handoff S0 must neither hedge a step to the new holder while
    # the old one's advert lingers nor keep relaying through the old one
    # (a step run twice breaks the phase's exact launch counts)
    "sessions": ("model", [(0, []), (1, []), (1, [])]),
    # serve_standby: S0 and stage-1 replicas R1a, R1b, R1c, all replicating:
    # each case kills the replica holding its session, and a standby must
    # outlive both kills
    "standby": ("model", [(0, STANDBY_ARGS), (1, STANDBY_ARGS), (1, STANDBY_ARGS),
                          (1, STANDBY_ARGS)]),
}
# swarms with a stage of two replicas or more, which a balancer's tick under
# a transient load skew could reshape mid-phase
STILL_SWARMS = ("swarm", "overload", "overload_counter", "sessions", "standby")


def write_manifest(work: str, tag: str, layout) -> str:
    """The YAML manifest of a swarm of SWARM_LAYOUTS (MODEL split evenly
    over its stages, a node named {tag}{i} per entry), written by the port's
    Manifest.to_yaml."""
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.parallel.stages import Manifest, NodeSpec

    num_stages = max(stage for stage, _ in layout) + 1
    specs = Manifest.even_split(MODEL, num_stages).stage_specs()
    if get_config(MODEL).num_layers != specs[-1].end_layer + 1:
        raise AssertionError(f"{MODEL}: an even split of {num_stages} misses layers")
    nodes = [NodeSpec(f"{tag}{i}", stage, specs[stage].start_layer, specs[stage].end_layer)
             for i, (stage, _) in enumerate(layout)]
    path = os.path.join(work, f"{tag}.yaml")
    with open(path, "w") as f:
        f.write(Manifest(MODEL, num_stages, nodes).to_yaml())
    return path


def swarm_nodes(parts: Optional[str], work: str, tag: str) -> List[Dict[str, Any]]:
    """The node processes of one swarm of SWARM_LAYOUTS, started now: the
    first, a stage-0 node, is the gossip seed on a UDP port chosen here; the
    others bootstrap to it on ephemeral ports. `swarm`: three one-session
    nodes (stage 0, and stage 1 twice: replicas A and B); `swarm_lanes`: a
    lane pair (LANE_NODE_ARGS) deployed as users deploy: each node's stage
    from a manifest (--manifest, --name), both bootstrapping to a tools/seed
    process, the swarm's LAST entry; `swarm_counter`: three counter stages;
    `overload` and `overload_counter`: serve_overload's."""
    seed_port = free_udp_port()
    kind, layout = SWARM_LAYOUTS[tag]
    common = (["--backend", "counter", "--num-stages", "3"] if kind == "counter"
              else ["--parts", parts, "--max-len", str(MAX_LEN)])
    if tag in STILL_SWARMS:
        common += ["--rebalance-period", str(STILL_REBALANCE_S)]
    seed, manifest = None, None
    if tag in MANIFEST_SWARMS:
        seed = launch_seed(os.path.join(work, f"{tag}_seed.log"))
        manifest = write_manifest(work, tag, layout)
    nodes = []
    for i, (stage, extra) in enumerate(layout):
        if seed is not None:
            gossip = ["--bootstrap", f"127.0.0.1:{seed['port']}"]
        else:
            gossip = (["--gossip-port", str(seed_port)] if i == 0
                      else ["--bootstrap", f"127.0.0.1:{seed_port}"])
        identity = None if manifest is None else ["--manifest", manifest, "--name", f"{tag}{i}"]
        nodes.append(launch_node(stage, os.path.join(work, f"{tag}{i}.log"),
                                 common + extra + gossip, identity=identity))
        nodes[-1]["elastic"] = tag == "elastic"  # its nodes migrate by design
    return nodes + ([seed] if seed is not None else [])


def wait_gossip(phase: str, nodes: List[Dict[str, Any]], timeout_s: float = 30.0) -> float:
    """Wait until every node's /stats gossip view holds every node's record;
    returns the seconds it took."""
    t0 = time.perf_counter()
    views: List[Any] = []
    while time.perf_counter() - t0 < timeout_s:
        views = [http_get_json(f"http://127.0.0.1:{n['port']}/stats")["dht"] for n in nodes]
        if all(sum(len(v) for v in view.values()) == len(nodes) for view in views):
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise TimeoutError(f"{phase}: gossip views {views} after {timeout_s}s")


def whole_sessions(count: int, per: List[int]) -> Optional[int]:
    """How many sessions of `per` passes each make up `count` passes (a
    subset's size; None when no subset sums to it)."""
    for mask in range(1 << len(per)):
        if sum(c for i, c in enumerate(per) if mask >> i & 1) == count:
            return bin(mask).count("1")
    return None


def post_wire(port: int, path: str, body: Dict[str, Any]):
    """(status, unpacked reply) of one wire POST to a local node."""
    from inferd_tpu_torch.client.base import http_post
    from inferd_tpu_torch.runtime import wire

    status, raw, _ = http_post(f"http://127.0.0.1:{port}{path}", wire.pack(body), 300.0)
    return status, wire.unpack(raw)


def check_planned_routes(phase: str, st: Dict[str, Any], sessions: int,
                         client_routed: int = 0) -> Dict[str, Any]:
    """The seed's planned-route counts from its /stats: a route followed for
    each of its `sessions` new sessions, planned by the seed for all but the
    `client_routed` ones whose client sent a route, none stale and no plan
    failed (both replicas live)."""
    c = st["metrics"]["counters"]
    seen = {k: int(c.get(f"route.{k}", 0)) for k in ("planned", "followed", "stale",
                                                      "plan_failed")}
    seen.update(planner=st["routes"]["planner"], recent=st["routes"]["recent"])
    if (seen["planned"] != sessions - client_routed or seen["followed"] != sessions
            or seen["stale"] or seen["plan_failed"]):
        raise AssertionError(f"{phase}: the seed's route counts {seen}, want "
                             f"{sessions - client_routed} planned and {sessions} followed, "
                             "none stale or failed")
    return seen


def wait_svc_ms(phase: str, seed: Dict[str, Any], replicas: List[str],
                timeout_s: float = 10.0) -> Dict[str, float]:
    """Each replica's svc_ms in the seed's gossip view, once every record
    carries one."""
    deadline = time.monotonic() + timeout_s
    while True:
        view = http_get_json(f"http://127.0.0.1:{seed['port']}/stats")["dht"]["1"]
        svc = {nid: view.get(nid, {}).get("svc_ms") for nid in replicas}
        if all(isinstance(v, (int, float)) and v > 0 for v in svc.values()):
            return svc
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: svc_ms in the seed's view {svc}")
        time.sleep(0.1)


def run_routed_client(phase: str, card: str, gossip_port: int, prompts, streams,
                      names: Dict[str, str]) -> None:
    """RoutedChainClient over a records-less gossip observer bootstrapped to
    the seed's port: each prompt in turn, its chain planned per session by
    D*-Lite, token-exact to the serve phase's chain streams."""
    from inferd_tpu_torch.client.routed_client import RoutedChainClient
    from inferd_tpu_torch.config import SamplingConfig
    from inferd_tpu_torch.control.dht import SwarmDHT

    dht = SwarmDHT("chip-smoke-observer", 0, bootstrap=[("127.0.0.1", gossip_port)],
                   host="127.0.0.1")
    dht.start()
    try:
        t0 = time.perf_counter()
        while len(dht.get_stage(1)) < len(names) or not dht.get_stage(0):
            if time.perf_counter() - t0 > 15.0:
                raise AssertionError(f"{phase}: the observer's view {dht.get_all(2)}")
            time.sleep(0.1)
        view_s = time.perf_counter() - t0
        client = RoutedChainClient(dht, 2, sampling=SamplingConfig(temperature=0.0),
                                   prefill_chunk=512)
        finals: Dict[str, Any] = {}

        async def last_hop(session_id, completed_stage):
            if completed_stage == 1:  # the first pass is done: the plan's final stats
                finals[session_id] = (client.planner_stats(session_id),
                                      [nid for nid, _ in client._plans[session_id].chain])

        client.hop_hook = last_hop

        async def go():
            async with client as c:
                return [await c.generate_ids(p, max_new_tokens=NEW_TOKENS) for p in prompts]

        t1 = time.perf_counter()
        got = asyncio.run(go())
        wall = time.perf_counter() - t1
    finally:
        dht.stop()
    for p, a_, b_ in zip(prompts, got, streams):
        if a_ != b_:
            raise AssertionError(f"{phase}: routed client stream of prompt {len(p)} != the "
                                 f"serve phase's chain stream from token "
                                 f"{first_divergence(a_, b_)}")
    plans = list(finals.values())
    chains = [names.get(chain[1], chain[1]) for _, chain in plans]
    stats0 = plans[0][0]
    say(phase, f"RoutedChainClient (observer view full after {view_s:.2f} s): "
               f"{len(prompts)} prompts in turn in {wall:.2f} s, token-exact to the serve "
               f"streams; stage-1 replica per session {chains}; the first session's planner: "
               f"{stats0['builds']} build, {stats0['refreshes']} refreshes, "
               f"{stats0['cost_updates']} cost updates, expansions at build "
               f"{stats0['expansions_build']} against at replan {stats0['expansions_replan']} "
               f"({card})")


def run_serve_swarm(card: str, parts: str, work: str, serve, lanes) -> Dict[str, Any]:
    """The `serve_swarm` phase: the relay topology (SwarmClient -> stage 0
    -> a stage-1 replica picked from gossip -> the logits unwinding back),
    held token-exact to the `serve` and `serve_lanes` phases' chain streams
    on the same parts."""
    import threading

    import numpy as np

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.client.swarm_client import SwarmClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.cache import kv_slot_bytes
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.utils.profiling import paired_delta_stats

    phase = "serve_swarm"
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    prompts = serve_prompts(cfg.vocab_size)
    one: List[Dict[str, Any]] = []
    lane: List[Dict[str, Any]] = []
    counter: List[Dict[str, Any]] = []
    lane_seed: List[Dict[str, Any]] = []

    def url(n):
        return ("127.0.0.1", n["port"])

    def node_id(n):
        return f"127.0.0.1:{n['port']}"

    def stats(nodes):
        return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

    def run(client, ps, concurrent=False, new=NEW_TOKENS, stamps=None):
        async def go():
            async with client as c:
                async def one_(p):
                    marks: List[float] = []
                    t_req = time.perf_counter()
                    ids = await c.generate_ids(
                        p, max_new_tokens=new,
                        on_token=lambda _t: marks.append(time.perf_counter()))
                    if stamps is not None:
                        stamps.append((t_req, marks))
                    return ids

                if concurrent:
                    return await asyncio.gather(*(one_(p) for p in ps))
                return [await one_(p) for p in ps]

        return asyncio.run(go())

    def swarm_client(nodes):
        return SwarmClient([url(nodes[0])], sampling=greedy, prefill_chunk=512)

    try:
        one = take_swarm(parts, work, "swarm")
        lane = take_swarm(parts, work, "swarm_lanes")
        lane_seed = [lane.pop()]  # the tools/seed process, the swarm's last entry
        counter = take_swarm(parts, work, "swarm_counter")
        t0 = time.perf_counter()
        for n in one + lane + counter + lane_seed:
            wait_ready(n)
        converged = [wait_gossip(phase, nodes) for nodes in (one, lane, counter)]
        say(phase, f"{len(one) + len(lane) + len(counter)} run_node --device {DEVICE} processes "
                   f"in three swarms (one-session: stage 0 seed + stage-1 replicas A, B; "
                   f"lanes: {' '.join(LANE_NODE_ARGS)}, started with --manifest and --name "
                   f"and bootstrapped to a tools/seed process; counter: 3 stages) ready in "
                   f"{time.perf_counter() - t0:.1f}s; every gossip view full after "
                   f"{', '.join(f'{c:.2f}' for c in converged)} s")
        want_view = {str(n["stage"]): [node_id(n)] for n in lane}
        deadline = time.monotonic() + 10.0
        views = [d["view"] for d in seed_lines(lane_seed[0]) if "view" in d]
        while (not views or views[-1] != want_view) and time.monotonic() < deadline:
            time.sleep(0.2)
            views = [d["view"] for d in seed_lines(lane_seed[0]) if "view" in d]
        lane_recs = stats(lane[:1])[0]["dht"]
        names = sorted(r["name"] for recs in lane_recs.values() for r in recs.values())
        say(phase, f"the lane pair's tools/seed view {views[-1] if views else None} (want "
                   f"{want_view}); the pair's records named {names} from the manifest")
        if not views or views[-1] != want_view or names != ["swarm_lanes0", "swarm_lanes1"]:
            raise AssertionError(f"{phase}: the seed's views {views}, record names {names}")
        codecs = {st["node_id"]: st["wire_codec"] for st in stats(one + lane + counter)}
        say(phase, f"wire codec per node: {codecs}")
        if set(codecs.values()) != {"native"}:
            raise AssertionError(f"{phase}: a node packs with another codec than the native "
                                 f"one: {codecs}")
        for st in stats(one + lane + counter):  # fresh processes: every count starts at 0
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"{phase}: a node did work before the main path: {st}")
        seed, rep_a, rep_b = one
        layers = cfg.num_layers // 2

        # sequential, then the four at once: token-exact against serve's chain
        stamps: List[Any] = []
        sequential = run(swarm_client(one), prompts, stamps=stamps)
        seq = stats(one)
        concurrent = run(swarm_client(one), prompts, concurrent=True)
        conc = stats(one)
        for name, got in (("sequential", sequential), ("concurrent", concurrent)):
            for p, a_, b_ in zip(prompts, got, serve["streams"]):
                if a_ != b_:
                    raise AssertionError(f"{phase}: {name} relay stream of prompt {len(p)} != "
                                         f"the serve phase's chain stream from token "
                                         f"{first_divergence(a_, b_)}")
        for i, (p, (t_req, marks)) in enumerate(zip(prompts, stamps)):
            ttft = (marks[0] - t_req) * 1e3
            tps = (len(marks) - 1) / (marks[-1] - marks[0])
            b_ttft, b_tps = serve["rates"][i]
            say(phase, f"prompt {len(p)} tokens through the relay: TTFT {ttft:.1f} ms, decode "
                       f"{tps:.1f} tok/s ({card}); the serve phase's chain in this run: TTFT "
                       f"{b_ttft:.1f} ms, {b_tps:.1f} tok/s")
        # a session's passes on each stage: its 512-token chunks, then a step per token
        per = [-(-len(p) // 512) + NEW_TOKENS - 1 for p in prompts]
        seq_served = [seq[i]["forward_passes"] for i in (1, 2)]
        conc_served = [conc[i]["forward_passes"] - seq[i]["forward_passes"] for i in (1, 2)]
        whole = [[whole_sessions(c, per) for c in served]
                 for served in (seq_served, conc_served)]
        say(phase, f"stage-1 forward passes, replicas A / B: sequential {seq_served}, "
                   f"concurrent {conc_served} (sessions of {per} passes: {whole}); seed "
                   f"relays {conc[0]['relays']}, affinity entries {conc[0]['affinity']}")
        if (None in whole[0] + whole[1] or sum(whole[0]) != len(prompts)
                or sum(whole[1]) != len(prompts) or not all(conc_served)):
            raise AssertionError(f"{phase}: sessions on A / B: sequential {seq_served}, "
                                 f"concurrent {conc_served} passes: want whole sessions "
                                 f"({per} passes) on each replica, and both serving when "
                                 "the sessions run at once")
        routes_seen = check_planned_routes(phase, conc[0], 2 * len(prompts))
        replica_names = {node_id(rep_a): "A", node_id(rep_b): "B"}
        recent = [{s: replica_names.get(nid, nid) for s, nid in r["route"].items()}
                  for r in routes_seen["recent"][-len(prompts):]]
        say(phase, f"the seed planned {routes_seen['planned']} routes for its "
                   f"{2 * len(prompts)} new sessions and followed {routes_seen['followed']} "
                   f"(stale {routes_seen['stale']}, plan failures {routes_seen['plan_failed']}); "
                   f"the first concurrent session's chain {recent[0]} (stage: replica), the "
                   f"last's {recent[-1]}; the planner's stats {routes_seen['planner']}")
        svc = wait_svc_ms(phase, seed, [node_id(rep_a), node_id(rep_b)])
        for n, st in zip((rep_a, rep_b), conc[1:]):
            step = st["metrics"]["histograms"]["stage.compute_ms"]
            say(phase, f"replica {replica_names[node_id(n)]}: svc_ms {svc[node_id(n)]} in the "
                       f"seed's view; its stage steps in this phase: {step['count']} forwards, "
                       f"mean {step['mean_ms']:.3f} ms, p50 <= {step['p50_ms']} ms ({card})")
        sessions = [2 * len(prompts), whole[0][0] + whole[1][0], whole[0][1] + whole[1][1]]
        node_graphs = []
        for st, n_sessions in zip(conc, sessions):
            passes = st["forward_passes"]
            decode = n_sessions * (NEW_TOKENS - 1)
            routes = flash_routes(st)
            want = {"split": layers * decode, "mma": layers * (passes - decode)}
            say(phase, f"node stage {st['stage']} ({st['node_id']}): {passes} passes, flash_gqa "
                       f"routes {routes} (want {want}: {routes == want})")
            if routes != want or st["errors"]:
                raise AssertionError(f"{phase}: {st['node_id']}: routes {routes}, want {want}, "
                                     f"{st['errors']} errors")
            node_graphs.append(check_node_graphs(phase, st, decode))

        # a stage-1 envelope entering at the stage-0 node is relayed there
        sid = "swarm-mismatch"
        tokens = np.asarray([prompts[0]], np.int32)
        status, body = post_wire(seed["port"], "/forward", {
            "session_id": sid, "stage": 0, "relay": False,
            "payload": {"tokens": tokens, "start_pos": 0, "real_len": tokens.shape[1]}})
        if status != 200:
            raise AssertionError(f"{phase}: chain-mode stage 0: HTTP {status}: {body}")
        status, body = post_wire(seed["port"], "/forward",
                                 {"session_id": sid, "stage": 1, "payload": body["result"]})
        logits = np.asarray(body["result_for_user"]["logits"]) if status == 200 else None
        if (logits is None or logits.shape != (1, cfg.vocab_size)
                or not np.isfinite(logits).all()
                or int(np.argmax(logits[0])) != serve["streams"][0][0]
                or body["served_by"] not in (node_id(rep_a), node_id(rep_b))):
            raise AssertionError(f"{phase}: a stage-1 envelope at the stage-0 node: HTTP "
                                 f"{status}, {body if logits is None else body['served_by']}")
        post_wire(seed["port"], "/end_session", {"session_id": sid, "stage": 0})
        say(phase, f"a stage-1 envelope posted to the stage-0 node was relayed to "
                   f"{body['served_by']}: logits [1, {cfg.vocab_size}], finite, argmax = the "
                   "serve stream's first token")

        # the pool's idle buffers stay bounded while sessions grow to the top bucket
        rng = np.random.default_rng(3)
        grow = [rng.integers(0, cfg.vocab_size, SWARM_GROW_PROMPT).tolist()
                for _ in range(SWARM_GROW_SESSIONS)]
        pre = stats(one)

        async def grow_all():
            # all at once, half routed to each replica: each replica's pool
            # then meets more idle buffers than its bound holds (a pick by
            # load alone may leave a replica two sessions, which fit under it)
            clients = [routed_swarm_client(seed["port"], {"1": node_id(r)}, greedy,
                                           prefill_chunk=512) for r in (rep_a, rep_b)]
            async with clients[0] as ca, clients[1] as cb:
                return await asyncio.gather(*(
                    (ca if i % 2 == 0 else cb).generate_ids(p, max_new_tokens=2)
                    for i, p in enumerate(grow)))

        asyncio.run(grow_all())
        post = stats(one)
        slot = kv_slot_bytes(cfg, layers)
        buckets, b = [], bucket_len(512)
        while b <= bucket_len(SWARM_GROW_PROMPT):
            buckets.append(b)
            b *= 2
        passes_per = -(-SWARM_GROW_PROMPT // 512) + 1  # prefill chunks, one decode step
        for a_, b_ in zip(pre, post):
            buf = b_["executor"]["buffers"]
            mem = {k: b_["memory"].get(k, 0) for k in ("allocated", "reserved")}
            sessions = (b_["forward_passes"] - a_["forward_passes"]) // passes_per
            per_shape = sessions * sum(buckets) * slot  # what a bound per shape keeps idle
            say(phase, f"node stage {b_['stage']} ({b_['node_id']}) after {sessions} sessions "
                       f"grew to {buckets[-1]} slots: buffers {buf}; idle "
                       f"{buf['free_bytes'] / 2**30:.3f} GiB of a "
                       f"{buf['max_free_bytes'] / 2**30:.3f} GiB bound (a bound per shape "
                       f"would keep {per_shape / 2**30:.3f} GiB idle); device memory "
                       f"allocated {mem['allocated'] / 2**30:.3f} GiB, reserved "
                       f"{mem['reserved'] / 2**30:.3f} GiB (before the growth "
                       f"{a_['memory'].get('reserved', 0) / 2**30:.3f}) ({card})")
            if buf["free_bytes"] > buf["max_free_bytes"] or (sessions and not buf["released"]):
                raise AssertionError(f"{phase}: {b_['node_id']}: buffers {buf} after {sessions} "
                                     "sessions grew")

        # planned chains from a client: RoutedChainClient over an observer of the
        # seed's gossip, then tools/send --routed as a user runs it
        gossip_port = stats([seed])[0]["gossip_port"]
        run_routed_client(phase, card, gossip_port, prompts, serve["streams"], replica_names)
        run_cli_send_routed(card, gossip_port, prompts[0], serve["streams"][0])
        routes_seen = check_planned_routes(phase, stats([seed])[0],
                                           2 * len(prompts) + SWARM_GROW_SESSIONS,
                                           client_routed=SWARM_GROW_SESSIONS)
        say(phase, f"before the kill the seed planned {routes_seen['planned']} routes for its "
                   f"{2 * len(prompts) + SWARM_GROW_SESSIONS} new sessions (the "
                   f"{SWARM_GROW_SESSIONS} growing ones routed by their clients), followed "
                   f"{routes_seen['followed']}, stale {routes_seen['stale']}, plan failures "
                   f"{routes_seen['plan_failed']}")

        # planted fault: a replica dies with no tombstone, once the seed's view
        # has both replicas idle (a load frozen in its last record would steer
        # new sessions away from it, and no hop would meet the dead peer); the
        # one the seed's planner would route the next new session to, by the
        # same node cost (an svc_ms the other replica's routed sessions left
        # lower would steer them away too). It is replica B from here on.
        from inferd_tpu_torch.control.dstar import node_cost

        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            view = stats([seed])[0]["dht"]["1"]
            if all(view.get(node_id(n), {}).get("load") == 0 for n in (rep_a, rep_b)):
                break
            time.sleep(0.1)
        costs = {replica_names[node_id(n)]: node_cost(view[node_id(n)]) for n in (rep_a, rep_b)}
        if costs["A"] < costs["B"]:
            rep_a, rep_b = rep_b, rep_a
            one = [seed, rep_a, rep_b]
        say(phase, f"node costs in the seed's view before the kill {costs}: replica "
                   f"{replica_names[node_id(rep_b)]} dies (B from here on)")
        b_stats = stats([rep_b])[0]
        rep_b["proc"].kill()
        rep_b["proc"].wait(timeout=30)
        t_kill = time.monotonic()
        expired: List[float] = []

        def watch():
            while time.monotonic() - t_kill < SWARM_TTL_S + 10:
                view = http_get_json(f"http://127.0.0.1:{seed['port']}/stats")["dht"]
                if node_id(rep_b) not in view.get("1", {}):
                    expired.append(time.monotonic() - t_kill)
                    return
                time.sleep(0.25)

        after_kill = run(swarm_client(one), prompts[:2], concurrent=True)
        if after_kill != serve["streams"][:2]:
            raise AssertionError(f"{phase}: new sessions after replica B died differ from "
                                 "the serve streams")
        st0 = stats([seed])[0]
        b_listed = node_id(rep_b) in st0["dht"]["1"]
        if st0["dead_hops"] != 1 or not b_listed:
            raise AssertionError(f"{phase}: after B died: dead hops {st0['dead_hops']} (want "
                                 f"1), B's record in the seed's view: {b_listed}")
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        c0 = st0["metrics"]["counters"]
        say(phase, f"replica B killed (no tombstone): two new sessions at once completed on A, "
                   f"token-exact; the seed counted {st0['dead_hops']} dead hop; route.stale "
                   f"{c0.get('route.stale', 0):.0f}, the planner's kills "
                   f"{(st0['routes']['planner'] or {}).get('kills')}")

        # the lane pair, relaying: serve_lanes' traffic; stage 0's flush relays
        # each window's decode steps as one coalesced POST per next hop
        t_lanes = time.perf_counter()
        lane_streams = run(swarm_client(lane), lanes["prompts"], concurrent=True)
        lane_wall = time.perf_counter() - t_lanes
        for p, a_, b_ in zip(lanes["prompts"], lane_streams, lanes["streams"]):
            if a_ != b_:
                raise AssertionError(f"{phase}: lane relay stream of prompt {len(p)} != "
                                     f"serve_lanes' from token {first_divergence(a_, b_)}")
        pieces = [len(c[j:j + LANE_PREFILL_CHUNK]) for p in lanes["prompts"]
                  for c in (p[i:i + 512] for i in range(0, len(p), 512))
                  for j in range(0, len(c), LANE_PREFILL_CHUNK)]
        chunks = sum(-(-len(p) // 512) for p in lanes["prompts"])  # the client's chunks
        session_steps = len(lanes["prompts"]) * (NEW_TOKENS - 1)
        lane_split = 0
        lane_st = stats(lane)
        for st in lane_st:
            ex = st["executor"]
            split, want_split = paged_splits(phase, st, cfg)
            lane_split += split
            node_graphs.append(check_node_graphs(phase, st, ex["batched_steps"]))
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            want = dict.fromkeys(kern, 0)
            want.update(flash_gqa=layers * ex["prefill_steps"],
                        paged_decode_gqa=layers * ex["batched_steps"])
            routes = flash_routes(st)
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            say(phase, f"lane node stage {st['stage']}: {ex['prefill_steps']} prefill dispatches "
                       f"(want {len(pieces)}), {ex['batched_steps']} decode dispatches for "
                       f"{ex['batched_tokens']} session steps (want {session_steps}); launches "
                       f"{kern} (want {want}: {kern == want}); flash_gqa routes {routes} (want "
                       f"{want_routes})")
            if (split != want_split or st["errors"] or kern != want or routes != want_routes
                    or ex["prefill_steps"] != len(pieces)
                    or ex["batched_tokens"] != session_steps):
                raise AssertionError(f"{phase}: lane node {st['node_id']}: launches {kern} "
                                     f"(want {want}), routes {routes}, split {split} (want "
                                     f"{want_split}), {ex['prefill_steps']} prefill dispatches, "
                                     f"{ex['batched_tokens']} session steps, {st['errors']} "
                                     "errors")
        if not lane_split:
            raise AssertionError(f"{phase}: the lane pair launched no split paged_decode_gqa")
        c0, c1 = (st["metrics"]["counters"] for st in lane_st)
        coalesced = int(c0.get("hop.coalesced", 0))
        sessions = int(c0.get("hop.coalesced_sessions", 0))
        posts = int(c0.get("hop.count", 0))
        decode_posts = posts - chunks  # a prefill chunk's relay is a single POST
        coalesce = {
            "posts": posts, "coalesced": coalesced, "coalesced_sessions": sessions,
            "fallback": int(c0.get("hop.coalesced_fallback", 0)),
            "relays": lane_st[0]["relays"],
            "multi_envelopes": int(c1.get("forward.multi_envelopes", 0)),
            "multi_frames": int(c1.get("forward.multi_frames", 0)),
            "posts_per_session_step": decode_posts / session_steps,
            "sessions_per_coalesced_post": sessions / max(coalesced, 1),
            "mean_cobatch": [st["executor"]["mean_batch"] for st in lane_st],
            "tokens_per_s": sum(len(x) for x in lane_streams) / lane_wall,
        }
        say(phase, f"relay-mode lane pair: {len(lanes['prompts'])} concurrent sessions equal "
                   f"serve_lanes' streams; paged split launches {lane_split}; stage 0 relayed "
                   f"{session_steps} session decode steps and {chunks} prompt chunks in "
                   f"{posts} POSTs ({coalesced} coalesced carrying {sessions} sessions, "
                   f"{coalesce['sessions_per_coalesced_post']:.2f} per POST; "
                   f"{coalesce['fallback']} fallbacks): "
                   f"{coalesce['posts_per_session_step']:.3f} stage-0 -> stage-1 POSTs per "
                   f"session decode step; stage 1 took {coalesce['multi_envelopes']} multi "
                   f"envelopes of {coalesce['multi_frames']} frames; mean co-batch "
                   f"{coalesce['mean_cobatch']}; aggregate {coalesce['tokens_per_s']:.1f} tok/s "
                   f"({card})")
        if (coalesced < 1 or coalesce["fallback"] or coalesce["multi_envelopes"] != coalesced
                or coalesce["multi_frames"] != sessions
                or coalesce["relays"] != chunks + session_steps
                or posts - coalesced + sessions != coalesce["relays"]):
            raise AssertionError(f"{phase}: the lane pair's coalesced relay: {coalesce}")
        # the network CLI as a user runs it, through the same pair
        run_cli_send(card, lane[0]["port"], lanes["prompts"][2], lanes["streams"][2])

        # the counter swarm: three stages, entered right and wrong
        for entry in (counter[0], counter[2]):
            status, body = post_wire(entry["port"], "/forward",
                                     {"session_id": "count", "stage": 0, "payload": {}})
            r = body.get("result_for_user", {}) if status == 200 else {}
            if r.get("state") != 3 or r.get("trace") != [0, 1, 2]:
                raise AssertionError(f"{phase}: counter swarm via stage {entry['stage']}: "
                                     f"HTTP {status} {body}")
        say(phase, "counter swarm: state 3, trace [0, 1, 2], entered at stage 0 and at stage 2")

        watcher.join(timeout=SWARM_TTL_S + 15)
        if not expired or expired[0] > SWARM_TTL_S + 3.0:
            raise AssertionError(f"{phase}: B's record left the seed's view after "
                                 f"{expired or 'never'} s (TTL {SWARM_TTL_S})")
        say(phase, f"B's record left the seed's view {expired[0]:.1f} s after the kill "
                   f"(TTL {SWARM_TTL_S})")

        # per-token latency, relay against chain, on the same two nodes
        view = stats([seed])[0]["dht"]["1"]
        if set(view) != {node_id(rep_a)}:
            raise AssertionError(f"{phase}: stage 1 of the seed's view {sorted(view)}, want A")
        prompt = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                   SWARM_TIMING_PROMPT).tolist()
        arms = {"relay": lambda: swarm_client(one),
                "chain": lambda: ChainClient([url(seed), url(rep_a)], sampling=greedy,
                                             prefill_chunk=512)}
        short, long_ = SWARM_TIMING_STEPS
        outs = {name: run(make(), [prompt], new=long_)[0] for name, make in arms.items()}
        if outs["relay"] != outs["chain"]:
            raise AssertionError(f"{phase}: relay and chain streams differ on the timing prompt")
        times: Dict[str, Any] = {name: ([], []) for name in arms}
        for i in range(SWARM_TIMING_PAIRS):
            for name in (list(arms) if i % 2 == 0 else list(reversed(arms))):
                for n in ((short, long_) if i % 2 == 0 else (long_, short)):
                    t0 = time.perf_counter()
                    run(arms[name](), [prompt], new=n)
                    times[name][0 if n == short else 1].append(time.perf_counter() - t0)
        timing: Dict[str, Any] = {}
        for name, (ts, tl) in times.items():
            per, n_valid, spread, _ = paired_delta_stats(ts, tl, short, long_)
            timing[name] = {"ms_per_token": per * 1e3, "valid_pairs": n_valid,
                            "spread_pt": spread}
        ratio = timing["relay"]["ms_per_token"] / timing["chain"]["ms_per_token"]
        timing["relay_over_chain"] = ratio
        say(phase, f"per-token latency on the same two nodes (stage 0 + replica A), "
                   f"{SWARM_TIMING_PAIRS} interleaved pairs of {short}- and {long_}-token runs "
                   f"each: relay {timing['relay']['ms_per_token']:.3f} ms/token "
                   f"({timing['relay']['valid_pairs']} valid, spread "
                   f"{timing['relay']['spread_pt']}%), chain "
                   f"{timing['chain']['ms_per_token']:.3f} ms/token "
                   f"({timing['chain']['valid_pairs']} valid, spread "
                   f"{timing['chain']['spread_pt']}%): relay / chain {ratio:.3f} ({card})")

        final = stats(one[:2] + lane + counter) + [b_stats]
        launches = dict.fromkeys(final[0]["kernels"], 0)
        routes = {"split": 0, "mma": 0}
        for st in final:
            for name, k in st["kernels"].items():
                launches[name] += k["launches"]
            for r, v in flash_routes(st).items():
                routes[r] += v
        stop_nodes(one + lane + counter + lane_seed)
        one, lane, counter, lane_seed = [], [], [], []
        return {"launches": launches, "flash_routes": routes, "paged_split": lane_split,
                "gemv_routes": {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()},
                "graphs": node_graphs, "timing": timing, "b_expired_s": expired[0],
                "coalesce": coalesce}
    except BaseException:
        stop_nodes(one + lane + counter + lane_seed, show_logs=True)
        one, lane, counter, lane_seed = [], [], [], []
        raise
    finally:
        stop_nodes(one + lane + counter + lane_seed)


def overload_client(entry, log: List[Dict[str, Any]], sampling):
    """A SwarmClient entering at `entry` that logs each /forward step it
    sends: the stage-0 node that computes it (its entry, or `stage0_port`
    while set: a chunk E1 rescues to E0 is E0's), its size and start, the
    answer's status, code and retry_after, and the last stage that served
    it. `sids` lists its sessions in order."""
    import numpy as np

    from inferd_tpu_torch.client.base import ServerError
    from inferd_tpu_torch.client.swarm_client import SwarmClient

    class Recorder(SwarmClient):
        stage0_port: Optional[int] = None

        async def _step(self, session_id, tokens, start_pos):
            if not self.sids or self.sids[-1] != session_id:
                self.sids.append(session_id)
            row = {"sid": session_id, "entry": self.entry_nodes[0][1],
                   "stage0": self.stage0_port or self.entry_nodes[0][1], "n": len(tokens),
                   "start": start_pos, "status": 200, "code": None, "retry_after": None,
                   "served_by": None}
            log.append(row)
            t0 = time.perf_counter()
            try:
                resp = await self._post("/forward", self._forward_env(session_id, tokens,
                                                                      start_pos))
            except ServerError as e:
                row.update(status=e.status, code=e.code, retry_after=e.retry_after,
                           ms=(time.perf_counter() - t0) * 1e3)
                raise
            row.update(served_by=resp["served_by"], ms=(time.perf_counter() - t0) * 1e3)
            return np.asarray(resp["result_for_user"]["logits"])[0]

    c = Recorder([("127.0.0.1", entry["port"])], sampling=sampling, prefill_chunk=512)
    c.sids = []
    return c


def overload_passes(log: List[Dict[str, Any]]) -> Dict[Any, Dict[str, int]]:
    """Per node port (stage 0) and node id (the last stage), the prefill and
    decode passes the logged steps made it compute: an answered step on its
    stage-0 node and on the replica that served it; a shed one (503 busy) on
    its stage-0 node only; a refused one (409, 408) nowhere."""
    out: Dict[Any, Dict[str, int]] = {}
    for r in log:
        kind = "decode" if r["n"] == 1 and r["start"] > 0 else "prefill"
        at = []
        if r["status"] == 200:
            at = [r["stage0"], r["served_by"]]
        elif r["status"] == 503 and r["code"] == "busy":
            at = [r["stage0"]]
        for node in at:
            out.setdefault(node, {"prefill": 0, "decode": 0})[kind] += 1
    return out


def run_serve_overload(card: str, parts: str, work: str, serve) -> Dict[str, Any]:
    """The `serve_overload` phase: the relay's overload plane on the serve
    parts (deadlines, admission shedding with Retry-After, session rescue,
    restarts) and, on counter stages, hedged decode relays and a deadline
    on a stall; every stream token-exact against the serve phase's chain
    streams, every kernel launch accounted for."""
    import threading

    import numpy as np

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.control.dht import sess_hash
    from inferd_tpu_torch.utils.profiling import paired_delta_stats

    phase = "serve_overload"
    cfg = get_config(MODEL)
    layers = cfg.num_layers // 2
    greedy = SamplingConfig(temperature=0.0)
    prompts = serve_prompts(cfg.vocab_size)
    model: List[Dict[str, Any]] = []
    counter: List[Dict[str, Any]] = []
    log: List[Dict[str, Any]] = []

    def node_id(n):
        return f"127.0.0.1:{n['port']}"

    def stats(n):
        return http_get_json(f"http://127.0.0.1:{n['port']}/stats")

    def counters(st):
        return st["metrics"]["counters"]

    def forward(n, env):
        return post_wire(n["port"], "/forward", env)

    def tokens_env(sid, toks, start, **kw):
        return {"session_id": sid, "stage": 0, "task_id": sid,
                "payload": {"tokens": np.asarray([toks], np.int32), "start_pos": start,
                            "real_len": len(toks)}, **kw}

    def generate(client, prompt, new=NEW_TOKENS, **kw):
        async def go():
            async with client as c:
                return await c.generate_ids(prompt, max_new_tokens=new, **kw)

        return asyncio.run(go())

    def wait_for(cond, what, timeout_s=15.0):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            if cond():
                return time.perf_counter() - t0
            time.sleep(0.05)
        raise TimeoutError(f"{phase}: {what} after {timeout_s}s")

    def advertised(holder, viewer, sid):
        """Whether `viewer`'s gossip view has `holder` advertising `sid`."""
        rec = stats(viewer)["dht"]["0"].get(node_id(holder), {})
        return sess_hash(sid) in rec.get("sess", [])

    try:
        model = take_swarm(parts, work, "overload")
        counter = take_swarm(None, work, "overload_counter")
        t0 = time.perf_counter()
        for n in model + counter:
            wait_ready(n)
        converged = [wait_gossip(phase, nodes) for nodes in (model, counter)]
        e0, e1, e2, r1, r2 = model
        seed, good, stalled, last = counter
        names = {node_id(n): nm for n, nm in zip(model, ("E0", "E1", "E2", "R1", "R2"))}
        fresh = [stats(n) for n in model + counter]
        for st in fresh:
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"{phase}: a node did work before the phase: {st}")
        say(phase, f"{len(model) + len(counter)} run_node processes ready in "
                   f"{time.perf_counter() - t0:.1f}s (E0, E1, E2 --chaos delay_ms=400; R1 "
                   f"{' '.join(OVERLOAD_R1_ARGS)}; R2 --capacity 1; counter: a seed with "
                   f"--hedge-mode any --hedge-delay-ms {OVERLOAD_HEDGE_MS} --hop-timeout 5, "
                   "stage-1 replicas sound and --chaos stall_p=1 --capacity 100, stage 2); "
                   f"gossip full after {', '.join(f'{c:.2f}' for c in converged)} s; device "
                   "memory reserved per model node, GiB: "
                   f"{[round(st['memory'].get('reserved', 0) / 2**30, 3) for st in fresh[:5]]}")

        # an expired deadline: 408 at E0's entry, no node computes
        status, body = forward(e0, tokens_env("dl-entry", prompts[0], 0,
                                              deadline_ms=(time.time() - 5.0) * 1e3))
        passes = [stats(n)["forward_passes"] for n in model]
        if (status != 408 or body.get("code") != "deadline" or "entry" not in body["error"]
                or any(passes) or counters(stats(e0)).get("deadline.expired.entry") != 1):
            raise AssertionError(f"{phase}: expired deadline at E0: HTTP {status} {body}, "
                                 f"passes {passes}")
        say(phase, f"a spent deadline at E0: HTTP 408 {body['code']!r} ({body['error']}); "
                   f"no node computed (forward passes {passes})")

        # a deadline that expires during E2's compute: 408 post-compute, no relay
        t = time.perf_counter()
        status, body = forward(e2, tokens_env(
            "dl-compute", prompts[0], 0,
            deadline_ms=(time.time() + OVERLOAD_POST_COMPUTE_DEADLINE_S) * 1e3))
        took = time.perf_counter() - t
        after = [stats(n)["forward_passes"] for n in model]
        if (status != 408 or body.get("code") != "deadline" or "post-compute" not in body["error"]
                or after != [0, 0, 1, 0, 0]
                or counters(stats(e2)).get("deadline.expired.post-compute") != 1):
            raise AssertionError(f"{phase}: deadline in E2's compute: HTTP {status} {body}, "
                                 f"passes {after}")
        post_wire(e2["port"], "/end_session", {"session_id": "dl-compute", "stage": 0})
        say(phase, f"a deadline {OVERLOAD_POST_COMPUTE_DEADLINE_S * 1e3:.0f} ms ahead through "
                   f"E2 (400 ms chaos delay): HTTP 408 after {took * 1e3:.1f} ms "
                   f"({body['error']}); E2 computed, R1 and R2 did not (forward passes {after})")

        # two resident serve sessions put R1's pool under its reserve
        residents = {}
        for i, p in enumerate((prompts[2], prompts[3])):
            sid = f"resident-{i}"
            status, s0 = forward(e1, dict(tokens_env(sid, p, 0), relay=False))
            status1, s1 = forward(r1, {"session_id": sid, "stage": 1, "relay": False,
                                       "payload": s0.get("result")})
            logits = np.asarray(s1["result"]["logits"]) if status1 == 200 else None
            if status != 200 or logits is None or not np.isfinite(logits).all():
                raise AssertionError(f"{phase}: resident {sid}: HTTP {status} / {status1} {s1}")
            residents[sid] = (len(p), int(np.argmax(logits[0])))
        r1_st = stats(r1)
        pool = r1_st["executor"]["paged"]
        reserve = max(1, int(OVERLOAD_RESERVE * OVERLOAD_KV_BLOCKS))
        own = r1_st["dht"]["1"][node_id(r1)]
        if not pool["blocks_free"] < reserve or own.get("shed") != 1:
            raise AssertionError(f"{phase}: R1 after two residents: pool {pool}, reserve "
                                 f"{reserve}, its record {own}")
        # their decode steps (mid-session chunks) are never shed, and co-batch
        # (twice each, at once: two co-batched dispatches, a capture and a replay)
        for _ in range(OVERLOAD_RESIDENT_STEPS):
            hidden = {}
            for sid, (pos, tok) in residents.items():
                status, s0 = forward(e1, dict(tokens_env(sid, [tok], pos), relay=False))
                hidden[sid] = s0["result"]
            answers: Dict[str, Any] = {}

            def step(sid):
                answers[sid] = forward(r1, {"session_id": sid, "stage": 1, "relay": False,
                                            "payload": hidden[sid]})

            threads = [threading.Thread(target=step, args=(sid,)) for sid in residents]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            if sorted(a[0] for a in answers.values()) != [200, 200]:
                raise AssertionError(f"{phase}: R1 refused a resident's decode step: {answers}")
            residents = {sid: (pos + 1, int(np.argmax(np.asarray(
                answers[sid][1]["result"]["logits"])[0]))) for sid, (pos, _) in residents.items()}
        waited = wait_for(lambda: stats(e0)["dht"]["1"][node_id(r1)].get("shed") == 1,
                          "R1's shed flag in E0's view")
        r1_svc = round(stats(r1)["svc_ms"], 3)
        wait_for(lambda: stats(e0)["dht"]["1"][node_id(r1)].get("svc_ms") == r1_svc,
                 "R1's svc_ms in E0's view")
        say(phase, f"two resident sessions ({len(prompts[2])} and {len(prompts[3])} prompt "
                   f"tokens) on R1: blocks free {pool['blocks_free']} of {pool['blocks_total']} "
                   f"< reserve {reserve}; R1's record carries shed: 1 (in E0's view after "
                   f"{waited:.2f} s); their {OVERLOAD_RESIDENT_STEPS} decode steps each "
                   f"answered 200, not shed; R1's svc_ms {r1_svc} in E0's view")

        # the serve prompts at once through E0: R1 sheds, restarts land on R2
        wave_logs = [[] for _ in prompts]
        marks: List[List[Any]] = [[] for _ in prompts]
        t = time.perf_counter()

        async def wave():
            async def one(i, p):
                c = overload_client(e0, wave_logs[i], greedy)
                async with c:
                    # a restart may meet R1 again while E0's gossip view still
                    # shows R2 at its wave load (E0 plans over gossiped load and
                    # the sessions it holds)
                    return await c.generate_ids(p, max_new_tokens=NEW_TOKENS,
                                                on_token=marks[i].append,
                                                session_retries=OVERLOAD_SHED_RETRIES)

            return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

        streams = asyncio.run(wave())
        wave_s = time.perf_counter() - t
        for p, got, want in zip(prompts, streams, serve["streams"]):
            if got != want:
                raise AssertionError(f"{phase}: shed wave stream of prompt {len(p)} != the "
                                     "serve phase's chain stream from token "
                                     f"{first_divergence(got, want)}")
        sheds = [r for lg in wave_logs for r in lg if r["status"] != 200]
        served_r1 = [r for lg in wave_logs for r in lg if r["served_by"] == node_id(r1)]
        finals_on_r2 = all(all(r["served_by"] == node_id(r2) for r in lg
                               if r["sid"] == lg[-1]["sid"]) for lg in wave_logs)
        r1_c = counters(stats(r1))
        if (not sheds or any((r["status"], r["code"]) != (503, "busy")
                             or not 0.05 < (r["retry_after"] or 0) <= 5.0 for r in sheds)
                or served_r1 or not finals_on_r2 or r1_c.get("admission.shed", 0) != len(sheds)
                or any(m.count(None) != sum(1 for r in lg if r["status"] != 200)
                       for m, lg in zip(marks, wave_logs))):
            raise AssertionError(f"{phase}: shed wave: sheds {sheds}, steps served by R1 "
                                 f"{len(served_r1)}, final attempts on R2 {finals_on_r2}, R1 "
                                 f"counters {r1_c}")
        log += [r for lg in wave_logs for r in lg]
        restarts = [m.count(None) for m in marks]
        # a restart is every session of a prompt after its first; one that met
        # R1 again was shed again
        met_r1 = sum(1 for lg in wave_logs for sid in dict.fromkeys(r["sid"] for r in lg)
                     if sid != lg[0]["sid"]
                     and any(r["sid"] == sid and r["status"] != 200 for r in lg))
        e0_routes = {k: int(v) for k, v in counters(stats(e0)).items() if k.startswith("route.")}
        say(phase, f"the serve prompts at once through E0 in {wave_s:.2f} s: R1 shed "
                   f"{len(sheds)} new session(s) with HTTP 503 busy, retry_after "
                   f"{[r['retry_after'] for r in sheds]} s; restarts per prompt {restarts}, "
                   f"each on R2; every stream equals the serve phase's chain stream; R1 "
                   f"computed no wave step; restarts that met R1 again: {met_r1} of "
                   f"{sum(restarts)}; E0's route counts {e0_routes}")

        # rescue: a session entering at E0 fails over to E1 after a few tokens
        e0_before: Dict[str, Any] = {}
        rescue_log: List[Dict[str, Any]] = []
        c = overload_client(e0, rescue_log, greedy)

        stamps: List[float] = []

        def fail_over(tok):
            stamps.append(time.perf_counter())
            if tok is not None and len(c.sids) == 1 and len(rescue_log) == (
                    -(-len(prompts[2]) // 512) + OVERLOAD_RESCUE_AFTER - 1):
                sid = c.sids[-1]
                wait_for(lambda: advertised(e0, e1, sid), "E0's advert of the session at E1")
                e0_before.update(stats(e0)["executor"]["graphs"])
                c.entry_nodes = [("127.0.0.1", e1["port"])]
                c.stage0_port = e0["port"]  # E1 relays each chunk to E0, which computes it
                stamps.append(time.perf_counter())  # the wait for the advert is not a step

        e1_before = counters(stats(e1)).get("sessions.rescue_relay", 0)
        got = generate(c, prompts[2], on_token=fail_over)
        sent_e1 = sum(1 for r in rescue_log if r["entry"] == e1["port"])
        e0_graphs = stats(e0)["executor"]["graphs"]
        rescued = counters(stats(e1)).get("sessions.rescue_relay", 0) - e1_before
        replays = e0_graphs["replays"] - e0_before.get("replays", 0)
        captures = e0_graphs["captures"] - e0_before.get("captures", 0)
        if (got != serve["streams"][2] or rescued != sent_e1 or not sent_e1
                or captures or replays != sent_e1
                or stats(e1)["executor"]["sessions"] != len(residents)):
            raise AssertionError(f"{phase}: rescue: stream equal {got == serve['streams'][2]}, "
                                 f"{sent_e1} chunks to E1, rescue relays {rescued}, E0 graphs "
                                 f"+{captures} captures +{replays} replays")
        log += rescue_log
        # per token: E0's own steps before the switch, E1 -> E0 bounces after it
        k = OVERLOAD_RESCUE_AFTER
        direct = statistics.median(b - a for a, b in zip(stamps[:k - 1], stamps[1:k])) * 1e3
        bounced = statistics.median(b - a for a, b in zip(stamps[k:-1], stamps[k + 1:])) * 1e3
        timing_rescue = {"direct_ms_per_token": direct, "rescued_ms_per_token": bounced}
        say(phase, f"rescue: after {k} tokens the client entered at E1; E1 relayed all "
                   f"{sent_e1} later chunks to E0 through its `sess` advert "
                   f"(sessions.rescue_relay {rescued:.0f}), each an E0 graph replay (+{replays}, "
                   f"+{captures} captures); the stream equals the serve chain stream; median "
                   f"ms per token entering at E0 {direct:.3f}, rescued through E1 "
                   f"{bounced:.3f} ({bounced / direct:.3f}x) ({card})")

        # the relay's ms/token with a deadline on every envelope against without
        prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, SWARM_TIMING_PROMPT).tolist()
        short, long_ = SWARM_TIMING_STEPS
        arms = {"deadline": {"deadline_s": 60.0}, "none": {}}
        outs = {}
        for name, kw in arms.items():
            outs[name] = generate(overload_client(e0, log, greedy), prompt, new=long_, **kw)
        if outs["deadline"] != outs["none"]:
            raise AssertionError(f"{phase}: the timing prompt's streams differ with a deadline")
        times: Dict[str, Any] = {name: ([], []) for name in arms}
        for i in range(SWARM_TIMING_PAIRS):
            for name in (list(arms) if i % 2 == 0 else list(reversed(arms))):
                for n in ((short, long_) if i % 2 == 0 else (long_, short)):
                    t = time.perf_counter()
                    generate(overload_client(e0, log, greedy), prompt, new=n, **arms[name])
                    times[name][0 if n == short else 1].append(time.perf_counter() - t)
        timing: Dict[str, Any] = {}
        for name, (ts, tl) in times.items():
            per, n_valid, spread, _ = paired_delta_stats(ts, tl, short, long_)
            timing[name] = {"ms_per_token": per * 1e3, "valid_pairs": n_valid,
                            "spread_pt": spread}
        ratio = timing["deadline"]["ms_per_token"] / timing["none"]["ms_per_token"]
        timing["deadline_over_none"] = ratio
        say(phase, f"relay per token through E0 and R2, {SWARM_TIMING_PAIRS} interleaved pairs "
                   f"of {short}- and {long_}-token runs each: with a deadline on every envelope "
                   f"{timing['deadline']['ms_per_token']:.3f} ms/token ("
                   f"{timing['deadline']['valid_pairs']} valid, spread "
                   f"{timing['deadline']['spread_pt']}%), without "
                   f"{timing['none']['ms_per_token']:.3f} ms/token ("
                   f"{timing['none']['valid_pairs']} valid, spread "
                   f"{timing['none']['spread_pt']}%): ratio {ratio:.4f} ({card})")

        # a rescue that fails: E0 killed mid-session, E1 answers 409, one restart
        e0_final: Dict[str, Any] = {}
        fail_log: List[Dict[str, Any]] = []
        c = overload_client(e0, fail_log, greedy)
        seen: List[Any] = []

        kill_marks: Dict[str, float] = {}

        def kill_e0(tok):
            seen.append(tok)
            now = time.perf_counter()
            if tok is None:
                kill_marks["restart"] = now
            elif seen[-2:-1] == [None]:
                kill_marks["first_after"] = now
            if tok is not None and len(c.sids) == 1 and len(seen) == OVERLOAD_RESCUE_AFTER:
                sid = c.sids[-1]
                wait_for(lambda: advertised(e0, e1, sid), "E0's advert of the session at E1")
                e0_final.update(stats(e0))
                e0["proc"].kill()
                e0["proc"].wait(timeout=30)
                c.entry_nodes = [("127.0.0.1", e1["port"])]
                kill_marks["killed"] = time.perf_counter()

        e1_failed = counters(stats(e1)).get("sessions.rescue_failed", 0)
        got = generate(c, prompts[1], on_token=kill_e0, retry_rng=random.Random(0))
        refused = [r for r in fail_log if r["status"] != 200]
        failed = counters(stats(e1)).get("sessions.rescue_failed", 0) - e1_failed
        if (got != serve["streams"][1] or seen.count(None) != 1 or failed < 1
                or [(r["status"], r["code"]) for r in refused] != [(409, "session_state")]
                or len(c.sids) != 2):
            raise AssertionError(f"{phase}: failed rescue: stream equal "
                                 f"{got == serve['streams'][1]}, restarts {seen.count(None)}, "
                                 f"rescue_failed +{failed}, refused {refused}, sessions {c.sids}")
        log += fail_log
        restart_s = {"to_409_and_backoff": kill_marks["restart"] - kill_marks["killed"],
                     "to_first_token": kill_marks["first_after"] - kill_marks["killed"]}
        say(phase, f"E0 killed (SIGKILL) after {OVERLOAD_RESCUE_AFTER} tokens of a session: "
                   f"E1 counted sessions.rescue_failed +{failed:.0f} and answered 409 "
                   "session_state; the client restarted once (on_token(None) once) through "
                   "E1, whose re-prefill ran eagerly; the stream equals the serve chain "
                   f"stream; from the kill to the restart {restart_s['to_409_and_backoff']:.3f} s "
                   f"(the rescue's bounces and the client's backoff; the refused step's round "
                   f"trip {refused[0]['ms']:.1f} ms), to the restart's first token "
                   f"{restart_s['to_first_token']:.3f} s ({card})")
        bounces = stats(e1)["metrics"]["histograms"].get("rescue.bounce_ms")
        say(phase, f"E1's rescue bounces (rescue.bounce_ms, every bounce's relay): {bounces}; "
                   f"the kill-to-restart bound {OVERLOAD_RESTART_BOUND_S} s")
        if restart_s["to_409_and_backoff"] > OVERLOAD_RESTART_BOUND_S:
            raise AssertionError(f"{phase}: {restart_s['to_409_and_backoff']:.3f} s from E0's "
                                 f"kill to the client's restart, past the "
                                 f"{OVERLOAD_RESTART_BOUND_S} s bound; E1's rescue bounces "
                                 f"{bounces}; the refused steps {refused}")

        # counter stages: hedges win over the stall, then a deadline on it
        def hedge_env(i, **kw):
            return {"session_id": f"hedge-{i}", "stage": 1, "task_id": f"h{i}", "rescued": True,
                    "payload": {"state": 1, "trace": [0], "start_pos": 5, "real_len": 1}, **kw}

        hedged, i = [], 0
        while True:
            b = stats(seed)["hedge_budget"]
            if b["fired"] + 1 > 0.05 * (b["primary"] + 1) + 2 or i >= 20:
                break
            t = time.perf_counter()
            status, body = forward(seed, hedge_env(i))
            took = time.perf_counter() - t
            r = body.get("result_for_user", {}) if status == 200 else {}
            if r.get("state") != 3 or r.get("trace") != [0, 1, 2]:
                raise AssertionError(f"{phase}: counter envelope {i}: HTTP {status} {body}")
            hedged.append(took * 1e3)
            i += 1
        sc = counters(stats(seed))
        b = stats(seed)["hedge_budget"]
        if not sc.get("hedge.fired") or sc.get("hedge.won") != sc.get("hedge.fired") or (
                b["fired"] > 0.05 * b["primary"] + 2):
            raise AssertionError(f"{phase}: hedges on the counter seed: {sc}, budget {b}")
        t = time.perf_counter()
        status, body = forward(seed, hedge_env(
            "dl", deadline_ms=(time.time() + OVERLOAD_STALL_DEADLINE_S) * 1e3))
        took = time.perf_counter() - t
        st_seed = stats(seed)
        if (status != 408 or body.get("code") != "deadline"
                or took > OVERLOAD_STALL_DEADLINE_S + 0.15 or st_seed["dead_hops"] != 1):
            raise AssertionError(f"{phase}: a deadline toward the stall: HTTP {status} {body} "
                                 f"after {took:.3f} s, {st_seed['dead_hops']} dead hops")
        say(phase, f"counter seed: {len(hedged)} decode envelopes, each answered by its hedge "
                   f"when the stalled replica was picked: hedge.fired {sc['hedge.fired']:.0f} == "
                   f"hedge.won {sc['hedge.won']:.0f} (<= 0.05 x {b['primary']} primaries + 2), "
                   f"answers in {[round(x, 1) for x in hedged]} ms (hedge delay "
                   f"{OVERLOAD_HEDGE_MS} ms); then, the budget spent, an envelope with a "
                   f"{OVERLOAD_STALL_DEADLINE_S * 1e3:.0f} ms deadline met the stall: HTTP 408 "
                   f"after {took * 1e3:.1f} ms ({body['error']}), not the 5 s hop timeout")

        # every model node's launches: exact for the steps it served
        for sid, (pos, _) in residents.items():
            for n, stage in ((e1, 0), (r1, 1)):
                post_wire(n["port"], "/end_session", {"session_id": sid, "stage": stage,
                                                      "relay": False})
        final = {"E0": e0_final, **{nm: stats(n) for nm, n in (("E1", e1), ("E2", e2),
                                                                ("R1", r1), ("R2", r2))}}
        passes = overload_passes(log)
        extra = {"E1": {"prefill": 2, "decode": 2 * OVERLOAD_RESIDENT_STEPS},
                 "E2": {"prefill": 1, "decode": 0}}
        node_graphs, launches, routes = [], None, {"split": 0, "mma": 0}
        for nm, st in final.items():
            if counters(st).get("hedge.fired"):
                raise AssertionError(f"{phase}: {nm} hedged on the model path: {counters(st)}")
            for k, v in flash_routes(st).items():
                routes[k] += v
            launches = {k: (launches or {}).get(k, 0) + v["launches"]
                        for k, v in st["kernels"].items()}
            if nm == "R1":
                ex = st["executor"]
                split, want_split = paged_splits(phase, st, cfg)
                want = {"paged": layers * ex["batched_steps"], "mma": layers * ex["prefill_steps"]}
                got_ = {"paged": st["kernels"]["paged_decode_gqa"]["launches"],
                        "mma": flash_routes(st)["mma"]}
                if got_ != want or split != want_split or flash_routes(st)["split"]:
                    raise AssertionError(f"{phase}: R1 launches {got_}, want {want}; split "
                                         f"{split}, want {want_split}")
                node_graphs.append(check_node_graphs(phase, st, ex["batched_steps"]))
                continue
            port = int(st["node_id"].rsplit(":", 1)[1])
            key = port if nm.startswith("E") else st["node_id"]
            want_p = dict(passes.get(key, {"prefill": 0, "decode": 0}))
            for k, v in extra.get(nm, {}).items():
                want_p[k] += v
            want = {"split": layers * want_p["decode"], "mma": layers * want_p["prefill"]}
            say(phase, f"{nm} ({st['node_id']}): {st['forward_passes']} passes "
                       f"({want_p}), flash_gqa routes {flash_routes(st)} (want {want})")
            if (flash_routes(st) != want
                    or st["forward_passes"] != want_p["prefill"] + want_p["decode"]):
                raise AssertionError(f"{phase}: {nm}: routes {flash_routes(st)}, want {want}, "
                                     f"passes {st['forward_passes']}")
            if want_p["decode"]:
                node_graphs.append(check_node_graphs(phase, st, want_p["decode"]))
        stop_nodes(model + counter)
        model, counter = [], []
        return {"launches": launches, "flash_routes": routes,
                "paged_split": final["R1"]["kernels"]["paged_decode_gqa"]["split_launches"],
                "gemv_routes": {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()},
                "graphs": node_graphs, "timing": timing, "sheds": len(sheds),
                "rescue": timing_rescue, "restart_s": restart_s}
    except BaseException:
        stop_nodes(model + counter, show_logs=True)
        model, counter = [], []
        raise
    finally:
        stop_nodes(model + counter)


# -- serve_elastic: drain, live stage migration, empty-stage adoption ------------


def drive(client, prompts, concurrent: bool = False, new: int = NEW_TOKENS,
          marks: Optional[List[float]] = None, on_token=None, **kw) -> List[List[int]]:
    """Greedy streams of `prompts` through `client`, in turn or all at once;
    `marks` collects the wall time (time.time()) of every token, and
    `on_token` (in turn only) sees each token too."""
    def tick(tok):
        if marks is not None and tok is not None:
            marks.append(time.time())
        if on_token is not None:
            on_token(tok)

    async def go():
        async with client as c:
            if concurrent:
                return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=new, **kw)
                                              for p in prompts))
            return [await c.generate_ids(p, max_new_tokens=new, on_token=tick, **kw)
                    for p in prompts]

    return asyncio.run(go())


def routed_swarm_client(entry: int, route: Dict[str, str], sampling, **kw):
    """A SwarmClient entering at the node on port `entry` whose envelopes
    carry `route` ({str(stage): node_id}): the relay follows it for a new
    session (the planner's route, here chosen by the phase), so a phase
    knows which replica holds the session's KV."""
    from inferd_tpu_torch.client.swarm_client import SwarmClient

    class Routed(SwarmClient):
        def _forward_env(self, session_id, tokens, start_pos):
            return dict(super()._forward_env(session_id, tokens, start_pos), route=route)

    return Routed([("127.0.0.1", entry)], sampling=sampling, **kw)


def check_streams(phase: str, what: str, prompts, got, want) -> None:
    for p, a_, b_ in zip(prompts, got, want):
        if a_ != b_:
            raise AssertionError(f"{phase}: {what}: the stream of prompt {len(p)} differs from "
                                 f"the serve phase's chain stream from token "
                                 f"{first_divergence(a_, b_)}")


def kv_held(st: Dict[str, Any]) -> int:
    """A one-session node's KV buffer bytes: its live sessions' and its idle
    pool's."""
    ex = st["executor"]
    return int(ex["kv_bytes"]) + int(ex["buffers"]["free_bytes"])


def run_serve_elastic(card: str, parts: str, work: str, serve) -> Dict[str, Any]:
    """The `serve_elastic` phase: four one-session graphed nodes, A0 and A1 on
    stage 0, B and C on stage 1, their balancers every ELASTIC_REBALANCE_S:
    C drains while it holds a session and hands it to B, A1 is reassigned to
    stage 1 while it holds a stage-0 session and hands it to A0 (both
    sessions go on with no client restart), and when A0 dies the min-id of
    B and A1 adopts the empty stage 0; every stream token-exact against the
    serve phase's chain streams."""
    import numpy as np

    from inferd_tpu_torch.client.base import http_post
    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.client.swarm_client import SwarmClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.runtime import wire

    phase = "serve_elastic"
    cfg = get_config(MODEL)
    layers = cfg.num_layers // 2
    greedy = SamplingConfig(temperature=0.0)
    prompts = serve_prompts(cfg.vocab_size)
    per = [-(-len(p) // 512) + NEW_TOKENS - 1 for p in prompts]  # a session's passes per stage
    nodes: List[Dict[str, Any]] = []
    final: Dict[str, Dict[str, Any]] = {}  # each node's last /stats

    def url(n):
        return ("127.0.0.1", n["port"])

    def nid(n):
        return f"127.0.0.1:{n['port']}"

    def stats(n):
        return http_get_json(f"http://127.0.0.1:{n['port']}/stats")

    def passes(n):
        return stats(n)["forward_passes"]

    def counters(st):
        return st["metrics"]["counters"]

    def swarm_client(n, **kw):
        return SwarmClient([url(n)], sampling=greedy, prefill_chunk=512, **kw)

    def chain_client(*ns):
        return ChainClient([url(n) for n in ns], sampling=greedy, prefill_chunk=512)

    def view(n, stage):
        return stats(n)["dht"].get(str(stage), {})

    def wait_for(what: str, cond, timeout_s: float) -> float:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"{phase}: {what} not within {timeout_s} s")
            time.sleep(0.1)
        return time.perf_counter() - t0

    def launches_exact(name: str, st: Dict[str, Any]) -> None:
        """flash_gqa launched 14 times for every forward pass and for each
        migration's two warm-up passes (a first chunk and a decode step)."""
        mig = int(st["metrics"]["counters"].get("migrations", 0))
        want = layers * (st["forward_passes"] + 2 * mig)
        got = st["kernels"]["flash_gqa"]["launches"]
        say(phase, f"{name}: stage {st['stage']}, {st['forward_passes']} passes, {mig} "
                   f"migrations: flash_gqa launches {got} (want {want}), routes "
                   f"{flash_routes(st)}")
        if got != want:
            raise AssertionError(f"{phase}: {name}: flash_gqa launches {got}, want {want}")

    try:
        nodes = take_swarm(parts, work, "elastic")
        a0, a1, b, c = nodes
        names = {nid(a0): "A0", nid(a1): "A1", nid(b): "B", nid(c): "C"}
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        converged = wait_gossip(phase, nodes)
        say(phase, f"4 run_node --device {DEVICE} {' '.join(ELASTIC_ARGS)} processes (A0, A1 on "
                   f"stage 0; B, C on stage 1) ready in {time.perf_counter() - t0:.1f}s; every "
                   f"gossip view full after {converged:.2f} s; ids {names}")
        for n in nodes:  # fresh processes: every count starts at 0
            st = stats(n)
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"{phase}: a node did work before the phase: {st}")

        # 1. warm: the serve prompts through A0 in turn, then four at once
        before = {n["port"]: passes(n) for n in (b, c)}
        seq = drive(swarm_client(a0), prompts)
        conc = drive(swarm_client(a0), prompts, concurrent=True)
        check_streams(phase, "warm, in turn", prompts, seq, serve["streams"])
        check_streams(phase, "warm, at once", prompts, conc, serve["streams"])
        served = {names[nid(n)]: passes(n) - before[n["port"]] for n in (b, c)}
        say(phase, f"warm: the serve prompts through A0 in turn and then at once, token-exact; "
                   f"stage-1 passes {served} (sessions of {per} passes)")
        if not all(served.values()) or sum(served.values()) != 2 * sum(per):
            raise AssertionError(f"{phase}: warm: stage-1 passes {served}")

        # 2. drain C while it holds a session: C hands it to B, and its next
        # steps, relayed by A0, reach B: through C's rescue while A0's view
        # holds C's advert of the session, then straight (route.sess_moved)
        drained: Dict[str, Any] = {}
        c_before, b_before = passes(c), passes(b)
        toks: List[int] = []

        def drain_at(tok):
            toks.append(tok)
            if len(toks) == ELASTIC_DRAIN_AFTER:
                t = time.perf_counter()
                drained["reply"] = post_wire(c["port"], "/drain", {"wait_s": 2.0})
                drained["ms"] = (time.perf_counter() - t) * 1e3

        got = drive(routed_swarm_client(a0["port"], {"1": nid(c)}, greedy, prefill_chunk=512),
                    prompts[1:2], on_token=drain_at)
        check_streams(phase, "C's resident session across the drain", prompts[1:2], got,
                      serve["streams"][1:2])
        status, drain_reply = drained["reply"]
        st_c, st_b = stats(c), stats(b)
        c_served, b_served = st_c["forward_passes"] - c_before, st_b["forward_passes"] - b_before
        c_count, b_count = counters(st_c), counters(st_b)
        moved = counters(stats(a0)).get("route.sess_moved", 0)
        want_c = per[1] - (NEW_TOKENS - ELASTIC_DRAIN_AFTER)  # its chunks and the steps before
        say(phase, f"drain: POST /drain {{'wait_s': 2}} to C after {ELASTIC_DRAIN_AFTER} tokens "
                   f"of a session through A0 routed to C: HTTP {status} {drain_reply} in "
                   f"{drained['ms']:.1f} ms; C's drain.handed_off "
                   f"{c_count.get('drain.handed_off')}, B's sessions.imported "
                   f"{b_count.get('sessions.imported')}; C served {c_served} passes (want "
                   f"{want_c}), B the remaining {b_served} (want {per[1] - want_c}), "
                   f"{c_count.get('sessions.rescue_relay', 0):.0f} of them through C's rescue, "
                   f"the rest relayed straight to B (A0's route.sess_moved {moved:.0f}); "
                   f"token-exact, client restarts {toks.count(None)}")
        if (status != 200 or not drain_reply.get("ok") or drain_reply.get("draining") is not True
                or drain_reply.get("resident") != 1 or drain_reply.get("handed_off") != 1
                or c_count.get("drain.handed_off") != 1 or b_count.get("sessions.imported") != 1
                or c_served != want_c or b_served != per[1] - want_c or None in toks
                or moved < 1):
            raise AssertionError(f"{phase}: drain reply {status} {drain_reply}, C served "
                                 f"{c_served}, B {b_served}, restarts {toks.count(None)}")
        env = {"session_id": "elastic-new", "stage": 1, "relay": False,
               "payload": {"hidden": np.zeros((1, 1, cfg.hidden_size), np.float32),
                           "start_pos": 0, "real_len": 1}}
        status, raw, headers = http_post(f"http://127.0.0.1:{c['port']}/forward",
                                         wire.pack(env), 30.0)
        body = wire.unpack(raw)
        retry = headers.get("Retry-After")
        say(phase, f"a new session's chain envelope to C: HTTP {status} {body}, Retry-After "
                   f"{retry}")
        if status != 503 or body.get("code") != "draining" or retry is None:
            raise AssertionError(f"{phase}: a new session at the draining C: {status} {body}")
        wait_for("C's draining: 1 in A0's view",
                 lambda: view(a0, 1).get(nid(c), {}).get("draining") == 1, 5.0)
        b_before, c_before = passes(b), passes(c)
        after = drive(swarm_client(a0), prompts)
        check_streams(phase, "four new sessions during the drain", prompts, after,
                      serve["streams"])
        b_served, c_served = passes(b) - b_before, passes(c) - c_before
        say(phase, f"four new sessions through A0 in turn during the drain: token-exact, B "
                   f"{b_served} passes (want {sum(per)}), C {c_served} (want 0); C's record "
                   f"in A0's view: draining 1")
        if b_served != sum(per) or c_served:
            raise AssertionError(f"{phase}: during the drain B served {b_served}, C {c_served}")
        final["C"] = stats(c)
        stop_nodes([c])
        gone = wait_for("C's tombstone in A0's view", lambda: nid(c) not in view(a0, 1), 10.0)
        say(phase, f"C stopped: its record left A0's view after {gone:.2f} s (a tombstone)")

        # 3. reassign A1 to stage 1 while it holds a stage-0 session, after a
        # whole session of its own on stage 0 (its svc_ms, which a migration
        # keeps, then no longer carries its first forward's captures): A1
        # hands the resident to A0, and its next steps, entering A1, reach A0
        got = drive(chain_client(a1, b), prompts[2:3])
        check_streams(phase, "a chain session through A1 on stage 0", prompts[2:3], got,
                      serve["streams"][2:3])
        reassigned: Dict[str, Any] = {}
        a0_before = passes(a0)
        toks = []

        def reassign_at(tok):
            toks.append(tok)
            if len(toks) == ELASTIC_DRAIN_AFTER:
                reassigned["st0"] = stats(a1)
                t = time.perf_counter()
                reassigned["reply"] = post_wire(a1["port"], "/reassign", {"stage": 1})
                reassigned["ms"] = (time.perf_counter() - t) * 1e3

        got = drive(routed_swarm_client(a1["port"], {"1": nid(b)}, greedy, prefill_chunk=512),
                    prompts[2:3], on_token=reassign_at)
        check_streams(phase, "A1's stage-0 session across its reassign", prompts[2:3], got,
                      serve["streams"][2:3])
        st0 = reassigned["st0"]
        status, reply = reassigned["reply"]
        wall_ms = reassigned["ms"]
        st1, st_b = stats(a1), stats(b)
        a0_took = passes(a0) - a0_before
        a0_count = counters(stats(a0))
        want_a1 = 2 * per[2] - (NEW_TOKENS - ELASTIC_DRAIN_AFTER)  # and the chain session's
        say(phase, f"reassign with a resident: A1 served {st0['forward_passes']} stage-0 passes "
                   f"(want {want_a1}) of a chain session and of a session routed A1 -> B, then "
                   f"handed the second to A0 (A1's sessions.exported "
                   f"{counters(st1).get('sessions.exported')}, A0's sessions.imported "
                   f"{a0_count.get('sessions.imported')}), which served the remaining {a0_took} "
                   f"(want {NEW_TOKENS - ELASTIC_DRAIN_AFTER}); token-exact, client restarts "
                   f"{toks.count(None)}")
        if (st0["forward_passes"] != want_a1 or a0_took != NEW_TOKENS - ELASTIC_DRAIN_AFTER
                or None in toks
                or a0_count.get("sessions.imported") != 1
                or counters(st1).get("sessions.exported") != 1):
            raise AssertionError(f"{phase}: the reassign's handoff: A1 {st0['forward_passes']}, "
                                 f"A0 {a0_took}, restarts {toks.count(None)}, {a0_count}")
        mig = st1["last_migration"] or {}
        hist = st1["metrics"]["histograms"].get("reshard.ms_to_serving", {})
        gib = 2.0**30
        mem = {k: {m: round(v / gib, 3) for m, v in d.items()}
               for k, d in mig.get("memory", {}).items()}
        say(phase, f"reassign: POST /reassign {{'stage': 1}} to A1: HTTP {status} {reply} in "
                   f"{wall_ms:.1f} ms (the handoff included); A1's /stats: stage {st1['stage']}, "
                   f"migrations {st1['metrics']['counters'].get('migrations')}, "
                   f"reshard.ms_to_serving {hist}; load {mig.get('load_ms', 0):.1f} ms, warm-up "
                   f"{mig.get('warmup_ms', 0):.1f} ms, serving after "
                   f"{mig.get('ms_to_serving', 0):.1f} ms, release "
                   f"{mig.get('release_ms', 0):.1f} ms (released: {mig.get('released')}); "
                   f"memory GiB {mem} ({card})")
        if (status != 200 or reply != {"ok": True, "stage": 1} or st1["stage"] != 1
                or st1["metrics"]["counters"].get("migrations") != 1 or hist.get("count") != 1
                or not mig.get("released")):
            raise AssertionError(f"{phase}: reassign {status} {reply}; A1 {st1['stage']} "
                                 f"{st1['metrics']}, {mig}")
        old_bytes = st0["quantized_bytes"]
        freed = mig["memory"]["after_warmup"]["allocated"] - mig["memory"]["after_release"][
            "allocated"]
        non_kv = {"A1": st1["memory"]["allocated"] - kv_held(st1),
                  "B": st_b["memory"]["allocated"] - kv_held(st_b)}
        diff = non_kv["A1"] - non_kv["B"]
        say(phase, f"A1's release freed {freed / gib:.3f} GiB (its stage-0 weights "
                   f"{old_bytes / gib:.3f} GiB); allocated less KV buffers: A1 "
                   f"{non_kv['A1'] / gib:.3f} GiB, B (started on stage 1) "
                   f"{non_kv['B'] / gib:.3f} GiB: A1 - B = {diff / 2**20:.1f} MiB (margin "
                   f"{ELASTIC_MEMORY_MARGIN / 2**20:.0f} MiB) ({card})")
        if freed < 0.9 * old_bytes or abs(diff) > ELASTIC_MEMORY_MARGIN:
            raise AssertionError(f"{phase}: A1 still holds its old stage: freed {freed}, "
                                 f"non-KV {non_kv}")
        seen = wait_for("stage 1 = {B, A1} in A0's view",
                        lambda: set(view(a0, 1)) == {nid(b), nid(a1)}, SWARM_TTL_S)

        # A1's svc_ms still averages its stage-0 computes, prefills included
        # (a migration keeps the EWMA: PERF.md §7), which can outweigh the
        # held sessions that spread new ones (one run put all four on B); a
        # session pinned to A1 first folds stage-1 steps into it, as B's
        def svc(n):
            return view(a0, 1).get(nid(n), {}).get("svc_ms")

        svc_old = svc(a1)
        pinned = drive(routed_swarm_client(a0["port"], {"1": nid(a1)}, greedy,
                                           prefill_chunk=512), prompts[:1])
        check_streams(phase, "a session pinned to A1 after the reassign", prompts[:1], pinned,
                      serve["streams"])
        wait_for("A1's stage-1 svc_ms in A0's view", lambda: svc(a1) != svc_old, SWARM_TTL_S)
        say(phase, f"a session pinned to A1 (stage 1) after the reassign: token-exact; svc_ms in "
                   f"A0's view: A1 {svc_old} before it, {svc(a1)} after, B {svc(b)}")
        a1_before, b_before = passes(a1), passes(b)
        conc = drive(swarm_client(a0), prompts, concurrent=True)
        check_streams(phase, "four sessions at once after the reassign", prompts, conc,
                      serve["streams"])
        st_a1 = stats(a1)
        a1_served, b_served = st_a1["forward_passes"] - a1_before, passes(b) - b_before
        a1_sessions = whole_sessions(a1_served, per)
        say(phase, f"A0's view showed stage 1 = {{B, A1}} {seen:.2f} s after the reassign; four "
                   f"sessions at once through A0: token-exact, stage-1 passes A1 {a1_served}, B "
                   f"{b_served} ({a1_sessions} whole sessions on A1)")
        if not a1_served or not b_served or a1_sessions is None:
            raise AssertionError(f"{phase}: after the reassign A1 served {a1_served}, B "
                                 f"{b_served}")
        # A1's stage-1 graphs: its warm-up's decode step and every decode step since
        check_node_graphs(phase, st_a1, (a1_sessions + 1) * (NEW_TOKENS - 1) + 1)

        # 4. A0 dies; the min-id of B and A1 adopts the empty stage 0
        final["A0"] = stats(a0)
        a0["proc"].kill()
        a0["proc"].wait(timeout=30)
        t_kill = time.time()
        left = wait_for("A0's record leaving B's and A1's views",
                        lambda: all(nid(a0) not in view(n, 0) for n in (b, a1)),
                        SWARM_TTL_S + 10)
        entry = min((b, a1), key=nid)
        marks: List[float] = []
        got = drive(swarm_client(entry), prompts, marks=marks, session_retries=4,
                    retry_delay_s=0.5)
        check_streams(phase, "after the adoption", prompts, got, serve["streams"])
        st = {name: stats(n) for name, n in (("B", b), ("A1", a1))}
        stages = {name: s["stage"] for name, s in st.items()}
        adopters = [name for name, s in st.items() if s["stage"] == 0]
        adopt = {name: {k: v for k, v in s["metrics"]["counters"].items()
                        if k.startswith("stage.adopt.") or k.startswith("migrations")}
                 for name, s in st.items()}
        at = (st[adopters[0]]["last_migration"] or {}) if len(adopters) == 1 else {}
        say(phase, f"A0 killed: its record left both views {left:.1f} s later; the serve "
                   f"prompts through {names[nid(entry)]} (the smaller id), token-exact; stages "
                   f"{stages}; counters {adopt}; the adoption served "
                   f"{at.get('at', t_kill) - t_kill:.1f} s after the kill (load "
                   f"{at.get('load_ms', 0):.1f} ms, warm-up {at.get('warmup_ms', 0):.1f} ms), "
                   f"the first token {marks[0] - t_kill:.1f} s after it ({card})")
        want_migrations = {"B": 0, "A1": 1}
        want_migrations[names[nid(entry)]] += 1
        got_migrations = {name: int(s["metrics"]["counters"].get("migrations", 0))
                          for name, s in st.items()}
        if (adopters != [names[nid(entry)]] or sorted(stages.values()) != [0, 1]
                or got_migrations != want_migrations):
            raise AssertionError(f"{phase}: adoption: stages {stages}, migrations "
                                 f"{got_migrations} (want {want_migrations}), entry "
                                 f"{names[nid(entry)]}")
        final.update(st)
        for name in ("A0", "A1", "B", "C"):
            launches_exact(name, final[name])
        stop_nodes(nodes)
        nodes = []
        launches = dict.fromkeys(final["B"]["kernels"], 0)
        routes = {"split": 0, "mma": 0}
        for fst in final.values():
            for name, k in fst["kernels"].items():
                launches[name] += k["launches"]
            for r, v in flash_routes(fst).items():
                routes[r] += v
        return {"launches": launches, "flash_routes": routes,
                "gemv_routes": {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()},
                "migration": mig, "adoption_s": at.get("at", t_kill) - t_kill,
                "first_token_s": marks[0] - t_kill, "drain": drain_reply}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def run_serve_sessions(card: str, parts: str, parts1: str, work: str) -> Dict[str, Any]:
    """The `serve_sessions` phase: sessions that move, on fresh processes.

    Swarm: S0 (stage 0) and S1a, S1b (stage 1), one-session graphed nodes. A
    SESS_PREFIX-token prefix pinned through a SwarmClient, then the prompts
    that extend it fork it on both stages and prefill only their suffix,
    token-exact against the same prompts unpinned; a fork after the pin's
    end misses and prefills in full; generate_ids_disaggregated hands a
    session from S1a to S1b (/export_session); POST /generate on S0 with
    pin_prefix_len, plain and streamed, and tools/send --server-side
    --pin-prefix-ids give the client loop's ids; stop() of S1b hands its
    resident session to S1a. Paged: P and Q, whole-model --batch-lanes
    --paged-kv nodes: a pinned prefix and its forks on P against unforked
    streams on Q, a tail-block fork stepped in lockstep with its parent
    (bit-exact logits), and a session exported P -> Q. Every node's
    flash_gqa (split and mma) and paged_decode_gqa launches are exact."""
    import numpy as np

    from inferd_tpu_torch.config import SamplingConfig, get_config

    phase = "serve_sessions"
    cfg = get_config(MODEL)
    layers, whole_layers = cfg.num_layers // 2, cfg.num_layers
    greedy = SamplingConfig(temperature=0.0)
    rng = np.random.default_rng(19)
    prefix = rng.integers(0, cfg.vocab_size, SESS_PREFIX).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist() for n in SESS_SUFFIXES]
    paged_prompts = [p[:SESS_PAGED_PREFIX] + p[SESS_PREFIX:] for p in prompts]
    dec = NEW_TOKENS - 1
    nodes: List[Dict[str, Any]] = []
    t_phase = time.perf_counter()

    def nid(n):
        return f"127.0.0.1:{n['port']}"

    def stats(n):
        return http_get_json(f"http://127.0.0.1:{n['port']}/stats")

    def counter(st, name):
        return int(st["metrics"]["counters"].get(name, 0))

    def client(n, route=None, chunk=SESS_PREFIX):
        return routed_swarm_client(n["port"], route or {}, greedy, prefill_chunk=chunk)

    def timed(cl, prompt, on_token=None):
        """(ids, seconds to the first token, seconds in all) of one
        generation."""
        marks: List[float] = []

        def tick(tok):
            marks.append(time.perf_counter())
            if on_token is not None:
                on_token(tok)

        async def go():
            async with cl as c:
                t = time.perf_counter()
                ids = await c.generate_ids(prompt, max_new_tokens=NEW_TOKENS, on_token=tick)
                return ids, marks[0] - t, time.perf_counter() - t

        return asyncio.run(go())

    try:
        nodes = take_swarm(parts, work, "sessions")
        s0, s1a, s1b = nodes
        pq = [start_single(parts1, work, BATCH_PAGED_ARGS, tag) for tag in ("_sessP", "_sessQ")]
        nodes += pq
        p_node, q_node = pq
        for n in nodes:
            wait_ready(n)
        converged = wait_gossip(phase, [s0, s1a, s1b])
        names = {nid(s0): "S0", nid(s1a): "S1a", nid(s1b): "S1b"}
        say(phase, f"5 fresh run_node --device {DEVICE} processes (S0, S1a, S1b; P, Q with "
                   f"{' '.join(BATCH_PAGED_ARGS)}) ready in {time.perf_counter() - t_phase:.1f}s; "
                   f"the swarm's gossip views full after {converged:.2f}s")
        # what each one-session node computes: prompt chunks (the tensor
        # cores' route) and decode steps (the split route)
        want = {name: {"chunks": 0, "decode": 0} for name in ("S0", "S1a", "S1b")}

        def add(name, chunks=0, decode=0):
            want[name]["chunks"] += chunks
            want[name]["decode"] += decode

        via_a = {"1": nid(s1a)}
        # 1. the prompts unpinned, then pinned: both stages fork, the suffix prefills
        refs, ref_ttft = [], []
        for p in prompts:
            ids, ttft, _ = timed(client(s0, via_a), p)
            refs.append(ids)
            ref_ttft.append(ttft)
            for name in ("S0", "S1a"):
                add(name, 2, dec)
        pinned = client(s0, via_a)
        forked, fork_ttft = [], []
        before = {n["port"]: stats(n) for n in (s0, s1a)}

        async def forks():
            async with pinned as c:
                await c.pin_prefix(prefix)
                for p in prompts:
                    t = time.perf_counter()
                    first: List[float] = []
                    forked.append(await c.generate_ids(
                        p, max_new_tokens=NEW_TOKENS,
                        on_token=lambda tok: first.append(time.perf_counter())))
                    fork_ttft.append(first[0] - t)
                parent, _ = c.pinned_parent(prefix)
                # the pin's parent ends: the next fork misses, and prefills in full
                await c._end_session(parent)
                miss = await c.generate_ids(prompts[0], max_new_tokens=NEW_TOKENS)
                return miss, c.pinned_parent(prefix)

        miss, left = asyncio.run(forks())
        for name in ("S0", "S1a"):
            add(name, 1 + len(prompts), len(prompts) * dec)  # the pin, each suffix
            add(name, 2, dec)  # the miss
        after = {n["port"]: stats(n) for n in (s0, s1a)}
        fork_ok = {names[nid(n)]: counter(after[n["port"]], "fork.ok")
                   - counter(before[n["port"]], "fork.ok") for n in (s0, s1a)}
        fork_miss = counter(after[s0["port"]], "fork.miss") - counter(before[s0["port"]],
                                                                       "fork.miss")
        check_streams(phase, "forked on the pin", prompts, forked, refs)
        check_streams(phase, "a fork that missed", prompts[:1], [miss], refs[:1])
        say(phase, f"{len(prompts)} prompts of a {SESS_PREFIX}-token prefix and {SESS_SUFFIXES} "
                   f"more: pinned, each forked on both stages (fork.ok {fork_ok}, want "
                   f"{len(prompts)} each), token-exact against the same prompts unpinned; the "
                   f"first token after {[round(t * 1e3, 1) for t in fork_ttft]} ms forked "
                   f"against {[round(t * 1e3, 1) for t in ref_ttft]} ms unpinned (the fork's "
                   f"saved prefill of {SESS_PREFIX} tokens; the first unpinned session paid "
                   f"the fresh processes' first captures); after the pin's /end_session a "
                   f"fork missed (fork.miss {fork_miss}), the pin was dropped "
                   f"({left is None}) and the prompt prefilled in full, token-exact ({card})")
        if fork_ok != {"S0": len(prompts), "S1a": len(prompts)} or fork_miss != 1 or left:
            raise AssertionError(f"{phase}: fork.ok {fork_ok}, fork.miss {fork_miss}, pin {left}")

        # 2. a session prefilled through S1a and handed, at stage 1, to S1b
        async def disagg():
            async with client(s1a, via_a) as c:
                return await c.generate_ids_disaggregated(prompts[1], ("127.0.0.1", s1b["port"]),
                                                          max_new_tokens=NEW_TOKENS)

        got = asyncio.run(disagg())
        check_streams(phase, "disaggregated S1a -> S1b", prompts[1:2], [got], refs[1:2])
        add("S0", 2, dec)
        add("S1a", 2)
        add("S1b", 0, dec)
        st_a = stats(s1a)
        h = st_a["metrics"]["histograms"].get("handoff.ms", {})
        handoff = {"bytes": counter(st_a, "handoff.bytes"), "ms": h.get("mean_ms"),
                   "sessions": counter(st_a, "sessions.handed_off")}
        say(phase, f"generate_ids_disaggregated: prefill through S1a, /export_session of its "
                   f"stage-1 KV ({len(prompts[1])} slots) to S1b, {dec} decode steps on S1b: "
                   f"token-exact; handoff.bytes {handoff['bytes']}, handoff.ms {h} ({card})")
        if handoff["sessions"] != 1 or counter(stats(s1b), "sessions.imported") != 1:
            raise AssertionError(f"{phase}: the disaggregated handoff {handoff}")

        # 3. POST /generate on S0: the node pins and forks on its own
        before = {n["port"]: stats(n)["forward_passes"] for n in (s1a, s1b)}

        async def server_side():
            async with client(s0) as c:
                plain = await c.generate_server_side(prompts[0], max_new_tokens=NEW_TOKENS,
                                                     pin_prefix_len=SESS_PREFIX)
                streamed: List[int] = []
                ids = await c.generate_server_side_stream(
                    prompts[1], streamed.append, max_new_tokens=NEW_TOKENS,
                    pin_prefix_len=SESS_PREFIX)
                return plain, ids, streamed

        plain, ids, streamed = asyncio.run(server_side())
        check_streams(phase, "POST /generate", prompts[:2], [plain, ids], refs[:2])
        if streamed != ids:
            raise AssertionError(f"{phase}: the streamed lines {streamed}, the done line {ids}")
        cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.send", "--entry", nid(s0),
               "--prompt-ids", ",".join(map(str, prompts[2])), "--pin-prefix-ids",
               ",".join(map(str, prefix)), "--server-side", "--max-new-tokens",
               str(NEW_TOKENS), "--temperature", "0"]
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"{phase}: tools/send --server-side exit {r.returncode}\n"
                                 f"{r.stderr[-4000:]}")
        sent = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
        check_streams(phase, "tools/send --server-side --pin-prefix-ids", prompts[2:3], [sent],
                      refs[2:3])
        moved = {names[nid(n)]: stats(n)["forward_passes"] - before[n["port"]]
                 for n in (s1a, s1b)}
        x = [name for name, v in moved.items() if v]
        if len(x) != 1:
            raise AssertionError(f"{phase}: /generate's stage-1 passes {moved}: want one replica")
        for name in ("S0", x[0]):
            add(name, 1 + 3, 3 * dec)  # the node's pin, three forked suffixes
        st0 = stats(s0)
        gen = {k: counter(st0, k) for k in ("generate.requests", "generate.tokens",
                                             "generate.errors")}
        say(phase, f"POST /generate to S0 with pin_prefix_len {SESS_PREFIX}: plain and streamed "
                   f"({len(streamed)} ndjson token lines), and tools/send --server-side "
                   f"--pin-prefix-ids: exit 0; all three token-exact, forked on S0 and {x[0]} "
                   f"(the node's one pin); S0's {gen}, generate.wall_ms "
                   f"{st0['metrics']['histograms'].get('generate.wall_ms')} ({card})")
        if gen != {"generate.requests": 3, "generate.tokens": 3 * NEW_TOKENS,
                   "generate.errors": 0}:
            raise AssertionError(f"{phase}: S0's generate counters {gen}")

        # 4. stop() of S1b while it holds a session: S1a adopts it
        final: Dict[str, Dict[str, Any]] = {}
        stopped: Dict[str, float] = {}
        toks: List[int] = []

        def stop_at(tok):
            toks.append(tok)
            if len(toks) == SESS_STOP_AFTER:
                final["S1b"] = stats(s1b)
                t = time.perf_counter()
                s1b["proc"].terminate()
                s1b["proc"].wait(timeout=60)
                stopped["s"] = time.perf_counter() - t

        got, _, _ = timed(client(s0, {"1": nid(s1b)}), prompts[3], on_token=stop_at)
        check_streams(phase, "S1b's resident across its stop", prompts[3:4], [got], refs[3:4])
        add("S0", 2, dec)
        add("S1b", 2, SESS_STOP_AFTER - 1)
        add("S1a", 0, dec - (SESS_STOP_AFTER - 1))
        imported = counter(stats(s1a), "sessions.imported")
        want_imported = 1 + (x[0] == "S1b")  # and /generate's pin, when S1b held it
        say(phase, f"S1b stopped (SIGTERM, {stopped['s']:.2f}s to exit) after "
                   f"{SESS_STOP_AFTER} tokens of a session routed to it: S1a's "
                   f"sessions.imported {imported} (want {want_imported}), the stream "
                   f"token-exact with client restarts {toks.count(None)}")
        if imported != want_imported or None in toks:
            raise AssertionError(f"{phase}: S1b's stop: S1a imported {imported}, restarts "
                                 f"{toks.count(None)}")

        # 5. paged: forks of a pinned prefix on P against unforked streams on Q
        q_refs = [timed(client(q_node, chunk=SESS_PAGED_PREFIX), p)[0] for p in paged_prompts]
        cow: List[Dict[str, int]] = []

        def watch(tok):
            if len(cow) < len(forked_p) + 1:
                cow.append(stats(p_node)["executor"]["paged"])

        forked_p: List[List[int]] = []
        p_before = stats(p_node)["executor"]

        async def paged_forks():
            async with client(p_node, chunk=SESS_PAGED_PREFIX) as c:
                await c.pin_prefix(paged_prompts[0][:SESS_PAGED_PREFIX])
                for p in paged_prompts:
                    forked_p.append(await c.generate_ids(p, max_new_tokens=NEW_TOKENS,
                                                         on_token=watch))

        asyncio.run(paged_forks())
        check_streams(phase, "paged forks on P against Q", paged_prompts, forked_p, q_refs)
        p_mid = stats(p_node)
        p_prefilled = p_mid["executor"]["prefill_tokens"] - p_before["prefill_tokens"]
        want_prefilled = SESS_PAGED_PREFIX + sum(SESS_SUFFIXES)
        say(phase, f"P: a {SESS_PAGED_PREFIX}-token prefix pinned, {len(paged_prompts)} forks "
                   f"(fork.ok {counter(p_mid, 'fork.ok')}) prefilled {p_prefilled} tokens (want "
                   f"{want_prefilled}: the pin and the suffixes), token-exact against Q's "
                   f"unforked streams; P's block pool while each fork ran "
                   f"{[(c['cow_shared'], c['blocks_used']) for c in cow]} (cow_shared, "
                   f"blocks_used)")
        if (counter(p_mid, "fork.ok") != len(paged_prompts) or p_prefilled != want_prefilled
                or not all(c["cow_shared"] > 0 for c in cow)):
            raise AssertionError(f"{phase}: P's forks {p_mid['metrics']}, prefilled "
                                 f"{p_prefilled}, pool {cow}")

        # a fork with a partial tail block, stepped in lockstep with its parent
        def fwd(sid, toks_, start):
            st, body = post_wire(p_node["port"], "/forward", {
                "session_id": sid, "stage": 0, "relay": False,
                "payload": {"tokens": np.asarray([toks_], np.int32), "start_pos": start,
                            "real_len": len(toks_)}})
            if st != 200:
                raise AssertionError(f"{phase}: /forward {sid} at {start}: {st} {body}")
            return np.asarray(body["result"]["logits"], np.float32)[0]

        logits = fwd("tail-parent", prompts[0], 0)
        pos = len(prompts[0])
        for _ in range(SESS_TAIL_STEPS):
            logits = fwd("tail-parent", [int(np.argmax(logits))], pos)
            pos += 1
        status, reply = post_wire(p_node["port"], "/fork_session", {
            "session_id": "tail-child", "parent_session_id": "tail-parent", "prefix_len": pos,
            "stage": 0, "relay": False})
        pending = stats(p_node)["executor"]["paged"]
        same = []
        for _ in range(SESS_TAIL_ROUNDS):
            tok = int(np.argmax(logits))
            logits = fwd("tail-parent", [tok], pos)
            child = fwd("tail-child", [tok], pos)
            same.append(logits.tobytes() == child.tobytes())
            pos += 1
        for sid in ("tail-parent", "tail-child"):
            post_wire(p_node["port"], "/end_session", {"session_id": sid, "stage": 0})
        say(phase, f"a fork of a {len(prompts[0]) + SESS_TAIL_STEPS}-slot parent on P "
                   f"({(len(prompts[0]) + SESS_TAIL_STEPS) % PAGED_BS} slots in its copied tail "
                   f"block): {status} {reply}, pool {pending}; {SESS_TAIL_ROUNDS} lockstep steps "
                   f"from the parent's tokens: the child's logits bit-equal the parent's {same}")
        if status != 200 or not reply.get("ok") or not all(same):
            raise AssertionError(f"{phase}: the tail fork {status} {reply}, equal {same}")

        # a session exported P -> Q, decoded on Q
        async def export_pq():
            async with client(p_node, chunk=SESS_PAGED_PREFIX) as c:
                return await c.generate_ids_disaggregated(
                    paged_prompts[1], ("127.0.0.1", q_node["port"]), max_new_tokens=NEW_TOKENS)

        got = asyncio.run(export_pq())
        check_streams(phase, "exported P -> Q", paged_prompts[1:2], [got], q_refs[1:2])
        st_p = stats(p_node)
        say(phase, f"a paged session exported P -> Q: handoff.bytes "
                   f"{counter(st_p, 'handoff.bytes')}, handoff.ms "
                   f"{st_p['metrics']['histograms'].get('handoff.ms')}; Q decoded on, "
                   f"token-exact against its own stream ({card})")

        # exact launches per node
        for n in (s0, s1a):
            final[names[nid(n)]] = stats(n)
        final["P"], final["Q"] = stats(p_node), stats(q_node)
        relay = {k: counter(final["S0"], k) for k in ("route.sess_moved", "hedge.fired")}
        bounced = {nm: counter(final[nm], "sessions.rescue_relay") for nm in ("S1a", "S1b")}
        say(phase, f"S0 on the default hedge mode: {relay} (the relay followed the handed-off "
                   f"sessions, no step hedged to a new holder); stage-1 steps bounced through "
                   f"an old holder's rescue {bounced}")
        if relay["route.sess_moved"] < 1 or relay["hedge.fired"]:
            raise AssertionError(f"{phase}: S0's relay after the handoffs {relay}")
        launches = dict.fromkeys(final["S0"]["kernels"], 0)
        routes = {"split": 0, "mma": 0}
        paged_split = 0
        for name, st in final.items():
            kern = {k: v["launches"] for k, v in st["kernels"].items()}
            got_routes = flash_routes(st)
            if name in want:
                w = want[name]
                want_kern = dict.fromkeys(kern, 0)
                want_kern["flash_gqa"] = layers * (w["chunks"] + w["decode"])
                want_routes = {"split": layers * w["decode"], "mma": layers * w["chunks"]}
                passes = w["chunks"] + w["decode"]
                check_node_graphs(phase, st, w["decode"])
            else:
                ex = st["executor"]
                want_kern = dict.fromkeys(kern, 0)
                want_kern["flash_gqa"] = whole_layers * ex["prefill_steps"]
                want_kern["paged_decode_gqa"] = whole_layers * ex["batched_steps"]
                want_routes = {"split": 0, "mma": whole_layers * ex["prefill_steps"]}
                passes = st["forward_passes"]
                split, want_split = paged_splits(phase, st, cfg)
                paged_split += split
                check_node_graphs(phase, st, ex["batched_steps"])
                if split != want_split:
                    raise AssertionError(f"{phase}: {name}: paged splits {split}, want "
                                         f"{want_split}")
                w = {"prefill_steps": ex["prefill_steps"], "decode_steps": ex["batched_steps"]}
            say(phase, f"{name}: {st['forward_passes']} passes (want {passes}; {w}); launches "
                       f"{kern} (want {want_kern}); flash_gqa routes {got_routes} (want "
                       f"{want_routes})")
            if kern != want_kern or got_routes != want_routes or st["forward_passes"] != passes:
                raise AssertionError(f"{phase}: {name}: launches {kern}, routes {got_routes}, "
                                     f"passes {st['forward_passes']}")
            for k, v in kern.items():
                launches[k] += v
            for r_, v in got_routes.items():
                routes[r_] += v
        stop_nodes(nodes)
        nodes = []
        wall = time.perf_counter() - t_phase
        return {"launches": launches, "flash_routes": routes, "paged_split": paged_split,
                "gemv_routes": {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()},
                "handoff": handoff, "fork_ttft_s": fork_ttft, "unpinned_ttft_s": ref_ttft,
                "wall_s": wall}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def standby_client(entry: int, route: Dict[str, str], log: List[Dict[str, Any]], sampling):
    """A SwarmClient into the node on port `entry` whose new sessions take
    `route`'s replicas (routed_swarm_client), logging every step it sends:
    its start and rows, the answer's status and `resume_from`, the stage-1
    node that computed it (`served_by`), its logits and when it was sent."""
    import numpy as np

    from inferd_tpu_torch.client.base import ServerError
    from inferd_tpu_torch.client.swarm_client import SwarmClient

    class Logged(SwarmClient):
        def _forward_env(self, session_id, tokens, start_pos):
            return dict(super()._forward_env(session_id, tokens, start_pos), route=route)

        async def _step(self, session_id, tokens, start_pos):
            row = {"sid": session_id, "start": start_pos, "n": len(tokens), "status": 200,
                   "resume_from": None, "served_by": None, "t": time.perf_counter()}
            log.append(row)
            try:
                resp = await self._post("/forward", self._forward_env(session_id, tokens,
                                                                      start_pos))
            except ServerError as e:
                row.update(status=e.status, resume_from=e.resume_from)
                raise
            logits = np.asarray(resp["result_for_user"]["logits"], np.float32)[0]
            row.update(served_by=resp["served_by"], logits=logits)
            return logits

    return Logged([("127.0.0.1", entry)], sampling=sampling, prefill_chunk=512)


def standby_paged_check(phase: str, card: str, params) -> Dict[str, Any]:
    """Two whole-model paged BatchedExecutors (bs PAGED_BS, eager) in this
    process: a session's deltas at several frontiers, a non-aligned one
    among them, ship full blocks only and concatenate to export_sessions'
    payload bit for bit; the StandbyStore's payload, imported into the
    second executor at a block-aligned length, continues bit-exact with the
    unmoved lane for STANDBY_PAGED_TAIL lockstep steps, with
    paged_decode_gqa launches exact."""
    import numpy as np
    import torch

    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import attention as A
    from inferd_tpu_torch.ops.attention import paged_plan
    from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor
    from inferd_tpu_torch.runtime.repl import StandbyStore

    cfg = get_config(MODEL)
    lanes = 2
    prompt = serve_prompts(cfg.vocab_size)[STANDBY_PROMPT]
    a, b = eager([BatchedExecutor(cfg, params, lanes=lanes, max_len=1024, block_size=PAGED_BS,
                                  device=DEVICE) for _ in range(2)])
    reset_kernel_counts()

    def step(ex, toks, pos):
        out = ex.process("s", {"tokens": np.asarray([toks], np.int32), "start_pos": pos,
                               "real_len": len(toks)})
        return np.asarray(out["logits"].float().cpu(), np.float32)[0]

    store = StandbyStore()
    shipped: List[tuple] = []

    def ship(frontier):
        d = a.export_session_delta("s", frontier)
        if d is None:
            shipped.append((frontier, None))
            return frontier
        ok, have = store.apply("s", 0, d)
        shipped.append((d["start"], d["length"]))
        if not ok or d["start"] % PAGED_BS or d["length"] % PAGED_BS:
            raise AssertionError(f"{phase}: paged delta {d['start']}-{d['length']} ok {ok}")
        return have

    logits = step(a, prompt, 0)
    pos = len(prompt)
    frontier = ship(0)
    for i in range(STANDBY_PAGED_STEPS):
        logits = step(a, [int(np.argmax(logits))], pos)
        pos += 1
        if pos % 10 == 0 or i == STANDBY_PAGED_STEPS - 1:
            frontier = ship(frontier)
    full = dict(a.export_sessions(only="s"))["s"]
    foreign = a.export_session_delta("s", PAGED_BS + 5)  # a frontier inside block 1
    got = store.payload("s")
    n = got["length"]
    exact = (n == pos and torch.equal(got["k"], full["k"][:, :, :n])
             and torch.equal(got["v"], full["v"][:, :, :n])
             and (foreign["start"], foreign["length"]) == (PAGED_BS, n)
             and torch.equal(foreign["k"], full["k"][:, :, PAGED_BS:n]))
    if not b.import_session("s", got):
        raise AssertionError(f"{phase}: the paged import declined the store's payload")
    launches0, split0 = A.paged_decode_gqa.launches, A.paged_decode_gqa.split_launches
    widths0 = [dict(ex.stats()["decode_widths"]) for ex in (a, b)]
    same = []
    for _ in range(STANDBY_PAGED_TAIL):
        tok = int(np.argmax(logits))
        logits = step(a, [tok], pos)
        same.append(logits.tobytes() == step(b, [tok], pos).tobytes())
        pos += 1
    launched = A.paged_decode_gqa.launches - launches0
    split = A.paged_decode_gqa.split_launches - split0
    want_split = 0
    for ex, w0 in zip((a, b), widths0):
        for w, c in ex.stats()["decode_widths"].items():
            if paged_plan(lanes, cfg.num_kv_heads, int(w), PAGED_BS, cfg.torch_dtype).splits > 1:
                want_split += cfg.num_layers * (c - w0.get(w, 0))
    counts = kernel_counts()
    want_all = cfg.num_layers * (STANDBY_PAGED_STEPS + 2 * STANDBY_PAGED_TAIL)
    say(phase, f"paged pair in this process (eager, bs {PAGED_BS}): deltas shipped (start, "
               f"length) {shipped}, full blocks only; their concatenation equals "
               f"export_sessions' {n} slots bit for bit, and a frontier of {PAGED_BS + 5} "
               f"ships from {PAGED_BS}: {exact}; imported into a second executor, "
               f"{STANDBY_PAGED_TAIL} lockstep steps bit-equal to the unmoved lane {same}; "
               f"paged_decode_gqa launches {counts['launches']['paged_decode_gqa']} (want "
               f"{want_all}), in the lockstep {launched} (want "
               f"{2 * cfg.num_layers * STANDBY_PAGED_TAIL}), split {split} (want {want_split}) "
               f"({card})")
    if (not exact or not all(same) or counts["launches"]["paged_decode_gqa"] != want_all
            or launched != 2 * cfg.num_layers * STANDBY_PAGED_TAIL or split != want_split):
        raise AssertionError(f"{phase}: the paged check: exact {exact}, lockstep {same}, "
                             f"launches {counts}, split {split} want {want_split}")
    del a, b
    torch.cuda.empty_cache()
    return dict(counts, paged_split=A.paged_decode_gqa.split_launches)


def run_serve_standby(card: str, parts: str, params, work: str,
                      overload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The `serve_standby` phase: crash-tolerant sessions on fresh processes.

    S0 (stage 0) and R1a, R1b, R1c (stage 1), one-session graphed nodes, every
    one with --standby-repl --repl-interval 0.05. The 300-token serve prompt,
    32 greedy tokens through a SwarmClient into S0, its stage 1 routed to a
    chosen replica: once unkilled on R1a (the reference), STANDBY_WARM_TOKENS
    on each other replica (a process's first compute and graph capture is
    no part of a promotion's cost), then (a) routed to R1a,
    SIGKILLed after STANDBY_KILL_AFTER tokens once its standby's shadow
    reaches the committed length: the standby promotes the exact bytes and
    the stream is token-exact with no restart; (b) routed to another
    replica, stopped (SIGSTOP) at the first token from there on whose
    standby's frontier F lags, then SIGKILLed: the standby offers a resume
    from F, the client re-sends the pos - F tokens past it, and the stream
    is held teacher-forced to the reference's logits (LOGIT_TOL), token-exact
    but where the reference's top-2 gap is inside that tolerance. Between the
    cases the paged in-process check (standby_paged_check). Every node's
    flash_gqa launches exact per route and every decode step a capture or a
    replay; 0 restarts; one promotion per case."""
    import signal

    import numpy as np
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.ops.attention import flash_plan

    phase = "serve_standby"
    cfg = get_config(MODEL)
    layers = cfg.num_layers // 2
    greedy = SamplingConfig(temperature=0.0)
    prompt = serve_prompts(cfg.vocab_size)[STANDBY_PROMPT]
    nodes: List[Dict[str, Any]] = []
    logs: List[List[Dict[str, Any]]] = []
    final: Dict[str, Dict[str, Any]] = {}
    t_phase = time.perf_counter()

    def nid(n):
        return f"127.0.0.1:{n['port']}"

    def stats(n):
        return http_get_json(f"http://127.0.0.1:{n['port']}/stats")

    def counter(st, name):
        return int(st["metrics"]["counters"].get(name, 0))

    def shadow(n, sid):
        try:
            return stats(n)["repl"]["shadows"].get(sid)
        except (OSError, RuntimeError):
            return None

    def run(holder, on_token=None, new=NEW_TOKENS):
        """One generation of the prompt, stage 1 routed to `holder`: (ids, the
        step log, the (time, token) of every token)."""
        log: List[Dict[str, Any]] = []
        marks: List[tuple] = []

        def tick(tok):
            marks.append((time.perf_counter(), tok))
            if on_token is not None:
                on_token(tok, log)

        ids = drive(standby_client(s0["port"], {"1": nid(holder)}, log, greedy), [prompt],
                    new=new, on_token=tick)[0]
        logs.append(log)
        return ids, log, marks

    def per_token(log):
        """The logits each token was sampled from, in stream order: a step's
        whose rows reach past every answered step before it (a resume's
        re-sent tail reaches no further, and its logits are dropped)."""
        out, hi = [], 0
        for r in log:
            if r["status"] == 200 and r["start"] + r["n"] > hi:
                out.append(r["logits"])
                hi = r["start"] + r["n"]
        return out

    try:
        nodes = take_swarm(parts, work, "standby")
        s0, r1a, r1b, r1c = nodes
        for n in nodes:
            wait_ready(n)
        converged = wait_gossip(phase, nodes)
        names = {nid(s0): "S0", nid(r1a): "R1a", nid(r1b): "R1b", nid(r1c): "R1c"}
        by_name = {"S0": s0, "R1a": r1a, "R1b": r1b, "R1c": r1c}
        say(phase, f"4 fresh run_node --device {DEVICE} {' '.join(STANDBY_ARGS)} processes (S0; "
                   f"R1a, R1b, R1c) ready in {time.perf_counter() - t_phase:.1f}s; gossip views "
                   f"full after {converged:.2f}s")
        ref, ref_log, ref_marks = run(r1a)
        ref_logits = per_token(ref_log)
        for n in (r1b, r1c):  # a standby that promotes has served before, as a live one has
            run(n, new=STANDBY_WARM_TOKENS)
        ms_tok = statistics.median(b_[0] - a_[0] for a_, b_ in zip(ref_marks[1:-1],
                                                                  ref_marks[2:])) * 1e3
        cases: Dict[str, Dict[str, Any]] = {}

        def kill_case(case: str, holder, lag: bool):
            """The on_token callback of one case: from STANDBY_KILL_AFTER
            tokens on, find the holder's standby and kill the holder once its
            frontier equals the committed length (a) or lags it (b)."""
            rec = cases[case] = {"holder": names[nid(holder)], "seen": []}
            others = [n for n in (r1a, r1b, r1c) if n is not holder
                      and n["proc"].poll() is None]

            def on_token(tok, log):
                rec["seen"].append(tok)
                if tok is None or "killed" in rec or len(rec["seen"]) < STANDBY_KILL_AFTER:
                    return
                sid = log[-1]["sid"]
                pos = len(prompt) + len(rec["seen"]) - 1  # the holder's committed slots
                st = stats(holder)
                if not lag:
                    deadline = time.monotonic() + 10.0
                    while time.monotonic() < deadline:
                        got = {names[nid(n)]: shadow(n, sid) for n in others}
                        if pos in got.values():
                            break
                        time.sleep(0.01)
                    else:
                        raise AssertionError(f"{phase} ({case}): no shadow reached {pos}: {got}")
                else:
                    holder["proc"].send_signal(signal.SIGSTOP)  # no ship from here on
                    time.sleep(0.05)  # a ship in flight lands or dies
                    got = {names[nid(n)]: shadow(n, sid) for n in others}
                    lagging = [v for v in got.values() if v is not None and 0 < v < pos]
                    if not lagging:
                        holder["proc"].send_signal(signal.SIGCONT)
                        return
                standby = max(got, key=lambda k: got[k] or -1)
                rec.update(sid=sid, pos=pos, F=got[standby], standby=standby,
                           at_token=len(rec["seen"]), holder_stats=st,
                           survivor_before=stats(by_name[standby]), log_at=len(log))
                holder["proc"].send_signal(signal.SIGKILL)  # reaped after the run
                rec["killed"] = time.perf_counter()
                final[rec["holder"]] = st

            return on_token

        # case (a): the shadow caught up, the exact bytes promoted
        got_a, log_a, marks_a = run(r1a, kill_case("a", r1a, lag=False))
        r1a["proc"].wait(timeout=30)
        a_ = cases["a"]
        a_["survivor_after"] = stats(by_name[a_["standby"]])
        # while the dead holder's record expires from S0's view: the paged check
        paged = standby_paged_check(phase, card, params)
        deadline = time.monotonic() + SWARM_TTL_S + 10
        while nid(r1a) in stats(s0)["dht"].get("1", {}):
            if time.monotonic() > deadline:
                raise AssertionError(f"{phase}: R1a's record outlived its TTL in S0's view")
            time.sleep(0.2)
        # case (b): a lagging frontier, the tail re-sent
        y = next(n for n in (r1b, r1c) if names[nid(n)] != a_["standby"])
        got_b, log_b, marks_b = run(y, kill_case("b", y, lag=True))
        b_ = cases.get("b", {})
        if "killed" not in b_:
            raise AssertionError(f"{phase}: case (b) found no lagging standby before the end")
        y["proc"].wait(timeout=30)
        b_["survivor_after"] = stats(by_name[b_["standby"]])

        lines = []
        for case, got, log, marks in (("a", got_a, log_a, marks_a), ("b", got_b, log_b, marks_b)):
            c = cases[case]
            delta = {k: counter(c["survivor_after"], f"repl.{k}")
                     - counter(c["survivor_before"], f"repl.{k}")
                     for k in ("promotions", "resumed_tokens", "offers", "tail_tokens", "stale")}
            post = [(r["start"], r["n"], r["status"], r["resume_from"]) for r in
                    log[c["log_at"]:c["log_at"] + 3]]
            next_tok = next(t for t, tok in marks if t > c["killed"] and tok is not None)
            # the tokens before the first kill check (case (b) stops the holder at each later one)
            pre = [t for t, tok in marks if tok is not None][:STANDBY_KILL_AFTER]
            hst = c["holder_stats"]
            h = hst["metrics"]["histograms"]
            c.update(delta=delta, kill_to_next_token_s=next_tok - c["killed"],
                     decode_ms_per_token=statistics.median(
                         b2 - a2 for a2, b2 in zip(pre[1:-1], pre[2:])) * 1e3,
                     ships=counter(hst, "repl.ships"), bytes=counter(hst, "repl.bytes"),
                     first_ship=hst["repl"]["first_ship"], lock_ms=h.get("repl.lock_ms"),
                     export_ms=h.get("repl.export_ms"), ship_ms=h.get("repl.ship_ms"))
            want_post = ([(c["pos"], 1, 200, None)] if case == "a" else
                         [(c["pos"], 1, 409, c["F"]), (c["F"], c["pos"] - c["F"], 200, None),
                          (c["pos"], 1, 200, None)])
            restarts = c["seen"].count(None)
            bad = []
            if restarts or post[:len(want_post)] != want_post:
                bad.append(f"restarts {restarts}, the steps after the kill {post} (want "
                           f"{want_post})")
            if delta["promotions"] != 1 or delta["resumed_tokens"] != c["F"] or delta["stale"]:
                bad.append(f"{c['standby']}'s repl counters {delta}")
            if c["F"] < len(prompt):
                bad.append(f"the frontier {c['F']} below the prompt's {len(prompt)} slots")
            if case == "a":
                if got != ref or delta["offers"]:
                    bad.append(f"case (a) stream equal {got == ref}, offers {delta['offers']}")
                tf = "token-exact"
            else:
                if delta["offers"] < 1 or delta["tail_tokens"] != c["pos"] - c["F"]:
                    bad.append(f"offers {delta['offers']}, tail tokens {delta['tail_tokens']} "
                               f"(want {c['pos'] - c['F']})")
                gl = per_token(log)
                d = first_divergence(got, ref)
                if d < c["at_token"]:
                    raise AssertionError(f"{phase} (b): the stream left the reference at token "
                                         f"{d}, before the kill")
                errs = [float(np.max(np.abs(g_ - r_)) / np.max(np.abs(r_)))
                        for g_, r_ in zip(gl[c["at_token"]:d + 1], ref_logits[c["at_token"]:d + 1])]
                gaps = [float(np.diff(np.sort(r_)[-2:])[0] / np.max(np.abs(r_)))
                        for r_ in ref_logits[c["at_token"]:]]
                c.update(max_logit_err=max(errs), min_top2_gap=min(gaps), diverged_at=d)
                gap_d = gaps[d - c["at_token"]] if d < len(ref) else None
                if max(errs) > LOGIT_TOL:
                    bad.append(f"teacher-forced logits {max(errs):.4%} of max |logit| past "
                               f"{LOGIT_TOL:.0%}")
                if d < len(ref) and gaps[d - c["at_token"]] > LOGIT_TOL:
                    bad.append(f"the stream left the reference at token {d}, where its top-2 "
                               f"gap {gaps[d - c['at_token']]:.4%} is outside {LOGIT_TOL:.0%}")
                left = ("token-exact" if gap_d is None else
                        f"left the reference at token {d}, where its top-2 gap is {gap_d:.4%}")
                tf = (f"teacher-forced after the kill: logits within {max(errs):.4%} of max "
                      f"|logit| (tol {LOGIT_TOL:.0%}), the reference's least top-2 gap there "
                      f"{min(gaps):.4%}, stream {left}")
            lines.append(
                f"case ({case}): {c['holder']} killed (SIGKILL) after {c['at_token']} tokens "
                f"(committed {c['pos']} slots, {c['standby']}'s shadow {c['F']}): {tf}; "
                f"restarts {restarts}; {c['standby']}'s {delta}; the steps after the kill "
                f"(start, rows, status, resume_from) {post}; kill to the next token "
                f"{c['kill_to_next_token_s']:.3f} s; {c['holder']}'s repl.ships {c['ships']}, "
                f"repl.bytes {c['bytes']}, first ship {c['first_ship']}, repl.lock_ms "
                f"{c['lock_ms']}, repl.export_ms {c['export_ms']}, repl.ship_ms "
                f"{c['ship_ms']}; decode "
                f"{c['decode_ms_per_token']:.2f} ms/token before the kill ({card})")
            if bad:
                raise AssertionError(f"{phase} ({case}): " + "; ".join(bad))
        for ln in lines:
            say(phase, ln)
        ov = (overload or {}).get("restart_s", {}).get("to_first_token")
        say(phase, f"kill to the next token: case (a) {cases['a']['kill_to_next_token_s']:.3f} s, "
                   f"case (b) {cases['b']['kill_to_next_token_s']:.3f} s, against "
                   f"serve_overload's kill to the restart's first token "
                   f"{'not run' if ov is None else f'{ov:.3f} s'}; the unkilled stream "
                   f"{ms_tok:.2f} ms/token ({card})")

        # exact launches per node, from the steps each computed: S0 every step
        # it answered or relayed to a resume offer, a stage-1 node those it
        # served; a chunk of n rows on flash_plan's route, a token step split
        for n in (s0, r1a, r1b, r1c):
            name = names[nid(n)]
            if name not in final:
                final[name] = stats(n)
        computed = {name: {"split": 0, "mma": 0, "decode": 0} for name in final}
        for log in logs:
            for r in log:
                rows = 1 if r["n"] == 1 else bucket_len(r["n"])  # a chunk pads to its bucket
                route = flash_plan(1, rows, rows, cfg.num_heads, cfg.num_kv_heads,
                                   torch.bfloat16, 0, rows).route
                at = []
                if r["status"] == 200:
                    at = ["S0", names[r["served_by"]]]
                elif r["resume_from"] is not None:
                    at = ["S0"]
                for name in at:
                    computed[name][route] += 1
                    computed[name]["decode"] += r["n"] == 1
        launches = dict.fromkeys(final["S0"]["kernels"], 0)
        routes = {"split": 0, "mma": 0}
        for name, st in sorted(final.items()):
            w = computed[name]
            kern = {k: v["launches"] for k, v in st["kernels"].items()}
            want_kern = dict.fromkeys(kern, 0)
            want_kern["flash_gqa"] = layers * (w["split"] + w["mma"])
            want_routes = {"split": layers * w["split"], "mma": layers * w["mma"]}
            got_routes = flash_routes(st)
            say(phase, f"{name}: {st['forward_passes']} passes ({w}), rescue relays "
                       f"{counter(st, 'sessions.rescue_relay')}; launches {kern} (want "
                       f"{want_kern}); flash_gqa routes {got_routes} (want {want_routes})")
            if w["decode"]:
                check_node_graphs(phase, st, w["decode"])
            if (kern != want_kern or got_routes != want_routes
                    or st["forward_passes"] != w["split"] + w["mma"]):
                raise AssertionError(f"{phase}: {name}: launches {kern}, routes {got_routes}, "
                                     f"passes {st['forward_passes']}, want {w}")
            for k, v in kern.items():
                launches[k] += v
            for r_, v in got_routes.items():
                routes[r_] += v
        for k, v in paged["launches"].items():
            launches[k] += v
        for r_, v in paged["flash_routes"].items():
            routes[r_] += v
        stop_nodes(nodes)
        nodes = []
        return {"launches": launches, "flash_routes": routes, "paged_split": paged["paged_split"],
                "gemv_routes": {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()},
                "cases": {k: {x: v[x] for x in ("holder", "standby", "pos", "F", "at_token",
                                                "kill_to_next_token_s", "ships", "bytes",
                                                "first_ship", "lock_ms", "decode_ms_per_token")}
                          for k, v in cases.items()},
                "wall_s": time.perf_counter() - t_phase}
    except BaseException:
        for n in nodes:  # a holder left stopped must die with the rest
            if n["proc"].poll() is None:
                n["proc"].send_signal(signal.SIGCONT)
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


# -- generate, generate_quant, serve_kstep, cli: the whole model in one process --

# The serve prompts the in-process engines and the quantized and K-step
# nodes run (a subset keeps every route: 16 tokens is the one prefill of at
# most 64 rows, the GEMVs' tensor-core route; 700 crosses the client's
# 512-token chunk and takes the longest decode span)
ENGINE_PROMPT_LENS = (16, 700)
GEN_CHUNK = 8  # fused decode steps per host read in the chunked runs (generate(chunk=8))
GEN_SEED = 11  # the sampler's seed in the sampled runs
# bench.py's headline regime: a 64-token prompt, generate_scan at 50 and 150
# steps under the default SamplingConfig, differenced in interleaved pairs
HEADLINE_PROMPT = 64
HEADLINE_STEPS = (50, 150)
HEADLINE_PAIRS = 2
KSTEP_WINDOW = 8  # serve_kstep: decode_steps per /forward


def serve_prompts(vocab: int, lens=PROMPT_LENS) -> List[List[int]]:
    """The serve phase's prompts (PROMPT_LENS tokens each, from seed 0), or
    those of them whose lengths are in `lens` (the same tokens)."""
    import numpy as np

    if set(lens) - set(PROMPT_LENS):
        raise ValueError(f"prompt lengths {lens} are not among the serve phase's {PROMPT_LENS}")
    rng = np.random.default_rng(0)
    drawn = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
    return [p for p in drawn if len(p) in lens]


def _wrappers():
    from inferd_tpu_torch.ops import attention as A
    from inferd_tpu_torch.ops import lora
    from inferd_tpu_torch.ops import qmatmul as Q

    return {"flash_gqa": A.flash_gqa, "paged_decode_gqa": A.paged_decode_gqa,
            "w8a16_matmul": Q.w8a16_matmul, "w4a16_matvec": Q.w4a16_matvec,
            "fused_lane_delta": lora.fused_lane_delta}


def reset_kernel_counts() -> None:
    """Every wrapper's launch and route counters in this process to 0."""
    for w in _wrappers().values():
        for attr in ("launches", "split_launches", "mma_launches", "simt_launches"):
            if hasattr(w, attr):
                setattr(w, attr, 0)


def kernel_counts() -> Dict[str, Any]:
    """This process's counters, in the shape a phase result carries them."""
    w = _wrappers()
    return {"launches": {name: f.launches for name, f in w.items()},
            "flash_routes": {r: getattr(w["flash_gqa"], f"{r}_launches") for r in ("split", "mma")},
            "gemv_routes": {name: {r: getattr(w[name], f"{r}_launches") for r in ("mma", "simt")}
                            for name in ("w8a16_matmul", "w4a16_matvec")}}


def whole_model(parts: str):
    """The serve phase's two stage checkpoints joined into the whole model's
    params on the card: the same seeded weights, initialised once."""
    import torch

    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    (p0, s0, _), (p1, s1, _) = [load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                      device=DEVICE) for s in range(2)]
    if s0.end_layer + 1 != s1.start_layer:
        raise AssertionError(f"stage layers {s0} {s1} do not join")
    return {"embed": p0["embed"], "final_norm": p1["final_norm"],
            "layers": {k: torch.cat([p0["layers"][k], p1["layers"][k]]) for k in p0["layers"]}}


def generate_three_ways(eng, prompt, seed: int) -> List[List[int]]:
    """NEW_TOKENS tokens by Engine.generate at chunk 1 and at GEN_CHUNK, and
    by generate_scan, from one seed."""
    import numpy as np

    from inferd_tpu_torch.core.generate import bucket_len

    padded = [prompt + [0] * (bucket_len(len(prompt)) - len(prompt))]
    return [eng.generate(prompt, NEW_TOKENS, seed=seed),
            eng.generate(prompt, NEW_TOKENS, seed=seed, chunk=GEN_CHUNK),
            eng.generate_scan(np.asarray(padded), len(prompt), NEW_TOKENS, seed=seed)[0].tolist()]


def first_divergence(a: List[int], b: List[int]) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def check_flash_routes(phase: str, counts, runs: int, layers: int,
                       new: int = NEW_TOKENS) -> None:
    """One prefill chunk per run on the tensor cores, `new` - 1 decode
    steps on the split-KV route, `layers` launches each, as flash_plan
    routes them: exact."""
    want = {"split": layers * (new - 1) * runs, "mma": layers * runs}
    got = counts["flash_routes"]
    say(phase, f"flash_gqa routes {got} over {runs} generations (want {want}: {got == want})")
    if got != want or counts["launches"]["flash_gqa"] != sum(want.values()):
        raise AssertionError(f"{phase}: flash_gqa launches {counts}, want routes {want}")


@contextlib.contextmanager
def planted_kstep_slot_fault():
    """Until the block ends, every step after the first of a fused window
    (models/qwen3.decode_window) writes its K/V one slot early, over the
    previous token's (its positions and masks stay right): the fault the
    chunked stream's equality with the per-step one must catch. A graph
    captured inside the block holds the fault; one captured before does
    not, so the check runs on engines made inside it."""
    import torch

    from inferd_tpu_torch.models import qwen3 as Q

    real_layers, real_window = Q.forward_layers, Q.decode_window
    early = [False]

    def faulty_layers(layers, cfg, hidden, positions, k_cache=None, v_cache=None,
                      cache_write_pos=None, *rest, **kw):
        if early[0] and isinstance(cache_write_pos, torch.Tensor):
            cache_write_pos = cache_write_pos - 1
        return real_layers(layers, cfg, hidden, positions, k_cache, v_cache, cache_write_pos,
                           *rest, **kw)

    def faulty_window(params, cfg, k_cache, v_cache, tok, fill, active, eos, u, bounds, *rest):
        outs = []
        for j, bound in enumerate(bounds):
            early[0] = j > 0
            try:
                o = real_window(params, cfg, k_cache, v_cache, tok, fill, active, eos,
                                None if u is None else u[j:j + 1], (bound,), *rest)
            finally:
                early[0] = False
            tok, fill, active = o[0][0], o[1], o[2]
            outs.append(o)
        return (torch.cat([o[0] for o in outs]), fill, active,
                *(torch.cat([o[i] for o in outs]) for i in (3, 4, 5)))

    Q.forward_layers, Q.decode_window = faulty_layers, faulty_window
    try:
        yield
    finally:
        Q.forward_layers, Q.decode_window = real_layers, real_window


def forced_logits(eng, prompts, streams) -> List[Any]:
    """Last-token logits of each prompt's prefill and of its stream's first
    DECODE_CHECKED tokens fed one at a time, through the engine."""
    import torch

    out = []
    with torch.no_grad():
        for p, ids in zip(prompts, streams):
            logits, cache = eng.prefill(p, eng.new_cache(1))
            out.append(logits.float())
            for tok in ids[:DECODE_CHECKED]:
                tok_t = torch.tensor([[tok]], device=DEVICE)
                out.append(eng._forward(tok_t, cache.length, cache, 1).float())
                cache.length += 1
    return out


def headline(phase: str, card: str, methods) -> Dict[str, Dict[str, float]]:
    """bench.py's headline regime for each (name, run(n_steps, seed))
    method: one warm-up run, then HEADLINE_PAIRS interleaved pairs of
    50- and 150-step runs (host clock, each ending in a read of its
    tokens), differenced by utils.profiling.paired_delta_stats."""
    import torch

    from inferd_tpu_torch.utils.profiling import interleaved_pair_times, paired_delta_stats

    short, long_ = HEADLINE_STEPS
    out = {}
    for name, run in methods:
        seeds = iter(range(1, 1000))
        run(short, 0)  # nothing compiles: one run warms the allocator and the caches

        def timed(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n, next(seeds))
            return time.perf_counter() - t0

        ts, tl = interleaved_pair_times(lambda: timed(short), lambda: timed(long_), HEADLINE_PAIRS)
        per, n_valid, spread, ts_valid = paired_delta_stats(ts, tl, short, long_)
        e2e_t = statistics.median(ts_valid)
        overhead = max(e2e_t - short * per, 0.0) * 1e3 if n_valid else 0.0
        out[name] = {"steady_ms_per_token": per * 1e3, "e2e_tok_s": short / e2e_t,
                     "overhead_ms": overhead, "valid_pairs": n_valid, "spread_pt": spread}
        say(phase, f"headline {name}: steady {per * 1e3:.3f} ms/token ({1 / per:.1f} tok/s), "
                   f"e2e {short / e2e_t:.1f} tok/s over {short} tokens, fixed overhead "
                   f"{overhead:.1f} ms; {n_valid}/{HEADLINE_PAIRS} valid pairs, spread "
                   f"{spread}% ({card})")
    return out


def device_share(phase: str, card: str, name: str, fn, per: int, reps: int = 4):
    """Where one decode step's time goes: the host clock per step (no
    profiler), and from a torch.profiler trace (CUPTI) of `reps` more calls
    the device's busy time per step (the sum of its kernels' durations) and
    the kernels launched per step; `fn` runs `per` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / (reps * per) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / (reps * per) / 1e3
    by_name: Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / (reps * per)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host_top = sorted(((e.key, e.self_cpu_time_total / (reps * per)) for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), key=lambda kv: -kv[1])[:8]
    say(phase, f"{name}: most host time under the profiler, ms per step: "
               + ", ".join(f"{k[:40]} {v / 1e3:.3f}" for k, v in host_top))
    out = {"host_ms": host_ms, "device_busy_ms": busy_ms if kernels else None,
           "kernels_per_step": len(kernels) / (reps * per)}
    if not kernels:
        say(phase, f"{name}: {host_ms:.3f} ms per step on the host clock; device time not "
                   f"measured (the profiler traced no kernel) ({card})")
        return out
    say(phase, f"{name}: {host_ms:.3f} ms per step on the host clock; the device is busy "
               f"{busy_ms:.3f} ms of it ({max(0.0, 1 - busy_ms / host_ms):.0%} idle) over "
               f"{out['kernels_per_step']:.0f} kernel launches per step (torch.profiler); "
               "most device time: " + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top)
               + f" ({card})")
    return out


# The engine's graphs must be reused, not captured anew per generation:
# replays per capture at least this many over the prompts' generations, and
# over the headline's repeated runs (a few kv buckets, thousands of steps).
GRAPH_REPLAYS_PER_CAPTURE = 4
HEADLINE_REPLAYS_PER_CAPTURE = 20
# the headline's steady ms/token differences tokens 50..150 of runs from a
# 64-token prompt: their mean fill, the context its roofline is taken at
HEADLINE_CTX = HEADLINE_PROMPT + sum(HEADLINE_STEPS) // 2


def check_graph_stats(phase: str, stats: Dict[str, Dict[str, int]], least: int) -> None:
    """Print each engine's graph_stats; fail unless its steps were replayed
    at least `least` times per capture."""
    for name, st in stats.items():
        say(phase, f"{name}: graph_stats {st}")
        if not st["captures"] or st["replays"] < least * st["captures"]:
            raise AssertionError(f"{phase} {name}: {st['replays']} replays of {st['captures']} "
                                 f"captures (want >= {least} per capture)")


def roofline_shares(phase: str, card: str, cfg, quant: str, rates) -> None:
    """The roofline share of each method's steady ms/token: the step's floor
    (perf/roofline, the h100 row, at HEADLINE_CTX) over the measured ms."""
    from inferd_tpu_torch.perf import roofline as rl

    roof = rl.roofline(rl.decode_step_cost(cfg, quant=quant, ctx=HEADLINE_CTX), rl.get_chip("h100"))
    for name, r in rates.items():
        say(phase, f"{name}: roofline share of the steady ms/token {roof.floor_ms:.4f} / "
                   f"{r['steady_ms_per_token']:.3f} = {roof.floor_ms / r['steady_ms_per_token']:.2%}"
                   f" (bound by {roof.bound}, {quant}, ctx {HEADLINE_CTX}; {card})")
        r["roofline_frac"] = roof.floor_ms / r["steady_ms_per_token"]


def headline_methods(eng, prompt, scan_only: bool = False):
    """(name, run) pairs over one engine for `headline`: generate_scan, and
    unless scan_only, generate at chunk 1 and at GEN_CHUNK."""
    import numpy as np

    toks = np.asarray([prompt])
    methods = [("generate_scan", lambda n, seed: eng.generate_scan(
        toks, len(prompt), n, seed=seed).cpu())]
    if not scan_only:
        methods += [(f"generate(chunk={c})", lambda n, seed, c=c: eng.generate(
            prompt, n, seed=seed, chunk=c)) for c in (1, GEN_CHUNK)]
    return methods


def run_generate(card: str, params, serve: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The `generate` phase: the engine in this process, the whole model
    (with `serve`'s streams, the shared prefixes are printed)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core import sampling as samplib
    from inferd_tpu_torch.core.generate import Engine, bucket_len
    from inferd_tpu_torch.ops.attention import flash_plan

    phase = "generate"
    cfg = get_config(MODEL)
    prompts = serve_prompts(cfg.vocab_size, ENGINE_PROMPT_LENS)
    greedy_cfg = SamplingConfig(temperature=0.0)
    engines = {"greedy": Engine(cfg, params, sampling_cfg=greedy_cfg),
               "sampled (0.6/20/0.95)": Engine(cfg, params)}
    for p in prompts:
        b = bucket_len(len(p))
        plans = [flash_plan(1, b, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.torch_dtype, 0, b),
                 flash_plan(1, 1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.torch_dtype,
                            len(p), len(p) + 1)]
        say(phase, f"prompt {len(p)}: prefill bucket {b} -> {plans[0].route}, decode at "
                   f"{len(p)} -> {plans[1].route} ({plans[1].splits} splits)")
    reset_kernel_counts()
    t0 = time.perf_counter()
    streams = {name: [generate_three_ways(eng, p, GEN_SEED) for p in prompts]
               for name, eng in engines.items()}
    counts = kernel_counts()
    wall = time.perf_counter() - t0
    for name, per_prompt in streams.items():
        for p, (a, b, c) in zip(prompts, per_prompt):
            if not a == b == c:
                raise AssertionError(
                    f"{name}, prompt {len(p)}: chunk 1 / chunk {GEN_CHUNK} / generate_scan "
                    f"differ from token {min(first_divergence(a, b), first_divergence(a, c))}")
        say(phase, f"{name}: generate(chunk=1), generate(chunk={GEN_CHUNK}) and generate_scan "
                   f"give the same tokens on all {len(prompts)} prompts ({NEW_TOKENS} each, "
                   f"seed {GEN_SEED}); distinct tokens per stream "
                   f"{[len(set(s[0])) for s in per_prompt]}")
    runs = 3 * len(prompts) * len(engines)
    say(phase, f"{runs} generations of {NEW_TOKENS} tokens in {wall:.1f}s; launches "
               f"{counts['launches']}")
    check_flash_routes(phase, counts, runs, cfg.num_layers)
    others = {k: v for k, v in counts["launches"].items() if k != "flash_gqa"}
    if any(others.values()):
        raise AssertionError(f"{phase}: bf16 generation launched {others}")
    greedy = [s[0] for s in streams["greedy"]]
    graph_stats = {name: eng.graph_stats() for name, eng in engines.items()}
    check_graph_stats(phase, graph_stats, GRAPH_REPLAYS_PER_CAPTURE)

    # the same steps run eagerly (the eager decode_window, no graph): the
    # graphs' tokens, bit for bit, at the same kv bounds
    for name, eng in engines.items():
        eager = Engine(cfg, params, sampling_cfg=eng.sampling)
        eager.graphs = None  # the eager step on the card
        for p, s in zip(prompts, streams[name]):
            e = eager.generate(p, NEW_TOKENS, seed=GEN_SEED)
            if e != s[0]:
                raise AssertionError(f"{name}, prompt {len(p)}: the graphed stream differs from "
                                     f"the eager step's from token {first_divergence(e, s[0])}")
        del eager
    say(phase, f"the graphed streams equal the eager step function's (generate(chunk=1), no "
               f"graph, the same kv bounds), greedy and sampled, on all {len(prompts)} prompts")

    # the planted fault: a fused window's later steps writing their K/V one
    # slot early must break the equality of the chunked streams with the
    # per-step ones (greedy or sampled); fresh engines capture it
    caught = {}
    with planted_kstep_slot_fault():
        for name, eng in engines.items():
            faulty = Engine(cfg, params, sampling_cfg=eng.sampling)
            caught[name] = [len(p) for p, s in zip(prompts, streams[name])
                            if faulty.generate(p, NEW_TOKENS, seed=GEN_SEED,
                                               chunk=GEN_CHUNK) != s[0]]
            del faulty
    say(phase, f"planted fault kv_slot_early (a window's later steps write their K/V one slot "
               f"early): chunk {GEN_CHUNK} differs from chunk 1 on prompts {caught} of "
               f"{list(ENGINE_PROMPT_LENS)}")
    if not any(caught.values()):
        raise AssertionError("planted fault kv_slot_early passes the chunk equality")

    # teacher-forced: the kernel path against plain attention, logits only
    plain = Engine(dataclasses.replace(cfg, attn_impl="xla"), params, sampling_cfg=greedy_cfg)
    got = forced_logits(engines["greedy"], prompts, greedy)
    ref = forced_logits(plain, prompts, greedy)
    l_err = max((g - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, ref))
    say(phase, f"kernel path vs plain attention over {len(ref)} teacher-forced steps (prefill + "
               f"{DECODE_CHECKED} decode steps per prompt): logits {l_err:.4%} of max |logit| "
               f"(tol {LOGIT_TOL:.0%})")
    if not l_err <= LOGIT_TOL:
        raise AssertionError(f"{phase}: kernel path vs plain attention, logits {l_err}")
    del plain, got, ref
    served = dict(zip(PROMPT_LENS, serve["streams"])) if serve else {}
    for p, a in zip(prompts, greedy):
        if len(p) in served:
            say(phase, f"prompt {len(p)}: the engine's greedy stream shares its first "
                       f"{first_divergence(a, served[len(p)])} of {NEW_TOKENS} tokens with the "
                       "serve phase's chain stream (printed, not gated: other buffers, other "
                       "split plans)")

    # bench.py's headline regime, and what a step and the sampler cost
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, HEADLINE_PROMPT).tolist()
    eng = Engine(cfg, params, max_len=512)
    rates = headline(phase, card, headline_methods(eng, prompt))
    roofline_shares(phase, card, cfg, "none", rates)
    headline_graphs = eng.graph_stats()
    check_graph_stats(phase, {"headline engine": headline_graphs}, HEADLINE_REPLAYS_PER_CAPTURE)
    eager = Engine(cfg, params, max_len=512)
    eager.graphs = None  # the eager step on the card
    logits, cache = eng.prefill(prompt, eng.new_cache(1, 512))
    sub = samplib.split_key(samplib.prng_key(0))[1]
    key = samplib.prng_key(0)
    tok = samplib.sample(logits, sub)

    def at_prompt(call):  # every call from the same fill: one kv bound, one graph
        def run():
            cache.length = HEADLINE_PROMPT
            return call()
        return run

    steps = {"decode (one step)": (at_prompt(lambda: eng.decode(tok, cache, sub)), 1),
             f"decode_chunk ({GEN_CHUNK} steps)": (
                 at_prompt(lambda: eng.decode_chunk(tok, cache, key, GEN_CHUNK)), GEN_CHUNK),
             "decode (one step, eager: no graph)": (
                 at_prompt(lambda: eager.decode(tok, cache, sub)), 1)}
    step_share = {name: device_share(phase, card, name, fn, per) for name, (fn, per)
                  in steps.items()}
    del eager
    row = torch.randn(1, cfg.vocab_size, device=DEVICE) * 3
    sampler = {}
    for label, args in (("0.6/20/0.95 (topk 20 of V)", (0.6, 20, 0.95, 0.0)),
                        ("0.6/0/0.95 (sort of V)", (0.6, 0, 0.95, 0.0)),
                        ("greedy (argmax)", (0.0, 0, 1.0, 0.0))):
        sampler[label] = time_ms(lambda a=args: samplib.sample(row, sub, *a))
    say(phase, f"sampler on [1, {cfg.vocab_size}] float32 logits, device ms per call: "
               + ", ".join(f"{k} {v:.4f}" for k, v in sampler.items()) + f" ({card})")
    del eng, cache, engines
    torch.cuda.empty_cache()
    return dict(counts, rates=rates, step_share=step_share, sampler_ms=sampler,
                graph_stats=dict(graph_stats, headline=headline_graphs))


def run_generate_quant(card: str, params) -> Dict[str, Any]:
    """The `generate_quant` phase: the engine on --quant int8 weights."""
    import numpy as np
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import Engine, bucket_len
    from inferd_tpu_torch.ops import quant
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS

    phase = "generate_quant"
    cfg = get_config(MODEL)
    prompts = serve_prompts(cfg.vocab_size, ENGINE_PROMPT_LENS)
    qparams = quant.apply_quant_mode("int8", params, tie_word_embeddings=cfg.tie_word_embeddings)
    eng = Engine(cfg, qparams, sampling_cfg=SamplingConfig(temperature=0.0))
    reset_kernel_counts()
    small_rows, head_rows = [], []
    for p in prompts:
        a = eng.generate(p, NEW_TOKENS)
        b = eng.generate(p, NEW_TOKENS, chunk=GEN_CHUNK)
        if a != b:
            raise AssertionError(f"{phase}, prompt {len(p)}: chunk {GEN_CHUNK} != chunk 1 from "
                                 f"token {first_divergence(a, b)}")
        bucket = bucket_len(len(p))
        for _ in range(2):  # a prefill (its head on the last row), then decode steps
            small_rows += ([bucket] if bucket <= MAX_KERNEL_ROWS else []) + [1] * (NEW_TOKENS - 1)
            head_rows += [1] * NEW_TOKENS
    counts = kernel_counts()
    say(phase, f"int8 greedy: generate(chunk={GEN_CHUNK}) equals generate(chunk=1) on all "
               f"{len(prompts)} prompts")
    check_flash_routes(phase, counts, 2 * len(prompts), cfg.num_layers)
    per_step = gemv_route_launches(cfg, "int8", cfg.num_layers, True, [1], [1])
    want = gemv_route_launches(cfg, "int8", cfg.num_layers, True, small_rows, head_rows)
    got = counts["gemv_routes"]["w8a16_matmul"]
    say(phase, f"w8a16_matmul routes {got} (want {want}: {got == want}); a decode step "
               f"launches {per_step} = {GEMVS_PER_LAYER} x {cfg.num_layers} + 1")
    if (per_step != {"mma": 0, "simt": GEMVS_PER_LAYER * cfg.num_layers + 1} or got != want
            or counts["launches"]["w8a16_matmul"] != sum(want.values())
            or counts["launches"]["w4a16_matvec"]):
        raise AssertionError(f"{phase}: GEMV launches {counts}, want {want}")
    check_graph_stats(phase, {"int8 greedy": eng.graph_stats()}, GRAPH_REPLAYS_PER_CAPTURE)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, HEADLINE_PROMPT).tolist()
    rates = headline(phase, card, headline_methods(Engine(cfg, qparams, max_len=512), prompt,
                                                   scan_only=True))
    roofline_shares(phase, card, cfg, "int8", rates)
    del eng, qparams
    torch.cuda.empty_cache()
    return dict(counts, rates=rates)


def kstep_session(process, sid: str, prompt: List[int], eos=None, sampling=None):
    """A raw /forward session: the prompt's prefill (its first token the
    logits' argmax), then windows of KSTEP_WINDOW decode_steps up to
    NEW_TOKENS tokens or eos, the key chained. Returns (stream, the
    windows' results)."""
    import numpy as np

    r = process(sid, {"tokens": np.asarray([prompt], np.int32), "start_pos": 0,
                      "real_len": len(prompt)})
    out = [int(np.argmax(np.asarray(r["logits"], np.float32)[0]))]
    windows, key = [], None
    while len(out) < NEW_TOKENS and (eos is None or out[-1] != eos):
        pl = {"tokens": [[out[-1]]], "start_pos": len(prompt) + len(out) - 1,
              "decode_steps": min(KSTEP_WINDOW, NEW_TOKENS - len(out)), "seed": GEN_SEED}
        if eos is not None:
            pl["eos"] = eos
        if sampling is not None:
            pl["sampling"] = sampling
        if key is not None:
            pl["key"] = key
        w = process(sid, pl)
        if not 1 <= w["real_len"] <= pl["decode_steps"]:
            raise AssertionError(f"session {sid}: a window of {pl['decode_steps']} committed "
                                 f"{w['real_len']} tokens")
        windows.append({k: w[k] for k in ("tokens", "real_len", "decode_steps", "key")})
        out += [int(t) for t in w["tokens"][0]]
        key = w["key"]
    return out, windows


def node_process(node: Dict[str, Any], stage: int = 0):
    """A session-step callable over a node's /forward (raw payloads)."""
    from inferd_tpu_torch.client.base import ServerError, http_post
    from inferd_tpu_torch.runtime import wire

    def process(sid, payload):
        status, raw, _ = http_post(f"http://127.0.0.1:{node['port']}/forward", wire.pack(
            {"session_id": sid, "stage": stage, "relay": False, "payload": payload}), 300.0)
        body = wire.unpack(raw)
        if status != 200:
            raise ServerError(str(body.get("error")), status, body.get("code"))
        return body["result"]

    return process


def run_serve_kstep(card: str, params, parts: str, work: str) -> Dict[str, Any]:
    """The `serve_kstep` phase: decode_steps through /forward on a one-stage
    node, against the same executor in this process."""
    import torch

    from inferd_tpu_torch.client.base import ServerError
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.parallel.stages import StageSpec
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    phase = "serve_kstep"
    cfg = get_config(MODEL)
    spec = StageSpec(0, 1, 0, cfg.num_layers - 1)
    parts1 = one_stage_parts(work, params)
    prompts = serve_prompts(cfg.vocab_size)
    modes = (("greedy", None), ("sampled", {"temperature": 0.6, "top_k": 20, "top_p": 0.95}))
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts1, 0, work, tag="_kstep"), start_node(parts, 0, work,
                                                                        tag="_chain0")]
        for n in nodes:
            wait_ready(n)
        before = http_get_json(f"http://127.0.0.1:{nodes[0]['port']}/stats")
        if any(k["launches"] for k in before["kernels"].values()) or before["forward_passes"]:
            raise AssertionError(f"the node did work before the main path: {before}")
        local = eager([Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)])[0]
        # the free runs only pick each session's eos: graphed, as the node is
        graphed = Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
        served, prefills, steps, stops = {}, 0, 0, 0
        for mode, sampling in modes:
            for i, p in enumerate(prompts):
                free, _ = kstep_session(graphed.process, f"free-{mode}-{i}", p,
                                        sampling=sampling)
                # eos: the free run's token 5, or the first that is not its token 0
                eos = next((t for t in free[5:] + free[1:] if free.index(t) > 0), None)
                want = kstep_session(local.process, f"local-{mode}-{i}", p, eos, sampling)
                got = kstep_session(node_process(nodes[0]), f"node-{mode}-{i}", p, eos, sampling)
                if got != want:
                    raise AssertionError(f"{phase} {mode}, prompt {len(p)}: the node's (graphed) "
                                         f"windows {got[1]} != in-process eager {want[1]}")
                cut = len(free) if eos is None else free.index(eos) + 1
                if got[0] != free[:cut]:
                    raise AssertionError(f"{phase} {mode}, prompt {len(p)}: the eos run is not "
                                         "the free run cut at eos")
                stops += sum(w["real_len"] < w["decode_steps"] for w in got[1])
                served[(mode, len(p))] = got
                prefills += 1
                steps += sum(w["decode_steps"] for w in got[1])
                graphed.end_session(f"free-{mode}-{i}")
                local.end_session(f"local-{mode}-{i}")
            say(phase, f"{mode}: {len(prompts)} sessions of decode_steps {KSTEP_WINDOW} windows: "
                       "tokens, real_len, decode_steps and key equal the in-process executor's, "
                       "and each stream is its free run's cut at eos (the free run's token 5); "
                       "real_len per window "
                       + str([[w['real_len'] for w in served[(mode, len(p))][1]] for p in prompts]))
        if not stops:
            raise AssertionError(f"{phase}: no eos stopped a window mid-way")
        st = http_get_json(f"http://127.0.0.1:{nodes[0]['port']}/stats")
        kern = {name: k["launches"] for name, k in st["kernels"].items()}
        routes = flash_routes(st)
        want_routes = {"split": cfg.num_layers * steps, "mma": cfg.num_layers * prefills}
        windows = sum(len(v[1]) for v in served.values())
        say(phase, f"node: {st['forward_passes']} forward passes ({prefills} prefills, {windows} "
                   f"windows of {steps} decode steps in all); launches {kern}; flash_gqa routes "
                   f"{routes} (want {want_routes}: {routes == want_routes})")
        node_graphs = check_node_graphs(phase, st, windows)
        if (routes != want_routes or st["forward_passes"] != prefills + windows
                or kern["flash_gqa"] != sum(want_routes.values())
                or any(v for name, v in kern.items() if name != "flash_gqa")):
            raise AssertionError(f"{phase}: node stats {st}")
        chain0 = node_process(nodes[1])
        chain0("chain", {"tokens": [prompts[0]], "start_pos": 0, "real_len": len(prompts[0])})
        try:
            chain0("chain", {"tokens": [[1]], "start_pos": len(prompts[0]), "decode_steps": 4})
            raise AssertionError("stage 0 of the two-stage chain served decode_steps")
        except ServerError as e:
            say(phase, f"stage 0 of the two-stage chain answers decode_steps with HTTP "
                       f"{e.status} {e.code}: {e}")
            if e.status != 409 or e.code != "session_state" or "single-stage" not in str(e):
                raise
        del local, graphed
        torch.cuda.empty_cache()
        return {"launches": kern, "flash_routes": routes, "gemv_routes": gemv_routes(st),
                "graphs": node_graphs}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


# -- whole-model lane batching: generate_batched, serve_batch ------------------------

BATCH_LANES = 8
# the batch lanes' KV budget, in process and on the nodes: every prompt + 32
# tokens fits, and the dense step walks this many slots (core/batch)
BATCH_MAX_LEN = 2048
# the window: the client takes its sessions' logits one after another (~3 ms
# each), so their next steps reach the node that far apart, past a 2 ms window
BATCH_WINDOW_MS = 10
BATCH_NODE_ARGS = ["--batch-lanes", str(BATCH_LANES), "--max-len", str(BATCH_MAX_LEN),
                   "--window-ms", str(BATCH_WINDOW_MS)]
BATCH_PAGED_ARGS = BATCH_NODE_ARGS + ["--paged-kv", str(PAGED_BS), "--prefill-chunk",
                                      str(LANE_PREFILL_CHUNK)]
WHOLE_LANE_ARGS = ["--stage-lanes", str(LANES), "--paged-kv", str(PAGED_BS), "--max-len",
                   str(BATCH_MAX_LEN), "--prefill-chunk", str(LANE_PREFILL_CHUNK)]
BATCH_CLIENT_CHUNK = 1024  # the client sends each prompt whole: one chunk, as the engine's prefill
TENANT_BATCH_LANES = 4
SAMPLED_KSTEP = {"temperature": 0.6, "top_k": 20, "top_p": 0.95}


def tenant_batch_args(dirs: List[str]) -> List[str]:
    return ["--batch-lanes", str(TENANT_BATCH_LANES), "--max-len", str(BATCH_MAX_LEN),
            "--window-ms", str(BATCH_WINDOW_MS), "--adapters", ",".join(dirs)]


def one_stage_parts(work: str, params) -> str:
    """The whole model as a one-stage checkpoint under `work` (written once:
    serve_kstep's node, the whole-model lane nodes)."""
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.parallel.stages import (
        StageSpec, save_stage_checkpoint, stage_checkpoint_path)

    parts1 = os.path.join(work, "parts1")
    path = stage_checkpoint_path(parts1, 0)
    if not os.path.exists(path):
        cfg = get_config(MODEL)
        save_stage_checkpoint(path, params, StageSpec(0, 1, 0, cfg.num_layers - 1), MODEL)
    return parts1


def batch_prompts(vocab: int) -> List[List[int]]:
    """The serve prompts and the serve_lanes prompts: twelve, 16-1000 tokens."""
    import numpy as np

    rng = np.random.default_rng(1)
    return serve_prompts(vocab) + [rng.integers(0, vocab, n).tolist() for n in LANE_PROMPT_LENS]


def solo_margin(params, cfg, prompt: List[int], stream: List[int]) -> float:
    """The greedy `stream`'s worst token against the solo model: the prompt
    and the stream (but its last token) as one eager chunk through the
    whole model, and at each of the stream's positions the gap from the
    top logit to its token's, over the row's max |logit|. 0 where the
    stream took the argmax; a near-tie flip is a small gap."""
    import torch

    from inferd_tpu_torch.core.cache import KVCache
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.models import qwen3 as Q

    ids = prompt + stream[:-1]
    b = bucket_len(len(ids))
    toks = torch.tensor([ids + [0] * (b - len(ids))], device=DEVICE)
    cache = KVCache.create(cfg, cfg.num_layers, 1, b, device=DEVICE)
    with torch.no_grad():
        hidden, _ = Q.forward_layers_cached(params["layers"], cfg, Q.embed(params, toks, cfg), 0,
                                            cache, 0, real_end=len(ids))
        logits = Q.unembed(params, cfg, hidden[:, len(prompt) - 1:len(ids)])[0]
        chosen = logits[torch.arange(len(stream), device=DEVICE),
                        torch.tensor(stream, device=DEVICE)]
        gap = (logits.max(-1).values - chosen) / logits.abs().max(-1).values
    return float(gap.max())


def run_generate_batched(card: str, params) -> Dict[str, Any]:
    """The `generate_batched` phase: core.batch.BatchedEngine (8 lanes) in
    this process on twelve prompts, greedy and sampled, chunk 1 and 8."""
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core import sampling as samplib
    from inferd_tpu_torch.core.batch import BatchedEngine
    from inferd_tpu_torch.core.generate import Engine

    phase = "generate_batched"
    cfg = get_config(MODEL)
    prompts = batch_prompts(cfg.vocab_size)
    modes = {"greedy": SamplingConfig(temperature=0.0), "sampled (0.6/20/0.95)": SamplingConfig()}
    engines, windows, streams, walls = {}, {}, {}, {}
    reset_kernel_counts()
    for name, sc in modes.items():
        eng = BatchedEngine(cfg, params, lanes=BATCH_LANES, max_len=BATCH_MAX_LEN,
                            sampling_cfg=sc, device=DEVICE)
        steps = windows[name] = []
        chunked = eng.decode_chunk

        def counted(toks, active, n, *a, _real=chunked, _steps=steps, **kw):
            _steps.append(n)
            return _real(toks, active, n, *a, **kw)

        eng.decode_chunk = counted
        engines[name] = eng
        for chunk in (1, GEN_CHUNK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams[(name, chunk)] = eng.generate_all(prompts, NEW_TOKENS, seed=GEN_SEED,
                                                      chunk=chunk)
            walls[(name, chunk)] = time.perf_counter() - t0
    counts = kernel_counts()
    total = len(prompts) * NEW_TOKENS
    for (name, chunk), wall in walls.items():
        say(phase, f"{name}, chunk {chunk}: {total} tokens of {len(prompts)} prompts on "
                   f"{BATCH_LANES} lanes in {wall:.2f} s = {total / wall:.1f} tok/s aggregate "
                   f"(wall clock, prefills included; {card})")
    for name in modes:
        a, b = streams[(name, 1)], streams[(name, GEN_CHUNK)]
        bad = [len(p) for p, x, y in zip(prompts, a, b) if x != y]
        if bad or any(len(x) != NEW_TOKENS for x in a):
            raise AssertionError(f"{phase} {name}: chunk {GEN_CHUNK} != chunk 1 on prompts {bad}")
    say(phase, f"chunk {GEN_CHUNK} gives chunk 1's tokens on all {len(prompts)} prompts, greedy "
               "and sampled; distinct tokens per sampled stream "
               f"{[len(set(x)) for x in streams[('sampled (0.6/20/0.95)', 1)]]}")
    # launches, counted per replay: 28 tensor-core launches per prefill, 28
    # split-KV launches per decode step of a window (the lanes' bound)
    n_steps = sum(sum(w) for w in windows.values())
    want = {"split": cfg.num_layers * n_steps, "mma": cfg.num_layers * len(prompts) * 4}
    got = counts["flash_routes"]
    others = {k: v for k, v in counts["launches"].items() if k != "flash_gqa"}
    say(phase, f"flash_gqa routes {got} over {sum(len(w) for w in windows.values())} windows of "
               f"{n_steps} steps and {len(prompts) * 4} prefills (want {want}: {got == want})")
    if got != want or counts["launches"]["flash_gqa"] != sum(want.values()) or any(
            others.values()):
        raise AssertionError(f"{phase}: launches {counts}, want flash routes {want}")
    for name, eng in engines.items():
        st = eng.graph_stats()
        say(phase, f"{name}: graph_stats {st} over {len(windows[name])} windows "
                   f"({st['replays'] / max(st['captures'], 1):.1f} replays per capture)")
        if (st["captures"] + st["replays"] != len(windows[name])
                or st["replays"] < GRAPH_REPLAYS_PER_CAPTURE * st["captures"]):
            raise AssertionError(f"{phase} {name}: graphs {st} for {len(windows[name])} windows "
                                 f"(want every window a capture or a replay, >= "
                                 f"{GRAPH_REPLAYS_PER_CAPTURE} replays per capture)")

    # every sequence against itself decoded alone in the batched engine (the
    # lanes never interact: bit for bit), and against the solo engine with
    # seed + index: its shared prefix printed (8 lanes and 1 run other split
    # plans and GEMM shapes, so other bits, and a near-tie flips), and each
    # greedy token held to the solo model's logits over the same context
    alone_bad, solo_same = {}, {}
    for name, sc in modes.items():
        solo = Engine(cfg, params, max_len=BATCH_MAX_LEN, sampling_cfg=sc)
        solo_same[name] = [first_divergence(solo.generate(p, NEW_TOKENS, seed=GEN_SEED + i), s)
                           for i, (p, s) in enumerate(zip(prompts, streams[(name, 1)]))]
        del solo
        alone_bad[name] = [len(p) for i, (p, s) in enumerate(zip(prompts, streams[(name, 1)]))
                           if engines[name].generate_all([p], NEW_TOKENS, seed=GEN_SEED + i,
                                                         chunk=GEN_CHUNK)[0] != s]
        say(phase, f"{name}: decoded alone in the batched engine, prompts that differ: "
                   f"{alone_bad[name]}; tokens each sequence shares with the solo Engine's "
                   f"(seed + index): {solo_same[name]} of {NEW_TOKENS} (printed, not gated)")
    margins = [solo_margin(params, cfg, p, s) for p, s in zip(prompts, streams[("greedy", 1)])]
    say(phase, f"greedy: each batched token's logit below the solo model's top logit over the "
               f"same context, worst per sequence, share of max |logit|: "
               f"{[round(m, 4) for m in margins]} (tol {LOGIT_TOL:.0%})")
    if any(alone_bad.values()) or not max(margins) <= LOGIT_TOL:
        raise AssertionError(f"{phase}: sequences leave their own decoded alone {alone_bad}, or "
                             f"greedy tokens the solo model's top logits {margins}")

    # what a co-batched step costs beside a solo one, in this call
    eng = engines["greedy"]
    fill = len(prompts[1])
    solo = Engine(cfg, params, max_len=BATCH_MAX_LEN, sampling_cfg=modes["greedy"])
    logits, cache = solo.prefill(prompts[1], solo.new_cache(1))
    sub = samplib.split_key(samplib.prng_key(0))[1]
    tok = samplib.sample(logits, sub)

    def cobatched():
        for lane in range(BATCH_LANES):
            eng.lengths[lane] = fill
        eng.decode_chunk([1] * BATCH_LANES, [True] * BATCH_LANES, 1)

    def one():
        cache.length = fill
        return solo.decode(tok, cache, sub)

    share = {"co-batched step (8 lanes)": device_share(phase, card, "co-batched step (8 lanes)",
                                                       cobatched, 1),
             "solo step": device_share(phase, card, "solo step", one, 1)}
    eng.lengths[:] = [0] * BATCH_LANES
    cob, solo_ms = share["co-batched step (8 lanes)"]["host_ms"], share["solo step"]["host_ms"]
    say(phase, f"at fill {fill}: a co-batched step of {BATCH_LANES} lanes {cob:.3f} ms = "
               f"{BATCH_LANES * 1e3 / cob:.1f} tok/s aggregate, the solo engine's step "
               f"{solo_ms:.3f} ms = {1e3 / solo_ms:.1f} tok/s ({card})")
    del solo, cache, engines, eng
    torch.cuda.empty_cache()

    # tools/generate --engine batched, as a user runs it
    cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.generate", "--model", MODEL,
           "--random-init", "--prompt-ids", ",".join(str(t) for t in range(100, 132)),
           "--max-new-tokens", "16", "--chunk", "8", "--engine", "batched", "--lanes", "4"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    ids = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
    rate = r.stderr.strip().splitlines()[-1]
    say(phase, f"tools/generate --engine batched --lanes 4: exit 0 in "
               f"{time.perf_counter() - t0:.1f}s with {len(ids)} ids; {rate} ({card})")
    if len(ids) != 16 or "on cuda" not in rate:
        raise AssertionError(f"{phase}: {r.stdout!r} {r.stderr[-2000:]!r}")
    return dict(counts, prompts=prompts, streams=streams[("greedy", 1)],
                tokens_per_s={f"{n} chunk {c}": total / w for (n, c), w in walls.items()},
                step_share=share)


def kstep_sessions(node, prompts, tag: str, sampling=None):
    """kstep_session on `node` for every prompt at once (threads): the
    streams, and the windows' results."""
    from concurrent.futures import ThreadPoolExecutor

    process = node_process(node)
    with ThreadPoolExecutor(len(prompts)) as pool:
        return list(pool.map(lambda ip: kstep_session(process, f"{tag}{ip[0]}", ip[1],
                                                      sampling=sampling), enumerate(prompts)))


def check_kstep_frozen_fill(phase: str, make, prompt) -> None:
    """A paged whole-model lane executor made under planted_frozen_fill
    (its K-step windows captured with the fill frozen) gives a sampled
    decode_steps stream that leaves the eager executor's; without the fault
    the graphed stream is the eager one."""
    import torch

    def run(ex):
        out = kstep_session(ex.process, "f", prompt, sampling=SAMPLED_KSTEP)[0]
        del ex
        torch.cuda.empty_cache()
        return out

    want = run(eager([make()])[0])
    sound = run(make())
    with planted_frozen_fill():
        try:
            got = run(make())
            how = f"the stream leaves the eager one at token {first_divergence(got, want)}"
        except Exception as e:  # the executor refuses a window that commits no token
            got, how = None, f"the session fails: {e}"
    say(phase, f"planted fault frozen_fill on graphed paged K-step windows, prompt {len(prompt)}, "
               f"sampled: {how}; without the fault, graphed equals eager: {sound == want}")
    if sound != want:
        raise AssertionError(f"{phase}: graphed K-step windows leave the eager stream")
    if got == want:
        raise AssertionError(f"{phase}: planted fault frozen_fill passes the K-step windows")


def run_serve_batch(card: str, params, work: str, gen: Dict[str, Any]) -> Dict[str, Any]:
    """The `serve_batch` phase: whole-model lane nodes (`run_node
    --batch-lanes`, dense and paged; `--stage-lanes` on the one-stage
    parts; `--batch-lanes 4 --adapters`) against generate_batched's greedy
    streams `gen`."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.runtime.adapters import AdapterRegistry
    from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor

    phase = "serve_batch"
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    parts1 = one_stage_parts(work, params)
    dirs = write_tenants(work)
    kinds = {"dense": BATCH_NODE_ARGS, "paged": BATCH_PAGED_ARGS, "stage lanes": WHOLE_LANE_ARGS,
             "tenants": tenant_batch_args(dirs)}
    tags = {"dense": "_batch", "paged": "_batchp", "stage lanes": "_wlanes",
            "tenants": "_batcht"}
    serve_p, lane_p = gen["prompts"][:len(PROMPT_LENS)], gen["prompts"][len(PROMPT_LENS):]
    serve_s, lane_s = gen["streams"][:len(PROMPT_LENS)], gen["streams"][len(PROMPT_LENS):]
    nodes: Dict[str, Dict[str, Any]] = {}
    try:
        for kind in kinds:
            nodes[kind] = start_single(parts1, work, kinds[kind], tags[kind])
        for n in nodes.values():
            wait_ready(n)

        def stats(kind):
            return http_get_json(f"http://127.0.0.1:{nodes[kind]['port']}/stats")

        for kind in kinds:  # fresh processes: every count starts at 0
            st = stats(kind)
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"{kind} node did work before the main path: {st}")

        # the serve_lanes traffic on the two --batch-lanes nodes: the dense
        # node's streams are generate_batched's (the same step at the same
        # max_len, each prompt prefilled whole), the paged node's an eager
        # in-process paged executor's (sessions one at a time)
        launches = dict.fromkeys(_wrappers(), 0)
        routes_all = {"split": 0, "mma": 0}
        out: Dict[str, Any] = {"rates": {}, "mean_batch": {}, "graphs": {}}
        served: Dict[str, List[List[int]]] = {}

        def chain_streams(kind: str) -> List[List[int]]:
            """The lane prompts as concurrent greedy ChainClient sessions."""
            async def drive():
                async with ChainClient([("127.0.0.1", nodes[kind]["port"])], sampling=greedy,
                                       prefill_chunk=BATCH_CLIENT_CHUNK) as client:
                    return await asyncio.gather(*(client.generate_ids(p, max_new_tokens=NEW_TOKENS)
                                                  for p in lane_p))

            return asyncio.run(drive())

        for kind in ("dense", "paged"):
            t0 = time.perf_counter()
            got = served[kind] = chain_streams(kind)
            wall = time.perf_counter() - t0
            if kind == "dense":
                want, against = lane_s, "generate_batched's greedy ones"
            else:
                local = eager([BatchedExecutor(cfg, params, lanes=BATCH_LANES,
                                               max_len=BATCH_MAX_LEN, block_size=PAGED_BS,
                                               prefill_chunk=LANE_PREFILL_CHUNK, device=DEVICE)])

                async def one_by_one():
                    client = make_local_client(local, greedy, prefill_chunk=BATCH_CLIENT_CHUNK)
                    return [await client.generate_ids(p, max_new_tokens=NEW_TOKENS)
                            for p in lane_p]

                want, against = asyncio.run(one_by_one()), "an eager in-process paged executor's"
                del local
                torch.cuda.empty_cache()
            bad = [len(p) for p, a, b in zip(lane_p, got, want) if a != b]
            say(phase, f"{kind} node ({' '.join(kinds[kind])}): {len(lane_p)} concurrent "
                       f"ChainClient sessions, {len(lane_p) * NEW_TOKENS} tokens in {wall:.2f} s "
                       f"= {len(lane_p) * NEW_TOKENS / wall:.1f} tok/s aggregate ({card}); "
                       f"streams equal {against}: {not bad}; tokens shared with "
                       f"generate_batched's: {[first_divergence(a, b) for a, b in zip(got, lane_s)]}")
            if bad:
                raise AssertionError(f"{phase} {kind}: streams of prompts {bad} leave {against}")
            st = stats(kind)
            ex = st["executor"]
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            routes = flash_routes(st)
            layers = cfg.num_layers
            if kind == "dense":
                want_routes = {"split": layers * steps, "mma": layers * ex["prefill_steps"]}
                want_paged = 0
            else:
                want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
                want_paged = layers * sum(ex["decode_widths"].values())
                split, want_split = paged_splits(phase, st, cfg)
                out["paged_split"] = split
            mean = toks / steps if steps else 0.0
            say(phase, f"{kind} node: {steps} decode dispatches serving {toks} session steps "
                       f"(mean co-batch {mean:.3f}; window {ex['window']}), "
                       f"{ex['prefill_steps']} prefill dispatches; launches {kern}; flash_gqa "
                       f"routes {routes} (want {want_routes}); paged_decode_gqa launches "
                       f"{kern['paged_decode_gqa']} (want {want_paged})")
            out["graphs"][kind] = check_node_graphs(phase, st, steps)
            if (routes != want_routes or kern["paged_decode_gqa"] != want_paged
                    or (kind == "paged" and (want_paged == 0 or split != want_split))
                    or toks != len(lane_p) * (NEW_TOKENS - 1) or not mean > 1.0
                    or st["errors"] or kern["fused_lane_delta"] or kern["w8a16_matmul"]):
                raise AssertionError(f"{phase} {kind}: node stats {st}")
            out["mean_batch"][kind] = mean
            out["rates"][kind] = len(lane_p) * NEW_TOKENS / wall

        # decode_steps windows of 8 on both and on a whole-model --stage-lanes
        # node (its prefill chunked as the paged node's): one token per step's
        # streams (the dense node: generate_batched's; the fresh stage lanes:
        # the paged node's above). The paged node's K-step sessions map the
        # prompts' blocks that its first sessions published and prefill only
        # the rest, in other chunks (other bits): they are held to the same
        # ChainClient traffic driven again, which maps the same blocks
        for kind in ("dense", "paged", "stage lanes"):
            before = stats(kind)["executor"]["batched_steps"]
            res = kstep_sessions(nodes[kind], lane_p, "k")
            k_disp = stats(kind)["executor"]["batched_steps"] - before
            want = {"dense": lane_s, "stage lanes": served["paged"]}.get(kind)
            if want is None:  # the paged node, warm: the ChainClient traffic again
                want = chain_streams(kind)
            bad = [len(p) for p, (a, _), b in zip(lane_p, res, want) if a != b]
            full = all(w["real_len"] == w["decode_steps"] for _, ws in res for w in ws)
            st = stats(kind)
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            say(phase, f"{kind} node: decode_steps {KSTEP_WINDOW} windows of {len(lane_p)} "
                       f"sessions at once, {k_disp} dispatches: "
                       f"streams equal one token per step: {not bad}; launches {kern}")
            out["graphs"][kind] = check_node_graphs(phase, st, st["executor"]["batched_steps"])
            if bad or not full or st["errors"]:
                raise AssertionError(f"{phase} {kind}: K-step streams of prompts {bad} leave one "
                                     f"token per step, windows {res}, {st['errors']} errors")
            if kind != "dense" and not kern["paged_decode_gqa"]:
                raise AssertionError(f"{phase} {kind}: no paged_decode_gqa launch")

        # tenants: sessions on t0, t1, t2 and the base model at once, one prompt
        names = [LORA_TENANTS[i][0] for i in range(3)] + [None]
        tport = nodes["tenants"]["port"]

        async def tenants():
            clients = {nm: ChainClient([("127.0.0.1", tport)], sampling=greedy, adapter=nm)
                       for nm in names}
            return await asyncio.gather(*(clients[nm].generate_ids(serve_p[1],
                                                                   max_new_tokens=NEW_TOKENS)
                                          for nm in names))

        got = asyncio.run(tenants())
        if any(a == got[-1] for a in got[:-1]):
            raise AssertionError(f"{phase}: a tenant stream equals the base model's: {got}")
        say(phase, f"tenants node ({' '.join(kinds['tenants'][:4])} t0,t1,t2): prompt "
                   f"{len(serve_p[1])}, the three tenant streams leave the base session's "
                   f"(sharing {[first_divergence(a, got[-1]) for a in got[:-1]]} tokens with "
                   f"it); the base session shares {first_divergence(got[-1], serve_s[1])} with "
                   "generate_batched's")
        # a tenant's graphed K-step windows against the eager executor's
        local = eager([BatchedExecutor(cfg, params, lanes=TENANT_BATCH_LANES,
                                       max_len=BATCH_MAX_LEN, device=DEVICE,
                                       adapters=AdapterRegistry(cfg, ",".join(dirs),
                                                                device=DEVICE))])[0]

        def tenant_kstep(process, sid):
            r = process(sid, {"tokens": [serve_p[1]], "start_pos": 0, "adapter": "t0",
                              "real_len": len(serve_p[1])})
            out_ = [int(np.argmax(np.asarray(r["logits"], np.float32)[0]))]
            for _ in range(3):
                w = process(sid, {"tokens": [[out_[-1]]], "decode_steps": KSTEP_WINDOW,
                                  "start_pos": len(serve_p[1]) + len(out_) - 1})
                out_ += [int(t) for t in w["tokens"][0]]
            return out_

        a, b = tenant_kstep(node_process(nodes["tenants"]), "tk"), tenant_kstep(local.process, "tk")
        del local
        torch.cuda.empty_cache()
        st = stats("tenants")
        kern = {name: k["launches"] for name, k in st["kernels"].items()}
        say(phase, f"tenants node: t0's graphed K-step windows equal the eager executor's: "
                   f"{a == b}; launches {kern}; registry {st['executor']['adapters']}")
        out["graphs"]["tenants"] = check_node_graphs(phase, st, st["executor"]["batched_steps"])
        if a != b or not kern["fused_lane_delta"] or st["errors"]:
            raise AssertionError(f"{phase}: tenant windows {a} != eager {b}, or stats {st}")

        for kind in kinds:
            st = stats(kind)
            for name, k in st["kernels"].items():
                launches[name] += k["launches"]
            for r, v in flash_routes(st).items():
                routes_all[r] += v
        stop_nodes(list(nodes.values()))
        nodes = {}

        # the planted fault: paged K-step windows captured with a frozen fill
        check_kstep_frozen_fill(phase, lambda: BatchedExecutor(
            cfg, params, lanes=BATCH_LANES, max_len=BATCH_MAX_LEN, block_size=PAGED_BS,
            device=DEVICE), serve_p[1])
        out.update(launches=launches, flash_routes=routes_all,
                   gemv_routes={name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()})
        return out
    except BaseException:
        stop_nodes(list(nodes.values()), show_logs=True)
        nodes = {}
        raise
    finally:
        stop_nodes(list(nodes.values()))


# The anatomy phase: perf/anatomy.profile_step on the whole model at the
# headline regime's context, bf16, --quant int8, and paged (bs PAGED_BS).
ANATOMY_CASES = (("bf16", "none", 0), ("int8", "int8", 0), (f"paged bs {PAGED_BS}", "none", PAGED_BS))
ANATOMY_PAIRS = 2


def run_anatomy(card: str, params) -> Dict[str, Any]:
    """The `anatomy` phase: where one decode step's time goes, per phase,
    each beside its bound, the graphed whole step and the host's dispatch
    cost; the counts of every launch the phase's graphs and eager steps
    made."""
    import torch

    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import quant
    from inferd_tpu_torch.perf import anatomy, roofline as rl

    phase = "anatomy"
    cfg = get_config(MODEL)
    chip = rl.get_chip("h100")
    qparams = quant.apply_quant_mode("int8", params, tie_word_embeddings=cfg.tie_word_embeddings)
    reset_kernel_counts()
    out = {}
    for label, q, bs in ANATOMY_CASES:
        t0 = time.perf_counter()
        before = kernel_counts()["launches"]
        r = anatomy.profile_step(cfg, params=qparams if q != "none" else params, quant=q,
                                 ctx=HEADLINE_CTX, pairs=ANATOMY_PAIRS, chip=chip,
                                 paged_block_size=bs)
        moved = {k: v - before[k] for k, v in kernel_counts()["launches"].items()
                 if v != before[k]}
        for name, ph in r["phases"].items():
            extra = (f", the eager host-driven step {ph['hostloop_step_ms']:.4f} ms"
                     if name == "dispatch" else
                     f", bound {ph['roofline_ms']:.4f} ms ({ph['roofline_frac'] or 0:.1%} of it)")
            say(phase, f"{label}: {name} {ph['ms']:.4f} ms, {ph['bytes']} bytes{extra}; "
                       f"{ph['pairs_valid']}/{ANATOMY_PAIRS} valid pairs")
        say(phase, f"{label}: step {r['step_ms']} ms (graphed; bound {r['step_roofline_ms']} ms, "
                   f"{r['step_roofline_frac']:.1%}), phase sum {r['phase_sum_ms']} ms, "
                   f"unattributed {r['unattributed_ms']} ms, dispatch "
                   f"{r['phases']['dispatch']['ms']} ms; ctx {HEADLINE_CTX}, "
                   f"{time.perf_counter() - t0:.1f}s; graphs {r['graphs']}; launches {moved} "
                   f"({card})")
        want = {"w8a16_matmul"} if q == "int8" else set()
        want |= {"paged_decode_gqa"} if bs else {"flash_gqa"}
        if not want <= set(moved) or any(r["phases"][p]["ms"] <= 0 for p in anatomy.PHASES
                                         if p != "dispatch"):
            raise AssertionError(f"{phase} {label}: launches {moved} (want {want}), {r}")
        out[label] = r
    counts = kernel_counts()
    from inferd_tpu_torch.ops.attention import paged_decode_gqa

    paged_split = paged_decode_gqa.split_launches
    check_paged_split_capture(phase)  # after the counts: not part of the path
    del qparams
    torch.cuda.empty_cache()
    return dict(counts, anatomy=out, paged_split=paged_split)


def check_paged_split_capture(phase: str) -> None:
    """paged_decode_gqa on a plan that splits the chain (its combine kernel
    a programmatic dependent launch) captured into a CUDA graph: a replay
    gives the eager call's bits and counts one launch and one split launch.
    The anatomy's paged case (ctx HEADLINE_CTX) keeps its chain whole."""
    import torch

    from inferd_tpu_torch.ops.attention import paged_decode_gqa, paged_plan
    from inferd_tpu_torch.utils.cuda_graph import GraphCache

    gen = torch.Generator(DEVICE).manual_seed(5)
    b, nq, nkv, d, mb = LANES, 16, 8, 128, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    kp, vp = randn(b * mb + 1, PAGED_BS, nkv, d), randn(b * mb + 1, PAGED_BS, nkv, d)
    table = (1 + torch.randperm(b * mb, generator=gen, device=DEVICE)).reshape(b, mb).int()
    kv_len = torch.tensor([4096, 3000, 17, 1000, 2048, 4095, 1, 512], device=DEVICE)
    qpos = (kv_len - 1)[:, None]
    q = randn(b, 1, nq, d)
    plan = paged_plan(b, nkv, mb, PAGED_BS, torch.bfloat16)

    def fn(q):
        return paged_decode_gqa(q, kp, vp, table, qpos, kv_len)

    eager = fn(q)
    graphs = GraphCache()
    graphs.run("paged", fn, {"q": q})  # the warm-up and the capture
    before = (paged_decode_gqa.launches, paged_decode_gqa.split_launches)
    got = graphs.run("paged", fn, {"q": q}).clone()
    torch.cuda.synchronize()
    moved = (paged_decode_gqa.launches - before[0], paged_decode_gqa.split_launches - before[1])
    say(phase, f"paged_decode_gqa captured on a split plan {plan._asdict()} (its combine a "
               f"programmatic dependent launch): replay equals the eager call bit for bit: "
               f"{torch.equal(got, eager)}; a replay counts {moved} (launches, split launches)")
    if plan.splits < 2 or not torch.equal(got, eager) or moved != (1, 1):
        raise AssertionError(f"{phase}: paged split under capture: plan {plan}, moved {moved}")


PROFILE_WINDOW_S = 2.0  # the /profile window on each node (a request takes 0.2-0.7 s)
PROFILE_PROMPT, PROFILE_TOKENS = 100, 9  # the request traced: a prefill and 8 decode steps


def profile_node_args(work: str) -> List[str]:
    return ["--enable-profiling", "--profile-dir", os.path.join(work, "profiles")]


def run_profile(card: str, parts: str, work: str) -> Dict[str, Any]:
    """The `profile` phase: the serve chain's two nodes with
    --enable-profiling; a warm-up request, then, one node at a time, POST
    /profile window on it and one request of a prefill and 8 decode steps
    inside the window. Each node's trace (utils/profiling.host_time_split)
    splits its host time; the trace must hold the card's kernels."""
    from inferd_tpu_torch.client.base import http_post
    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.runtime import wire
    from inferd_tpu_torch.utils.profiling import TRACE_FILE, host_time_split

    phase = "profile"
    cfg = get_config(MODEL)
    extra = profile_node_args(work)
    prompt = serve_prompts(cfg.vocab_size)[1][:PROFILE_PROMPT]
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = start_nodes(parts, work, extra, tag="_profile")
        for n in nodes:
            wait_ready(n)
        before = [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]
        if any(k["launches"] for st in before for k in st["kernels"].values()):
            raise AssertionError(f"the nodes did work before the main path: {before}")

        async def drive(tokens: int) -> List[int]:
            async with ChainClient([("127.0.0.1", n["port"]) for n in nodes],
                                   sampling=SamplingConfig(temperature=0.0)) as client:
                return await client.generate_ids(prompt, max_new_tokens=tokens)

        asyncio.run(drive(4))  # warm-up: allocator, libraries, first launches
        splits = []
        # one node's window at a time: while a second process on the card
        # starts its own trace, the first one's comes back empty (graphed
        # nodes or not), so each node is traced around a request of its own
        for n in nodes:
            status, raw, _ = http_post(f"http://127.0.0.1:{n['port']}/profile", wire.pack(
                {"action": "window", "seconds": PROFILE_WINDOW_S, "capture_id": "smoke"}), 60.0)
            reply = wire.unpack(raw)
            if status != 200 or not reply.get("ok"):
                raise AssertionError(f"{phase}: /profile window on node {n['stage']}: HTTP "
                                     f"{status} {reply}")
            t0 = time.perf_counter()
            ids = asyncio.run(drive(PROFILE_TOKENS))
            drive_s = time.perf_counter() - t0
            if len(ids) != PROFILE_TOKENS:
                raise AssertionError(f"{phase}: {len(ids)} tokens, want {PROFILE_TOKENS}")
            if drive_s > PROFILE_WINDOW_S:
                raise AssertionError(f"{phase}: the request took {drive_s:.1f}s, longer than "
                                     f"the {PROFILE_WINDOW_S}s window")
            p = os.path.join(reply["dir"], TRACE_FILE)
            deadline = time.monotonic() + PROFILE_WINDOW_S + 120
            while not os.path.exists(p) and time.monotonic() < deadline:
                time.sleep(0.2)
            if not os.path.exists(p):
                raise AssertionError(f"{phase}: node {n['stage']} wrote no trace at {p}")
            s = host_time_split(p)
            splits.append(s)
            req = max(s["requests"], 1)
            parts_ms = {k: v for k, v in s.items() if k.endswith("_ms") and k != "device_kernel_ms"}
            say(phase, f"node {n['stage']}: trace {os.path.getsize(p)} bytes, {s['requests']} "
                       f"requests ({drive_s:.2f}s of drive in the {PROFILE_WINDOW_S}s window); "
                       f"host ms per request: "
                       + ", ".join(f"{k[:-3]} {v / req:.3f}" for k, v in parts_ms.items())
                       + f"; device: {s['device_kernels']} kernels, "
                         f"{s['device_kernel_ms'] / req:.3f} ms per request ({card})")
            # the decode steps: the session's compute requests after its prefill
            steps = [r for r in s["per_request"] if r["compute"]][1:]
            if (len(steps) < PROFILE_TOKENS - 1 or not s["device_kernels"]
                    or not s["layers_ms"]):
                raise AssertionError(f"{phase}: node {n['stage']}'s trace misses the requests or "
                                     f"the card's kernels: {s}")
            med = {k: statistics.median(r[k] for r in steps) for k in steps[0]
                   if k.endswith("_ms")}
            say(phase, f"node {n['stage']}: one decode step (the median of {len(steps)} "
                       f"requests), host ms: request {statistics.median(r['ms'] for r in steps):.3f}"
                       ": " + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in med.items())
                       + f" (under the profiler; {card})")
        st = [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]
        for x in st:
            g = x["executor"]["graphs"]
            say(phase, f"node {x['stage']}: graphs {g} (the decode steps replay graphs)")
            if not g["replays"]:
                raise AssertionError(f"{phase}: node {x['stage']} replayed no graph: {g}")
        kern = {name: sum(x["kernels"][name]["launches"] for x in st)
                for name in st[0]["kernels"]}
        routes = {r: sum(flash_routes(x)[r] for x in st) for r in ("split", "mma")}
        gemv = {name: {r: sum(gemv_routes(x)[name][r] for x in st) for r in ("mma", "simt")}
                for name in ("w8a16_matmul", "w4a16_matvec")}
        return {"launches": kern, "flash_routes": routes, "gemv_routes": gemv,
                "host_split": splits}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def run_cli(card: str) -> None:
    """The `cli` phase: tools/generate as a user runs it, on the card by
    default."""
    phase = "cli"
    cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.generate", "--model", MODEL,
           "--random-init", "--prompt-ids", ",".join(str(t) for t in range(100, 132)),
           "--max-new-tokens", "16", "--chunk", "8"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    ids = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
    rate = r.stderr.strip().splitlines()[-1]
    say(phase, f"{' '.join(cmd[1:4])} ... exit 0 in {time.perf_counter() - t0:.1f}s with "
               f"{len(ids)} ids; {rate} ({card})")
    if len(ids) != 16 or "on cuda" not in rate:
        raise AssertionError(f"{phase}: {r.stdout!r} {r.stderr[-2000:]!r}")


def run_cli_send(card: str, entry_port: int, prompt: List[int], want: List[int]) -> None:
    """The `cli` phase's network half: tools/send --entry as a subprocess
    against a live swarm (serve_swarm's lane pair, while it serves), greedy:
    exit 0 and the stream the swarm gave the same prompt."""
    phase = "cli"
    cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.send", "--entry",
           f"127.0.0.1:{entry_port}", "--prompt-ids", ",".join(map(str, prompt)),
           "--max-new-tokens", str(len(want)), "--temperature", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: tools/send exit {r.returncode}\n{r.stderr[-4000:]}")
    ids = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
    say(phase, f"python -m inferd_tpu_torch.tools.send --entry ... --prompt-ids <{len(prompt)} "
               f"ids> --max-new-tokens {len(want)} --temperature 0: exit 0 in "
               f"{time.perf_counter() - t0:.1f}s with {len(ids)} ids, equal to the swarm's "
               f"stream: {ids == want} ({card})")
    if ids != want:
        raise AssertionError(f"{phase}: tools/send printed {ids}, want {want}")


def run_cli_send_routed(card: str, gossip_port: int, prompt: List[int],
                        want: List[int]) -> None:
    """tools/send --routed as a subprocess against serve_swarm's one-session
    swarm (its seed's gossip port), greedy: exit 0 and the swarm's stream."""
    phase = "cli"
    cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.send", "--routed",
           f"127.0.0.1:{gossip_port}", "--num-stages", "2", "--prompt-ids",
           ",".join(map(str, prompt)), "--max-new-tokens", str(len(want)), "--temperature", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: tools/send --routed exit {r.returncode}\n"
                             f"{r.stderr[-4000:]}")
    ids = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
    say(phase, f"python -m inferd_tpu_torch.tools.send --routed 127.0.0.1:<seed gossip port> "
               f"--num-stages 2 --prompt-ids <{len(prompt)} ids> --max-new-tokens {len(want)} "
               f"--temperature 0: exit 0 in {time.perf_counter() - t0:.1f}s with {len(ids)} "
               f"ids, equal to the swarm's stream: {ids == want} ({card})")
    if ids != want:
        raise AssertionError(f"{phase}: tools/send --routed printed {ids}, want {want}")


CODEC_PAIRS = 5  # interleaved rounds of native and Python per operation


def run_codec() -> List[Dict[str, Any]]:
    """The `codec` phase: the wire's native codec (csrc/wirecodec.cpp)
    against its pure-Python codec on the envelopes the lane pair sends: a
    decode step's (bf16 hidden row [1, 1, 1024]), a coalesced window's (8
    rows) and the last stage's reply ([1, 151936] f32 logits, ~600 KB);
    pack and unpack each, host clock per call, the two codecs in turns in one
    process (the median of CODEC_PAIRS rounds). The bytes must be equal."""
    import torch

    from inferd_tpu_torch import native
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.runtime import wire

    phase = "codec"
    card = nvidia_smi_line()
    cfg = get_config(MODEL)
    g = torch.Generator().manual_seed(0)
    row = {"task_id": "t", "session_id": "s", "stage": 1, "deadline_ms": 1.7e12,
           "payload": {"hidden": torch.randn(1, 1, cfg.hidden_size, generator=g)
                       .to(torch.bfloat16), "start_pos": 700, "real_len": 1}}
    cases = {
        "decode_envelope": (row, 2000),
        "coalesced_8": (wire.coalesce_forward([dict(row, session_id=f"s{i}")
                                               for i in range(LANES)]), 1000),
        "logits_reply": ({"task_id": "t", "session_id": "s", "served_by": "127.0.0.1:1",
                          "result_for_user": {"logits": torch.randn(1, cfg.vocab_size,
                                                                    generator=g)}}, 200),
    }
    codec = native.load(wire.tensor_parts, wire.tensor_build)
    fns = {"native": (codec.pack, codec.unpack), "python": (wire.pack_python,
                                                            wire.unpack_python)}
    rows = []
    for name, (payload, iters) in cases.items():
        blob = codec.pack(payload)
        if blob != wire.pack_python(payload):
            raise AssertionError(f"{phase}: {name}: native bytes != Python bytes")
        times: Dict[str, List[float]] = {f"{c}_{op}": [] for c in fns for op in ("pack",
                                                                                "unpack")}
        for i in range(CODEC_PAIRS):
            for c in (("native", "python") if i % 2 == 0 else ("python", "native")):
                pack, unpack = fns[c]
                for op, fn, arg in (("pack", pack, payload), ("unpack", unpack, blob)):
                    fn(arg)  # warm
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn(arg)
                    times[f"{c}_{op}"].append((time.perf_counter() - t0) / iters * 1e6)
        us = {k: statistics.median(v) for k, v in times.items()}
        rows.append(dict({"case": name, "bytes": len(blob)}, **{f"{k}_us": v
                                                              for k, v in us.items()}))
        say(phase, f"{name} ({len(blob)} bytes): pack native {us['native_pack']:.2f} us, "
                   f"Python {us['python_pack']:.2f} us ({us['python_pack'] / us['native_pack']:.2f}x); "
                   f"unpack native {us['native_unpack']:.2f} us, Python "
                   f"{us['python_unpack']:.2f} us "
                   f"({us['python_unpack'] / us['native_unpack']:.2f}x); median of "
                   f"{CODEC_PAIRS} interleaved rounds of {iters} calls (host clock, {card})")
    return rows


FP8_NODE_ARGS = ["--kv-dtype", "float8_e4m3fn"]


def run_serve_fp8(card: str, params, work: str, serve=None) -> Dict[str, Any]:
    """The `serve_fp8` phase: one greedy request to a one-stage run_node
    --kv-dtype float8_e4m3fn node, token-exact against the same executor
    with the same fp8 KV config in this process, its graphs off; flash_gqa
    launches exact per route (fp8 K/V) and every decode step a graph
    capture or a replay."""
    import dataclasses as dc

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.parallel.stages import StageSpec
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    phase = "serve_fp8"
    cfg = dc.replace(get_config(MODEL), kv_dtype="float8_e4m3fn")
    greedy = SamplingConfig(temperature=0.0)
    prompt = serve_prompts(cfg.vocab_size)[2]
    node: Optional[Dict[str, Any]] = None
    try:
        node = start_single(one_stage_parts(work, params), work, FP8_NODE_ARGS, "_fp8")
        wait_ready(node)
        before = http_get_json(f"http://127.0.0.1:{node['port']}/stats")
        if any(k["launches"] for k in before["kernels"].values()) or before["forward_passes"]:
            raise AssertionError(f"{phase}: the node did work before the main path: {before}")

        async def go(client):
            async with client as c:
                return await c.generate_ids(prompt, max_new_tokens=NEW_TOKENS)

        got = asyncio.run(go(ChainClient([("127.0.0.1", node["port"])], sampling=greedy,
                                         prefill_chunk=512)))
        local = eager([Qwen3StageExecutor(cfg, StageSpec(0, 1, 0, cfg.num_layers - 1), params,
                                          max_len=MAX_LEN)])
        want = asyncio.run(go(make_local_client(local, greedy)))
        st = http_get_json(f"http://127.0.0.1:{node['port']}/stats")
        kern = {name: k["launches"] for name, k in st["kernels"].items()}
        routes = flash_routes(st)
        chunks = -(-len(prompt) // 512)
        bf16 = ("" if serve is None else f"; its first {first_divergence(got, serve['streams'][2])}"
                f" tokens equal the bf16 serve stream's")
        want_routes = {"split": cfg.num_layers * (NEW_TOKENS - 1), "mma": cfg.num_layers * chunks}
        say(phase, f"prompt {len(prompt)} tokens, {NEW_TOKENS} greedy tokens through run_node "
                   f"{' '.join(FP8_NODE_ARGS)}: the node's stream equals the in-process eager "
                   f"executor's with fp8 KV: {got == want}; launches {kern}; flash_gqa routes "
                   f"{routes} (want {want_routes}){bf16} ({card})")
        node_graphs = check_node_graphs(phase, st, NEW_TOKENS - 1)
        if (got != want or routes != want_routes or kern["flash_gqa"] != sum(want_routes.values())
                or any(v for name, v in kern.items() if name != "flash_gqa") or st["errors"]):
            raise AssertionError(f"{phase}: stream {got} (want {want}), stats {st}")
        del local
        return {"launches": kern, "flash_routes": routes, "gemv_routes": gemv_routes(st),
                "graphs": node_graphs}
    except BaseException:
        if node is not None:
            stop_nodes([node], show_logs=True)
            node = None
        raise
    finally:
        if node is not None:
            stop_nodes([node])


# -- main -----------------------------------------------------------------------


def ptxas_report(log: str) -> List[str]:
    """One line per kernel of nvcc's -Xptxas -v log: its (demangled, where
    c++filt is found) name, registers, static shared memory and spills."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True, text=True
                                      ).stdout.strip() or name
            name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


SIM_FIXTURES = os.path.join(REPO, "tests", "data", "sim")


def cpu_name() -> str:
    """The host CPU's model and core count, beside the simulator's wall times."""
    import platform

    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.lower().startswith(("model name", "cpu model", "hardware"))), "")
    except OSError:
        pass
    return f"{model or platform.processor() or platform.machine()}, {os.cpu_count()} cores"


def run_sim(beside: str = "") -> List[Dict[str, Any]]:
    """The `sim` phase: the port's fleet simulator replays the committed
    fixtures (the slow 1000-node sweeps skipped) on the host's CPU; any
    fixture off its gates or its pinned expect (trace hash included) fails.
    `beside` names what shares the host's CPU meanwhile (printed with the
    wall times)."""
    import torch

    from inferd_tpu_torch.sim import scenario as simlib

    phase = "sim"
    mem0 = torch.cuda.memory_allocated()
    paths = simlib.fixture_paths(SIM_FIXTURES)
    slow = len(simlib.fixture_paths(SIM_FIXTURES, include_slow=True)) - len(paths)
    rows, failed = [], []
    t_all = time.perf_counter()
    for path in paths:
        name = os.path.basename(path)
        t0 = time.perf_counter()
        try:
            ok, failures, m = simlib.check_fixture(path)
        except Exception as e:  # a broken fixture is a failure of the phase
            ok, failures, m = False, [f"error: {type(e).__name__}: {e}"], {}
        ms = (time.perf_counter() - t0) * 1e3
        gp = m.get("goodput_ratio")
        events = m.get("trace", {}).get("events")
        summary = f"goodput={gp}" if gp is not None else f"events={events}"
        say(phase, f"{'PASS' if ok else 'FAIL'} {name} ({summary}, trace "
                   f"{m.get('trace', {}).get('hash')}) {ms:.1f} ms wall")
        for msg in failures:
            say(phase, f"    {msg}")
        rows.append({"fixture": name, "ok": ok, "wall_ms": ms})
        if not ok:
            failed.append(name)
    total = time.perf_counter() - t_all
    say(phase, f"{len(paths)} fixtures ({slow} slow skipped), {len(paths) - len(failed)} PASS, in "
               f"{total:.2f}s wall on the host CPU ({cpu_name()}{beside}); no card memory used: "
               f"{torch.cuda.memory_allocated() == mem0}")
    if not paths or failed:
        raise AssertionError(f"{phase}: fixtures failed: {failed or 'none found'}")
    if torch.cuda.memory_allocated() != mem0:
        raise AssertionError(f"{phase}: the simulator allocated card memory")
    return rows


# -- serve_llama: the Llama-3 family from HF checkpoints ----------------------------

LLAMA_MODEL = "llama3.2-1b"  # served at its published width and depth: 16 layers, 8 + 8
LLAMA_WIDE = "llama3.1-8b"  # its published width in process, the depth cut
LLAMA_WIDE_LAYERS = 4
LLAMA_SEEDS = {LLAMA_MODEL: 21, LLAMA_WIDE: 22}  # the weights' seeds (drawn on the card)
LLAMA_REV = "5eed" * 10  # the snapshot's revision in the HF cache layout
LLAMA_SHARDS = 2  # safetensors files per checkpoint: the loader reads a sharded one
LLAMA_PROMPT_LENS = (100, 700)  # the Llama chain's traffic (the second crosses the 512 chunk)
LLAMA_GEN_PROMPT = 0  # the prompt (100 tokens) the generate tool and the wide check run
HF_LAYER_NAMES = {  # the port's stacked layer params -> HF's names ([out, in] when transposed)
    "input_norm": ("input_layernorm.weight", False),
    "post_norm": ("post_attention_layernorm.weight", False),
    "q_proj": ("self_attn.q_proj.weight", True), "k_proj": ("self_attn.k_proj.weight", True),
    "v_proj": ("self_attn.v_proj.weight", True), "o_proj": ("self_attn.o_proj.weight", True),
    "gate_proj": ("mlp.gate_proj.weight", True), "up_proj": ("mlp.up_proj.weight", True),
    "down_proj": ("mlp.down_proj.weight", True),
}
HF_QK_NORMS = {"q_norm": ("self_attn.q_norm.weight", False),
               "k_norm": ("self_attn.k_norm.weight", False)}
MOE_LEAVES = ("router", "gate_proj", "up_proj", "down_proj")  # Qwen3-MoE: mlp.gate, mlp.experts.{e}


def hf_state_dict(params, cfg) -> Dict[str, Any]:
    """A Llama or Qwen3(-MoE) model's params as HF's checkpoint holds them:
    HF's names, linear weights [out, in], bf16, on the host; no
    lm_head.weight when the head is tied. An MoE layer's router is
    `mlp.gate.weight` and its experts `mlp.experts.{e}.{gate,up,down}_proj`:
    each layer's expert stack moves to the host once, every expert a view
    of it."""
    import torch

    names = dict(HF_LAYER_NAMES, **(HF_QK_NORMS if cfg.qk_norm else {}))
    want = set(names) | ({"router"} if cfg.is_moe else set())
    if set(params["layers"]) != want:
        raise AssertionError(f"layer params {sorted(params['layers'])} are not {sorted(want)}")

    def host(t, transpose=False):
        return (t.transpose(-1, -2) if transpose else t).contiguous().to(torch.bfloat16).cpu()

    sd = {"model.embed_tokens.weight": host(params["embed"]),
          "model.norm.weight": host(params["final_norm"])}
    for key, (name, transpose) in names.items():
        if cfg.is_moe and key in MOE_LEAVES:
            continue
        for i in range(cfg.num_layers):
            sd[f"model.layers.{i}.{name}"] = host(params["layers"][key][i], transpose)
    for i in range(cfg.num_layers if cfg.is_moe else 0):
        sd[f"model.layers.{i}.mlp.gate.weight"] = host(params["layers"]["router"][i], True)
        for key in MOE_LEAVES[1:]:
            stack = host(params["layers"][key][i], True)  # [E, out, in]
            for e in range(cfg.num_experts):
                sd[f"model.layers.{i}.mlp.experts.{e}.{key}.weight"] = stack[e]
    if "lm_head" in params:
        sd["lm_head.weight"] = host(params["lm_head"], True)
    return sd


def write_hf_checkpoint(d: str, sd: Dict[str, Any], layers: int,
                        shards: int = LLAMA_SHARDS) -> int:
    """`sd` as `shards` safetensors files in `d`, split by layer as the
    hub's shards are (the embedding with the first layers, the norm and an
    untied head with the last), through the port's writer; the bytes
    written."""
    from inferd_tpu_torch.utils.safetensors_io import save_file

    os.makedirs(d, exist_ok=True)
    per = -(-layers // shards)

    def shard(name: str) -> int:
        if name.startswith("model.layers."):
            return int(name.split(".")[2]) // per
        return 0 if "embed_tokens" in name else shards - 1

    total = 0
    for s in range(shards):
        path = os.path.join(d, f"model-{s + 1:05d}-of-{shards:05d}.safetensors")
        save_file({k: v for k, v in sd.items() if shard(k) == s}, path)
        total += os.path.getsize(path)
    return total


def draw_checkpoint(phase: str, card: str, name: str, cfg, d: str, seed: Optional[int] = None,
               shards: int = LLAMA_SHARDS):
    """`cfg`'s params from its seed (LLAMA_SEEDS'), on the card, written to
    `d` as an HF checkpoint in `shards` files (the parameters, tensor bytes
    and seconds printed); returns the params."""
    import torch

    from inferd_tpu_torch.models import qwen3

    seed = LLAMA_SEEDS[name] if seed is None else seed
    t0 = time.perf_counter()
    params = qwen3.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                               device=DEVICE)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = hf_state_dict(params, cfg)
    nbytes = write_hf_checkpoint(d, sd, cfg.num_layers, shards)
    t_write = time.perf_counter() - t0
    numel = sum(t.numel() for t in sd.values())
    say(phase, f"checkpoint of {name} ({cfg.num_layers} layers, hidden {cfg.hidden_size}, heads "
               f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, vocab {cfg.vocab_size}, "
               f"{'tied' if cfg.tie_word_embeddings else 'untied'} head"
               + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok} x "
                  f"{cfg.moe_intermediate_size}" if cfg.is_moe else "")
               + f"): {len(sd)} tensors, {numel} parameters, {2 * numel} bytes of bf16 "
               f"tensors, {nbytes} bytes in {shards} safetensors files, drawn on the card in "
               f"{t_draw:.2f} s, moved to the host and written in {t_write:.2f} s "
               f"({nbytes / t_write / 1e9:.2f} GB/s) ({card})")
    del sd
    return params, {"bytes": nbytes, "tensor_bytes": 2 * numel, "params": numel,
                    "draw_s": t_draw, "write_s": t_write}


def start_generate_tool(model: str, prompt: List[int], new: int, home: str,
                        layers: int = 0) -> subprocess.Popen:
    """python -m inferd_tpu_torch.tools.generate without --random-init on
    the HF cache at `home`, greedy, started now (a phase's chain serves
    while it loads the whole checkpoint): finish it with tool_ids."""
    return subprocess.Popen(
        [sys.executable, "-m", "inferd_tpu_torch.tools.generate", "--model", model,
         *(["--num-layers", str(layers)] if layers else []),
         "--prompt-ids", ",".join(map(str, prompt)), "--max-new-tokens", str(new),
         "--temperature", "0", "--max-len", str(MAX_LEN), "--device", DEVICE],
        cwd=REPO, env=dict(os.environ, HF_HOME=home), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def tool_ids(phase: str, tool: subprocess.Popen) -> List[int]:
    """The ids a start_generate_tool process printed (exit 0 required)."""
    try:
        out, err = tool.communicate(timeout=600)
    finally:
        if tool.poll() is None:
            tool.kill()
            tool.wait()
    if tool.returncode != 0 or "generated ids:" not in out:
        raise AssertionError(f"{phase}: tools/generate exited {tool.returncode}: "
                             f"{out[-2000:]} {err[-4000:]}")
    return json.loads(out.split("generated ids:", 1)[1].strip())


def serve_beside(phase: str, params, cfg, name: str, parts: str, tool: subprocess.Popen,
                 serve: Callable[[], Dict[str, Any]]) -> tuple:
    """`serve()` (a phase's chain) while, beside it, a thread holds both
    stage files of `parts` to the in-process split of `params`
    (check_stage_files) and the generate tool runs: (serve's result, the
    tool's ids, the seconds until both were done)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        check = pool.submit(check_stage_files, phase, params, cfg, parts, name)
        try:
            out = serve()
            ids = tool_ids(phase, tool)
        finally:
            if tool.poll() is None:
                tool.kill()
                tool.wait()
        check.result()
    return out, ids, time.perf_counter() - t0


def run_serve_llama(card: str, work: str) -> Dict[str, Any]:
    """The `serve_llama` phase: Llama-3.2-1B from an HF checkpoint through
    tools/split_model --weights, two run_node stages, the generate tool
    without --random-init, and Llama-3.1-8B's width in process."""
    import torch

    from inferd_tpu_torch.config import HF_REPOS, SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import Engine
    from inferd_tpu_torch.models.loader import load_params
    from inferd_tpu_torch.parallel.stages import stage_checkpoint_path
    from inferd_tpu_torch.tools import split_model

    phase = "serve_llama"
    t_phase = time.perf_counter()
    cfg = get_config(LLAMA_MODEL)
    greedy = SamplingConfig(temperature=0.0)
    home = os.path.join(work, "hf")
    repo = os.path.join(home, "hub",
                        "models--" + HF_REPOS.get(LLAMA_MODEL, LLAMA_MODEL).replace("/", "--"))
    snap = os.path.join(repo, "snapshots", LLAMA_REV)
    params, ckpt = draw_checkpoint(phase, card, LLAMA_MODEL, cfg, snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(LLAMA_REV)
    parts = os.path.join(work, "llama_parts")
    t0 = time.perf_counter()
    split_model.main(["--model", LLAMA_MODEL, "--stages", "2", "--weights", snap, "--out", parts,
                      "--device", DEVICE])
    t_split = time.perf_counter() - t0
    torch.cuda.empty_cache()
    say(phase, f"tools/split_model --weights <snapshot> --device {DEVICE}: loaded and split in "
               f"{t_split:.2f} s ({os.path.getsize(stage_checkpoint_path(parts, 0))} + "
               f"{os.path.getsize(stage_checkpoint_path(parts, 1))} bytes)")

    free, total = torch.cuda.mem_get_info()
    say(phase, f"the card before its node processes start: {free / 2**30:.2f} GiB free of "
               f"{total / 2**30:.2f} GiB ({card})")
    # beside the chain: the stage files held to the in-process split of the
    # drawn params, and the generate tool without --random-init from the HF
    # cache (its ids held to an Engine over load_params of the snapshot)
    prompt = serve_prompts(cfg.vocab_size, LLAMA_PROMPT_LENS)[LLAMA_GEN_PROMPT]
    tool = start_generate_tool(LLAMA_MODEL, prompt, NEW_TOKENS, home)
    serve, got_ids, t_beside = serve_beside(
        phase, params, cfg, LLAMA_MODEL, parts, tool,
        lambda: run_serve(card, parts, work, model=LLAMA_MODEL, phase=phase,
                          prompt_lens=LLAMA_PROMPT_LENS))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loaded = load_params(cfg, snap, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    eng = Engine(cfg, loaded, max_len=MAX_LEN, sampling_cfg=greedy)
    want = eng.generate(prompt, NEW_TOKENS)
    del eng, loaded
    torch.cuda.empty_cache()
    if got_ids != want:
        raise AssertionError(f"{phase}: tools/generate's ids differ from the Engine's from token "
                             f"{first_divergence(got_ids, want)}")
    chain = serve["streams"][LLAMA_GEN_PROMPT]
    say(phase, f"tools/generate --model {LLAMA_MODEL} (no --random-init, HF_HOME the cache; "
               f"beside the chain) exited 0: its {len(got_ids)} ids equal an Engine over "
               f"load_params of the snapshot (loaded to the card in {t_load:.2f} s, "
               f"{ckpt['bytes'] / t_load / 1e9:.2f} GB/s, warm); they share their first "
               f"{first_divergence(got_ids, chain)} of {NEW_TOKENS} tokens with the chain's "
               f"stream of the {len(prompt)}-token prompt (printed, not gated: other buffers, "
               f"other split plans) ({card})")
    wide = run_llama_wide(phase, card, work)
    say(phase, f"lap {time.perf_counter() - t_phase:.1f} s")
    counts = {k: serve[k] for k in ("launches", "flash_routes", "gemv_routes")}
    for k in ("launches", "flash_routes"):
        for name, v in wide[k].items():
            counts[k][name] += v
    return dict(counts, streams=serve["streams"], rates=serve["rates"],
                step_share=serve["step_share"], checkpoint=ckpt, split_s=t_split,
                load_s=t_load, serve_beside_s=t_beside, wide=wide)


def run_llama_wide(phase: str, card: str, work: str) -> Dict[str, Any]:
    """Llama-3.1-8B's published width (untied head) cut to LLAMA_WIDE_LAYERS
    layers, in this process: its HF checkpoint loaded to the card equals
    the drawn params; the Engine's graphed greedy stream equals the eager
    one with flash_gqa launches exact; teacher-forced, the kernel path
    holds against plain attention and the planted faults do not."""
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import Engine
    from inferd_tpu_torch.models.loader import load_params
    from inferd_tpu_torch.parallel.stages import StageSpec

    cfg = get_config(LLAMA_WIDE).with_layers(LLAMA_WIDE_LAYERS)
    d = os.path.join(work, "llama_wide")
    drawn, ckpt = draw_checkpoint(phase, card, LLAMA_WIDE, cfg, d)
    t0 = time.perf_counter()
    params = load_params(cfg, d, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    shutil.rmtree(d)
    differ = [k for k in drawn if k != "layers" and not torch.equal(params[k], drawn[k])]
    differ += [k for k, v in drawn["layers"].items() if not torch.equal(params["layers"][k], v)]
    if params.keys() != drawn.keys():
        differ.append(f"keys {sorted(params)}")
    del drawn
    torch.cuda.empty_cache()
    if differ:
        raise AssertionError(f"{phase}: {LLAMA_WIDE} loaded params differ from the drawn: {differ}")
    say(phase, f"{LLAMA_WIDE} x {LLAMA_WIDE_LAYERS} layers: load_params to the card in "
               f"{t_load:.2f} s ({ckpt['bytes'] / t_load / 1e9:.2f} GB/s, warm), every "
               f"parameter equal to the drawn one ({card})")
    prompt = serve_prompts(cfg.vocab_size, LLAMA_PROMPT_LENS)[LLAMA_GEN_PROMPT]
    greedy = SamplingConfig(temperature=0.0)
    eng = Engine(cfg, params, max_len=MAX_LEN, sampling_cfg=greedy)
    reset_kernel_counts()
    t0 = time.perf_counter()
    stream = eng.generate(prompt, NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    check_flash_routes(phase, counts, 1, cfg.num_layers)
    others = {k: v for k, v in counts["launches"].items() if k != "flash_gqa"}
    if any(others.values()):
        raise AssertionError(f"{phase}: {LLAMA_WIDE} launched {others}")
    graphs = eng.graph_stats()
    eager = Engine(cfg, params, max_len=MAX_LEN, sampling_cfg=greedy)
    eager.graphs = None
    e = eager.generate(prompt, NEW_TOKENS)
    del eng, eager
    if e != stream:
        raise AssertionError(f"{phase}: {LLAMA_WIDE}'s graphed stream differs from the eager one "
                             f"from token {first_divergence(e, stream)}")
    say(phase, f"{LLAMA_WIDE} x {LLAMA_WIDE_LAYERS}: {NEW_TOKENS} greedy tokens of the "
               f"{len(prompt)}-token prompt in {wall:.2f} s through the graphed Engine "
               f"({graphs}), equal to the eager step's stream")
    LastStageProbe = _last_stage_probe_class()
    spec = StageSpec(stage=0, num_stages=1, start_layer=0, end_layer=cfg.num_layers - 1)
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    check_kernel_path(f"{phase} {LLAMA_WIDE}", cfg,
                      [LastStageProbe(cfg, spec, params, max_len=MAX_LEN)],
                      [LastStageProbe(plain_cfg, spec, params, max_len=MAX_LEN)],
                      [prompt], [stream], contextlib.nullcontext, planted_attention_fault,
                      E2E_FAULTS, "plain attention")
    del params
    torch.cuda.empty_cache()
    return dict(counts, checkpoint=ckpt, load_s=t_load, stream=stream)


# -- serve_moe: mixture-of-experts models --------------------------------------------------

MOE_MODEL = "qwen3-moe-30b-a3b"  # its published width; MOE_LAYERS of its 48 layers, 3 + 3
MOE_LAYERS = 6
MOE_WIDE = "mixtral-8x7b"  # its published width in process, MOE_WIDE_LAYERS of its 32 layers
MOE_WIDE_LAYERS = 2
MOE_SEEDS = {MOE_MODEL: 31, MOE_WIDE: 32}  # the weights' seeds (drawn on the card)
MOE_SHARDS = 4  # safetensors files of the Qwen3-MoE checkpoint
MOE_PROMPT_LENS = (100, 700)  # the chain's traffic: the second crosses the client's 512 chunk
MOE_NEW_TOKENS = 16
MOE_GEN_PROMPT = 0  # the generate tool's prompt: the 100-token one (the chain's shapes)
MOE_INPROC_LAYERS = 3  # the paged lanes (2 + 1 layers) and the quantized engines
MOE_LANE_PROMPT_LENS = (16, 100, 300, 700)  # the paged lanes' four sessions
MOE_WIDE_PROMPT = 300


def moe_layer_time(phase: str, card: str, name: str, cfg, layers) -> Dict[str, Any]:
    """One MoE layer (models/qwen3.moe_mlp) on a decode row, captured in a
    CUDA graph and replayed (CUDA events; its weights far exceed L2), beside
    its bounds: perf/roofline's (the router and the top-k experts a token
    uses) and the bytes dense dispatch reads (every expert's weights)."""
    import torch

    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.perf import roofline as rl

    lp = {k: v[0] for k, v in layers.items()}
    x = torch.randn((1, 1, cfg.hidden_size), generator=torch.Generator(device=DEVICE)
                    .manual_seed(0), device=DEVICE).to(cfg.torch_dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            qwen3.moe_mlp(lp, cfg, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qwen3.moe_mlp(lp, cfg, x)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, qwen3.moe_mlp(lp, cfg, x)):
        raise AssertionError(f"{phase}: {name}'s graphed MoE layer differs from the eager one")
    ms = time_ms(graph.replay)
    eager_ms = time_ms(lambda: qwen3.moe_mlp(lp, cfg, x), iters=10)
    active = rl.decode_step_cost(cfg.with_layers(1)).mlp_weight_bytes
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    dense = (3 * e * h * i + h * e) * torch.finfo(cfg.torch_dtype).bits // 8
    bound_ms, dense_ms = active / HBM_BYTES_PER_S * 1e3, dense / HBM_BYTES_PER_S * 1e3
    say(phase, f"{name}: one MoE layer at a decode row (dense dispatch: {e} experts of "
               f"{h} x {i}, top-{cfg.num_experts_per_tok}), graphed {ms:.4f} ms (eager "
               f"{eager_ms:.4f} ms); roofline bound (the router and the "
               f"{cfg.num_experts_per_tok} active experts, {active} bytes) {bound_ms:.4f} ms, "
               f"{bound_ms / ms:.1%} of the measured; every expert's weights ({dense} bytes, "
               f"what dense dispatch reads) {dense_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} "
               f"TB/s ({card})")
    del graph, out
    return {"ms": ms, "eager_ms": eager_ms, "bound_ms": bound_ms, "active_bytes": active,
            "dense_bytes": dense, "dense_read_ms": dense_ms}


def check_stage_files(phase: str, params, cfg, parts: str, name: str) -> None:
    """Both stage files of `parts` hold, byte for byte, what the port's
    split of `params` writes (stages.stage_checkpoint_bytes, built here in
    memory); the chunked leaves (flax's form past MAX_CHUNK_SIZE) counted."""
    from inferd_tpu_torch.parallel import flax_format
    from inferd_tpu_torch.parallel.stages import (Manifest, extract_stage_params,
                                                  stage_checkpoint_path, stage_checkpoint_pieces)

    ordered = dict(params, layers=dict(sorted(params["layers"].items())))
    manifest = Manifest.even_split(name, 2, num_layers=cfg.num_layers)
    for spec in manifest.stage_specs():
        stage = extract_stage_params(ordered, cfg, spec)
        want = stage_checkpoint_pieces(stage, spec, name)
        size = sum(memoryview(b).nbytes for b in want)
        path = stage_checkpoint_path(parts, spec.stage)
        same = os.path.getsize(path) == size
        with open(path, "rb") as f:
            for piece in want:
                if not same:
                    break
                mv = memoryview(piece).cast("B")
                for at in range(0, len(mv), 64 << 20):
                    part = mv[at:at + (64 << 20)]
                    if f.read(len(part)) != part:
                        same = False
                        break
        chunked = [k for k, v in stage["layers"].items()
                   if v.numel() * v.element_size() > flax_format.MAX_CHUNK_SIZE]
        say(phase, f"stage {spec.stage} (layers {spec.start_layer}-{spec.end_layer}): "
                   f"{size} bytes, equal to the in-process split byte for byte: {same}; "
                   f"leaves past {flax_format.MAX_CHUNK_SIZE} bytes, written chunked: {chunked}")
        if not same:
            raise AssertionError(f"{phase}: stage {spec.stage} split from the checkpoint differs "
                                 "from the in-process split of the same params")
        if cfg.is_moe and not {"gate_proj", "up_proj", "down_proj"} <= set(chunked):
            raise AssertionError(f"{phase}: stage {spec.stage}'s expert stacks are not chunked")
        del want, stage


def lane_streams(executors, prompts, new: int) -> List[List[int]]:
    """Greedy streams through lane executors: each prompt's 512-token
    chunks one session at a time, then every session's decode steps
    co-batched, one process_batch per stage per step."""
    import numpy as np

    sids = [f"lanes-{i}" for i in range(len(prompts))]
    toks = []
    for sid, p in zip(sids, prompts):
        for c in range(0, len(p), 512):
            out = {"tokens": np.asarray([p[c:c + 512]], np.int32), "start_pos": c,
                   "real_len": len(p[c:c + 512])}
            for ex in executors:
                out = ex.process(sid, out)
        toks.append([int(out["logits"].float().argmax(-1)[0])])
    for j in range(new - 1):
        items = [(sid, {"tokens": [[t[-1]]], "start_pos": len(p) + j, "real_len": 1})
                 for sid, p, t in zip(sids, prompts, toks)]
        for ex in executors:
            outs = ex.process_batch(items)
            for o in outs:
                if isinstance(o, Exception):
                    raise o
            items = [(sid, {"hidden": o.get("hidden"), "start_pos": o["start_pos"],
                            "real_len": o["real_len"]}) for (sid, _), o in zip(items, outs)]
        for t, o in zip(toks, outs):
            t.append(int(o["logits"].float().argmax(-1)[0]))
    for ex in executors:
        for sid in sids:
            ex.end_session(sid)
    return toks


def moe_paged_lanes(phase: str, card: str, cfg, loaded) -> Dict[str, Any]:
    """The paged lane executors (bs PAGED_BS, two stages of the cut model)
    serve four sessions co-batched, graphed, token for token equal to the
    same executors eager; paged_decode_gqa and flash_gqa launches exact;
    then teacher-forced, the kernel path near plain attention and the
    planted paged faults not."""
    from inferd_tpu_torch.ops import attention as A
    from inferd_tpu_torch.ops.attention import paged_plan

    prompts = serve_prompts(cfg.vocab_size, MOE_LANE_PROMPT_LENS)
    reset_kernel_counts()
    t0 = time.perf_counter()
    graphed = lane_executors(cfg, loaded, PAGED_BS, False)
    streams = lane_streams(graphed, prompts, MOE_NEW_TOKENS)
    wall = time.perf_counter() - t0
    graphs = [ex.stats()["graphs"] for ex in graphed]
    widths = [dict(ex.stats()["decode_widths"]) for ex in graphed]
    del graphed
    eager_streams = lane_streams(eager_lanes(cfg, loaded, PAGED_BS, False), prompts,
                                 MOE_NEW_TOKENS)
    counts = kernel_counts()
    counts["paged_split"] = A.paged_decode_gqa.split_launches
    if eager_streams != streams:
        bad = next(i for i, (a, b) in enumerate(zip(streams, eager_streams)) if a != b)
        raise AssertionError(f"{phase}: paged lanes, prompt {len(prompts[bad])}: graphed != eager "
                             f"from token {first_divergence(streams[bad], eager_streams[bad])}")
    layers = cfg.num_layers
    steps = MOE_NEW_TOKENS - 1
    chunks = sum(-(-len(p[c:c + 512]) // LANE_PREFILL_CHUNK) for p in prompts
                 for c in range(0, len(p), 512))
    splits = sum(layers * n for w, n in widths[0].items()
                 if paged_plan(LANES, cfg.num_kv_heads, int(w), PAGED_BS,
                               cfg.torch_dtype).splits > 1)
    want = {"paged_decode_gqa": 2 * layers * steps, "paged_split": 2 * splits,
            "flash_mma": 2 * layers * chunks, "flash_split": 0}
    got = {"paged_decode_gqa": counts["launches"]["paged_decode_gqa"],
           "paged_split": counts["paged_split"], "flash_mma": counts["flash_routes"]["mma"],
           "flash_split": counts["flash_routes"]["split"]}
    say(phase, f"paged lanes ({len(prompts)} sessions of {list(MOE_LANE_PROMPT_LENS)} tokens, "
               f"{MOE_NEW_TOKENS} greedy tokens each, {steps} co-batched decode steps, "
               f"{layers} layers as 2 + 1, bs {PAGED_BS}): graphed in {wall:.1f} s, equal to the "
               f"eager lanes token for token; graphs per stage {graphs}; decode widths "
               f"{widths}; launches {got} (want {want}: {got == want}) ({card})")
    if got != want or counts["launches"]["w8a16_matmul"] or counts["launches"]["w4a16_matvec"]:
        raise AssertionError(f"{phase}: paged lanes launched {counts}, want {want}")
    check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS, prompts, streams,
                         faults=LANE_E2E_FAULTS)
    return counts


def dequantized(tree, dtype):
    """A quantized param tree with every quantized weight widened back to
    `dtype` (the explicitly dequantized model)."""
    from inferd_tpu_torch.ops import quant

    if isinstance(tree, dict):
        return {k: dequantized(v, dtype) for k, v in tree.items()}
    return tree.dequantize(dtype) if isinstance(tree, quant.QTYPES) else tree


# The quantized MoE engines against the explicitly dequantized one, teacher-
# forced in float32: in bf16 two roundings of the same model flip the
# router's top-8 at its near-ties (random weights leave the 8th and 9th
# experts' logits a few bf16 ulps apart; a flip moves the logits by a few %
# of max |logit| with no fault), so the bf16 engines serve the main path
# (streams, launches) and the comparison runs on the same quantized bytes
# with f32 activations (the GEMVs' f32 route), where the two differ only by
# float32 summation order. Planted faults: the GEMV ones of the quantized
# serve phases and each expert contraction reading the next expert's
# scales, every one of which must exceed the limit.
MOE_QUANT_TOL = 1e-3  # share of max |logit|
MOE_QUANT_FAULTS = QUANT_E2E_FAULTS + ("expert_scale_rolled",)


@contextlib.contextmanager
def planted_moe_quant_fault(fault: str):
    """A GEMV fault (planted_gemv_fault), or with "expert_scale_rolled"
    every quantized expert contraction (models/qwen3's qeinsum) run with
    each expert's scales taken from the next expert, until the block ends."""
    if fault != "expert_scale_rolled":
        with planted_gemv_fault(fault):
            yield
        return
    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.ops import quant

    real = qwen3.qeinsum

    def faulty(spec, x, w):
        if isinstance(w, quant.QTYPES):
            w = dataclasses.replace(w, scale=w.scale.roll(1, dims=0))
        return real(spec, x, w)

    qwen3.qeinsum = faulty
    try:
        yield
    finally:
        qwen3.qeinsum = real


def moe_quant_engines(phase: str, card: str, cfg, params) -> Dict[str, Any]:
    """--quant int8 and int4 (as tools/generate and run_node quantize) on
    the cut model: the bf16 Engine's graphed greedy streams of the
    serve_moe prompts with the GEMV launches exact per route (the four
    attention projections of every layer and the head at each decode row;
    the expert stacks contract in qeinsum); then teacher-forced over those
    streams in float32 (MOE_QUANT_TOL above), the quantized Engine's
    logits against the explicitly dequantized Engine's, and the planted
    MOE_QUANT_FAULTS outside the limit."""
    import torch

    from inferd_tpu_torch.config import SamplingConfig
    from inferd_tpu_torch.core.generate import Engine, bucket_len
    from inferd_tpu_torch.ops import quant
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS

    prompts = serve_prompts(cfg.vocab_size, MOE_PROMPT_LENS)
    greedy = SamplingConfig(temperature=0.0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    total: Dict[str, Any] = {}
    for flag in ("int8", "int4"):
        qp = quant.apply_quant_mode(flag, params, cfg.tie_word_embeddings)
        eng = Engine(cfg, qp, max_len=MAX_LEN, sampling_cfg=greedy)
        reset_kernel_counts()
        streams = [eng.generate(p, MOE_NEW_TOKENS) for p in prompts]
        counts = kernel_counts()
        graphs = eng.graph_stats()
        nbytes = quant.quantized_bytes(qp)
        del eng, qp
        small = [r for p in prompts for r in [bucket_len(len(p))] + [1] * (MOE_NEW_TOKENS - 1)
                 if r <= MAX_KERNEL_ROWS]
        name = QMM_KERNEL_OF[flag]
        want = gemv_route_launches(cfg, flag, cfg.num_layers, True, small,
                                   [1] * (MOE_NEW_TOKENS * len(prompts)))
        got = counts["gemv_routes"][name]
        other = QMM_KERNEL_OF["int4" if flag == "int8" else "int8"]
        say(phase, f"--quant {flag} ({nbytes} parameter bytes): {len(prompts)} greedy streams of "
                   f"{MOE_NEW_TOKENS} tokens through the graphed bf16 Engine ({graphs}); {name} "
                   f"routes {got} (want {want}: {got == want}) ({card})")
        check_flash_routes(phase, counts, len(prompts), cfg.num_layers, MOE_NEW_TOKENS)
        if (got != want or counts["launches"][name] != sum(want.values())
                or counts["launches"][other] or counts["launches"]["paged_decode_gqa"]):
            raise AssertionError(f"{phase}: --quant {flag} launched {counts}, want {want}")
        for k in ("launches", "flash_routes", "gemv_routes"):
            add_counts(total, {k: counts[k]})

        qp32 = quant.apply_quant_mode(flag, params32, cfg.tie_word_embeddings)
        deq = Engine(cfg32, dequantized(qp32, torch.float32), max_len=MAX_LEN,
                     sampling_cfg=greedy)
        deq.graphs = None
        ref = forced_logits(deq, prompts, streams)
        del deq
        eng = Engine(cfg32, qp32, max_len=MAX_LEN, sampling_cfg=greedy)
        eng.graphs = None  # the faults are planted in Python: no graph may hold the sound step

        def reading():
            got_l = forced_logits(eng, prompts, streams)
            return max((g - r).abs().max().item() / r.abs().max().item()
                       for g, r in zip(got_l, ref))

        readings = {"sound": reading()}
        for f in MOE_QUANT_FAULTS:
            with planted_moe_quant_fault(f):
                readings[f] = reading()
        say(phase, f"--quant {flag}, float32 activations, teacher-forced over {len(ref)} steps "
                   f"against the explicitly dequantized Engine: logits "
                   + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
                   + f" of max |logit| (tol {MOE_QUANT_TOL:g}: the sound path within, every "
                   f"fault outside) ({card})")
        if not readings["sound"] <= MOE_QUANT_TOL:
            raise AssertionError(f"{phase}: --quant {flag} vs the dequantized engine: {readings}")
        missed = [f for f in MOE_QUANT_FAULTS if not readings[f] > MOE_QUANT_TOL]
        if missed:
            raise AssertionError(f"{phase}: --quant {flag}: planted faults {missed} pass: "
                                 f"{readings}")
        del eng, qp32, ref
        torch.cuda.empty_cache()
    del params32
    return total


def add_counts(total: Dict[str, Any], more: Dict[str, Any]) -> Dict[str, Any]:
    """Sum nested dicts of launch counts into `total`."""
    for k, v in more.items():
        if isinstance(v, dict):
            add_counts(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v
    return total


def run_moe_wide(phase: str, card: str) -> Dict[str, Any]:
    """Mixtral-8x7B's published width (8 experts top-2 of 14336, untied
    head) cut to MOE_WIDE_LAYERS layers, drawn on the card: its MoE layer
    timed, and the graphed Engine's greedy stream of a 300-token prompt
    equal to the eager one with flash_gqa launches exact."""
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import Engine
    from inferd_tpu_torch.models import qwen3

    cfg = get_config(MOE_WIDE).with_layers(MOE_WIDE_LAYERS)
    params = qwen3.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(MOE_SEEDS[MOE_WIDE]),
                               device=DEVICE)
    layer = moe_layer_time(phase, card, f"{MOE_WIDE} x {MOE_WIDE_LAYERS}", cfg, params["layers"])
    prompt = serve_prompts(cfg.vocab_size, (MOE_WIDE_PROMPT,))[0]
    greedy = SamplingConfig(temperature=0.0)
    eng = Engine(cfg, params, max_len=MAX_LEN, sampling_cfg=greedy)
    reset_kernel_counts()
    t0 = time.perf_counter()
    stream = eng.generate(prompt, MOE_NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    check_flash_routes(phase, counts, 1, cfg.num_layers, MOE_NEW_TOKENS)
    others = {k: v for k, v in counts["launches"].items() if k != "flash_gqa"}
    graphs = eng.graph_stats()
    eager = Engine(cfg, params, max_len=MAX_LEN, sampling_cfg=greedy)
    eager.graphs = None
    e = eager.generate(prompt, MOE_NEW_TOKENS)
    del eng, eager, params
    torch.cuda.empty_cache()
    if any(others.values()):
        raise AssertionError(f"{phase}: {MOE_WIDE} launched {others}")
    if e != stream:
        raise AssertionError(f"{phase}: {MOE_WIDE}'s graphed stream differs from the eager one "
                             f"from token {first_divergence(e, stream)}")
    say(phase, f"{MOE_WIDE} x {MOE_WIDE_LAYERS} (hidden {cfg.hidden_size}, heads "
               f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, {cfg.num_experts} experts "
               f"top-{cfg.num_experts_per_tok} x {cfg.moe_intermediate_size}, vocab "
               f"{cfg.vocab_size}, {'tied' if cfg.tie_word_embeddings else 'untied'} head), "
               f"drawn on the card: {MOE_NEW_TOKENS} greedy "
               f"tokens of the {len(prompt)}-token prompt in {wall:.2f} s through the graphed "
               f"Engine ({graphs}), equal to the eager step's stream")
    return dict(counts, layer=layer, stream=stream)


def run_serve_moe(card: str, work: str) -> Dict[str, Any]:
    """The `serve_moe` phase: Qwen3-30B-A3B at its published width, 6 of
    its 48 layers, from an HF checkpoint in Qwen3-MoE's names through
    tools/split_model --weights --num-layers 6 (chunked stage files), two
    run_node stages, the generate tool; in process at 3 layers the paged
    lanes and --quant int8 / int4; Mixtral-8x7B's width at 2 layers."""
    import torch

    from inferd_tpu_torch.config import HF_REPOS, get_config
    from inferd_tpu_torch.parallel.stages import StageSpec, extract_stage_params
    from inferd_tpu_torch.tools import split_model

    phase = "serve_moe"
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    say(phase, f"the card before the phase: {free / 2**30:.2f} GiB free of "
               f"{total / 2**30:.2f} GiB ({card})")
    cfg = get_config(MOE_MODEL).with_layers(MOE_LAYERS)
    home = os.path.join(work, "hf_moe")
    repo = os.path.join(home, "hub",
                        "models--" + HF_REPOS.get(MOE_MODEL, MOE_MODEL).replace("/", "--"))
    snap = os.path.join(repo, "snapshots", LLAMA_REV)
    params, ckpt = draw_checkpoint(phase, card, MOE_MODEL, cfg, snap, seed=MOE_SEEDS[MOE_MODEL],
                              shards=MOE_SHARDS)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(LLAMA_REV)
    layer = moe_layer_time(phase, card, f"{MOE_MODEL} x {MOE_LAYERS}", cfg, params["layers"])
    parts = os.path.join(work, "moe_parts")
    t0 = time.perf_counter()
    split_model.main(["--model", MOE_MODEL, "--num-layers", str(MOE_LAYERS), "--stages", "2",
                      "--weights", snap, "--out", parts, "--device", DEVICE])
    torch.cuda.synchronize()
    t_split = time.perf_counter() - t0
    torch.cuda.empty_cache()
    say(phase, f"tools/split_model --weights <snapshot> --num-layers {MOE_LAYERS} --device "
               f"{DEVICE}: loaded and split in {t_split:.2f} s ({card})")

    # beside the chain: the stage files held byte for byte to the in-process
    # split of the drawn params, and the generate tool without --random-init
    # from the HF cache (it loads the whole checkpoint), held to the chain's ids
    prompt = serve_prompts(cfg.vocab_size, MOE_PROMPT_LENS)[MOE_GEN_PROMPT]
    tool = start_generate_tool(MOE_MODEL, prompt, MOE_NEW_TOKENS, home, layers=MOE_LAYERS)
    serve, got_ids, t_beside = serve_beside(
        phase, params, cfg, MOE_MODEL, parts, tool,
        lambda: run_serve(card, parts, work, model=MOE_MODEL, phase=phase, cfg=cfg,
                          prompt_lens=MOE_PROMPT_LENS, new_tokens=MOE_NEW_TOKENS))
    # the in-process checks' model: the first MOE_INPROC_LAYERS layers, as two stages
    small = cfg.with_layers(MOE_INPROC_LAYERS)
    cut = dict(params, layers={k: v[:MOE_INPROC_LAYERS].clone()
                               for k, v in params["layers"].items()})
    del params
    torch.cuda.empty_cache()
    chain = serve["streams"][MOE_GEN_PROMPT]
    say(phase, f"tools/generate --model {MOE_MODEL} --num-layers {MOE_LAYERS} (no --random-init, "
               f"HF_HOME the cache; beside the chain) exited 0: "
               f"{len(got_ids)} ids; equal to the chain's stream of the {len(prompt)}-token "
               f"prompt: {got_ids == chain}")
    if got_ids != chain:
        raise AssertionError(f"{phase}: tools/generate's ids differ from the chain's from token "
                             f"{first_divergence(got_ids, chain)}")
    shutil.rmtree(home)

    # in process, MOE_INPROC_LAYERS layers: the paged lanes, the quantized engines
    specs = [StageSpec(0, 2, 0, MOE_INPROC_LAYERS - 2),
             StageSpec(1, 2, MOE_INPROC_LAYERS - 1, MOE_INPROC_LAYERS - 1)]
    loaded = [(extract_stage_params(cut, small, spec), spec, MOE_MODEL) for spec in specs]
    lanes = moe_paged_lanes(phase, card, small, loaded)
    del loaded
    quant_counts = moe_quant_engines(phase, card, small, cut)
    del cut
    torch.cuda.empty_cache()
    wide = run_moe_wide(phase, card)
    say(phase, f"lap {time.perf_counter() - t_phase:.1f} s")
    counts = {k: serve[k] for k in ("launches", "flash_routes", "gemv_routes")}
    for more in (lanes, quant_counts, wide):
        add_counts(counts, {k: more[k] for k in ("launches", "flash_routes", "gemv_routes")})
    return dict(counts, streams=serve["streams"], rates=serve["rates"],
                step_share=serve["step_share"], checkpoint=ckpt, split_s=t_split,
                serve_beside_s=t_beside, layer=layer, wide_layer=wide["layer"],
                paged_split=lanes["paged_split"])


CASE_PHASES = {"flash": run_kernel_cases, "paged": run_paged_cases, "qmm": run_qmm_cases,
               "lora": run_lora_cases, "codec": run_codec, "sim": run_sim}
# --only phases that need the model's split (serve_quant runs int8 and int4;
# serve_lanes_lora runs serve_lanes first, its baseline; serve_tenant_routes
# runs serve_lanes and serve_lanes_lora first, its streams; serve_swarm runs
# serve and serve_lanes first, the streams it is held to; serve_overload and
# serve_elastic run serve first; serve_batch runs generate_batched first, its
# streams; serve_llama and serve_moe write and split their own checkpoints)
SPLIT_PHASES = ("serve", "serve_quant", "serve_lanes", "serve_lanes_quant", "serve_lanes_lora",
                "serve_tenant_routes", "serve_sessions", "serve_standby", "serve_swarm",
                "serve_overload", "serve_elastic",
                "generate", "generate_batched", "serve_batch", "serve_kstep", "serve_fp8",
                "anatomy", "profile", "serve_llama", "serve_moe")
OWN_CHECKPOINT = {"serve_llama": run_serve_llama, "serve_moe": run_serve_moe}


def main(argv: List[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port end to end on one CUDA card.")
    ap.add_argument("--only", default="", help="comma-separated phases to run alone "
                    f"({', '.join(CASE_PHASES)}, {', '.join(SPLIT_PHASES)}: on a fresh split; "
                    "generate runs the generate and generate_quant phases), after the build; "
                    "the default runs every phase")
    only = [x for x in ap.parse_args(argv).only.split(",") if x]
    if any(x not in CASE_PHASES and x not in SPLIT_PHASES for x in only):
        ap.error(f"--only takes {sorted(CASE_PHASES) + list(SPLIT_PHASES)}, got {only}")

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "inferd_tpu_torch")):
        print(f"chip_smoke: no inferd_tpu_torch package beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("gpu", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")

    from concurrent.futures import ThreadPoolExecutor

    from inferd_tpu_torch import native
    from inferd_tpu_torch.ops import build

    def build_all(meanwhile: Callable[[], Any] = lambda: None) -> Any:
        """One nvcc per source and the wire codec's C++ compiler, all at
        once, with `meanwhile` run in this thread as they compile (node
        processes it starts wait for each library's build lock, then load
        it); the build report printed; returns what `meanwhile` did."""
        with ThreadPoolExecutor(len(build.KERNELS) + 1) as pool:
            codec = pool.submit(native.build)
            kernels = [pool.submit(build.build, name) for name in build.KERNELS]
            done = meanwhile()
            infos = dict(zip(build.KERNELS, (f.result() for f in kernels)))
            codec_info = codec.result()
        for name, info in infos.items():
            regs = ptxas_report(info["log"])
            say("build", f"{name}: {os.path.relpath(info['path'], REPO)} "
                         f"({'built' if info['built'] else 'cached'} in {info['seconds']:.1f}s); "
                         f"ptxas ({len(regs)} kernels): {regs}")
        say("build", f"wire codec: {os.path.relpath(codec_info['path'], REPO)} "
                     f"({'built' if codec_info['built'] else 'cached'} in "
                     f"{codec_info['seconds']:.1f}s with {native.compiler()})")
        return done

    if only:  # a partial run: the named phases, no serve phases and no result lines
        build_all()
        for name in only:
            if name in CASE_PHASES:
                CASE_PHASES[name]()
        split_only = [x for x in only if x in SPLIT_PHASES and x not in OWN_CHECKPOINT]
        for name, run in OWN_CHECKPOINT.items():
            if name in only:
                work = tempfile.mkdtemp(prefix="chip_smoke_")
                try:
                    run(card, work)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
        if split_only:
            work = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                parts = split_parts(work)
                serve = None
                if {"serve", "serve_swarm", "serve_overload", "serve_elastic"} & set(split_only):
                    serve = run_serve(card, parts, work)
                if "serve_quant" in split_only:
                    for q in ("int8", "int4"):
                        run_serve(card, parts, work, quant_flag=q, prompt_lens=ENGINE_PROMPT_LENS)
                lanes = None
                if {"serve_lanes", "serve_lanes_lora", "serve_swarm",
                        "serve_tenant_routes"} & set(split_only):
                    lanes = run_serve_lanes(card, parts, work)
                if "serve_swarm" in split_only:
                    run_serve_swarm(card, parts, work, serve, lanes)
                overload = None
                if "serve_overload" in split_only:
                    t_overload = time.perf_counter()
                    overload = run_serve_overload(card, parts, work, serve)
                    say("time", f"serve_overload: {time.perf_counter() - t_overload:.1f}s")
                if "serve_elastic" in split_only:
                    t_elastic = time.perf_counter()
                    run_serve_elastic(card, parts, work, serve)
                    say("time", f"serve_elastic: {time.perf_counter() - t_elastic:.1f}s")
                if "serve_lanes_quant" in split_only:
                    run_serve_lanes(card, parts, work, quant_flag="int8", baseline=lanes)
                if {"serve_lanes_lora", "serve_tenant_routes"} & set(split_only):
                    lanes_lora = run_serve_lanes_lora(card, parts, work, baseline=lanes)
                    if "serve_tenant_routes" in split_only:
                        t_tenant = run_serve_tenant_routes(card, parts, work, lanes,
                                                           lanes_lora)["wall_s"]
                        say("time", f"serve_tenant_routes: {t_tenant:.1f}s")
                if "profile" in split_only:
                    run_profile(card, parts, work)
                whole = whole_model(parts)
                if "serve_sessions" in split_only:
                    t_sessions = run_serve_sessions(card, parts, one_stage_parts(work, whole),
                                                    work)["wall_s"]
                    say("time", f"serve_sessions: {t_sessions:.1f}s")
                if "serve_standby" in split_only:
                    t_standby = run_serve_standby(card, parts, whole, work, overload)["wall_s"]
                    say("time", f"serve_standby: {t_standby:.1f}s")
                if "generate" in split_only:
                    run_generate(card, whole, None)
                    run_generate_quant(card, whole)
                if {"generate_batched", "serve_batch"} & set(split_only):
                    gen_b = run_generate_batched(card, whole)
                    if "serve_batch" in split_only:
                        run_serve_batch(card, whole, work, gen_b)
                if "serve_kstep" in split_only:
                    run_serve_kstep(card, whole, parts, work)
                if "serve_fp8" in split_only:
                    run_serve_fp8(card, whole, work, serve)
                if "anatomy" in split_only:
                    run_anatomy(card, whole)
                del whole
            finally:
                shutil.rmtree(work, ignore_errors=True)
        say("done", f"phases {only} passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    lap_at = [time.perf_counter()]

    def lap(name: str) -> None:  # each phase's wall time, for the run's time limit
        now = time.perf_counter()
        say("time", f"{name}: {now - lap_at[0]:.1f}s")
        lap_at[0] = now

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def split_and_start():
            """The split, and every node process of the serve phases started
            (prestart_nodes), while nvcc runs: ~40% of the run's time limit
            would otherwise pass in one then the other."""
            parts = split_parts(work)
            parts1 = one_stage_parts(work, whole_model(parts))
            torch.cuda.empty_cache()  # the card's memory for the node processes
            dirs = write_tenants(work)
            free, total = torch.cuda.mem_get_info()
            say("nodes", f"the card before the node processes start: {free / 2**30:.2f} GiB "
                         f"free of {total / 2**30:.2f} GiB ({card})")
            # the simulator needs no card: it runs while the processes start
            prestart_nodes(parts, work, [
                ([], ""), (["--quant", "int8"], ""), (["--quant", "int4"], ""),
                (LANE_NODE_ARGS, ""), (LANE_NODE_ARGS + ["--quant", "int8"], ""),
                (profile_node_args(work), "_profile")],
                swarms=[(parts, "swarm"), (parts, "swarm_lanes"), (None, "swarm_counter"),
                        (parts, "overload"), (None, "overload_counter"), (parts, "elastic")],
                singles=[(parts1, BATCH_NODE_ARGS, "_batch"),
                         (parts1, BATCH_PAGED_ARGS, "_batchp"),
                         (parts1, WHOLE_LANE_ARGS, "_wlanes"),
                         (parts1, tenant_batch_args(dirs), "_batcht"),
                         (parts1, FP8_NODE_ARGS, "_fp8")],
                meanwhile=lambda: run_sim(", beside the node processes starting"))
            free, _ = torch.cuda.mem_get_info()
            say("nodes", f"the card with every node process started: {free / 2**30:.2f} GiB "
                         f"free ({card})")
            return parts, parts1

        parts, parts1 = build_all(split_and_start)
        lap("build, split, node start, sim")
        # the kernels are timed with the node processes idle beside them
        cases = run_kernel_cases()
        paged_cases = run_paged_cases()
        qmm_cases = run_qmm_cases()
        lora_cases = run_lora_cases()
        lap("kernel cases")
        codec_rows = run_codec()
        lap("codec")
        whole = whole_model(parts)
        serve = run_serve(card, parts, work)
        lap("serve")
        serve_q = {q: run_serve(card, parts, work, quant_flag=q, baseline=serve,
                                prompt_lens=ENGINE_PROMPT_LENS) for q in ("int8", "int4")}
        lap("serve_quant_int8, serve_quant_int4")
        lanes = run_serve_lanes(card, parts, work)
        lap("serve_lanes")
        swarm = run_serve_swarm(card, parts, work, serve, lanes)
        lap("serve_swarm")
        overload = run_serve_overload(card, parts, work, serve)
        lap("serve_overload")
        elastic = run_serve_elastic(card, parts, work, serve)
        lap("serve_elastic")
        lanes_q = run_serve_lanes(card, parts, work, quant_flag="int8", baseline=lanes)
        lap("serve_lanes_quant")
        lanes_lora = run_serve_lanes_lora(card, parts, work, baseline=lanes)
        lap("serve_lanes_lora")
        tenant = run_serve_tenant_routes(card, parts, work, lanes, lanes_lora)
        lap("serve_tenant_routes")
        sessions = run_serve_sessions(card, parts, parts1, work)
        lap("serve_sessions")
        standby = run_serve_standby(card, parts, whole, work, overload)
        lap("serve_standby")
        gen = run_generate(card, whole, serve)
        gen_q = run_generate_quant(card, whole)
        lap("generate, generate_quant")
        gen_b = run_generate_batched(card, whole)
        lap("generate_batched")
        serve_b = run_serve_batch(card, whole, work, gen_b)
        lap("serve_batch")
        kstep = run_serve_kstep(card, whole, parts, work)
        lap("serve_kstep")
        fp8 = run_serve_fp8(card, whole, work, serve)
        lap("serve_fp8")
        anat = run_anatomy(card, whole)
        lap("anatomy")
        del whole
        torch.cuda.empty_cache()
        prof = run_profile(card, parts, work)
        lap("profile")
        run_cli(card)
        lap("cli")
        # every node process of the phases above has stopped: the Llama
        # pair and its checks have the card to themselves
        llama = run_serve_llama(card, work)
        lap("serve_llama")
        moe = run_serve_moe(card, work)
        lap("serve_moe")
    finally:
        stop_prestarted()
        shutil.rmtree(work, ignore_errors=True)
    paths = {"serve": serve, "serve_quant_int8": serve_q["int8"],
             "serve_quant_int4": serve_q["int4"], "serve_lanes": lanes, "serve_swarm": swarm,
             "serve_overload": overload, "serve_elastic": elastic,
             "serve_lanes_quant": lanes_q, "serve_lanes_lora": lanes_lora,
             "serve_tenant_routes": tenant, "serve_sessions": sessions,
             "serve_standby": standby, "generate": gen,
             "generate_quant": gen_q,
             "generate_batched": gen_b,
             "serve_batch": serve_b, "serve_kstep": kstep, "serve_fp8": fp8,
             "anatomy": anat, "profile": prof, "serve_llama": llama, "serve_moe": moe}

    def by_path(name):
        return {path: r["launches"][name] for path, r in paths.items() if r["launches"][name]}

    def timed(row):
        return {"ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    def qmm_timed(row):
        return dict(timed(row), library_call=row["library_call"],
                    library_note=row["library_note"],
                    dequant_matmul_yardstick_ms=row["dequant_matmul_yardstick_ms"],
                    plan={k: row[k] for k in ("route", "cluster", "k_per_rank", "ctas")})

    def qmm_entry(name, kernel, replaces):
        rows = [r for r in qmm_cases if r["kernel"] == kernel]
        main_row = next(r for r in rows if r["case"] == QMM_MAIN_CASE)
        lane_row = next(r for r in rows if r["case"] == QMM_LANE_CASE)
        launches = by_path(name)
        return dict({
            "name": name, "route": "cuda", "source": "inferd_tpu_torch/csrc/qmatmul.cu",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_row_err": max(r["row_err"] for r in rows if r["dtype"] == "bfloat16"),
        }, **qmm_timed(main_row), **{
            "shape": f"{QMM_MAIN_CASE}: M 1, K 1024, N 151936 (the tied head), bf16, {kernel}",
            QMM_LANE_CASE: dict(qmm_timed(lane_row), shape="M 8, K 1024, N 3072, bf16"),
            "launches_by_route": {r: sum(res["gemv_routes"][name][r] for res in paths.values())
                                  for r in ("mma", "simt")},
            "stage_step": [qmm_stage_sums(qmm_cases, kernel, m) for m in (1, 8)],
        })

    def lora_timed(row):
        return dict(timed(row), gather_bmm_yardstick_ms=row["gather_bmm_yardstick_ms"])

    lora_main = next(r for r in lora_cases if r["case"] == LORA_MAIN_CASE)
    lora_prefill = next(r for r in lora_cases if r["case"] == LORA_PREFILL_CASE)
    lora_y = next(r for r in lora_cases if r["case"] == LORA_Y_MAIN_CASE)
    lora_delta_rows = [r for r in lora_cases if "checks" not in r]  # f32 deltas, LORA_TOL
    lora_launches = by_path("fused_lane_delta")
    main_case = next(c for c in cases if c["case"] == MAIN_CASE)
    paged_main = next(c for c in paged_cases if c["case"] == PAGED_MAIN_CASE)
    paged_heads = [c for c in paged_cases
                   if c["case"] in {f"{PAGED_MAIN_CASE}_{t}" for t in OTHER_HEADS}]
    paged_launches = by_path("paged_decode_gqa")
    flash_routes_all = {r: sum(res["flash_routes"][r] for res in paths.values())
                        for r in ("split", "mma")}
    lanes_chunk = next(c for c in cases if c["case"] == LANES_CHUNK_CASE)
    def flash_entry(route, replaces, row, shape):
        """One entry per flash_gqa kernel: its Pallas kernel, the launches of
        its route, the errors of the cases that ran on it, its main case,
        and beside it the same case at the Llama-3 and Qwen3-MoE heads."""
        on_route = [c for c in cases if c["route"] == route]
        at_heads = {c["case"]: dict(timed(c), shape=f"Nq {c['Nq']}, Nkv {c['Nkv']}, D {c['D']}")
                    for c in cases if c["case"] in {f"{row['case']}_{t}" for t in OTHER_HEADS}}
        return dict({
            "name": f"flash_gqa.{route}",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/flash_gqa.cu",
            "replaces": replaces,
            "launches": flash_routes_all[route],
            "launches_by_path": {path: r["flash_routes"][route] for path, r in paths.items()
                                 if r["flash_routes"][route]},
            "max_abs_err": max(c["max_abs_err"] for c in on_route),
            "max_row_err": max(c["row_err"] for c in on_route
                               if c["dtype"].startswith("bfloat16")),
        }, **timed(row), shape=shape, **at_heads)

    kernels = {"kernels": [
        # the one wrapper's two kernels: split-KV (with its combine) for
        # decode, the tensor cores for prompt chunks, as flash_plan routes
        flash_entry("split", "inferd_tpu/ops/attention.py:131", main_case,
                    f"{MAIN_CASE}: B 1, S 1, T 1024, Nq 16, Nkv 8, D 128, bf16"),
        flash_entry("mma", "inferd_tpu/ops/attention.py:218", lanes_chunk,
                    f"{LANES_CHUNK_CASE}: B 1, S 256, T 1024, kv_len 700 (device meta), bf16"),
        dict({
            "name": "paged_decode_gqa",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/paged_decode.cu",
            "replaces": "inferd_tpu/ops/attention.py:460",
            "launches": sum(paged_launches.values()),
            "launches_by_path": paged_launches,
            "max_abs_err": max(c["max_abs_err"] for c in paged_cases),
            "max_row_err": max(c["row_err"] for c in paged_cases
                               if c["dtype"].startswith("bfloat16")),
            "launches_split": sum(res["paged_split"] for res in paths.values()
                                  if "paged_split" in res),
        }, **timed(paged_main),  # library_ms None: no single PyTorch call computes it
            gather_sdpa_yardstick_ms=paged_main["gather_sdpa_yardstick_ms"],
            plan=paged_main["plan"],
            shape=f"{PAGED_MAIN_CASE}: B 8, bs 32, MB 32, kv_len {paged_main['kv_len']}, "
                  "Nq 16, Nkv 8, D 128, bf16",
            **{c["case"]: dict(timed(c), shape=f"Nq {c['Nq']}, Nkv {c['Nkv']}, D {c['D']}")
               for c in paged_heads}),
        # library_ms: torch's own weight-only quantized product on the same
        # weight (library_call); dequant_matmul_yardstick_ms is torch.matmul
        # against the weight dequantized beforehand, what --quant none pays
        qmm_entry("w8a16_matmul", "w8a16", "inferd_tpu/ops/qmatmul.py:34"),
        qmm_entry("w4a16_matvec", "w4a16_grouped", "inferd_tpu/ops/qmatmul.py:94"),
        dict({
            "name": "fused_lane_delta",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/lora_delta.cu",
            "replaces": "inferd_tpu/ops/lora.py:313",
            "launches": sum(lora_launches.values()),
            "launches_by_path": lora_launches,
            "max_abs_err": max(r["max_abs_err"] for r in lora_delta_rows),
            "max_row_err": max(r["row_err"] for r in lora_delta_rows),
        }, **lora_timed(lora_main),  # library_ms None: no single PyTorch call computes it
            plan=lora_main["plan"],
            shape=f"{LORA_MAIN_CASE}: B 8, S 1, in 1024, out 3072, r 16, ids {LORA_DECODE_IDS}, "
                  "bf16 pools 4 x 14 layers",
            **{LORA_PREFILL_CASE: dict(lora_timed(lora_prefill), plan=lora_prefill["plan"],
                                       shape="B 1, S 256, in 1024, out 3072, r 16, bf16"),
               LORA_Y_MAIN_CASE: dict(timed(lora_y), unfused_ms=lora_y["unfused_ms"],
                                      plan=lora_y["plan"],
                                      shape="the main case with y= (bf16), in place")}),
    ]}
    say("wire", json.dumps({"codec": codec_rows, "coalesce": swarm["coalesce"]}))
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception as e:  # report the failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
