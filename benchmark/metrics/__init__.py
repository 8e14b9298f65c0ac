"""One module a per-layer metric, found by the metric's name in
BENCHMARK.json.  Each has read(ctx) -> a number, or None when the traced
window holds nothing for it to read (the metric is then left out of the
result line).  ctx: steps and batch of the traced window, `trace`
(profile.read's reduction of the profiler's trace), `fetch_s` (host
seconds of each step's batch fetch, ended by a sync), `spans` (the
window's profile.Spans), `plain` (the reference's frozen package),
`program` (harness/program.py's metrics of the second traced pass, by
the program's own spans and counters)."""
