"""The built-in WebUI: one page, no dependencies.

Port of ``ai00_server_tpu/server/webui.py``: Chat, Continuation, Paper
(parallel completions), a model manager (list, load, unload, save, with
the JWT of ``/api/auth/exchange``), the live ``/api/models/state`` stream
and a ``/api/metrics`` panel.  ``GET /`` serves it unless a ``[web]`` zip
is configured: then the zip's ``index.html`` (``main.py``).
"""

WEBUI_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<meta name="viewport" content="width=device-width, initial-scale=1"/>
<title>ai00_server_tpu_torch</title>
<style>
:root { --bg:#101014; --panel:#17171d; --line:#2a2a33; --fg:#e8e8ee;
        --dim:#8a8a96; --acc:#35b377; --acc2:#6ca0f6; --warn:#e0a040; }
* { box-sizing: border-box; }
body { font-family: system-ui, sans-serif; margin: 0; background: var(--bg);
       color: var(--fg); height: 100vh; display: flex; flex-direction: column; }
header { display:flex; align-items:center; gap:1rem; padding:.6rem 1rem;
         border-bottom:1px solid var(--line); background:var(--panel); }
header h1 { font-size:1rem; margin:0; font-weight:600; }
header small { color:var(--dim); }
nav { display:flex; gap:.2rem; margin-left:auto; }
nav button { background:none; border:0; color:var(--dim); padding:.45rem .9rem;
             border-radius:6px; cursor:pointer; font-size:.92rem; }
nav button.on { background:var(--line); color:var(--fg); }
main { flex:1; overflow:hidden; display:flex; }
.tab { display:none; flex:1; overflow:auto; padding:1rem; }
.tab.on { display:flex; gap:1rem; }
.col { display:flex; flex-direction:column; gap:.6rem; min-width:0; }
.grow { flex:1; }
.side { width:240px; flex-shrink:0; }
textarea, input, select {
  background:#1e1e26; color:var(--fg); border:1px solid var(--line);
  border-radius:6px; padding:.45rem .6rem; width:100%; font:inherit; }
textarea { resize:vertical; }
button.act { background:var(--acc); color:#fff; border:0; border-radius:6px;
             padding:.5rem 1.1rem; cursor:pointer; font:inherit; }
button.act[disabled] { opacity:.45; cursor:default; }
button.sec { background:var(--line); color:var(--fg); border:0;
             border-radius:6px; padding:.4rem .9rem; cursor:pointer; }
button.danger { background:#a33; color:#fff; }
.card { background:var(--panel); border:1px solid var(--line);
        border-radius:8px; padding: .8rem; }
.card h3 { margin:.1rem 0 .5rem; font-size:.85rem; color:var(--dim);
           text-transform:uppercase; letter-spacing:.04em; }
label { font-size:.78rem; color:var(--dim); display:block; margin-top:.35rem; }
#chatlog { flex:1; overflow-y:auto; display:flex; flex-direction:column;
           gap:.5rem; padding:.4rem; }
.bub { max-width:80%; padding:.55rem .8rem; border-radius:10px;
       white-space:pre-wrap; word-break:break-word; }
.bub.user { align-self:flex-end; background:#24436e; }
.bub.bot  { align-self:flex-start; background:#1e2f25; }
.bub.sys  { align-self:center; background:none; color:var(--dim);
            font-size:.8rem; }
#contbox { flex:1; min-height:16rem; font-family:ui-monospace,monospace; }
#papergrid { display:grid; grid-template-columns:repeat(2, 1fr); gap:.7rem;
             flex:1; overflow:auto; align-content:start; }
.pcell { background:var(--panel); border:1px solid var(--line);
         border-radius:8px; padding:.6rem; white-space:pre-wrap;
         font-size:.85rem; min-height:7rem; }
.pcell b { color:var(--acc2); }
table { border-collapse:collapse; width:100%; font-size:.85rem; }
td, th { border-bottom:1px solid var(--line); padding:.35rem .5rem;
         text-align:left; }
th { color:var(--dim); font-weight:500; }
td.num { text-align:right; font-variant-numeric:tabular-nums; }
.pill { display:inline-block; padding:.1rem .5rem; border-radius:999px;
        font-size:.75rem; background:var(--line); }
.pill.ok { background:#1d4030; color:#9fe0b8; }
.pill.bad { background:#402020; color:#e0a0a0; }
#metrics { font-family:ui-monospace,monospace; font-size:.8rem;
           white-space:pre; overflow:auto; }
a { color: var(--acc2); }
.row { display:flex; gap:.5rem; align-items:center; }
.row > .grow { flex:1; }
small.dim { color:var(--dim); }
</style>
</head>
<body>
<header>
  <h1>ai00_server_tpu_torch</h1>
  <span id="hdrinfo"><small class="dim">connecting…</small></span>
  <nav>
    <button data-tab="chat" class="on">Chat</button>
    <button data-tab="cont">Continuation</button>
    <button data-tab="paper">Paper</button>
    <button data-tab="models">Models</button>
    <button data-tab="server">Server</button>
  </nav>
</header>
<main>

<!-- ======================= CHAT ======================= -->
<div class="tab on" id="tab-chat">
  <div class="col grow">
    <div id="chatlog"></div>
    <div class="row">
      <textarea id="chat-in" rows="2" class="grow"
        placeholder="Message (Enter to send, Shift+Enter newline)"></textarea>
      <div class="col" style="width:7.5rem">
        <button class="act" id="chat-send">Send</button>
        <button class="sec" id="chat-stop">Stop</button>
        <button class="sec" id="chat-clear">Clear</button>
      </div>
    </div>
  </div>
  <div class="col side">
    <div class="card">
      <h3>System prompt</h3>
      <textarea id="chat-sys" rows="3"
        placeholder="(optional system message)"></textarea>
    </div>
    <div class="card" id="sampler-card">
      <h3>Sampler</h3>
      <label>type
        <select id="s-type"><option>Nucleus</option><option>Typical</option>
        <option>Mirostat</option></select></label>
      <label>max_tokens <input id="s-max" type="number" value="512"/></label>
      <label>temperature
        <input id="s-temp" type="number" value="1.0" step="0.1"/></label>
      <label>top_p <input id="s-topp" type="number" value="0.5"
        step="0.05"/></label>
      <label>top_k <input id="s-topk" type="number" value="128"/></label>
      <label>presence_penalty
        <input id="s-pres" type="number" value="0.3" step="0.1"/></label>
      <label>frequency_penalty
        <input id="s-freq" type="number" value="0.3" step="0.1"/></label>
    </div>
  </div>
</div>

<!-- =================== CONTINUATION =================== -->
<div class="tab" id="tab-cont">
  <div class="col grow">
    <textarea id="contbox"
      placeholder="Write the beginning of a text; Generate continues it in place."></textarea>
    <div class="row">
      <button class="act" id="cont-go">Generate</button>
      <button class="sec" id="cont-stop">Stop</button>
      <span class="grow"></span>
      <small class="dim" id="cont-stat"></small>
    </div>
  </div>
  <div class="col side">
    <div class="card">
      <h3>Params</h3>
      <label>max_tokens <input id="c-max" type="number" value="256"/></label>
      <label>temperature
        <input id="c-temp" type="number" value="1.0" step="0.1"/></label>
      <label>top_p <input id="c-topp" type="number" value="0.5"
        step="0.05"/></label>
      <label>stop sequences (one per line)
        <textarea id="c-stop" rows="2"></textarea></label>
      <label>BNF schema (optional)
        <textarea id="c-bnf" rows="4" placeholder="start ::= …"></textarea>
      </label>
    </div>
  </div>
</div>

<!-- ====================== PAPER ======================= -->
<div class="tab" id="tab-paper">
  <div class="col grow">
    <div class="card">
      <h3>Parallel inference demo — one prompt per line, all run
        concurrently through the batched runtime</h3>
      <textarea id="paper-prompts" rows="4">The capital of France is
Once upon a time, in a distant galaxy,
def quicksort(arr):
The main difference between TPUs and GPUs is</textarea>
      <div class="row" style="margin-top:.5rem">
        <button class="act" id="paper-go">Run batch</button>
        <button class="sec" id="paper-stop">Stop</button>
        <label style="width:9rem;margin:0">max_tokens
          <input id="p-max" type="number" value="128"/></label>
        <span class="grow"></span>
        <small class="dim" id="paper-stat"></small>
      </div>
    </div>
    <div id="papergrid"></div>
  </div>
</div>

<!-- ====================== MODELS ====================== -->
<div class="tab" id="tab-models">
  <div class="col grow">
    <div class="card">
      <h3>Current model <span id="m-state" class="pill">?</span></h3>
      <div id="m-info"><small class="dim">—</small></div>
      <div class="row" style="margin-top:.6rem">
        <button class="sec danger" id="m-unload">Unload</button>
        <input id="m-savepath" placeholder="save path (.prefab)"
               style="max-width:20rem"/>
        <button class="sec" id="m-save">Save prefab</button>
        <span class="grow"></span>
        <small class="dim" id="m-msg"></small>
      </div>
    </div>
    <div class="card">
      <h3>Model files</h3>
      <table id="m-files"><thead><tr><th>name</th><th>size</th><th></th>
      </tr></thead><tbody></tbody></table>
    </div>
  </div>
  <div class="col side">
    <div class="card">
      <h3>Admin token</h3>
      <input id="adm-token" placeholder="JWT or listen.slot secret"/>
      <div class="row" style="margin-top:.4rem">
        <input id="adm-id" placeholder="app_id" style="flex:1"/>
        <input id="adm-secret" placeholder="secret" style="flex:1"/>
      </div>
      <button class="sec" id="adm-exchange"
        style="margin-top:.4rem">Exchange</button>
      <small class="dim" id="adm-msg"></small>
    </div>
    <div class="card">
      <h3>Load options</h3>
      <label>quant layers <input id="l-quant" type="number" value="0"/></label>
      <label>quant type <select id="l-qtype"><option>Int8</option>
        <option>NF4</option><option>SF4</option></select></label>
      <label>precision <select id="l-prec"><option>Fp16</option>
        <option>Fp32</option></select></label>
      <label>max_batch <input id="l-batch" type="number" value="8"/></label>
      <label>token_chunk_size
        <input id="l-chunk" type="number" value="128"/></label>
    </div>
  </div>
</div>

<!-- ====================== SERVER ====================== -->
<div class="tab" id="tab-server">
  <div class="col grow">
    <div class="card">
      <h3>Runtime info stream <span id="sse-pill" class="pill">off</span></h3>
      <div id="sse-info"><small class="dim">—</small></div>
    </div>
    <div class="card grow">
      <h3>Metrics (<a href="/api/metrics">/api/metrics</a> ·
        <a href="/api-docs">API docs</a>)</h3>
      <div id="metrics">—</div>
    </div>
  </div>
  <div class="col side">
    <div class="card">
      <h3>Devices</h3>
      <div id="adapters"><small class="dim">—</small></div>
    </div>
  </div>
</div>

</main>
<script>
"use strict";
const $ = id => document.getElementById(id);

/* ---------- tabs ---------- */
for (const b of document.querySelectorAll("nav button")) {
  b.onclick = () => {
    document.querySelectorAll("nav button").forEach(x =>
      x.classList.toggle("on", x === b));
    document.querySelectorAll(".tab").forEach(x =>
      x.classList.toggle("on", x.id === "tab-" + b.dataset.tab));
    if (b.dataset.tab === "models") refreshModels();
    if (b.dataset.tab === "server") refreshServer();
  };
}

/* ---------- shared helpers ---------- */
function sampler() {
  return { type: $("s-type").value,
    top_p: +$("s-topp").value, top_k: +$("s-topk").value,
    temperature: +$("s-temp").value,
    presence_penalty: +$("s-pres").value,
    frequency_penalty: +$("s-freq").value };
}
async function sse(url, body, onText, signal) {
  const resp = await fetch(url, { method: "POST", signal,
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(body) });
  if (!resp.ok) throw new Error(await resp.text());
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = "";
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    buf += dec.decode(value, { stream: true });
    const lines = buf.split("\n"); buf = lines.pop();
    for (const line of lines) {
      if (!line.startsWith("data: ")) continue;
      const p = line.slice(6);
      if (p === "[DONE]") return;
      try {
        const j = JSON.parse(p);
        const c = j.choices && j.choices[0];
        const t = c && (c.text !== undefined ? c.text
                 : (c.delta && c.delta.content) || "");
        if (t) onText(t);
      } catch (e) {}
    }
  }
}
async function refreshHeader() {
  try {
    const j = await (await fetch("/api/models/info")).json();
    $("hdrinfo").innerHTML = j.state === "loaded"
      ? `<small class="dim">${j.reload.model_path} · ${j.model.version} ` +
        `${j.model.num_layer}L/${j.model.num_emb}C · ` +
        `batch ${j.reload.max_batch}</small>`
      : `<small class="dim">no model loaded</small>`;
  } catch (e) { $("hdrinfo").innerHTML =
    `<small class="dim">server unreachable</small>`; }
}
refreshHeader(); setInterval(refreshHeader, 10000);

/* ---------- chat ---------- */
const history = [];
let chatAbort = null;
function bubble(cls, text) {
  const d = document.createElement("div");
  d.className = "bub " + cls; d.textContent = text;
  $("chatlog").appendChild(d);
  $("chatlog").scrollTop = $("chatlog").scrollHeight;
  return d;
}
async function chatSend() {
  const text = $("chat-in").value.trim(); if (!text) return;
  $("chat-in").value = "";
  bubble("user", text);
  const bot = bubble("bot", "…");
  const msgs = [];
  const sys = $("chat-sys").value.trim();
  if (sys) msgs.push({ role: "system", content: sys });
  msgs.push(...history, { role: "user", content: text });
  let out = "";
  chatAbort = new AbortController();
  $("chat-send").disabled = true;
  try {
    await sse("/api/oai/chat/completions", {
      messages: msgs, stream: true, max_tokens: +$("s-max").value,
      sampler: sampler(),
    }, t => { out += t; bot.textContent = out;
              $("chatlog").scrollTop = $("chatlog").scrollHeight; },
    chatAbort.signal);
  } catch (e) { if (e.name !== "AbortError")
      bot.textContent = out + " ⟨error: " + e.message + "⟩"; }
  $("chat-send").disabled = false;
  history.push({ role: "user", content: text },
               { role: "assistant", content: out });
}
$("chat-send").onclick = chatSend;
$("chat-stop").onclick = () => chatAbort && chatAbort.abort();
$("chat-clear").onclick = () => { history.length = 0;
  $("chatlog").innerHTML = ""; bubble("sys", "history cleared"); };
$("chat-in").addEventListener("keydown", e => {
  if (e.key === "Enter" && !e.shiftKey) { e.preventDefault(); chatSend(); }
});

/* ---------- continuation ---------- */
let contAbort = null;
$("cont-go").onclick = async () => {
  const base = $("contbox").value;
  contAbort = new AbortController();
  $("cont-go").disabled = true; $("cont-stat").textContent = "generating…";
  const t0 = performance.now(); let n = 0;
  const stops = $("c-stop").value.split("\n").filter(x => x);
  const body = { prompt: base, stream: true,
    max_tokens: +$("c-max").value,
    sampler: { type: "Nucleus", temperature: +$("c-temp").value,
               top_p: +$("c-topp").value } };
  if (stops.length) body.stop = stops;
  const bnf = $("c-bnf").value.trim();
  if (bnf) body.bnf_schema = bnf;
  try {
    await sse("/api/oai/completions", body, t => {
      n++; $("contbox").value += t;
      $("contbox").scrollTop = $("contbox").scrollHeight;
    }, contAbort.signal);
  } catch (e) { if (e.name !== "AbortError")
      $("cont-stat").textContent = "error: " + e.message; }
  const dt = (performance.now() - t0) / 1000;
  $("cont-stat").textContent =
    `${n} chunks in ${dt.toFixed(1)}s`;
  $("cont-go").disabled = false;
};
$("cont-stop").onclick = () => contAbort && contAbort.abort();

/* ---------- paper (parallel batch) ---------- */
let paperAborts = [];
$("paper-go").onclick = async () => {
  const prompts = $("paper-prompts").value.split("\n")
    .map(x => x.trim()).filter(x => x);
  const grid = $("papergrid"); grid.innerHTML = "";
  paperAborts.forEach(a => a.abort()); paperAborts = [];
  const t0 = performance.now(); let done = 0;
  $("paper-stat").textContent = `0/${prompts.length} done`;
  const jobs = prompts.map(p => {
    const cell = document.createElement("div");
    cell.className = "pcell";
    cell.innerHTML = "<b></b>"; cell.firstChild.textContent = p;
    const span = document.createElement("span");
    cell.appendChild(span); grid.appendChild(cell);
    const ab = new AbortController(); paperAborts.push(ab);
    return sse("/api/oai/completions", {
      prompt: p, stream: true, max_tokens: +$("p-max").value,
      sampler: { type: "Nucleus", temperature: 1.0, top_p: 0.5 },
    }, t => { span.textContent += t; }, ab.signal)
      .catch(e => { if (e.name !== "AbortError")
        span.textContent += " ⟨" + e.message + "⟩"; })
      .then(() => { done++;
        $("paper-stat").textContent = `${done}/${prompts.length} done · ` +
          `${((performance.now() - t0) / 1000).toFixed(1)}s`; });
  });
  await Promise.all(jobs);
};
$("paper-stop").onclick = () => paperAborts.forEach(a => a.abort());

/* ---------- admin auth ---------- */
$("adm-token").value = localStorage.getItem("ai00_admin_token") || "";
$("adm-token").onchange = () =>
  localStorage.setItem("ai00_admin_token", $("adm-token").value);
function adminHeaders() {
  const t = $("adm-token").value.trim();
  return t ? { "Authorization": "Bearer " + t,
               "Content-Type": "application/json" }
           : { "Content-Type": "application/json" };
}
$("adm-exchange").onclick = async () => {
  try {
    const r = await fetch("/api/auth/exchange", { method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ app_id: $("adm-id").value,
                             app_secret: $("adm-secret").value }) });
    const j = await r.json();
    if (j.token) { $("adm-token").value = j.token;
      localStorage.setItem("ai00_admin_token", j.token);
      $("adm-msg").textContent = "token acquired"; }
    else $("adm-msg").textContent = JSON.stringify(j);
  } catch (e) { $("adm-msg").textContent = String(e); }
};

/* ---------- models tab ---------- */
async function refreshModels() {
  try {
    const j = await (await fetch("/api/models/info")).json();
    const st = $("m-state");
    st.textContent = j.state;
    st.className = "pill " + (j.state === "loaded" ? "ok" : "bad");
    $("m-info").innerHTML = j.state === "loaded" ? `<table>
      <tr><th>path</th><td>${j.reload.model_path}</td></tr>
      <tr><th>version</th><td>${j.model.version} · ${j.model.num_layer}L ·
        C=${j.model.num_emb} · vocab ${j.model.num_vocab}</td></tr>
      <tr><th>quant</th><td>${j.reload.quant} layers ${j.reload.quant_type}
        · ${j.reload.precision}</td></tr>
      <tr><th>batch/chunk</th><td>${j.reload.max_batch} /
        ${j.reload.token_chunk_size}</td></tr>
      <tr><th>mesh</th><td>${JSON.stringify(j.reload.mesh)}</td></tr>
      </table>` : `<small class="dim">no model loaded</small>`;
  } catch (e) {}
  try {
    const j = await (await fetch("/api/models/list")).json();
    const tb = $("m-files").querySelector("tbody"); tb.innerHTML = "";
    for (const f of (j.files || j)) {
      const tr = document.createElement("tr");
      const name = f.name || f;
      const size = f.size ? (f.size / 1e6).toFixed(1) + " MB" : "";
      tr.innerHTML = `<td></td><td class="num">${size}</td><td></td>`;
      tr.cells[0].textContent = name;
      const btn = document.createElement("button");
      btn.className = "sec"; btn.textContent = "Load";
      btn.onclick = () => loadModel(name);
      tr.cells[2].appendChild(btn);
      tb.appendChild(tr);
    }
  } catch (e) {}
}
async function loadModel(name) {
  $("m-msg").textContent = "loading " + name + "…";
  try {
    const r = await fetch("/admin/models/load", { method: "POST",
      headers: adminHeaders(),
      body: JSON.stringify({ model_path: name,
        quant: +$("l-quant").value, quant_type: $("l-qtype").value,
        precision: $("l-prec").value, max_batch: +$("l-batch").value,
        token_chunk_size: +$("l-chunk").value }) });
    $("m-msg").textContent = r.ok ? "loaded" : "error: " + await r.text();
  } catch (e) { $("m-msg").textContent = String(e); }
  refreshModels(); refreshHeader();
}
$("m-unload").onclick = async () => {
  const r = await fetch("/admin/models/unload",
                        { headers: adminHeaders() });
  $("m-msg").textContent = r.ok ? "unloaded" : "error: " + await r.text();
  refreshModels(); refreshHeader();
};
$("m-save").onclick = async () => {
  const p = $("m-savepath").value.trim(); if (!p) return;
  const r = await fetch("/admin/models/save", { method: "POST",
    headers: adminHeaders(), body: JSON.stringify({ path: p }) });
  $("m-msg").textContent = r.ok ? "saved" : "error: " + await r.text();
};

/* ---------- server tab ---------- */
let sseInfo = null;
async function refreshServer() {
  try {
    const t = await (await fetch("/api/metrics")).text();
    $("metrics").textContent = t;
  } catch (e) {}
  try {
    const j = await (await fetch("/api/adapters")).json();
    $("adapters").innerHTML = (j.adapters || j)
      .map(a => `<div>${a}</div>`).join("");
  } catch (e) {}
  if (!sseInfo) {
    sseInfo = new EventSource("/api/models/state");
    $("sse-pill").textContent = "live";
    $("sse-pill").className = "pill ok";
    sseInfo.onmessage = ev => {
      try {
        const j = JSON.parse(ev.data);
        $("sse-info").innerHTML =
          `<small class="dim">${ev.data.slice(0, 400)}</small>`;
      } catch (e) {}
    };
    sseInfo.onerror = () => { $("sse-pill").textContent = "off";
      $("sse-pill").className = "pill bad"; };
  }
}
setInterval(() => {
  if ($("tab-server").classList.contains("on")) refreshServer();
}, 5000);
</script>
</body>
</html>
"""
