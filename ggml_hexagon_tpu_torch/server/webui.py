"""Built-in server web UI: a single-file chat page served at `/`.

The port's own copy of ggml_hexagon_tpu/server/webui.py (the port imports nothing of
the JAX package).

The reference ships a Vue SPA (examples/server/webui) built to static
assets; ours is an original dependency-free page (vanilla JS) speaking
the same API the SPA does: streaming /v1/chat/completions (SSE), /props
for model info, /slots for status.  Served inline — no build step, no
asset pipeline, works over curl'd single-port deployments.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>ggml_hexagon_tpu server</title>
<style>
:root { color-scheme: light dark;
  --bg:#ffffff; --fg:#1a1a1a; --muted:#6b6b6b; --line:#e3e3e3;
  --user:#eef3fb; --asst:#f6f6f4; --accent:#3d6fa5; }
@media (prefers-color-scheme: dark) { :root {
  --bg:#161618; --fg:#e8e8e6; --muted:#9a9a97; --line:#333336;
  --user:#223044; --asst:#242426; --accent:#7ea7d8; } }
* { box-sizing:border-box }
body { margin:0; background:var(--bg); color:var(--fg);
  font:15px/1.5 system-ui, sans-serif; display:flex; flex-direction:column;
  height:100vh }
header { padding:10px 16px; border-bottom:1px solid var(--line);
  display:flex; gap:12px; align-items:baseline }
header h1 { font-size:15px; margin:0 }
header .muted { color:var(--muted); font-size:12.5px }
#log { flex:1; overflow-y:auto; padding:16px; }
.msg { max-width:52em; margin:0 auto 10px; padding:8px 12px;
  border-radius:8px; white-space:pre-wrap; word-break:break-word }
.msg.user { background:var(--user) }
.msg.assistant { background:var(--asst) }
.msg .role { font-size:11px; color:var(--muted);
  text-transform:uppercase; letter-spacing:.06em }
form { display:flex; gap:8px; padding:12px 16px;
  border-top:1px solid var(--line) }
textarea { flex:1; resize:none; padding:8px 10px; border-radius:8px;
  border:1px solid var(--line); background:var(--bg); color:var(--fg);
  font:inherit; height:3.2em }
button { padding:0 18px; border-radius:8px; border:1px solid var(--line);
  background:var(--accent); color:#fff; font:inherit; cursor:pointer }
button[disabled] { opacity:.5; cursor:default }
#cfg { display:flex; gap:10px; padding:6px 16px; font-size:12.5px;
  color:var(--muted); border-top:1px solid var(--line); flex-wrap:wrap }
#cfg label { display:flex; gap:4px; align-items:center }
#cfg input { width:5em; border:1px solid var(--line); border-radius:4px;
  background:var(--bg); color:var(--fg); padding:1px 4px }
</style>
</head>
<body>
<header><h1>ggml_hexagon_tpu</h1>
  <span class="muted" id="model">loading&hellip;</span>
  <span class="muted" id="stats"></span></header>
<div id="log"></div>
<form id="f">
  <textarea id="inp" placeholder="Send a message&hellip; (Enter to send,
Shift+Enter for newline)"></textarea>
  <button id="send" type="submit">Send</button>
</form>
<div id="cfg">
  <label>temp <input id="temp" value="0.8"></label>
  <label>top_p <input id="topp" value="0.95"></label>
  <label>max tokens <input id="maxtok" value="512"></label>
  <label>system <input id="sys" style="width:16em"
    placeholder="optional system prompt"></label>
  <a href="#" id="clear" style="color:var(--muted)">clear</a>
</div>
<script>
"use strict";
const log = document.getElementById("log");
const form = document.getElementById("f");
const inp = document.getElementById("inp");
const send = document.getElementById("send");
const msgs = [];
fetch("/props").then(r => r.json()).then(p => {
  document.getElementById("model").textContent =
    (p.model_path || "model").split("/").pop();
}).catch(() => {});
function bubble(role) {
  const d = document.createElement("div");
  d.className = "msg " + role;
  const r = document.createElement("div");
  r.className = "role"; r.textContent = role;
  const b = document.createElement("div");
  d.append(r, b); log.append(d);
  log.scrollTop = log.scrollHeight;
  return b;
}
async function chat(text) {
  msgs.push({role: "user", content: text});
  bubble("user").textContent = text;
  const body = {
    messages: (document.getElementById("sys").value
      ? [{role: "system", content: document.getElementById("sys").value}]
      : []).concat(msgs),
    stream: true,
    temperature: parseFloat(document.getElementById("temp").value) || 0,
    top_p: parseFloat(document.getElementById("topp").value) || 1,
    max_tokens: parseInt(document.getElementById("maxtok").value) || 512,
  };
  const out = bubble("assistant");
  send.disabled = true;
  let acc = "";
  try {
    const resp = await fetch("/v1/chat/completions", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify(body)});
    if (!resp.ok) throw new Error(await resp.text());
    const rd = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    for (;;) {
      const {done, value} = await rd.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      const lines = buf.split("\\n");
      buf = lines.pop();
      for (const ln of lines) {
        if (!ln.startsWith("data: ")) continue;
        const payload = ln.slice(6).trim();
        if (payload === "[DONE]") continue;
        const delta = JSON.parse(payload).choices?.[0]?.delta?.content;
        if (delta) { acc += delta; out.textContent = acc;
                     log.scrollTop = log.scrollHeight; }
      }
    }
    const t0 = performance.now();
  } catch (e) {
    out.textContent = acc + "\\n[error] " + e.message;
  }
  msgs.push({role: "assistant", content: acc});
  send.disabled = false;
  inp.focus();
}
form.addEventListener("submit", ev => {
  ev.preventDefault();
  const t = inp.value.trim();
  if (!t || send.disabled) return;
  inp.value = "";
  chat(t);
});
inp.addEventListener("keydown", ev => {
  if (ev.key === "Enter" && !ev.shiftKey) {
    ev.preventDefault(); form.requestSubmit();
  }
});
document.getElementById("clear").addEventListener("click", ev => {
  ev.preventDefault(); msgs.length = 0; log.textContent = "";
});
</script>
</body>
</html>
"""
