"""Browser GUI served by the REST API (counterpart of
``alphazero_tpu/webui.py``; ``PAGE`` is the same page, character for
character).

A single self-contained HTML page (no external assets) that drives the
session JSON API of ``api_server.py``.  Open http://host:port/ after
starting the server.
"""

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>alphazero_tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.2rem;background:#faf8f4;color:#222}
 h1{font-size:1.1rem;margin:0 0 .8rem}
 .bar{display:flex;gap:.5rem;align-items:center;flex-wrap:wrap;margin-bottom:.8rem}
 select,input,button{font-size:.95rem;padding:.25rem .5rem}
 button{cursor:pointer}
 #board{display:grid;gap:0;width:max-content;border:2px solid #8a6d3b}
 .sq{width:34px;height:34px;display:flex;align-items:center;justify-content:center;
     font-size:24px;cursor:pointer;user-select:none;box-sizing:border-box}
 .board-go .sq,.board-gomoku .sq{background:#deb871;border:1px solid #8a6d3b33}
 .board-chess .sq.light{background:#f0d9b5}
 .board-chess .sq.dark{background:#b58863}
 .sq.sel{outline:3px solid #2b6cb0;outline-offset:-3px}
 .sq.last{box-shadow:inset 0 0 0 3px #d97706}
 #status{margin:.8rem 0;font-size:.95rem;white-space:pre-wrap}
 .stone-b{color:#111}.stone-w{color:#fff;text-shadow:0 0 2px #000}
</style></head><body>
<h1>alphazero_tpu — play vs the engine</h1>
<div class="bar">
 <select id="game"><option>gomoku</option><option>go</option><option>chess</option></select>
 <label>size <input id="size" type="number" value="15" min="5" max="19" style="width:3.5rem"></label>
 <label>sims <input id="sims" type="number" value="200" min="1" style="width:4.5rem"></label>
 <label id="promoLab" style="display:none">promo
  <select id="promo"><option value="q">Q</option><option value="n">N</option>
   <option value="b">B</option><option value="r">R</option></select></label>
 <label>key <input id="apikey" type="password" placeholder="(none)"
   style="width:6rem" title="X-API-Key when the server runs with --api-key"></label>
 <button id="new">new game</button>
 <button id="ai">ai move</button>
 <button id="pass" style="display:none">pass</button>
</div>
<div id="board"></div>
<div id="status">no game — press “new game”</div>
<script>
const PIECES={0:"♙",1:"♘",2:"♗",3:"♖",4:"♕",5:"♔",
              6:"♟",7:"♞",8:"♝",9:"♜",10:"♛",11:"♚"};
let gid=null,st=null,sel=null,busy=false;
const $=id=>document.getElementById(id);
async function api(method,path,body){
  const headers={"Content-Type":"application/json"};
  const k=$("apikey").value; if(k) headers["X-API-Key"]=k;
  const r=await fetch(path,{method,headers,
                            body:body?JSON.stringify(body):undefined});
  const j=await r.json();
  if(!r.ok) throw new Error(j.error||r.status);
  return j;
}
function sideName(p){
  // chess encodes player 0 = white (games/chess.py); go/gomoku 0 = black.
  return st.game==="chess" ? (p===0?"white":"black") : (p===0?"black":"white");
}
function statusLine(extra){
  if(!st) return "no game";
  let s=`${st.game}  move ${st.move_count}  `+
        (st.terminal?`game over — winner: ${st.winner>=0?sideName(st.winner):"draw"}`
                    :`to play: ${sideName(st.to_play)}`);
  if(st.ai) s+=`\nengine: action ${st.ai.action}  value ${st.ai.value.toFixed(3)}  `+
               `${st.ai.visits} visits in ${st.ai.time_s}s`;
  return s+(extra?"\n"+extra:"");
}
function draw(){
  const b=$("board"); b.innerHTML=""; if(!st) return;
  const chess=st.game==="chess";
  const n=Math.round(Math.sqrt(st.cells.length));
  b.className=chess?"board-chess":"board-"+st.game;
  b.style.gridTemplateColumns=`repeat(${n},34px)`;
  $("pass").style.display=st.game==="go"?"":"none";
  $("promoLab").style.display=chess?"":"none";
  for(let dr=0;dr<n;dr++){           // dr: display row, top = rank n-1
    const r=n-1-dr;
    for(let c=0;c<n;c++){
      const v=st.cells[r*n+c], d=document.createElement("div");
      d.className="sq"+(chess?((r+c)%2?" light":" dark"):"");
      if(chess&&v>=0) d.textContent=PIECES[v];
      else if(!chess&&v>=0){d.textContent="●";
        d.className+=v===0?" stone-b":" stone-w";}
      const a=r*n+c;
      if(sel===a) d.className+=" sel";
      d.onclick=()=>click(a,v);
      b.appendChild(d);
    }
  }
  $("status").textContent=statusLine();
}
async function refresh(p){ st=p; draw(); }
async function click(a,v){
  if(busy||!gid||st.terminal) return;
  try{
    if(st.game==="chess"){
      const mine=st.to_play===0? (v>=0&&v<6) : (v>=6);
      if(sel===null||mine){ sel=(v>=0&&mine)?a:null; draw(); return; }
      const body={from:sel,to:a,promo:$("promo").value}; sel=null;
      await move(body);
    } else {
      await move({action:a});
    }
  }catch(e){ $("status").textContent=statusLine("illegal: "+e.message); }
}
async function move(body){
  busy=true;
  try{
    await refresh(await api("POST",`/api/games/${gid}/move`,body));
    if(!st.terminal){
      $("status").textContent=statusLine("engine thinking…");
      await refresh(await api("POST",`/api/games/${gid}/ai_move`));
    }
  } finally { busy=false; }
}
$("new").onclick=async()=>{
  const game=$("game").value;
  const size=game==="chess"?8:parseInt($("size").value);
  const p=await api("POST","/api/games",
      {game,board_size:size,simulations:parseInt($("sims").value)});
  gid=p.id; sel=null; await refresh(p);
};
$("ai").onclick=async()=>{ if(gid&&!busy&&!st.terminal){busy=true;
  try{ $("status").textContent=statusLine("engine thinking…");
       await refresh(await api("POST",`/api/games/${gid}/ai_move`)); }
  finally{busy=false;} }};
$("pass").onclick=async()=>{ if(gid&&!busy&&st&&!st.terminal)
  await move({action:st.cells.length}); };
$("game").onchange=()=>{ const g=$("game").value;
  $("size").value=g==="gomoku"?15:g==="go"?9:8;
  $("size").disabled=g==="chess"; };
</script></body></html>
"""
