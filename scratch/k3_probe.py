import sys, time, subprocess
sys.path.insert(0, ".")
import numpy as np, torch
from luaradio_tpu_torch.ops import cudabuild, pll
print(subprocess.run(["nvidia-smi","--query-gpu=name,power.limit,clocks.max.sm,clocks.sm","--format=csv,noheader"],capture_output=True,text=True).stdout, torch.__version__, torch.version.cuda)
t=time.time(); built=cudabuild.build()
for k,(s,log) in built.items(): print(k, f"{s:.2f}s"); print(log)
dev=torch.device("cuda")
gen=torch.Generator(device=dev).manual_seed(3)
a,b,lo,hi=np.float32(0.0075699),np.float32(2.87e-5),np.float32(0.5401),np.float32(0.5429)
for n in (1, 100, 2048, 2049, 8192, 52430):
  for mult in (1.0,2.0,2.5):
    x=(torch.randn(n,generator=gen,device=dev,dtype=torch.complex64))
    if n>=100: x[:10]=0
    st=torch.tensor([0.3,-0.5,0.541],device=dev)
    g=pll.pll_phase(x,st,a,b,lo,hi,mult); torch.cuda.synchronize()
    e=pll.pll_phase_reference(x,st,a,b,lo,hi,mult)
    print(n, mult, [ (u-v).abs().max().item() for u,v in zip(g,e)])
for n in (52430, 1764000):
  x=torch.randn(n,generator=gen,device=dev,dtype=torch.complex64); st=torch.tensor([0.,0.,0.541],device=dev)
  for _ in range(2): pll.pll_phase(x,st,a,b,lo,hi,2.0)
  torch.cuda.synchronize(); e0=torch.cuda.Event(enable_timing=True); e1=torch.cuda.Event(enable_timing=True)
  e0.record(); 
  for _ in range(5): pll.pll_phase(x,st,a,b,lo,hi,2.0)
  e1.record(); e1.synchronize(); ms=e0.elapsed_time(e1)/5
  print("time", n, ms, "ms", n/ms/1e3, "MS/s", ms*1e6/n, "ns/sample")
for steps in (1024, 1<<20):
  print("probe", steps, pll.chain_probe(steps, dev))
print("launches", pll.pll_phase.launches)
