"""Device operators of the port: solvers, DTI, the CUDA build and the
fused NODDI kernel."""
