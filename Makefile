# Convenience targets mirroring the reference's Makefile surface
# (all/test/clean, Makefile:21,54-55).

PY ?= python

all: native

native:
	$(PY) -c "from seqalign_tpu.io import native; print('native seqio:', 'ok' if native.available() else 'unavailable (python fallback active)')"

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

smoke:
	$(PY) chip_smoke.py

golden: 
	sh tools/build_reference.sh
	$(PY) tools/gen_golden.py
	$(PY) tools/gen_cli_golden.py

clean:
	rm -f seqalign_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

.PHONY: all native test smoke golden clean
