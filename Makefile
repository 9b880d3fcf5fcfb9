# Build/test entry points (reference Makefile:83-116 equivalents).

.PHONY: all native test chip-smoke bench clean

all: native

native:
	$(MAKE) -C minnow_c_tpu/native

test: native
	python -m pytest tests/ -q

# On-card proof of the main path (numerics, frozen wire digests, the
# 512^3 snapshot, the delta codecs); needs a GPU.  One process per card.
chip-smoke: native
	python chip_smoke.py

bench: native
	python bench.py

clean:
	$(MAKE) -C minnow_c_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
