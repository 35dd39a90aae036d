# Top-level targets (the reference exposes meson/autotools targets incl.
# a Doxygen docs target, meson.build:60-81; these are the equivalents)

.PHONY: native test bench docs clean

native:
	$(MAKE) -C libzseek_jax/native

test: native
	python -m pytest tests/ -q

bench: native
	python bench.py

docs:
	mkdir -p build/docs
	cd build/docs && for m in libzseek_jax libzseek_jax.api \
	  libzseek_jax.runtime.writer libzseek_jax.runtime.reader \
	  libzseek_jax.runtime.zstd_codec libzseek_jax.runtime.codec \
	  libzseek_jax.format.seek_table libzseek_jax.parallel.mesh \
	  libzseek_jax.parallel.distributed; do \
	  PYTHONPATH=$(CURDIR) JAX_PLATFORMS=cpu python -m pydoc -w $$m; \
	done && ls *.html

clean:
	$(MAKE) -C libzseek_jax/native clean
	rm -rf build
