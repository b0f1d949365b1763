#!/usr/bin/env bash
# Build + run a two-stream instability deck on the reference VPIC
# (parameters matched to vpic_jax/models/twostream.py: 64 cells over
# 3 fastest-growing wavelengths, 64 ppc per beam, v0 = 0.2, vth = 0.005,
# neutralizing mi/me = 1836 ions), energies dumped every 2 steps for the
# linear-phase growth-rate fit (scripts/twostream_rate.py).
#
# Usage: [SEED=0] bash scripts/run_reference_twostream.sh <rundir>
set -e

BUILD=/tmp/vpic_ref_build
RUN=${1:?usage: run_reference_twostream.sh <rundir>}
SEED=${SEED:-0}

[ -x "$BUILD/vpicc" ] || bash "$(dirname "$0")/build_reference.sh"

mkdir -p "$RUN"
cat > "$RUN/twostream.cxx" <<'EOF'
// Two-stream instability: symmetric counter-streaming electron beams +
// neutralizing heavy ions in a 1-D periodic box (parameters matched to
// vpic_jax/models/twostream.py for the growth-rate comparison).

begin_globals {
  double energies_interval;
};

begin_initialization {
  double pi   = 3.1415926535897932;
  double Lx   = 2*pi*3.0;
  int    nx   = 64;
  double nppc = 64;          // per beam
  double v0   = 0.2;
  double vth  = 0.005;
  double mime = 1836.0;

  double dxx  = Lx/nx;
  double Ly   = dxx, Lz = dxx;

  define_units( 1, 1 );
  double wpe = 1;
  double dg  = courant_length( Lx, Ly, Lz, nx, 1, 1 );
  double dt  = 0.98*dg;
  if( dt > 0.2/wpe ) dt = 0.2/wpe;
  define_timestep( dt );

  define_periodic_grid( 0, 0, 0, Lx, Ly, Lz, nx, 1, 1, 1, 1, 1 );
  define_material( "vacuum", 1 );
  define_field_array( NULL, 0 );

  double Ne  = nppc*nx;      // per beam
  double we  = 0.5*Lx*Ly*Lz/(2*Ne);   // both beams together carry n0=1

  species_t * electron =
    define_species( "electron", -1, 1,      4.8*Ne, -1, 25, 1 );
  species_t * ion =
    define_species( "ion",       1, mime,   4.8*Ne, -1, 100, 1 );

  seed_entropy( __SEED__ );
  for( int sgn=0; sgn<2; sgn++ ) {
    double u0 = ( sgn ? -v0 : v0 );
    repeat( (int)Ne ) {
      inject_particle( electron,
                       uniform( rng(0), 0, Lx ), uniform( rng(0), 0, Ly ),
                       uniform( rng(0), 0, Lz ),
                       normal( rng(0), u0, vth ), 0, 0, 2*we, 0, 0 );
    }
    repeat( (int)Ne ) {
      inject_particle( ion,
                       uniform( rng(0), 0, Lx ), uniform( rng(0), 0, Ly ),
                       uniform( rng(0), 0, Lz ),
                       0, 0, 0, 2*we, 0, 0 );
    }
  }

  num_step = 400;
  status_interval = 0;
  global->energies_interval = 2;
}

begin_diagnostics {
  if( step()==0 ) dump_energies( "energies", 0 );
  else if( (step() % (int)global->energies_interval)==0 )
    dump_energies( "energies", 1 );
}

begin_particle_injection {}
begin_current_injection {}
begin_field_injection {}
begin_particle_collisions {}
EOF

sed -i "s/__SEED__/$SEED/" "$RUN/twostream.cxx"
"$BUILD/vpicc" "$RUN/twostream.cxx" "$RUN/twostream"
cd "$RUN"
exec nice -n 19 ./twostream
