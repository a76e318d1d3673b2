#include "fake_cuda.h"
